"""Training cells: the port's training step (``trainer.make_train_step``,
the step that ``clis/train_parallel.py`` runs) driven back to back, each
step on a new batch of images, text, timesteps and noise made from the
seed, each ending as the trainer's does, with its NaN-skip readback.

Set-up: the weights from the seed, the pipeline in training mode, the
train state (Adam, EMA) and the step, and the step's first three calls,
which the check follows (every kernel and shape of the window runs in the
first). The window runs steps until ``--seconds`` have passed;
``train_images_per_s`` is every image of every step over the window. With
``--trace 1`` ``traced_steps`` more steps run after the window under the
profiler of the device alone, the first as a lead-in and the rest marked
as the window (``devtrace``: the device's busy time, window and kernels),
then one more step with the host's ops and ranges (the program's ranges
read by the per-layer metrics, and the idle gaps' labels).

The check: the plain reference follows the same three steps from the same
weights and inputs in float32, after the program is freed. Compared: each
step's loss; the first gradient as Adam got it (from its first moment
after one step); the parameters' change after three steps and the EMA's,
per leaf by the norm, the median leaf's gap (``compare``). What the set-up keeps for the check (per-leaf norms,
read from the program's state after steps 1 and 3) is timed apart and left
out of ``setup_s``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np
import torch

import common
import program

B1 = 0.9  # Adam's first-moment decay (the trainer's)


def trainer_config(ctx):
    from ml_mdm_tpu_torch.trainer import TrainerConfig

    y, tr = ctx.config["yaml"], ctx.traffic
    return TrainerConfig(lr=float(y["lr"]), warmup_steps=int(y["warmup_steps"]),
                         gradient_clip_norm=float(y["gradient_clip_norm"]),
                         use_adamw=bool(y.get("use_adamw", False)),
                         ema_decay=float(tr["ema_decay"]), remat=bool(tr["remat"]),
                         remat_save_conv_max_side=int(tr["remat_save_conv_max_side"]))


def _step(ctx, step, state, index: int):
    x = common.train_inputs(ctx.seed, index, ctx.traffic, ctx.config, ctx.device)
    batch = {"images": x["images"], "lm_outputs": x["text"], "lm_mask": x["mask"]}
    return step(state, batch, noise={"time": x["time"], "eps": x["eps"]})


def _norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack(torch._foreach_norm(tensors)).tolist()


def run(ctx) -> Dict:
    from ml_mdm_tpu_torch.trainer import TrainState, make_train_step

    phases = [("imports", time.perf_counter())]
    shapes = program.named_shapes(ctx.config)
    weights = common.make_weights(shapes, ctx.seed, ctx.device, torch.float32)
    common.sync(ctx.device)
    phases.append(("weights", time.perf_counter()))
    pipe = program.build(ctx.config, weights, ctx.device, train=True)
    del weights
    cfg = trainer_config(ctx)
    state = TrainState.create(pipe.vision_module, cfg)
    step = make_train_step(pipe, cfg)
    common.sync(ctx.device)
    phases.append(("pipeline and train state", time.perf_counter()))
    names = list(state.params)
    kept, losses, norms, skipped, aside = {}, [], [], 0, 0.0
    for k in range(ctx.cell["reference_steps"]):
        state, m = _step(ctx, step, state, k)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        skipped += m["skipped"]
        t = time.perf_counter()
        if k == 0:  # Adam's first moment after one step is (1 - b1) g
            opt = state.optimizer.state
            kept["grad"] = [n / (1 - B1) for n in _norms(
                [opt[p]["exp_avg"] if "exp_avg" in opt.get(p, {}) else torch.zeros_like(p)
                 for p in (state.params[n] for n in names)])]
        aside += time.perf_counter() - t
        phases.append((f"step {k + 1}", time.perf_counter()))
    t = time.perf_counter()
    p0 = common.make_weights(shapes, ctx.seed, ctx.device, torch.float32)
    start = [p0[n] for n in names]
    kept["change"] = _norms(torch._foreach_sub([state.params[n].detach() for n in names], start))
    kept["ema"] = _norms(torch._foreach_sub([state.ema_params[n] for n in names], start))
    del p0, start
    common.sync(ctx.device)
    aside += time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t_start - aside
    ctx.log("set-up: " + ", ".join(
        f"{name} {end - start:.3f} s" for (_, start), (name, end)
        in zip([("start", ctx.t_start)] + phases, phases))
        + f"; the check's norms {aside:.3f} s aside; setup_s {setup_s:.3f} s")

    index = ctx.cell["reference_steps"]
    n_steps = 0
    t0 = time.perf_counter()
    ends = [t0]
    while not n_steps or ends[-1] - t0 < ctx.seconds:
        state, m = _step(ctx, step, state, index)
        skipped += m["skipped"]
        index += 1
        n_steps += 1
        ends.append(time.perf_counter())
    common.sync(ctx.device)
    window_s = time.perf_counter() - t0
    peak = common.peak_bytes(ctx.device)
    b = ctx.traffic["batch"]
    each = np.diff(ends)
    ctx.log(f"window: {n_steps} steps of {b} in {window_s:.3f} s (a step: least "
            f"{each.min():.4f}, median {np.median(each):.4f}, most {each.max():.4f} s); "
            f"losses of the first steps {losses}")
    result = {"setup_s": setup_s, "e2e": {"train_images_per_s": b * n_steps / window_s},
              "attempted": n_steps, "memory_peak_bytes": peak}
    if ctx.trace:
        from devtrace import Trace, mark, profiler

        traced = ctx.traffic["traced_steps"]
        with profiler(host=False) as prof:
            for k in range(traced):
                if k == 1:
                    mark()
                state, _ = _step(ctx, step, state, index)
                index += 1
            mark()
            common.sync(ctx.device)
        with profiler() as host:
            state, _ = _step(ctx, step, state, index)
            common.sync(ctx.device)
        result["trace"], result["host_trace"] = Trace.from_profiler(prof), Trace.from_profiler(host)
        busy, marked = result["trace"].busy_and_window()
        ctx.log(f"trace: {marked / 1e6 / (traced - 1):.4f} s a step traced (the device's, "
                f"marked), {window_s / n_steps:.4f} s a step in the window")
        work = _work(ctx)
        result["layer"] = {"window_s": window_s, "model_flops": work["flops"] * n_steps,
                           "conv_bwd_least_s": work["conv_bwd_least_s"], "host_steps": 1,
                           "peak": work["peak"]}
    del state, step, pipe
    common.free()
    prog = {"loss": losses, "grad_norm": norms[0],
            **{k: dict(zip(names, v)) for k, v in kept.items()}}
    result.update(check(ctx, prog))
    result["failed"] = skipped
    return result


def _work(ctx) -> Dict:
    """The FLOPs of one step's forward and backward at the mix's batch, and
    the least time of its convolutions' gradients, counted on the
    reference at those shapes (no recompute)."""
    from flops.count import conv_least_seconds, count, peaks
    from reference import diffusion as rd
    from reference.model import build as build_ref

    tr, cfg = ctx.traffic, ctx.config
    b = tr["batch"]
    ref = build_ref(cfg["yaml"]["unet_config"], ctx.nested, cfg["text_width"], "meta")
    sched = rd.Schedule(cfg["yaml"]["diffusion_config"]["sampler_config"], ctx.scales)
    sched.gammas = sched.gammas.to("meta")
    side = cfg["image_side"]
    images = torch.empty((b, side, side, 3), device="meta")
    eps = [torch.empty((b, s, s, 3), device="meta") for s in common.sides(cfg, side)]
    text = torch.empty((b, tr["text_tokens"], cfg["text_width"]), device="meta")
    mask = torch.ones((b, tr["text_tokens"]), dtype=torch.int32, device="meta")
    time_ = torch.zeros(b, dtype=torch.long, device="meta")

    def step():
        loss = rd.per_image_loss(ref, sched, images, text, mask, time_, eps, ctx.loss_weights)
        loss.mean().backward()

    work = count(step)
    peak = peaks(common.device_name(ctx.device))
    least = conv_least_seconds(work["convs"], peak, backward=True) if peak else None
    return {"flops": work["flops"], "conv_bwd_least_s": least, "peak": peak}


def reference_run(ctx, quant=None, drop_half: bool = False) -> Dict:
    """The reference's three steps: each step's loss, the first clipped
    gradient's norm per leaf, and the change of the parameters and of the
    EMA after the steps, per leaf (``quant``: ``reference.model.QUANT``;
    ``drop_half``: each step's loss over the first half of its batch, the
    planted fault of a step that leaves half the batch out)."""
    from reference import diffusion as rd
    from reference import model as rm

    cfg, tr = ctx.config, ctx.traffic
    rd.set_float32_exact()
    ref = rm.build(cfg["yaml"]["unet_config"], ctx.nested, cfg["text_width"], ctx.device)
    shapes = [(k, tuple(p.shape)) for k, p in ref.named_parameters()]
    p0 = common.make_weights(shapes, ctx.seed, ctx.device, torch.float32)
    ref.load_state_dict(p0, strict=True)
    y = cfg["yaml"]
    sched = rd.Schedule(y["diffusion_config"]["sampler_config"], ctx.scales)
    tref = rd.TrainReference(ref, sched, float(y["lr"]), int(y["warmup_steps"]),
                             float(y["gradient_clip_norm"]), float(tr["ema_decay"]),
                             ctx.loss_weights)
    out = {"loss": []}
    rm.QUANT = quant
    try:
        for k in range(ctx.cell["reference_steps"]):
            x = common.train_inputs(ctx.seed, k, tr, cfg, ctx.device)
            if drop_half:
                h = tr["batch"] // 2
                x = {n: ([e[:h] for e in v] if n == "eps" else v[:h]) for n, v in x.items()}
            r = tref.step(x["images"], x["text"], x["mask"], x["time"], x["eps"],
                          ctx.cell["check_rows"])
            out["loss"].append(r["loss"])
            if k == 0:
                out["grad"], out["grad_norm"] = rd.leaf_norms(r["grads"]), r["norm"]
            del r
    finally:
        rm.QUANT = None
    names = list(tref.params)
    out["change"] = dict(zip(names, _norms(torch._foreach_sub(
        [tref.params[n].detach() for n in names], [p0[n] for n in names]))))
    out["ema"] = dict(zip(names, _norms(torch._foreach_sub(
        [tref.ema[n] for n in names], [p0[n] for n in names]))))
    return out


def compare(prog: Dict, ref: Dict, clip: float) -> Dict[str, float]:
    """The check's numbers: the worst step's relative loss gap and the
    first step's; the worst leaf's gap of the first gradient; over
    ``moved_leaves``, the median leaf's gap of the first gradient, as Adam
    got it and before clipping by ``clip`` (each side's clipping undone by
    its own global norm), and the worst and the median leaf's gap of the
    change and of the EMA's change; the gap of the first global gradient
    norm. The cell's file names those it compares (``PERF.md`` says why)."""
    from reference.diffusion import leaf_gaps

    keep = moved_leaves(ref)
    change, ema = leaf_gaps(prog["change"], ref["change"], keep), leaf_gaps(prog["ema"], ref["ema"], keep)
    grad = leaf_gaps(prog["grad"], ref["grad"], keep)
    raw = leaf_gaps(*({k: v * max(side["grad_norm"], clip) / clip
                       for k, v in side["grad"].items()} for side in (prog, ref)), keep)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "loss_gap_first": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"]).values()),
        "grad_gap_median": float(np.median(list(grad.values()))),
        "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
        "raw_grad_gap_median": float(np.median(list(raw.values()))),
        "change_gap": max(change.values()),
        "change_gap_median": float(np.median(list(change.values()))),
        "ema_gap": max(ema.values()),
        "ema_gap_median": float(np.median(list(ema.values()))),
    }


def clip_norm(ctx) -> float:
    return float(ctx.config["yaml"]["gradient_clip_norm"])


def moved_leaves(ref: Dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    med = float(np.median(list(ref["grad"].values())))
    return [k for k, v in ref["grad"].items() if v >= 1e-3 * med]


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], grad: Dict[str, float],
                 keep: List[str], n: int = 4) -> str:
    """The ``n`` leaves of ``keep`` with the widest gap: name, gap, and the
    leaf's first gradient over the median leaf's."""
    from reference.diffusion import leaf_gaps

    gmed = float(np.median(list(grad.values())))
    gaps = sorted(((g, k) for k, g in leaf_gaps(prog, ref, keep).items()), reverse=True)[:n]
    return ", ".join(f"{k} {g:.4g} (grad {grad[k] / gmed:.3g} median)" for g, k in gaps)


def check(ctx, prog: Dict) -> Dict:
    t0 = time.perf_counter()
    ref = reference_run(ctx)
    nums = compare(prog, ref, clip_norm(ctx))
    ctx.log(f"check: the reference's three steps in {time.perf_counter() - t0:.3f} s; "
            f"losses {ref['loss']} against the program's {prog['loss']}")
    keep = moved_leaves(ref)
    ctx.log("check: " + "; ".join(
        f"{k}: {worst_leaves(prog[k], ref[k], ref['grad'], list(ref['grad']) if k == 'grad' else keep)}"
        for k in ("grad", "change", "ema")))
    ctx.log("check: all numbers " + json.dumps(nums) + "; timesteps " + json.dumps(
        [common.train_inputs(ctx.seed, k, ctx.traffic, ctx.config, ctx.device)["time"].tolist()
         for k in range(ctx.cell["reference_steps"])]))
    limits = ctx.cell["limits"]
    compared = {k: (v, limits[k]) for k, v in nums.items() if k in limits}
    return {"compared": compared, "numbers": nums,
            "correct": all(v <= lim for v, lim in compared.values())}
