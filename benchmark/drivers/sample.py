"""Sampling cells: one client that sends whole requests back to back, each
a batch of prompts with classifier-free guidance, denoised by the port's
``sample`` (DDIM), its images copied to the host as ``generate_batch``
ends a batch.

Set-up: the weights from the seed, the pipeline, and one request of the
mix's batch and guidance at ``warmup_steps`` DDIM steps (every kernel and
shape of the window). The window runs requests until ``--seconds`` have
passed; ``samples_per_s`` is every sample over the time from the first
request's start to the last one's end. With ``--trace 1`` the window's
forwards are timed on the host by hooks on the vision module, and one more
request runs after the window with two stretches of its forwards under the
profiler: ``traced_forwards`` (the first and how many) under the profiler
of the device alone, marked from that forward's start to the start of the
one after the stretch (``devtrace``), for the device's busy time, window
and kernels; then ``labelled_forwards`` more with the host's ops and ranges,
which label the idle gaps.

The check: a sample of the window's images, drawn from the seed, against
the plain reference run from the same noise and text in float32, after the
program is freed.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

import common
import program


def _sample_kwargs(traffic: Dict, steps: int) -> Dict:
    return dict(num_inference_steps=steps, ddim_eta=traffic["ddim_eta"],
                guidance_scale=traffic["guidance_scale"], resample_steps=True)


def _request(ctx, pipe, index: int, steps: int) -> torch.Tensor:
    r = common.request_inputs(ctx.seed, index, ctx.traffic, ctx.config, ctx.device)
    noise = r["noise"] if len(r["noise"]) > 1 else r["noise"][0]
    out = pipe.sample(ctx.traffic["batch"], {"lm_outputs": r["text"], "lm_mask": r["mask"]},
                      ctx.config["image_side"], noise=noise,
                      **_sample_kwargs(ctx.traffic, steps))
    return out.float().cpu()


class _ForwardClock:
    """Host time of each forward of the vision module, by hooks (no
    synchronisation: the time to enqueue it)."""

    def __init__(self, module):
        self.ms: List[float] = []
        self._t = 0.0
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, *_):
        self._t = time.perf_counter()

    def _post(self, *_):
        self.ms.append(1e3 * (time.perf_counter() - self._t))

    def remove(self):
        for h in self._hooks:
            h.remove()


class _Tracer:
    """The profiler over forwards [first, first + n) of the next request,
    started ``lead`` forwards before them and stopped as forward
    ``first + n`` begins, once the device has finished what came before;
    with ``marks``, a mark of the window as forwards ``first`` and
    ``first + n`` begin. The trace holds the steady loop: the forwards
    and the sampler's work between them, and not the request's ends."""

    def __init__(self, module, device, first: int, n: int, host: bool, lead: int = 0):
        from devtrace import profiler

        self.prof, self.device, self.seen = profiler(host), device, 0
        self.start, self.first, self.stop, self.marks = first - lead, first, first + n, not host
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, *_):
        from devtrace import mark

        if self.seen == self.start:
            self.prof.start()
        if self.marks and self.seen in (self.first, self.stop):
            mark()
        if self.seen == self.stop:
            common.sync(self.device)
            self.prof.stop()

    def _post(self, *_):
        self.seen += 1

    def trace(self):
        from devtrace import Trace

        for h in self._hooks:
            h.remove()
        return Trace.from_profiler(self.prof)


def run(ctx) -> Dict:
    tr = ctx.traffic
    steps, batch = tr["num_inference_steps"], tr["batch"]
    weights = common.make_weights(program.named_shapes(ctx.config), ctx.seed, ctx.device,
                                  torch.bfloat16)
    pipe = program.build(ctx.config, weights, ctx.device, train=False)
    del weights
    _request(ctx, pipe, -1, tr["warmup_steps"])
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    clock = _ForwardClock(pipe.vision_module) if ctx.trace else None
    outs = []
    t0 = time.perf_counter()
    while not outs or time.perf_counter() - t0 < ctx.seconds:
        outs.append(_request(ctx, pipe, len(outs), steps))
    window_s = time.perf_counter() - t0
    peak = common.peak_bytes(ctx.device)
    result = {"setup_s": setup_s, "e2e": {"samples_per_s": batch * len(outs) / window_s},
              "attempted": batch * len(outs), "memory_peak_bytes": peak}
    ctx.log(f"window: {len(outs)} requests of {batch} in {window_s:.3f} s")

    if ctx.trace:
        clock.remove()
        first, n = tr["traced_forwards"]
        device = _Tracer(pipe.vision_module, ctx.device, first, n, host=False, lead=2)
        host = _Tracer(pipe.vision_module, ctx.device, first + n + 1, tr["labelled_forwards"],
                       host=True)
        _request(ctx, pipe, len(outs), steps)
        work = _work(ctx)
        result["trace"], result["host_trace"] = device.trace(), host.trace()
        busy, traced = result["trace"].busy_and_window()
        ctx.log(f"trace: {traced / 1e3 / n:.3f} ms a forward traced (the device's, marked), "
                f"{1e3 * window_s / (steps * len(outs)):.3f} ms a forward in the window")
        result["layer"] = {"window_s": window_s, "enqueue_ms": clock.ms,
                           "model_flops": work["flops"] * steps * len(outs),
                           "conv_fwd_least_s": work["conv_least_s"] * n,
                           "peak": work["peak"]}

    del pipe
    common.free()
    result.update(check(ctx, outs))
    return result


def _work(ctx) -> Dict:
    """The FLOPs of one guided forward at the mix's rows and the least time
    of its convolutions, counted on the reference at those shapes."""
    from flops.count import conv_least_seconds, count, peaks
    from reference.model import build as build_ref

    rows = ctx.traffic["batch"] * (2 if ctx.traffic["guidance_scale"] != 1.0 else 1)
    ref = build_ref(ctx.config["yaml"]["unet_config"], ctx.nested, ctx.config["text_width"],
                    "meta")
    x = [torch.empty((rows, s, s, 3), device="meta")
         for s in common.sides(ctx.config, ctx.config["image_side"])]
    x = x if ctx.nested else x[0]
    t = torch.zeros(rows, dtype=torch.long, device="meta")
    text = torch.empty((rows, ctx.traffic["text_tokens"], ctx.config["text_width"]),
                       device="meta")
    mask = torch.ones(text.shape[:2], dtype=torch.int32, device="meta")
    with torch.no_grad():
        work = count(lambda: ref(x, t, text, mask))
    peak = peaks(common.device_name(ctx.device))
    least = conv_least_seconds(work["convs"], peak) if peak else None
    return {"flops": work["flops"], "conv_least_s": least, "peak": peak}


def picks(ctx, n_requests: int) -> List:
    """``check_samples`` (request, row) pairs of the window's, drawn from
    the seed."""
    batch = ctx.traffic["batch"]
    rng = random.Random(common.mix(ctx.seed, 4))
    chosen = rng.sample(range(n_requests * batch), min(ctx.cell["check_samples"],
                                                        n_requests * batch))
    return [divmod(idx, batch) for idx in sorted(chosen)]


def reference_images(ctx, chosen: List, quant=None) -> torch.Tensor:
    """The reference's images of the (request, row) pairs ``chosen``, from
    their noise and text, in one batch, computed in float32 (``quant``: the
    precision ``reference.model.QUANT`` names)."""
    from reference import diffusion as rd
    from reference import model as rm

    tr, cfg = ctx.traffic, ctx.config
    batch, guided = tr["batch"], tr["guidance_scale"] != 1.0
    rd.set_float32_exact()
    # 50 steps at a few shapes: the library's fastest float32 convolutions,
    # tried once a shape, pay back (the reference needs no bitwise repeat)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    ref = rm.build(cfg["yaml"]["unet_config"], ctx.nested, cfg["text_width"], ctx.device)
    shapes = [(k, tuple(p.shape)) for k, p in ref.named_parameters()]
    ref.load_state_dict({k: v.float() for k, v in common.make_weights(
        shapes, ctx.seed, ctx.device, torch.bfloat16).items()}, strict=True)
    sched = rd.Schedule(cfg["yaml"]["diffusion_config"]["sampler_config"], ctx.scales)
    inputs = {}
    for i, _ in chosen:
        if i not in inputs:
            inputs[i] = common.request_inputs(ctx.seed, i, tr, cfg, ctx.device)
    noise = [torch.cat([inputs[i]["noise"][lvl][r:r + 1] for i, r in chosen])
             for lvl in range(len(ctx.scales))]
    rows = [[r for _, r in chosen]] + ([[batch + r for _, r in chosen]] if guided else [])
    text = torch.cat([torch.stack([inputs[i]["text"][rr[k]] for k, (i, _) in enumerate(chosen)])
                      for rr in rows])
    mask = torch.cat([torch.stack([inputs[i]["mask"][rr[k]] for k, (i, _) in enumerate(chosen)])
                      for rr in rows])
    rm.QUANT = quant
    try:
        return rd.sample(ref, sched, noise, text, mask, tr["guidance_scale"],
                         tr["num_inference_steps"]).cpu()
    finally:
        rm.QUANT = None


def relative_errors(got: torch.Tensor, want: torch.Tensor) -> List[float]:
    return [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]


def check(ctx, outs: List[torch.Tensor]) -> Dict:
    """A sample of the window's images against the reference's."""
    chosen = picks(ctx, len(outs))
    t0 = time.perf_counter()
    want = reference_images(ctx, chosen)
    errs = relative_errors(torch.stack([outs[i][r] for i, r in chosen]), want)
    ctx.log(f"check: {len(chosen)} samples against the reference in "
            f"{time.perf_counter() - t0:.3f} s; relative errors "
            + " ".join(f"{e:.6g}" for e in errs))
    limit = ctx.cell["limits"]["image_rel_err"]
    worst = max(errs)
    return {"compared": {"image_rel_err": (worst, limit)},
            "failed": sum(e > limit for e in errs), "correct": worst <= limit}
