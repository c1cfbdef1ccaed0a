"""The plain reference against the port's plain path (float32, no kernel,
the tiny configurations): one forward, a guided DDIM request, the training
loss and its gradients, and two whole training steps. Both take the same
weights from ``common.make_weights``; the tolerances are float32 rounding
of the same math in another order (two-pass against one-pass GroupNorm
statistics, packed against unpacked convolutions)."""
import pytest
import torch

import tiny
import common
import program
from drivers import train as train_driver
from reference import diffusion as rd
from reference import model as rm

torch.set_num_threads(2)


def _pair(nested: bool, train: bool = False):
    cfg = tiny.config(nested)
    ctx = tiny.context(cfg, tiny.sample_traffic(), {})
    weights = common.make_weights(program.named_shapes(cfg), 7, "cpu", torch.float32)
    pipe = program.build(cfg, {k: v.clone() for k, v in weights.items()}, "cpu", train=False)
    pipe.vision_module.use_kernels(False)
    if train:
        pipe.vision_module.train()
    ref = rm.build(cfg["yaml"]["unet_config"], nested, cfg["text_width"])
    ref.load_state_dict(weights, strict=True)
    return ctx, pipe, ref


def _close(a, b, tol):
    for x, y in zip(rd._as_list(a), rd._as_list(b)):
        assert (x.float() - y).abs().max() <= tol * y.abs().max(), (x - y).abs().max()


@pytest.mark.parametrize("nested", [False, True])
def test_forward(nested):
    ctx, pipe, ref = _pair(nested)
    r = common.request_inputs(5, 0, dict(ctx.traffic, guidance_scale=1.0), ctx.config, "cpu")
    x = r["noise"] if nested else r["noise"][0]
    t = torch.tensor([3, 700])
    with torch.no_grad():
        got = pipe.model(x, t, r["text"], r["mask"], {})
        want = ref(x, t, r["text"], r["mask"])
    _close(got, want, 2e-5)


@pytest.mark.parametrize("nested", [False, True])
def test_guided_ddim(nested):
    ctx, pipe, ref = _pair(nested)
    r = common.request_inputs(5, 1, ctx.traffic, ctx.config, "cpu")
    x = r["noise"] if nested else r["noise"][0]
    got = pipe.sample(2, {"lm_outputs": r["text"], "lm_mask": r["mask"]},
                      ctx.config["image_side"], noise=x, num_inference_steps=3, ddim_eta=0.0,
                      guidance_scale=5.0, resample_steps=True)
    sched = rd.Schedule(ctx.config["yaml"]["diffusion_config"]["sampler_config"], ctx.scales)
    want = rd.sample(ref, sched, r["noise"], r["text"], r["mask"], 5.0, 3)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("nested", [False, True])
def test_loss_and_gradients(nested):
    ctx, pipe, ref = _pair(nested, train=True)
    ctx.traffic = tiny.train_traffic()
    x = common.train_inputs(9, 0, ctx.traffic, ctx.config, "cpu")
    batch = {"images": x["images"], "lm_outputs": x["text"], "lm_mask": x["mask"]}
    eps = x["eps"] if nested else x["eps"][0]
    losses = pipe.get_loss(batch, time=x["time"], eps=eps)[0]
    losses.mean().backward()
    sched = rd.Schedule(ctx.config["yaml"]["diffusion_config"]["sampler_config"], ctx.scales)
    want = rd.per_image_loss(ref, sched, x["images"], x["text"], x["mask"], x["time"],
                             x["eps"], ctx.loss_weights)
    want.mean().backward()
    assert torch.allclose(losses, want, rtol=1e-4)
    got_g = rd.leaf_norms({k: p.grad for k, p in pipe.vision_module.named_parameters()})
    want_g = rd.leaf_norms({k: p.grad for k, p in ref.named_parameters()})
    assert max(rd.leaf_gaps(got_g, want_g).values()) < 1e-3


def test_two_training_steps():
    """The trainer's step (f32 compute, plain) against the reference's:
    losses, the first gradient and the change after two steps."""
    from ml_mdm_tpu_torch.trainer import TrainState, make_train_step

    ctx, pipe, _ = _pair(True, train=True)
    ctx.traffic = tiny.train_traffic()
    ctx.cell = {"reference_steps": 2, "check_rows": 1}
    ctx.seed = 7
    cfg = train_driver.trainer_config(ctx)
    state = TrainState.create(pipe.vision_module, cfg)
    step = make_train_step(pipe, cfg)
    names = list(state.params)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    losses, norms = [], []
    for k in range(2):
        state, m = train_driver._step(ctx, step, state, k)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if k == 0:
            grad = {n: float(state.optimizer.state[state.params[n]]["exp_avg"].norm()) / 0.1
                    for n in names}
    prog = {"loss": losses, "grad": grad, "grad_norm": norms[0],
            "change": {n: float((state.params[n].detach() - p0[n]).norm()) for n in names},
            "ema": {n: float((state.ema_params[n] - p0[n]).norm()) for n in names}}
    nums = train_driver.compare(prog, train_driver.reference_run(ctx),
                                train_driver.clip_norm(ctx))
    assert nums["loss_gap"] < 1e-4 and nums["grad_gap"] < 1e-3
    assert nums["grad_norm_gap"] < 1e-4 and nums["raw_grad_gap_median"] < 1e-3
    assert nums["change_gap"] < 2e-2 and nums["ema_gap"] < 2e-2
