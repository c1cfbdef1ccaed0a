"""The ``train_1024`` path of the port against the JAX package, on the CPU:
the packing plans of the full nested configs, a tiny nested2 U-Net with
packing engaged (every shell packs: a small ``pack_min_side`` and
``ML_MDM_TPU_PACK64_MIN_SIDE``) and its training with ``multi_res_weights``
16:4:1: three steps with selective remat against the JAX
``make_train_step(remat=True)`` (marked slow), the packed loss and
gradients against the same weights unpacked, and the port's remat against
no remat.
f32; inputs from a numpy seed; the losses take the timesteps and noise the
JAX step drew from the same key (the JAX step draws level 0's noise in its
flat packed loss form, which is unpacked for the port: the per-image MSE
does not depend on the order of the pixels).

Tolerances:
- plans: equal;
- the forward: max |port - JAX| <= 5e-4 of max |JAX| per level (as the
  unpacked nested forwards of tests/test_torch_nested.py);
- losses and gradient norms of three steps: 1e-4 relative (as
  tests/test_torch_trainer.py); packed against unpacked: 1e-4 relative on
  the loss and on every gradient, plus 1e-7 of the largest gradient (for
  gradients that are 0 up to rounding);
- remat against no remat in the port: 1e-6 relative on the loss and on
  every gradient, plus the same 1e-7 (the same f32 operations recomputed;
  the CPU runs them deterministically).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu import trainer as jtrainer
from ml_mdm_tpu.diffusion import NestedDiffusion as JaxNestedDiffusion
from ml_mdm_tpu.models.nested_unet import NestedUNet as JaxNestedUNet
from ml_mdm_tpu.samplers import _pack_hi, _unpack_hi
from ml_mdm_tpu_torch import trainer
from ml_mdm_tpu_torch.diffusion import NestedDiffusion
from ml_mdm_tpu_torch.models.nested_unet import NestedUNet
from ml_mdm_tpu_torch.models.unet import pack_plan, packs_input
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from ml_mdm_tpu_torch.presets import nested_configs, set_pack_min_side
from ml_mdm_tpu_torch.utils.convert import params_from_jax
from torch_parity import LM_LEN, jax_config_of, rel_err, seeded_params, tiny_nested_configs, to_np

torch.set_num_threads(1)

PACK_ENV = {"ML_MDM_TPU_PACK64_MIN_SIDE": "16"}
CFG = dict(lr=1e-3, warmup_steps=2, gradient_clip_norm=2.0, ema_decay=0.9, ema_warmup_steps=1,
           remat=True, remat_save_conv_max_side=8)
N_STEPS = 3


def _levels(cfg, side):
    """(config, side) of every level, outermost first."""
    out = []
    while cfg is not None:
        out.append((cfg, side))
        side //= 2 ** (len(cfg.resolution_channels) - 1)
        cfg = getattr(cfg, "inner_config", None)
    return out


@pytest.mark.parametrize("name", ["cc12m_256x256", "cc12m_1024x1024"])
@pytest.mark.parametrize("pack", [None, 0])
def test_pack_plans_of_the_full_configs_match_jax(name, pack):
    """The port's plan and ``packs_input`` at every level of the full
    configs, computed from the configs alone, equal the JAX ``_pack_plan`` /
    ``packs_input`` of the JAX module bound to no parameters."""
    ucfg, _, _, side = nested_configs(name, pack_min_side=pack)
    jmod = JaxNestedUNet(3, 3, jax_config_of(ucfg), dtype=jnp.bfloat16).bind({})
    plans = []
    for cfg, s in _levels(ucfg, side):
        jplan = jmod._pack_plan(jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32))
        plan = pack_plan(cfg, s, s)
        assert plan == list(jplan), (cfg.resolution_channels, s)
        assert packs_input(cfg, s) == jmod.packs_input(s)
        plans.append(plan)
        jmod = getattr(jmod, "inner_unet", None)
    if pack == 0:
        assert not any(any(p) for p in plans)
    elif name == "cc12m_1024x1024":  # every stage of the 1024px shell packs
        assert plans[0] == [True, True, True] and packs_input(ucfg, 1024)
    else:  # the 256px shell's 64-channel stage 0
        assert plans[0] == [True, False, False] and not packs_input(ucfg, 256)


def _tiny_nested2_configs():
    """The tiny nested2 model with 8/40-channel outer shell and packing from
    side 8 on every level: the outer shell packs both its levels (40
    channels through the 64-channel gate), the middle and inner shells pack
    their level 0 inside the stage."""
    ucfg, dcfg, side = tiny_nested_configs(2)
    ucfg = dataclasses.replace(ucfg, resolution_channels=[8, 40])
    set_pack_min_side(ucfg, 8)
    dcfg = dataclasses.replace(dcfg, multi_res_weights="16:4:1", no_use_residual=True)
    return ucfg, dcfg, side


def _batch(seed, b=2, side=32):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, LM_LEN), np.float32)
    mask[1, 4:] = 0
    return {"images": np.clip(rng.standard_normal((b, side, side, 3)) * 0.5, -1, 1).astype(np.float32),
            "lm_outputs": rng.standard_normal((b, LM_LEN, 16)).astype(np.float32),
            "lm_mask": mask}


def _jax_packed_noise(jpipe, key, images):
    """The timesteps and per-level noise the JAX nested ``get_loss`` draws
    from ``key`` when level 0 trains in the flat packed form, unpacked."""
    k_et, k_renoise, _ = jax.random.split(key, 3)
    img0 = _pack_hi(jnp.asarray(images))
    eps, _, _, _, time = jpipe.sampler.get_eps_time(k_et, img0)
    b, side, _, c = images.shape
    keys = jax.random.split(k_renoise, len(jpipe.scales))
    eps_list = [np.array(_unpack_hi(eps))] + [
        np.array(jax.random.normal(keys[i], (b, side * s // jpipe.scales[0],
                                             side * s // jpipe.scales[0], c), eps.dtype))
        for i, s in enumerate(jpipe.scales) if i > 0]
    return {"time": torch.from_numpy(np.array(time)).long(),
            "eps": [torch.from_numpy(e) for e in eps_list]}


def _build(ucfg, dcfg, params):
    unet = NestedUNet(3, 3, ucfg)
    unet.load_state_dict(params_from_jax(params), strict=True)
    return NestedDiffusion(unet.eval(), dcfg)


@pytest.fixture(scope="module")
def packed_pair():
    """The packed tiny nested2 model in both packages (JAX's forward
    compiled once), the same weights unpacked in the port, and one forward of
    each package."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PACK_ENV.items():
            mp.setenv(k, v)
        ucfg, dcfg, side = _tiny_nested2_configs()
        jpipe = JaxNestedDiffusion(JaxNestedUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32),
                                   jax_config_of(dcfg))
        params = seeded_params(jpipe, 5, image_side=side, lm_dim=16, seq_len=LM_LEN)
        pipe = _build(ucfg, dcfg, params)
        flat = copy.deepcopy(ucfg)
        set_pack_min_side(flat, 0)
        unpacked = _build(flat, dcfg, params)
        unet = pipe.vision_module
        assert jpipe._packed_io(side) and unet.packs_input(side)
        plans = [unet._pack_plan(torch.zeros(1, side, side, 3)),
                 unet.inner_unet._pack_plan(torch.zeros(1, side // 2, side // 2, 3))]
        rng = np.random.default_rng(0)
        xs = [rng.standard_normal((2, s, s, 3)).astype(np.float32) for s in (32, 16, 8)]
        t, lm = np.array([3, 15]), rng.standard_normal((2, LM_LEN, 16)).astype(np.float32)
        mask = np.ones((2, LM_LEN), np.float32)
        ref_fwd = jax.jit(lambda p, *a: jpipe.model(p, *a, {}))(
            params, [jnp.asarray(x) for x in xs], jnp.asarray(t), jnp.asarray(lm), jnp.asarray(mask))
        with torch.no_grad():
            fwd = pipe.model([torch.from_numpy(x) for x in xs], torch.from_numpy(t),
                             torch.from_numpy(lm), torch.from_numpy(mask), {})
        yield dict(jpipe=jpipe, params=params, pipe=pipe, unpacked=unpacked, plans=plans,
                   fwd=fwd, ref_fwd=ref_fwd, xs=xs, side=side)


def test_tiny_nested2_packed_forward_matches_jax(packed_pair):
    assert packed_pair["plans"] == [[True, True], [False, True]]
    for got, ref, x in zip(packed_pair["fwd"], packed_pair["ref_fwd"], packed_pair["xs"]):
        assert tuple(got.shape) == x.shape
        assert rel_err(to_np(got), ref) <= 5e-4


def test_sampling_keeps_packed_weights_until_a_parameter_changes(packed_pair, monkeypatch):
    """With gradients off (sampling) the packed weights are built once: a
    second forward transforms no kernel and gives the same output. An
    in-place change of the parameters (as an optimizer step makes) rebuilds
    them, and the forward then equals that of a model loaded with the
    changed weights."""
    for k, v in PACK_ENV.items():
        monkeypatch.setenv(k, v)
    builds = []
    pack = s2d.pack_conv3x3_kernel
    monkeypatch.setattr(s2d, "pack_conv3x3_kernel", lambda k: builds.append(1) or pack(k))
    ucfg, dcfg, _ = _tiny_nested2_configs()
    pipe, ref = (_build(ucfg, dcfg, packed_pair["params"]) for _ in range(2))
    xs = [torch.from_numpy(x) for x in packed_pair["xs"]]
    args = (torch.tensor([3, 15]), torch.zeros((2, LM_LEN, 16)), torch.ones((2, LM_LEN)), {})

    def forward(p):
        with torch.no_grad():
            return p.model(xs, *args)

    first = forward(pipe)
    n = len(builds)
    assert n > 0
    assert all(torch.equal(a, b) for a, b in zip(forward(pipe), first)) and len(builds) == n
    with torch.no_grad():
        for prm in pipe.vision_module.parameters():
            prm.mul_(1.5)
    changed = forward(pipe)
    assert len(builds) == 2 * n
    ref.vision_module.load_state_dict(pipe.vision_module.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(changed, forward(ref)))
    assert not all(torch.equal(a, b) for a, b in zip(changed, first))


def _loss_and_grads(pipe, batch, noise, save_side=None):
    """One loss and backward in training mode (``save_side``: the stages
    above it recomputed)."""
    unet = pipe.vision_module.train()
    trainer.set_remat(unet, save_side)
    unet.zero_grad(set_to_none=True)
    loss = pipe.get_loss(batch, **noise)[0].mean()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in unet.named_parameters() if p.grad is not None}
    trainer.set_remat(unet, None)
    unet.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _assert_grads_close(got, ref, tol):
    """Each gradient within ``tol`` of max |ref| of its tensor plus 1e-7 of
    the model's largest gradient: the f32 rounding of a gradient that is 0
    up to rounding (conv1's bias in a shell whose GroupNorm has one-channel
    groups, the norm cancels it)."""
    assert got.keys() == ref.keys() and len(ref) > 0
    top = max(float(g.abs().max()) for g in ref.values())
    for k, r in ref.items():
        bound = tol * float(r.abs().max()) + 1e-7 * top
        assert float((got[k] - r).abs().max()) <= bound, k


def _noise(batch, side, seed=1):
    rng = np.random.default_rng(seed)
    return {"time": torch.tensor([3, 15]),
            "eps": [torch.from_numpy(rng.standard_normal((2, s, s, 3)).astype(np.float32))
                    for s in (side, side // 2, side // 4)]}


@pytest.mark.parametrize("save_side", [0, None])
def test_packed_training_matches_unpacked(packed_pair, monkeypatch, save_side):
    """The packed model's loss and gradients (K3 with ``packed_struct``,
    the packed resamples, input and output layers, multi_res_weights
    16:4:1) against the same weights unpacked, whose training
    tests/test_torch_trainer.py holds against the JAX package: 1e-4
    relative (the same function summed in another order), with every stage
    recomputed (save side 0) and without remat."""
    for k, v in PACK_ENV.items():
        monkeypatch.setenv(k, v)
    batch = {k: torch.from_numpy(v) for k, v in _batch(20).items()}
    noise = _noise(batch, packed_pair["side"])
    l_p, g_p = _loss_and_grads(packed_pair["pipe"], batch, noise, save_side)
    l_u, g_u = _loss_and_grads(packed_pair["unpacked"], batch, noise)
    assert abs(l_p - l_u) <= 1e-4 * abs(l_u)
    _assert_grads_close(g_p, g_u, 1e-4)


def test_remat_matches_no_remat(packed_pair, monkeypatch):
    """One loss and backward with every stage recomputed (save side 0)
    against none."""
    for k, v in PACK_ENV.items():
        monkeypatch.setenv(k, v)
    batch = {k: torch.from_numpy(v) for k, v in _batch(21).items()}
    noise = _noise(batch, packed_pair["side"], seed=2)
    (l_on, g_on), (l_off, g_off) = (_loss_and_grads(packed_pair["pipe"], batch, noise, s)
                                    for s in (0, None))
    assert abs(l_on - l_off) <= 1e-6 * abs(l_off)
    _assert_grads_close(g_on, g_off, 1e-6)


@pytest.mark.slow
def test_three_remat_steps_match_jax(packed_pair, monkeypatch):
    """Three steps of ``make_train_step`` with remat on (save side 8) from
    the same weights in both packages. Marked slow: the JAX package traces
    and compiles the packed nested2 step in about 90 s on one CPU."""
    for k, v in PACK_ENV.items():
        monkeypatch.setenv(k, v)
    jpipe, side = packed_pair["jpipe"], packed_pair["side"]
    ucfg, dcfg, _ = _tiny_nested2_configs()
    pipe = _build(ucfg, dcfg, packed_pair["params"])
    jcfg, tcfg = jtrainer.TrainerConfig(**CFG), trainer.TrainerConfig(**CFG)
    jopt, _ = jtrainer.make_optimizer(jcfg)
    jstep = jax.jit(jtrainer.make_train_step(jpipe, jopt, jcfg))
    jstate = jtrainer.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, packed_pair["params"]), jopt)
    pipe.vision_module.train()
    state = trainer.TrainState.create(pipe.vision_module)
    step = trainer.make_train_step(pipe, tcfg)
    losses = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), N_STEPS)):
        batch = _batch(20 + i, side=side)
        jstate, r = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                        noise=_jax_packed_noise(jpipe, key, batch["images"]))
        assert m["skipped"] == int(r["skipped"]) == 0
        assert abs(m["loss"] - float(r["loss"])) <= 1e-4 * abs(float(r["loss"]))
        assert abs(m["grad_norm"] - float(r["grad_norm"])) <= 1e-4 * abs(float(r["grad_norm"]))
        losses.append(m["loss"])
    assert len(set(losses)) == N_STEPS
