"""The port's training pieces against the JAX package: K3's backward
(``affine_silu_conv3x3_vjp``), K1's backward (``spatial_sums``), both
training losses, and the tiny nested model's parameter gradients. Inputs
come from a numpy seed; the losses get the timesteps and noise JAX drew
from the same key. f32 unless stated.

Tolerances, each on max |port - JAX| / max |JAX|:
- K3 and K1 gradients, f32: 1e-4 (the same math, sums in another order);
  bf16: 2e-2 (two bf16 ULPs: dy after the stats fold, the data gradient
  and the stored activation are rounded to bf16 at the same places, but
  f32 sums in another order can flip a rounding);
- K3 against autograd of the port's plain version: 1e-4 in f32, 3e-2 in
  bf16 (autograd rounds the activation's gradient at other places);
- losses: 1e-4 (the U-Net forward's 5e-4 of max|ref| on the prediction
  shrinks in a mean of squares);
- parameter gradients: 2e-3 per tensor (the forward's error carried
  through the backward of ~30 layers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.ops import fused_resnet as jfr
from ml_mdm_tpu.ops import gn_stats as jgn
from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats
from ml_mdm_tpu_torch.utils.convert import params_from_jax
from torch_parity import (
    LM_LEN,
    jax_flat_noise,
    jax_nested_noise,
    rel_err,
    tiny_nested_pair,
    tiny_pair,
    to_np,
    with_diffusion_config,
)

torch.set_num_threads(1)

FUSED_TRAIN_ENV = {"ML_MDM_TPU_FUSED_TRAIN": "interpret", "ML_MDM_TPU_FUSED_MIN_SIDE": "8"}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PLAIN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _k3_inputs(dtype: str, residual: bool, seed: int = 0, b=2, h=8, w=8, c=16, cout=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, h, w, c)).astype(f)
    a = (rng.standard_normal((b, c)) * 0.2 + 1.0).astype(f)
    bb = (rng.standard_normal((b, c)) * 0.3).astype(f)
    wk = (rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c)).astype(f)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(f)
    res = rng.standard_normal((b, h, w, cout)).astype(f) if residual else None
    cot = [rng.standard_normal((b, h, w, cout)).astype(f),
           rng.standard_normal((b, cout)).astype(f) * 0.1,
           rng.standard_normal((b, cout)).astype(f) * 0.01]
    # x, the residual and dy in the working type; coefficients, weights and
    # the stats cotangents f32, as the training route hands them over
    jdt = jnp.dtype(dtype)
    jx = [jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(wk), jnp.asarray(bias),
          None if res is None else jnp.asarray(res, jdt)]
    tdt = getattr(torch, dtype)
    tx = [torch.from_numpy(x).to(tdt), torch.from_numpy(a), torch.from_numpy(bb),
          torch.from_numpy(wk), torch.from_numpy(bias),
          None if res is None else torch.from_numpy(res).to(tdt)]
    return jx, tx, ([jnp.asarray(cot[0], jdt)] + [jnp.asarray(v) for v in cot[1:]],
                    [torch.from_numpy(cot[0]).to(tdt)] + [torch.from_numpy(v) for v in cot[1:]])


def _port_grads(fn, tx, tcot, stats):
    ins = [t.clone().requires_grad_(True) if t is not None else None for t in tx]
    out = fn(*ins, emit_stats=stats)
    outs = out if stats else (out,)
    torch.autograd.backward(outs, tcot[:len(outs)])
    return [t.grad if t is not None else None for t in ins]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats,residual", [(False, False), (True, False), (False, True),
                                            (True, True)])
def test_k3_backward_matches_jax_and_plain(dtype, stats, residual):
    jx, tx, (jcot, tcot) = _k3_inputs(dtype, residual)

    def jfn(x, a, b, w, bias, res):
        return jfr.affine_silu_conv3x3_vjp(x, a, b, w, bias, res, True, True, stats, False)

    if residual:
        _, pull = jax.vjp(jfn, *jx)
    else:
        _, pull = jax.vjp(lambda *p: jfn(*p, None), *jx[:5])
    ref = pull(tuple(jcot) if stats else jcot[0])
    got = _port_grads(fused_resnet.affine_silu_conv3x3_vjp, tx, tcot, stats)
    plain = _port_grads(fused_resnet.affine_silu_conv3x3_plain, tx, tcot, stats)
    names = ["x", "a", "b", "w", "bias", "residual"][:len(ref)]
    for name, r, g, p in zip(names, ref, got, plain):
        assert g.dtype == p.dtype == getattr(torch, str(r.dtype)), name
        assert np.abs(np.asarray(r, np.float32)).max() > 0, name
        assert rel_err(to_np(g), r) <= TOL[dtype], name
        assert rel_err(to_np(g), to_np(p)) <= PLAIN_TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_backward_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 8, 8, 16)) + 0.3).astype(np.float32)
    d1, d2 = rng.standard_normal((2, 2, 16)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, pull = jax.vjp(lambda v: jgn.spatial_sums(v, True), jnp.asarray(x, jdt))
    (ref,) = pull((jnp.asarray(d1), jnp.asarray(d2)))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    torch.autograd.backward(gn_stats.spatial_sums(xt), [torch.from_numpy(d1), torch.from_numpy(d2)])
    assert xt.grad.dtype == tdt
    assert rel_err(to_np(xt.grad), ref) <= TOL[dtype]


# -- losses ----------------------------------------------------------------------

_PAIRS = {}


def _pair(kind, **overrides):
    """The tiny flagship ("flat") or the tiny nested model of depth
    ``kind``, built once, with its diffusion config's ``overrides``."""
    if kind not in _PAIRS:
        _PAIRS[kind] = (tiny_pair(seed=4, fast_init=True) if kind == "flat"
                        else tiny_nested_pair(kind, seed=kind, fast_init=True))
    return with_diffusion_config(_PAIRS[kind], **overrides) if overrides else _PAIRS[kind]


def _batch(b, side, lm_dim, seed):
    rng = np.random.default_rng(seed)
    images = np.clip(rng.standard_normal((b, side, side, 3)) * 0.5, -1, 1).astype(np.float32)
    lm = rng.standard_normal((b, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((b, LM_LEN), np.float32)
    mask[0, 5:] = 0
    return {"images": images, "lm_outputs": lm, "lm_mask": mask}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", [
    ("flat", {}),
    (2, {"use_double_loss": True, "multi_res_weights": "4:2:1"}),
    (1, {"mixed_ratio": "2:1", "use_double_loss": True, "no_use_residual": True}),
])
def test_get_loss_matches_jax(case):
    kind, overrides = case
    jpipe, params, pipe, lm_dim, side = _pair(kind, **overrides)
    b = 3 if overrides.get("mixed_ratio") else 2
    batch = _batch(b, side, lm_dim, seed=5)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p, bt, k: jpipe.get_loss(p, bt, k)[:5])(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise = (jax_flat_noise if kind == "flat" else jax_nested_noise)(jpipe, key, batch["images"])
    pipe.vision_module.train()
    with torch.no_grad():
        got = pipe.get_loss(_port_batch(batch), **noise)
    pipe.vision_module.eval()
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(ref[1]))  # the same timesteps
    assert got[0].dtype == torch.float32 and got[0].shape == (b,)
    assert rel_err(to_np(got[0]), ref[0]) <= 1e-4
    for g, r in zip(got[2:5], ref[2:5]):  # x_t, prediction and target at the top
        assert rel_err(to_np(g), r) <= 5e-4
    if overrides.get("mixed_ratio"):
        # the top resolution ran on int(2/3 * 3) = 2 of 3 rows; the third
        # row of its prediction is the zero padding
        tb = _port_batch(batch)
        with torch.no_grad():
            out = pipe.model(noise["eps"], noise["time"], tb["lm_outputs"], tb["lm_mask"], {},
                             mixed_ratio=pipe.mixed_ratio)
        assert float(out[0][2:].abs().max()) == 0.0 < float(out[0][:2].abs().max())


def test_nested_parameter_gradients_match_jax(monkeypatch):
    """The tiny nested model's parameter gradients of the mean loss, with the
    JAX package on its fused training route (Pallas in interpret mode)."""
    for k, v in FUSED_TRAIN_ENV.items():
        monkeypatch.setenv(k, v)
    jpipe, params, pipe, lm_dim, side = _pair(1)
    batch = _batch(2, side, lm_dim, seed=6)
    key = jax.random.PRNGKey(8)

    def jloss(p, bt, k):
        return jnp.mean(jpipe.get_loss(p, bt, k)[0])

    ref_loss, ref = jax.jit(jax.value_and_grad(jloss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise = jax_nested_noise(jpipe, key, batch["images"])
    unet = pipe.vision_module.train()
    unet.zero_grad()
    loss = pipe.get_loss(_port_batch(batch), **noise)[0].mean()
    loss.backward()
    unet.eval()
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    ref = params_from_jax(jax.device_get(ref))
    top = max(float(v.abs().max()) for v in ref.values())
    nonzero = 0
    for name, p in unet.named_parameters():
        r = ref[name].numpy()
        g = to_np(p.grad) if p.grad is not None else np.zeros_like(r)
        if np.abs(r).max() == 0:  # parameters no forward uses
            assert np.abs(g).max() == 0, name
            continue
        nonzero += 1
        # a gradient that is 0 up to rounding (conv1's bias before a
        # GroupNorm of one-channel groups) is held to the largest one's scale
        scale = max(np.abs(r).max(), 1e-4 * top)
        assert np.abs(g - r).max() <= 2e-3 * scale, name
    assert nonzero >= 0.9 * len(ref)
