"""The port's nested (Matryoshka) path against the JAX package: the tiny
nested U-Nets of tests/torch_parity.py (one and two shells), the nested
sampler's per-resolution gammas, nested DDIM sampling, the low-resolution
residual, the resize behind it and the ``output_inner`` panes. f32, same
weights, same inputs and, for stochastic sampling, the JAX package's own
noise fed to the port.

Tolerances: the forward max-abs <= 5e-4 * max|ref| (as for the U-Net:
the same math in another summation order); gammas max-abs <= 1e-6 (the
same f32 operations); 3-step samples max-abs <= 1e-3 (the forward's
error carried through clipped x0 and the DDIM update); resize, residual
and panes max-abs <= 1e-5 (a few f32 roundings).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.samplers import NestedSampler as JaxNestedSampler
from ml_mdm_tpu.samplers import SamplerConfig as JaxSamplerConfig
from ml_mdm_tpu_torch.config import SamplerConfig
from ml_mdm_tpu_torch.samplers import NestedSampler
from ml_mdm_tpu_torch.utils.resize import resize_nhwc
from torch_parity import LM_LEN, rel_err, tiny_nested_pair, to_np

torch.set_num_threads(1)

KERNEL_ENV = {
    "ML_MDM_TPU_FUSED": "interpret",
    "ML_MDM_TPU_GN_KERNEL": "interpret",
    "ML_MDM_TPU_FUSED_MIN_SIDE": "8",
}

_PAIRS = {}


def _pair(depth):
    if depth not in _PAIRS:
        _PAIRS[depth] = tiny_nested_pair(depth, seed=depth)
    return _PAIRS[depth]


def _sides(pipe, side):
    return [int(side * s / pipe.scales[0]) for s in pipe.scales]


def _inputs(pipe, lm_dim, side, b=2, seed=0, rows=None):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, s, s, 3)).astype(np.float32) for s in _sides(pipe, side)]
    rows = rows or b
    lm = rng.standard_normal((rows, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((rows, LM_LEN), np.float32)
    mask[0, 5:] = 0
    return xs, lm, mask


def _t(a):
    return [torch.from_numpy(v) for v in a] if isinstance(a, list) else torch.from_numpy(a)


def _j(a):
    return [jnp.asarray(v) for v in a] if isinstance(a, list) else jnp.asarray(a)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("jax_kernels", [False, True])
def test_nested_unet_matches_jax(monkeypatch, depth, jax_kernels):
    if jax_kernels:
        for k, v in KERNEL_ENV.items():
            monkeypatch.setenv(k, v)
    jpipe, params, pipe, lm_dim, side = _pair(depth)
    xs, lm, mask = _inputs(pipe, lm_dim, side)
    t = np.array([3, 15], np.int32)
    ref = jpipe.model(params, _j(xs), _j(t), _j(lm), _j(mask), {})
    with torch.no_grad():
        got = pipe.model(_t(xs), _t(t).long(), _t(lm), _t(mask), {})
    assert len(got) == len(ref) == depth + 1
    for g, r, x in zip(got, ref, xs):
        assert g.shape == r.shape == x.shape
        assert np.abs(np.asarray(r)).max() > 1e-2  # the filled weights reach every output
        assert rel_err(to_np(g), r) <= 5e-4


def test_mixed_batch_pads_the_inner_rows():
    """A high-resolution batch smaller than the low-resolution one: the
    inner U-Net's extra rows get zero shell features (no residual here,
    the bare U-Net's outputs)."""
    jpipe, params, pipe, lm_dim, side = _pair(1)
    xs, lm, mask = _inputs(pipe, lm_dim, side, seed=4)
    xs[0] = xs[0][:1]
    t = np.array([3, 15], np.int32)
    ref = jpipe.vision_module.apply({"params": params}, _j(xs), _j(t), _j(lm), _j(mask), {})
    with torch.no_grad():
        got = pipe.vision_module(_t(xs), _t(t).long(), _t(lm), _t(mask), {})
    assert [tuple(g.shape) for g in got] == [x.shape for x in xs]
    for g, r in zip(got, ref):
        assert rel_err(to_np(g), r) <= 5e-4


@pytest.mark.parametrize("scales,power", [([4, 1], 1.0), ([16, 4, 1], 2.0)])
def test_nested_gammas(scales, power):
    kw = dict(schedule_type="DEEPFLOYD", num_diffusion_steps=1000,
              schedule_shifted=True, schedule_shifted_power=power)
    js, ts = JaxNestedSampler(JaxSamplerConfig(**kw)), NestedSampler(SamplerConfig(**kw))
    times = np.arange(0, 1001)
    ref = js.get_gammas(js.read_gamma(jnp.asarray(times)), scales)
    got = ts.get_gammas(ts.read_gamma(torch.from_numpy(times)), scales)
    assert len(got) == len(scales)
    for g, r, s in zip(got, ref, scales):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=0, atol=1e-6)
        if s == 1:
            np.testing.assert_array_equal(to_np(g), to_np(ts.read_gamma(torch.from_numpy(times))))
    assert float(got[0][0]) == 1.0  # gamma 1 stays 1 at every scale


def _jax_step_noise(key, n_steps, xs):
    """The per-step, per-resolution normals the JAX nested sampler draws
    from ``key`` (keys split per step, then per resolution)."""
    out = []
    for k in jax.random.split(key, n_steps):
        subs = jax.random.split(k, len(xs))
        out.append([np.array(jax.random.normal(s, x.shape, jnp.float32))
                    for s, x in zip(subs, xs)])
    return out


@pytest.mark.parametrize("depth,guidance,eta", [
    (1, 1.0, 0.0), (1, 3.0, 0.0), (1, 1.0, 1.0), (2, 1.0, 1.0),
])
def test_nested_ddim_sample_matches_jax(depth, guidance, eta):
    jpipe, params, pipe, lm_dim, side = _pair(depth)
    b = 2
    xs, lm, mask = _inputs(pipe, lm_dim, side, b=b, seed=7,
                           rows=b if guidance == 1.0 else 2 * b)
    steps = 3
    key = jax.random.PRNGKey(11)
    kw = dict(num_inference_steps=steps, resample_steps=True, ddim_eta=eta,
              guidance_scale=guidance)
    ref = jpipe.sampler.sample(jpipe.model.fn(params), _j(xs), _j(lm), _j(mask), {},
                               key, scales=jpipe.scales, **kw)
    noise = _jax_step_noise(key, steps, xs)
    got = pipe.sample(b, {"lm_outputs": _t(lm), "lm_mask": _t(mask)}, side,
                      noise=_t(xs), step_noise=lambda i, j, x: torch.from_numpy(noise[i][j]),
                      **kw)
    assert got.shape == (b, side, side, 3)
    assert float(got.abs().max()) <= 1.0
    assert 0.05 < float((got.abs() < 0.99).float().mean())
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
@pytest.mark.parametrize("size_in,size_out", [((4, 4), (16, 16)), ((8, 6), (32, 12)),
                                              ((16, 16), (8, 8))])
def test_resize_matches_jax(method, size_in, size_out):
    x = np.random.default_rng(5).standard_normal((2,) + size_in + (3,)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2,) + size_out + (3,), method=method)
    got = resize_nhwc(torch.from_numpy(x), *size_out, method)
    assert got.shape == ref.shape
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 2])
def test_low_res_residual_matches_jax(depth):
    jpipe, _, pipe, _, side = _pair(depth)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, s, s, 3)).astype(np.float32) for s in _sides(pipe, side)]
    ps = [rng.standard_normal(x.shape).astype(np.float32) for x in xs]
    times = np.array([4, 12], np.int32)
    ref = jpipe.model._low_res_residual(_j(xs), _j(ps), _j(times))
    got = pipe.model._low_res_residual(_t(xs), _t(ps), _t(times).long())
    assert len(got) == len(ref) == len(xs)
    assert not np.allclose(np.asarray(ref[0]), ps[0])  # the residual moved level 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=0, atol=1e-5)


def test_output_inner_panes_match_jax():
    jpipe, _, pipe, _, side = _pair(2)
    rng = np.random.default_rng(9)
    xs = [(rng.standard_normal((2, s, s, 3)) * 1.5).astype(np.float32)
          for s in _sides(pipe, side)]
    ref = jpipe.sampler._postprocess_nested(_j(xs), clip=True, output_inner=True)
    got = pipe.sampler._postprocess_nested(_t(xs), clip=True, output_inner=True)
    assert got.shape == ref.shape == (2, side, 3 * side, 3)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-5)
