"""The port's remaining sampling entry points against the JAX package, on
the tiny single-resolution U-Net and the tiny nested U-Net of
tests/torch_parity.py (f32, the same weights): ``sample_stream`` (the web
demo's previews), ``sample_chunked``, ``return_sequence`` and
``partial_diffusion`` (img2img). The JAX package's noise is fed to the port
through ``step_noise``: its stream splits its key once a step, its
``sample`` splits it once for all steps (and the nested step once more per
resolution).

Tolerances: every frame of the stream, the trajectories and img2img
max-abs <= SAMPLE_TOL = 1e-4 against JAX (the U-Net's f32 error carried
through a few steps; measured 1.7e-6 to 1.0e-5 here, the most with guidance
3, which scales the difference of two predictions; tests/test_torch_sampler.py
allows 1e-3 for its 5-step sample); the stream's last frame,
``sample_chunked`` and the trajectory's last frame bitwise equal to the
port's own ``sample``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import LM_LEN, tiny_nested_pair, tiny_pair, to_np

torch.set_num_threads(1)

SAMPLE_TOL = 1e-4  # see the docstring
STEPS = 3

_PAIRS = {}


def _pair(nested: bool):
    if nested not in _PAIRS:
        _PAIRS[nested] = (tiny_nested_pair(1, seed=5, fast_init=True) if nested
                          else tiny_pair(seed=4, fast_init=True))
    return _PAIRS[nested]


def _inputs(pipe, lm_dim, side, nested: bool, guidance: float, b: int = 2):
    rng = np.random.default_rng(9)
    sides = [side * s // pipe.scales[0] for s in pipe.scales] if nested else [side]
    xs = [rng.standard_normal((b, s, s, 3)).astype(np.float32) for s in sides]
    rows = b if guidance == 1.0 else 2 * b
    lm = rng.standard_normal((rows, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((rows, LM_LEN), np.float32)
    mask[0, 5:] = 0
    return xs if nested else xs[0], lm, mask


def _t(a):
    return [torch.from_numpy(v) for v in a] if isinstance(a, list) else torch.from_numpy(a)


def _j(a):
    return [jnp.asarray(v) for v in a] if isinstance(a, list) else jnp.asarray(a)


def _normals(key, x, nested: bool):
    """The normals the JAX step draws from ``key`` (per resolution when
    nested)."""
    if not nested:
        return [np.array(jax.random.normal(key, x.shape, jnp.float32))]
    return [np.array(jax.random.normal(k, xi.shape, jnp.float32))
            for k, xi in zip(jax.random.split(key, len(x)), x)]


def _stream_noise(key, n, x, nested):
    """The per-step noise of the JAX ``sample_stream``: one split a step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_normals(sub, x, nested))
    return out


def _sample_noise(key, n, x, nested):
    """The per-step noise of the JAX ``sample``: the key split n ways."""
    return [_normals(k, x, nested) for k in jax.random.split(key, n)]


def _feed(noise):
    return lambda i, j, x: torch.from_numpy(noise[i][j])


def _kw(nested, pipe, **kw):
    kw = dict(num_inference_steps=STEPS, resample_steps=True, **kw)
    return dict(kw, scales=pipe.scales) if nested else kw


def _max_abs(got, ref) -> float:
    return float(np.max(np.abs(to_np(got) - np.asarray(ref))))


@pytest.mark.parametrize("nested,guidance,eta", [
    (False, 1.0, 1.0), (False, 3.0, 0.0), (True, 1.0, 1.0), (True, 3.0, 0.0)])
def test_sample_stream_matches_jax(nested, guidance, eta):
    jpipe, params, pipe, lm_dim, side = _pair(nested)
    x, lm, mask = _inputs(pipe, lm_dim, side, nested, guidance)
    key = jax.random.PRNGKey(13)
    kw = dict(ddim_eta=eta, guidance_scale=guidance)
    ref = list(jpipe.sampler.sample_stream(jpipe.model.fn(params), _j(x), _j(lm), _j(mask), {},
                                           key, **_kw(nested, jpipe, **kw)))
    noise = _stream_noise(key, STEPS, x, nested)
    sample = {"lm_outputs": _t(lm), "lm_mask": _t(mask)}
    got = list(pipe.sample_stream(2, sample, side, noise=_t(x), step_noise=_feed(noise), **kw,
                                  num_inference_steps=STEPS, resample_steps=True))
    assert len(got) == len(ref) == STEPS
    for i, ((gx0, gxt, (g, gl)), (rx0, rxt, (rg, rgl))) in enumerate(zip(got, ref)):
        assert gx0.shape == rx0.shape and gxt.shape == rxt.shape
        assert _max_abs(gx0, rx0) <= SAMPLE_TOL and _max_abs(gxt, rxt) <= SAMPLE_TOL, i
        assert (float(g), float(gl)) == (float(rg), float(rgl))
    # only the last x_t is clipped
    assert float(got[0][1].abs().max()) > 1.0 and float(got[-1][1].abs().max()) <= 1.0
    final = pipe.sample(2, sample, side, noise=_t(x), step_noise=_feed(noise), **kw,
                        num_inference_steps=STEPS, resample_steps=True)
    assert torch.equal(got[-1][1], final)


@pytest.mark.parametrize("nested", [False, True])
def test_sample_chunked_is_sample(nested):
    _, _, pipe, lm_dim, side = _pair(nested)
    x, lm, mask = _inputs(pipe, lm_dim, side, nested, 1.0)
    sample = {"lm_outputs": _t(lm), "lm_mask": _t(mask)}
    kw = dict(num_inference_steps=5, resample_steps=True, ddim_eta=1.0)
    outs = []
    for entry, extra in ((pipe.sample, {}), (pipe.sample_chunked, {"chunk_steps": 2})):
        gen = torch.Generator().manual_seed(3)
        outs.append(entry(2, sample, side, gen, noise=_t(x), **kw, **extra))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("nested", [False, True])
def test_return_sequence_matches_jax(nested):
    """The trajectory of every step (DDPM steps, eta None, with the JAX
    noise): the single pipeline's rescaled, the nested one's as carried;
    the last frame clipped is the final image."""
    jpipe, params, pipe, lm_dim, side = _pair(nested)
    x, lm, mask = _inputs(pipe, lm_dim, side, nested, 1.0)
    key = jax.random.PRNGKey(21)
    ref_out, ref_seq = jpipe.sampler.sample(jpipe.model.fn(params), _j(x), _j(lm), _j(mask), {},
                                            key, **_kw(nested, jpipe, return_sequence=True))
    noise = _sample_noise(key, STEPS, x, nested)
    out, seq = pipe.sample(2, {"lm_outputs": _t(lm), "lm_mask": _t(mask)}, side, noise=_t(x),
                           step_noise=_feed(noise), num_inference_steps=STEPS,
                           resample_steps=True, return_sequence=True)
    assert seq.shape == ref_seq.shape == (STEPS,) + tuple(out.shape)
    assert _max_abs(seq, ref_seq) <= SAMPLE_TOL
    assert _max_abs(out, ref_out) <= SAMPLE_TOL
    assert torch.equal(torch.clamp(seq[-1], -1, 1), out)


@pytest.mark.parametrize("t_start,eta", [(400, None), (700, 0.0)])
def test_partial_diffusion_matches_jax(t_start, eta):
    """img2img (``tests/test_pipeline_features.py``'s case): a ramp image
    noised to t_start and denoised from there."""
    jpipe, params, pipe, lm_dim, side = _pair(False)
    _, lm, mask = _inputs(pipe, lm_dim, side, False, 1.0)
    src = np.tile(np.linspace(-0.5, 0.5, side, dtype=np.float32)[None, :, None, None],
                  (2, 1, side, 3))
    key = jax.random.PRNGKey(2)
    kw = dict(num_inference_steps=5, resample_steps=True, ddim_eta=eta)
    ref = jpipe.partial_diffusion(params, jnp.asarray(src), t_start,
                                  {"lm_outputs": _j(lm), "lm_mask": _j(mask)}, key, **kw)
    k_eps, k_loop = jax.random.split(key)
    eps = np.array(jax.random.normal(k_eps, src.shape, jnp.float32))
    n = len(pipe.sampler._timestep_table(5, True, t_start)) - 1
    noise = _sample_noise(k_loop, n, src, False)
    got = pipe.partial_diffusion(torch.from_numpy(src), t_start,
                                 {"lm_outputs": _t(lm), "lm_mask": _t(mask)},
                                 eps=torch.from_numpy(eps), step_noise=_feed(noise), **kw)
    assert got.shape == src.shape and bool(torch.isfinite(got).all())
    assert _max_abs(got, ref) <= SAMPLE_TOL
