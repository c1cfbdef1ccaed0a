"""The port's sampler and ``Diffusion.sample`` against the JAX sampler:
gamma tables, timestep tables, one DDPM/DDIM step for each prediction
type, and a 5-step DDIM (eta 0) sample of the tiny flagship-structured
U-Net from the same numpy noise, with and without classifier-free guidance.

Tolerances: gamma tables exact (same f32 numbers); one step <= 1e-5
max-abs; the 5-step sample max-abs <= 1e-3 (the U-Net agrees to 5e-4
relative per step, and the clipped x0 and DDIM update carry that error).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.samplers import Sampler as JaxSampler
from ml_mdm_tpu.samplers import SamplerConfig as JaxSamplerConfig
from ml_mdm_tpu_torch.config import SamplerConfig
from ml_mdm_tpu_torch.samplers import Sampler
from torch_parity import LM_LEN, tiny_pair, to_np

torch.set_num_threads(1)

SCHEDULES = [
    dict(schedule_type="DEEPFLOYD", num_diffusion_steps=1000),
    dict(schedule_type="DDPM", num_diffusion_steps=200),
    dict(schedule_type="COSINE", num_diffusion_steps=100),
    dict(schedule_type="SIGMOID", num_diffusion_steps=50, rescale_schedule=4.0),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_gamma_tables(kw):
    ref = np.asarray(JaxSampler(JaxSamplerConfig(**kw)).gammas)
    got = Sampler(SamplerConfig(**kw)).gammas.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,resample", [(50, True), (5, True), (7, False)])
def test_timestep_tables(n, resample):
    kw = dict(num_diffusion_steps=30 if not resample else 1000)
    ref = JaxSampler(JaxSamplerConfig(**kw))._timestep_table(n, resample, -1)
    got = Sampler(SamplerConfig(**kw))._timestep_table(n, resample, -1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pred", ["DDPM", "V_PREDICTION"])
@pytest.mark.parametrize("eta", [None, 0.0, 0.5])
def test_prediction_xt_last(pred, eta):
    kw = dict(schedule_type="DEEPFLOYD", num_diffusion_steps=1000,
              prediction_type=pred)
    js, ts = JaxSampler(JaxSamplerConfig(**kw)), Sampler(SamplerConfig(**kw))
    rng = np.random.default_rng(0)
    x, p, noise = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(3))
    t, t_last = np.array([600, 20]), np.array([580, 0])
    ref = js.get_prediction_xt_last(
        jnp.asarray(x), jnp.asarray(p), js.read_gamma(jnp.asarray(t)),
        js.read_gamma(jnp.asarray(t_last)), clip_fn=js.clip_sample,
        need_noise=jnp.asarray(t_last != 0), ddim_eta=eta,
        input_noise=jnp.asarray(noise))
    got = ts.get_prediction_xt_last(
        torch.from_numpy(x), torch.from_numpy(p), ts.read_gamma(torch.from_numpy(t)),
        ts.read_gamma(torch.from_numpy(t_last)), clip_fn=ts.clip_sample,
        need_noise=torch.from_numpy(t_last != 0), ddim_eta=eta,
        input_noise=torch.from_numpy(noise))
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_ddim_sample_matches_jax(pair, guidance):
    jpipe, params, pipe, lm_dim, side = pair
    rng = np.random.default_rng(7)
    b = 2
    rows = b if guidance == 1.0 else 2 * b
    noise = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    lm = rng.standard_normal((rows, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((rows, LM_LEN), np.float32)
    kw = dict(num_inference_steps=5, resample_steps=True, ddim_eta=0.0,
              guidance_scale=guidance)
    ref = jpipe.sampler.sample(jpipe.model.fn(params), jnp.asarray(noise),
                               jnp.asarray(lm), jnp.asarray(mask), {},
                               jax.random.PRNGKey(0), **kw)
    got = pipe.sample(b, {"lm_outputs": torch.from_numpy(lm),
                          "lm_mask": torch.from_numpy(mask)},
                      side, noise=torch.from_numpy(noise), **kw)
    assert got.shape == (b, side, side, 3)
    assert float(got.abs().max()) <= 1.0
    # the result is not the clipped extremes alone
    assert 0.05 < float((got.abs() < 0.99).float().mean())
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize("threshold", ["CLIP", "DYNAMIC", "DYNAMIC_IF", "NONE"])
def test_clip_sample(threshold):
    kw = dict(threshold_function=threshold)
    js, ts = JaxSampler(JaxSamplerConfig(**kw)), Sampler(SamplerConfig(**kw))
    x = (np.random.default_rng(1).standard_normal((2, 8, 8, 3)) * 2).astype(np.float32)
    ref = js.clip_sample(jnp.asarray(x), 1.0)
    got = ts.clip_sample(torch.from_numpy(x), 1.0)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-6, atol=1e-6)
