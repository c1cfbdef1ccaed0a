"""The port's whole U-Net against the JAX U-Net, tiny flagship structure
(channels 32/64/96, side 16, attention with text cross-attention at levels
1 and 2, micro-conditioning), f32, same weights and inputs.

Tolerance: max-abs <= 5e-4 * max|ref|: the same math through ~20 layers,
with f32 sums in another order, and the port's ResNets taking norm2's
moments one-pass from the conv output's sums.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import LM_LEN, rel_err, tiny_pair, to_np

torch.set_num_threads(1)

KERNEL_ENV = {
    "ML_MDM_TPU_FUSED": "interpret",
    "ML_MDM_TPU_GN_KERNEL": "interpret",
    "ML_MDM_TPU_FUSED_MIN_SIDE": "8",
}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0)


def _inputs(lm_dim, side, b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    t = np.array([17, 803][:b], np.int32)
    lm = rng.standard_normal((b, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((b, LM_LEN), np.float32)
    mask[0, 5:] = 0  # the pooled text embedding is a masked mean
    return x, t, lm, mask


def _port(pipe, x, t, lm, mask):
    with torch.no_grad():
        return pipe.model(torch.from_numpy(x), torch.from_numpy(t).long(),
                          torch.from_numpy(lm), torch.from_numpy(mask), {})


@pytest.mark.parametrize("jax_kernels", [False, True])
def test_unet_matches_jax(pair, monkeypatch, jax_kernels):
    if jax_kernels:
        for k, v in KERNEL_ENV.items():
            monkeypatch.setenv(k, v)
    jpipe, params, pipe, lm_dim, side = pair
    x, t, lm, mask = _inputs(lm_dim, side)
    ref = jpipe.model(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(lm),
                      jnp.asarray(mask), {})
    got = _port(pipe, x, t, lm, mask)
    assert got.shape == ref.shape == (2, side, side, 3)
    assert np.abs(np.asarray(ref)).max() > 1e-2  # the filled weights reach the output
    assert rel_err(to_np(got), ref) <= 5e-4


def test_unet_micro_conditioning_is_used(pair):
    jpipe, params, pipe, lm_dim, side = pair
    x, t, lm, mask = _inputs(lm_dim, side, seed=1)
    scale = np.array([4.0, 16.0], np.float32)
    ref = jpipe.model(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(lm),
                      jnp.asarray(mask), {"scale": jnp.asarray(scale)})
    with torch.no_grad():
        got = pipe.model(torch.from_numpy(x), torch.from_numpy(t).long(),
                         torch.from_numpy(lm), torch.from_numpy(mask),
                         {"scale": torch.from_numpy(scale)})
    assert rel_err(to_np(got), ref) <= 5e-4
    default = _port(pipe, x, t, lm, mask)
    assert not torch.allclose(got[0], default[0])
