"""The port's layers against the JAX modules, with the same weights
(JAX init, zero leaves filled from a seed, ``params_from_jax``,
``load_state_dict(strict=True)``) and the same numpy inputs.

The ResNet block, which holds both kernels, is compared against JAX's
plain path and against JAX with its Pallas kernels in interpret mode.

Tolerances: f32 modules max-abs <= 1e-4 * max|ref| (same math, f32 sums
in another order; the port's ResNet takes norm2's moments from the conv
output's sums, one-pass, where JAX's plain path takes them two-pass);
GroupNorm coefficients from the same bf16 input <= 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.models import layers as jl
from ml_mdm_tpu_torch.config import ResNetConfig
from ml_mdm_tpu_torch.models import layers as tl
from ml_mdm_tpu_torch.utils.convert import params_from_jax
from torch_parity import fill_zero_leaves, rel_err, to_np

torch.set_num_threads(1)

KERNEL_ENV = {
    "ML_MDM_TPU_FUSED": "interpret",
    "ML_MDM_TPU_GN_KERNEL": "interpret",
    "ML_MDM_TPU_FUSED_MIN_SIDE": "8",
}


def _load(module, params, prefix=()):
    """Load a JAX params subtree into a port module (wrapped under
    ``prefix`` so name-dependent conversion rules apply, then stripped)."""
    tree = params
    for p in reversed(prefix):
        tree = {p: tree}
    sd = params_from_jax(tree)
    strip = "".join(f"{p.replace('_', '.')}." for p in prefix)
    module.load_state_dict({k[len(strip):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_coeffs(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 6, 32)) * 1.5 + 0.3
    scale = rng.standard_normal(32) * 0.1 + 1.0
    bias = rng.standard_normal(32) * 0.1
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ra, rb = jl.group_norm_coeffs(jnp.asarray(x, jnp.float32).astype(jdt),
                                  jnp.asarray(scale, jnp.float32),
                                  jnp.asarray(bias, jnp.float32), 8)
    xt = torch.from_numpy(x.astype(np.float32)).to(tdt)
    a, b = tl.group_norm_coeffs(xt, torch.from_numpy(scale.astype(np.float32)),
                                torch.from_numpy(bias.astype(np.float32)), 8)
    assert a.dtype == b.dtype == torch.float32
    assert rel_err(to_np(a), np.asarray(ra).reshape(2, 32)) <= 1e-4
    assert rel_err(to_np(b), np.asarray(rb).reshape(2, 32)) <= 1e-4


def test_layer_norm_and_gelu():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 2 + 1
    mod = jl.LayerNormF32()
    params = fill_zero_leaves(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ref = mod.apply({"params": params}, jnp.asarray(x))
    got = _load(tl.LayerNormF32(24), params)(torch.from_numpy(x))
    assert rel_err(to_np(got), ref) <= 1e-5
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        g = tl.gelu(torch.from_numpy(x).to(dt))
        rg = jl.gelu(jnp.asarray(x).astype(jdt))
        assert rel_err(to_np(g), np.asarray(rg.astype(jnp.float32))) <= (1e-6 if dt == torch.float32 else 1e-2)


@pytest.mark.parametrize("jax_kernels", [False, True])
@pytest.mark.parametrize("cin,skip,cout", [(16, 0, 32), (32, 0, 32), (16, 16, 32)])
def test_resnet(monkeypatch, jax_kernels, cin, skip, cout):
    if jax_kernels:
        for k, v in KERNEL_ENV.items():
            monkeypatch.setenv(k, v)
    rng = np.random.default_rng(2)
    b, side, tdim = 2, 8, 24
    cfg = dict(num_channels=cin + skip, output_channels=cout, num_groups_norm=8)
    x = rng.standard_normal((b, side, side, cin)).astype(np.float32)
    s = rng.standard_normal((b, side, side, skip)).astype(np.float32)
    temb = rng.standard_normal((b, tdim)).astype(np.float32)
    jmod = jl.ResNet(jl.ResNetConfig(**cfg))
    jx = (jnp.asarray(x), jnp.asarray(s)) if skip else jnp.asarray(x)
    xin = np.concatenate([x, s], -1) if skip else x
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(xin), jnp.asarray(temb))["params"]
    params = fill_zero_leaves(params, 3)
    ref = jmod.apply({"params": params}, jx, jnp.asarray(temb))
    port = _load(tl.ResNet(ResNetConfig(**cfg), tdim), params)
    got = port(torch.from_numpy(xin), torch.from_numpy(temb))
    assert got.shape == ref.shape
    assert rel_err(to_np(got), ref) <= 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_with_cross_attention(masked):
    rng = np.random.default_rng(4)
    b, side, c, cond_dim, lk = 2, 4, 64, 24, 6
    x = rng.standard_normal((b, side, side, c)).astype(np.float32)
    cond = rng.standard_normal((b, lk, cond_dim)).astype(np.float32)
    mask = np.ones((b, lk), np.float32)
    if masked:
        mask[0, 4:] = 0
        mask[1, 2:] = 0
    jmod = jl.SelfAttention(c, cond_dim=cond_dim, use_attention_ffn=True)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cond),
                       jnp.asarray(mask))["params"]
    params = fill_zero_leaves(params, 5)
    jm = jnp.asarray(mask) if masked else None
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond), jm)
    port = _load(tl.SelfAttention(c, cond_dim=cond_dim, use_attention_ffn=True),
                 params, prefix=("attn_0",))
    got = port(torch.from_numpy(x), torch.from_numpy(cond),
               torch.from_numpy(mask) if masked else None)
    assert rel_err(to_np(got), ref) <= 1e-4


def test_nearest_upsample():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    ref = jl.nearest_upsample_2x(jnp.asarray(x))
    got = tl.nearest_upsample_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
