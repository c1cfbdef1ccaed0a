"""The port's ops against the JAX ops: spatial sums (K1) and the fused
affine + SiLU + 3x3 conv (K2, with its operand tuples K2·N and shortcut
K2·proj) against the Pallas kernels in interpret mode, the concatenated
GroupNorm coefficients against ``group_norm_coeffs_concat``, and the plain
attention against ``_einsum_attention``. On the CPU the port
runs each kernel's plain version; tests/test_torch_cuda.py holds each kernel
to its plain version on the card.

Tolerances: f32 comparisons max-abs <= 1e-4 * max|ref| (f32 sums taken in
another order); bf16 comparisons <= 2e-2 * max|ref| (two bf16 ULPs: the
frameworks round activations, weights and outputs to bf16 at the same
points, but an f32 difference in a sum can flip one rounding).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_mdm_tpu.models.layers import group_norm_coeffs_concat as jax_gn_concat
from ml_mdm_tpu.ops.attention import _einsum_attention
from ml_mdm_tpu.ops.fused_resnet import affine_silu_conv3x3 as jax_fused
from ml_mdm_tpu.ops.gn_stats import spatial_sums as jax_spatial_sums
from ml_mdm_tpu_torch.models.layers import group_norm_coeffs_concat
from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats
from torch_parity import rel_err, to_np

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    j = jnp.asarray(arr, jnp.float32).astype(JDT[dtype])
    return j, torch.from_numpy(np.asarray(arr, np.float32)).to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_sums_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 16, 12, 8)) * 2 + 0.5, dtype)
    r1, r2 = jax_spatial_sums(xj, True)
    s1, s2 = gn_stats.spatial_sums(xt)
    assert s1.dtype == s2.dtype == torch.float32
    assert rel_err(to_np(s1), r1) <= 1e-5
    assert rel_err(to_np(s2), r2) <= 1e-5


def _conv_inputs(rng, c, cout, dtype, residual):
    b, h, w = 2, 8, 8
    x = rng.standard_normal((b, h, w, c)) * 0.7
    a = rng.standard_normal((b, c)) * 0.2 + 1.0
    bb = rng.standard_normal((b, c)) * 0.3
    wk = rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c)
    bias = rng.standard_normal((cout,)) * 0.1
    res = rng.standard_normal((b, h, w, cout)) if residual else None
    xj, xt = _pair(x, dtype)
    rj, rt = _pair(res, dtype) if residual else (None, None)
    f32 = lambda v: (jnp.asarray(v, jnp.float32),  # noqa: E731
                     torch.from_numpy(np.asarray(v, np.float32)))
    (aj, at), (bj, bt), (biasj, biast) = f32(a), f32(bb), f32(bias)
    wj, wt = f32(wk)
    return (xj, aj, bj, wj, biasj, rj), (xt, at, bt, wt, biast, rt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("apply_silu", [True, False])
def test_affine_silu_conv3x3_matches_pallas(dtype, residual, apply_silu):
    rng = np.random.default_rng(1)
    jargs, targs = _conv_inputs(rng, 16, 8, dtype, residual)
    ry, r1, r2 = jax_fused(*jargs, apply_silu=apply_silu, interpret=True,
                           emit_stats=True)
    y, s1, s2 = fused_resnet.affine_silu_conv3x3(
        *targs, apply_silu=apply_silu, emit_stats=True)
    assert y.dtype == TDT[dtype] and y.shape == ry.shape
    assert rel_err(to_np(y), np.asarray(ry.astype(jnp.float32))) <= TOL[dtype]
    # the Pallas kernel squares the stored output in bf16, the port in f32
    # (trap 3 in ROADMAP.md queue 3): under bf16 the s2 gap is that rounding
    assert rel_err(to_np(s1), r1) <= TOL[dtype]
    assert rel_err(to_np(s2), r2) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cs,proj", [((16, 8), True), ((16, 8), False), ((24,), True),
                                     ((8, 16, 8), True)])
def test_affine_silu_conv3x3_operands_match_pallas(dtype, cs, proj):
    """K2·N (a tuple of operands, the skip concat) and K2·proj (the 1x1
    shortcut of the raw operands as a second output), with the stats."""
    rng = np.random.default_rng(4)
    b, h, w, cout = 2, 8, 8, 16
    ctot = sum(cs)
    f32 = lambda v: (jnp.asarray(v, jnp.float32),  # noqa: E731
                     torch.from_numpy(np.asarray(v, np.float32)))
    xs = [_pair(rng.standard_normal((b, h, w, c)) * 0.7, dtype) for c in cs]
    a_s = [f32(rng.standard_normal((b, c)) * 0.2 + 1.0) for c in cs]
    b_s = [f32(rng.standard_normal((b, c)) * 0.3) for c in cs]
    ws = [f32(rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * ctot)) for c in cs]
    bias = f32(rng.standard_normal((cout,)) * 0.1)
    kw_j, kw_t = {}, {}
    if proj:
        pks = [f32(rng.standard_normal((c, cout)) / np.sqrt(ctot)) for c in cs]
        pb = f32(rng.standard_normal((cout,)) * 0.1)
        kw_j = dict(proj_kernel=tuple(p[0] for p in pks), proj_bias=pb[0])
        kw_t = dict(proj_kernel=tuple(p[1] for p in pks), proj_bias=pb[1])
    pick = lambda vs, i: tuple(v[i] for v in vs)  # noqa: E731
    ref = jax_fused(pick(xs, 0), pick(a_s, 0), pick(b_s, 0), pick(ws, 0), bias[0],
                    interpret=True, emit_stats=True, **kw_j)
    got = fused_resnet.affine_silu_conv3x3(pick(xs, 1), pick(a_s, 1), pick(b_s, 1),
                                           pick(ws, 1), bias[1], emit_stats=True, **kw_t)
    assert len(got) == len(ref) == 3 + proj
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel_err(to_np(g), np.asarray(r.astype(jnp.float32))) <= TOL[dtype]
    assert got[0].dtype == TDT[dtype] and (not proj or got[3].dtype == TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_coeffs_concat_matches_jax(dtype):
    rng = np.random.default_rng(6)
    cs, g = (24, 8, 32), 8
    xs = [_pair(rng.standard_normal((2, 6, 10, c)) * (1 + i) + 0.3 * i, dtype)
          for i, c in enumerate(cs)]
    scale = rng.standard_normal(sum(cs)).astype(np.float32) * 0.2 + 1.0
    bias = rng.standard_normal(sum(cs)).astype(np.float32) * 0.1
    ra, rb = jax_gn_concat(tuple(x[0] for x in xs), jnp.asarray(scale), jnp.asarray(bias), g)
    ga, gb = group_norm_coeffs_concat(tuple(x[1] for x in xs), torch.from_numpy(scale),
                                      torch.from_numpy(bias), g)
    assert ga.shape == gb.shape == (2, sum(cs)) and ga.dtype == torch.float32
    for got, ref in ((ga, ra), (gb, rb)):
        ref = np.asarray(ref, np.float32).reshape(2, -1)
        assert rel_err(to_np(got), ref) <= 1e-5


def test_conv3x3_fast_is_a_plain_conv():
    rng = np.random.default_rng(2)
    _, (x, _, _, w, bias, res) = _conv_inputs(rng, 8, 16, "float32", True)
    got = fused_resnet.conv3x3_fast(x, w, bias, res)
    ref = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias, padding=1
    ).permute(0, 2, 3, 1) + res
    assert rel_err(to_np(got), to_np(ref)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_einsum(dtype, masked):
    rng = np.random.default_rng(3)
    b, lq, lk, h, d = 2, 24, 10, 2, 16
    qj, qt = _pair(rng.standard_normal((b, lq, h, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, lk, h, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, lk, h, d)), dtype)
    mj = mt = None
    if masked:
        mask = np.ones((b, lk), np.float32)
        mask[0, 6:] = 0
        mask[1, 3:] = 0
        mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
    ref = _einsum_attention(qj, kj, vj, mj)
    got = attention.dot_product_attention(qt, kt, vt, mt)
    assert got.dtype == TDT[dtype]
    assert rel_err(to_np(got), np.asarray(ref.astype(jnp.float32))) <= TOL[dtype]
