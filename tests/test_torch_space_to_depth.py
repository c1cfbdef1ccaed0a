"""The port's space-to-depth packing (``ml_mdm_tpu_torch/ops/space_to_depth.py``)
and K2's packed mode (``packed_struct``) against the JAX package, on the CPU.
Inputs come from a numpy seed. The cases mirror tests/test_space_to_depth.py.

Tolerances, each on max |port - JAX| / max |JAX|:
- the layout moves and kernel transforms: exact (copies, and sums of one
  nonzero with zeros);
- the packed convolutions, f32: 1e-5 (the same products summed in another
  order);
- K2·struct's plain version against the Pallas kernel in interpret mode
  (serial and pipelined), f32: 2e-5; bf16: 2e-2 (two bf16 ULPs: the
  activation and the output are rounded at the same places, but f32 sums in
  another order can flip a rounding);
- the struct backward (dx, da, db and the unpacked dw) against ``jax.vjp``
  of the JAX ``affine_silu_conv3x3_vjp(..., packed_struct=True)``, f32: 1e-4
  (as K3's unpacked backward in tests/test_torch_train.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.models.layers import group_norm_coeffs as jax_gn_coeffs
from ml_mdm_tpu.ops import fused_resnet as jfr
from ml_mdm_tpu.ops import space_to_depth as js2d
from ml_mdm_tpu_torch.models.layers import group_norm_coeffs
from ml_mdm_tpu_torch.ops import fused_resnet
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from torch_parity import rel_err, to_np

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(v, dtype="float32"):
    return torch.from_numpy(np.array(v)).to(getattr(torch, dtype))


def _j(v, dtype="float32"):
    return jnp.asarray(v, jnp.dtype(dtype))


def test_pack_unpack_roundtrip_and_layout():
    x = _rand(np.random.default_rng(0), 2, 8, 6, 5)
    y = s2d.space_to_depth(_t(x))
    assert tuple(y.shape) == (2, 4, 3, 20)
    np.testing.assert_array_equal(to_np(y), np.asarray(js2d.space_to_depth(_j(x))))
    np.testing.assert_array_equal(to_np(s2d.depth_to_space(y)), x)


@pytest.mark.parametrize("name,shape", [
    ("pack_conv3x3_kernel", (3, 3, 3, 8)),
    ("pack_conv1x1_kernel", (1, 1, 6, 10)),
    ("pack_strided_conv_kernel", (3, 3, 4, 6)),
    ("pack_strided_conv_kernel_p2p", (3, 3, 4, 6)),
    ("upsample_fold_kernel", (3, 3, 4, 6)),
])
def test_kernel_transforms_equal_jax(name, shape):
    k = _rand(np.random.default_rng(1), *shape)
    got = to_np(getattr(s2d, name)(_t(k)))
    ref = np.asarray(getattr(js2d, name)(_j(k)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    v = _rand(np.random.default_rng(2), shape[-1])
    np.testing.assert_array_equal(to_np(s2d.pack_channel_vector(_t(v))),
                                  np.asarray(js2d.pack_channel_vector(_j(v))))


@pytest.mark.parametrize("ksize,cin,cout", [(3, 4, 4), (3, 3, 8), (1, 6, 10)])
def test_packed_conv_equals_jax(ksize, cin, cout):
    rng = np.random.default_rng(3)
    x = s2d.space_to_depth(_t(_rand(rng, 2, 16, 16, cin)))
    w, b = _rand(rng, ksize, ksize, cin, cout, scale=0.2), _rand(rng, cout)
    got = s2d.packed_conv(x, _t(w), _t(b))
    ref = js2d.packed_conv(jnp.asarray(to_np(x)), _j(w), _j(b))
    assert rel_err(to_np(got), ref) <= 1e-5


@pytest.mark.parametrize("fn", ["packed_strided_conv", "packed_strided_conv_p2p"])
def test_packed_strided_convs_equal_jax(fn):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 16, 16, 4)
    w, b = _rand(rng, 3, 3, 4, 6, scale=0.2), _rand(rng, 6)
    got = getattr(s2d, fn)(s2d.space_to_depth(_t(x)), _t(w), _t(b))
    ref = getattr(js2d, fn)(js2d.space_to_depth(_j(x)), _j(w), _j(b))
    assert rel_err(to_np(got), ref) <= 1e-5


@pytest.mark.parametrize("in_packed,out_packed", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_packed_upsample_conv_io_forms(in_packed, out_packed):
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 8, 8, 4)
    w, b = _rand(rng, 3, 3, 4, 6, scale=0.2), _rand(rng, 6)
    xt, xj = _t(x), _j(x)
    if in_packed:
        xt, xj = s2d.space_to_depth(xt), js2d.space_to_depth(xj)
    kw = dict(in_packed=in_packed, out_packed=out_packed)
    got = s2d.packed_upsample_conv(xt, _t(w), _t(b), **kw)
    ref = js2d.packed_upsample_conv(xj, _j(w), _j(b), **kw)
    assert rel_err(to_np(got), ref) <= 1e-5
    # through K2's plain version (the sampling route) as well
    assert rel_err(to_np(s2d.packed_upsample_conv(xt, _t(w), _t(b), fast=True, **kw)), ref) <= 1e-5


def test_groupnorm_coefficients_pack_exactly():
    """GroupNorm coefficients of the packed tensor with repeated scale and
    bias are the unpacked ones, repeated (the c-major order keeps groups
    contiguous)."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 8, 8, 8, scale=3.0) + 1.0
    scale, bias = 1.0 + _rand(rng, 8, scale=0.1), _rand(rng, 8)
    a, b = group_norm_coeffs(s2d.space_to_depth(_t(x)), s2d.pack_channel_vector(_t(scale)),
                             s2d.pack_channel_vector(_t(bias)), 4)
    ja, jb = jax_gn_coeffs(_j(x), _j(scale), _j(bias), 4)
    for got, ref in ((a, ja), (b, jb)):
        ref = np.repeat(np.asarray(ref).reshape(2, 8), 4, axis=-1)
        assert rel_err(to_np(got), ref) <= 1e-5


def _struct_inputs(dtype, seed=0, b=2, side=16, cs=(8, 4), cout=8):
    """Unpacked operands (B, side, side, C_k) packed, per-operand packed
    kernels, (B, 4 C_k) coefficients, packed bias, residual and 1x1
    shortcut matrices; JAX and torch copies."""
    rng = np.random.default_rng(seed)
    h = side // 2
    xs = [np.asarray(js2d.space_to_depth(_j(_rand(rng, b, side, side, c, scale=0.5)))) for c in cs]
    ws = [np.asarray(js2d.pack_conv3x3_kernel(_j(_rand(rng, 3, 3, c, cout, scale=0.1)))) for c in cs]
    a = [_rand(rng, b, 4 * c, scale=0.2) + 1.0 for c in cs]
    bb = [_rand(rng, b, 4 * c, scale=0.1) for c in cs]
    bias, res = _rand(rng, 4 * cout, scale=0.1), _rand(rng, b, h, h, 4 * cout)
    rk, rb = [_rand(rng, 4 * c, 4 * cout, scale=0.1) for c in cs], _rand(rng, 4 * cout, scale=0.1)

    def pack(conv, f):
        return dict(x=tuple(conv(v, dtype) for v in xs), a=tuple(conv(v) for v in a),
                    b=tuple(conv(v) for v in bb), w=tuple(conv(v) for v in f(ws)),
                    bias=conv(bias), residual=conv(res, dtype),
                    proj_kernel=tuple(conv(v) for v in rk), proj_bias=conv(rb))

    return pack(_j, lambda w: w), pack(_t, lambda w: w)


def _select(kw, n, stats, residual, proj):
    out = {k: (v[:n] if isinstance(v, tuple) else v) for k, v in kw.items()}
    out["emit_stats"] = stats
    if not residual:
        out["residual"] = None
    if not proj:
        out.pop("proj_kernel")
        out.pop("proj_bias")
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,stats,residual,proj", [(1, False, False, False), (2, True, True, True),
                                                   (1, True, False, True)])
def test_struct_plain_matches_pallas_struct(dtype, n, stats, residual, proj):
    """K2·struct's plain version (both weight forms) against the JAX Pallas
    kernel in interpret mode, serial and pipelined (4 row blocks of 2)."""
    jkw, tkw = _struct_inputs(dtype)
    jkw, tkw = _select(jkw, n, stats, residual, proj), _select(tkw, n, stats, residual, proj)
    got = fused_resnet.affine_silu_conv3x3(packed_struct=True, **tkw)
    combined = dict(tkw, w=tuple(fused_resnet.struct_weights(w) for w in tkw["w"]))
    got_q = fused_resnet.affine_silu_conv3x3(packed_struct=True, **combined)
    got, got_q = (got, got_q) if isinstance(got, tuple) else ((got,), (got_q,))
    for pipelined in (False, True):
        ref = jfr.affine_silu_conv3x3(interpret=True, packed_struct=True, pipelined=pipelined,
                                      tile_h=2, **jkw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, q, r in zip(got, got_q, ref):
            assert rel_err(to_np(g), r) <= TOL[dtype]
            np.testing.assert_array_equal(to_np(g), to_np(q))


def test_struct_plain_matches_dense_packed_conv():
    """The 4 products equal a dense convolution of the activated packed
    input with the (3, 3) packed kernel, as the JAX ``packed_conv``
    computes it."""
    _, tkw = _struct_inputs("float32")
    kw = _select(tkw, 1, False, False, False)
    got = fused_resnet.affine_silu_conv3x3(packed_struct=True, **kw)
    v = torch.nn.functional.silu(kw["x"][0] * kw["a"][0][:, None, None, :]
                                 + kw["b"][0][:, None, None, :])
    pk = jnp.asarray(to_np(kw["w"][0]))
    ref = js2d.packed_conv(jnp.asarray(to_np(v)), pk, None, pk=pk) + to_np(kw["bias"])
    assert rel_err(to_np(got), ref) <= 1e-5


@pytest.mark.parametrize("cin", [3, 8])
def test_conv3x3_fast_packed_matches_jax(cin):
    """``packed_conv(fast=True)`` (the sampling input layer: 12 packed
    channels padded to a chunk of 32) against the JAX packed convolution."""
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 16, 16, cin)
    w, b = _rand(rng, 3, 3, cin, 16, scale=0.2), _rand(rng, 16)
    got = s2d.packed_conv(s2d.space_to_depth(_t(x)), _t(w), _t(b), fast=True)
    ref = js2d.packed_conv(js2d.space_to_depth(_j(x)), _j(w), _j(b))
    assert rel_err(to_np(got), ref) <= 1e-5


@pytest.mark.parametrize("stats,residual", [(True, True), (False, False)])
def test_struct_vjp_matches_jax(stats, residual):
    """K3 with ``packed_struct``: dx, da, db, the bias, the residual and the
    UNPACKED dw (the packed cotangent pulled back through
    ``pack_conv3x3_kernel``) against ``jax.vjp`` of the JAX
    ``affine_silu_conv3x3_vjp(..., packed_struct=True)`` in interpret mode."""
    rng = np.random.default_rng(8)
    b, side, c, cout = 2, 12, 8, 8
    h = side // 2
    x = np.asarray(js2d.space_to_depth(_j(_rand(rng, b, side, side, c, scale=0.5))))
    w = _rand(rng, 3, 3, c, cout, scale=0.1)
    a, bb = _rand(rng, b, 4 * c, scale=0.2) + 1.0, _rand(rng, b, 4 * c, scale=0.1)
    bias, res = _rand(rng, 4 * cout, scale=0.1), _rand(rng, b, h, h, 4 * cout)
    cots = [_rand(rng, b, h, h, 4 * cout), _rand(rng, b, 4 * cout, scale=0.1),
            _rand(rng, b, 4 * cout, scale=0.01)]
    args = [x, a, bb, w, bias] + ([res] if residual else [])

    def jfn(x, a, b, w, bias, *r):
        return jfr.affine_silu_conv3x3_vjp(x, a, b, js2d.pack_conv3x3_kernel(w), bias,
                                           r[0] if r else None, True, True, stats, True)

    _, pull = jax.vjp(jfn, *[_j(v) for v in args])
    ref = pull(tuple(_j(v) for v in cots) if stats else _j(cots[0]))
    ins = [_t(v).requires_grad_(True) for v in args]
    out = fused_resnet.affine_silu_conv3x3_vjp(
        ins[0], ins[1], ins[2], s2d.pack_conv3x3_kernel(ins[3]), ins[4],
        ins[5] if residual else None, emit_stats=stats, packed_struct=True)
    outs = out if stats else (out,)
    torch.autograd.backward(outs, [_t(v) for v in cots[:len(outs)]])
    for name, t, r in zip(["x", "a", "b", "w", "bias", "residual"], ins, ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        assert rel_err(to_np(t.grad), r) <= 1e-4, name


def test_struct_mode_refuses_what_the_kernel_does_not_take(monkeypatch):
    x = torch.zeros((1, 4, 4, 16))
    w = torch.zeros((3, 3, 16, 16))
    with pytest.raises(ValueError):  # K3 needs the (3, 3) form to flip
        fused_resnet.affine_silu_conv3x3_vjp(
            x, torch.ones(1, 16), torch.zeros(1, 16), fused_resnet.struct_weights(w), None,
            packed_struct=True)
    # K2·pipe's rule: two chunks of 32 channels, and by default 4096 blocks
    shell, core = (2, 512, 512, 128), (8, 16, 16, 768)
    assert fused_resnet.grid_blocks(*shell) == 8192 and fused_resnet.grid_blocks(*core) == 192
    assert fused_resnet.pipelines([32], *shell) is False
    assert fused_resnet.pipelines([32], *shell, pipelined=True) is False
    assert fused_resnet.pipelines([32, 32], *shell) is True
    assert fused_resnet.pipelines([64], *shell, pipelined=False) is False
    assert fused_resnet.pipelines([768], *core) is False
    assert fused_resnet.pipelines([768], *core, pipelined=True) is True
    monkeypatch.setenv("ML_MDM_TPU_FUSED_PIPELINED", "0")
    assert fused_resnet.pipelines([32, 32], *shell) is False
