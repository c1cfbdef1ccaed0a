"""K3's two passes (``ops/k3_passes.py``) against the JAX package on the
CPU: the plain pass A (the stats' cotangents folded into dy, and dbias) and
pass B (SiLU', the affine, dx, the activation for the weight gradient and
the (B, C) sums), composed with the data gradient's convolution and the
weight gradient as ``_AffineSiluConv3x3.backward`` composes them, held
against ``jax.vjp`` of ``ml_mdm_tpu.ops.fused_resnet.affine_silu_conv3x3_vjp``
(the Pallas kernel in interpret mode, the chain in f32 as its default
``vjp_chain_bf16_min_side`` 0 has it); the sums taken over the spans of
the kernels' split plan, ragged and whole; and that plan. Inputs come from
a numpy seed.

Tolerances, each on max |port - JAX| / max |JAX|: f32 1e-5 (the same
arithmetic, sums in another order); bf16 2e-2 (dy', dx and the activation
are rounded to bf16 at the same places, but an f32 sum in another order
can flip a rounding).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.ops import fused_resnet as jfr
from ml_mdm_tpu_torch.ops import fused_resnet, k3_passes
from torch_parity import rel_err, to_np

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(dtype, stats, residual, b=2, h=7, w=9, c=16, cout=8, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, h, w, c)).astype(f)
    a = (rng.standard_normal((b, c)) * 0.2 + 1.0).astype(f)
    bb = (rng.standard_normal((b, c)) * 0.3).astype(f)
    wk = (rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c)).astype(f)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(f)
    res = rng.standard_normal((b, h, w, cout)).astype(f) if residual else None
    dy = rng.standard_normal((b, h, w, cout)).astype(f)
    ds1 = (rng.standard_normal((b, cout)) * 0.1).astype(f)
    ds2 = (rng.standard_normal((b, cout)) * 0.01).astype(f)
    jdt = jnp.dtype(dtype)
    jx = [jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(wk),
          jnp.asarray(bias)] + ([jnp.asarray(res, jdt)] if residual else [])

    def jfn(*p):
        return jfr.affine_silu_conv3x3_vjp(*p[:5], p[5] if residual else None, True, True,
                                           stats, False)

    out, pull = jax.vjp(jfn, *jx)
    jdy = jnp.asarray(dy, jdt)
    ref = pull((jdy, jnp.asarray(ds1), jnp.asarray(ds2)) if stats else jdy)
    tdt = getattr(torch, dtype)
    t = {"x": torch.from_numpy(x).to(tdt), "a": torch.from_numpy(a), "b": torch.from_numpy(bb),
         "w": torch.from_numpy(wk), "dy": torch.from_numpy(dy).to(tdt),
         "ds1": torch.from_numpy(ds1), "ds2": torch.from_numpy(ds2),
         # the forward's stored y, as JAX stashed it
         "y": torch.from_numpy(np.array(out[0] if stats else out, np.float32)).to(tdt)}
    return t, ref


def _passes(t, stats, span=None):
    """The backward's pieces in its order: pass A (with the stats), the data
    gradient's convolution, pass B, the weight gradient."""
    if stats:
        dy, dbias = k3_passes.fold_plain(t["dy"], t["y"], t["ds1"], t["ds2"], span=span)
    else:
        dy, dbias = t["dy"], t["dy"].float().sum(dim=(0, 1, 2))
    ds = fused_resnet.conv3x3_fast(dy, t["w"].flip(0, 1).transpose(2, 3), None)
    dx, s, da, db = k3_passes.chain_plain(t["x"], ds, t["a"], t["b"], span=span)
    dw = torch.nn.grad.conv2d_weight(
        s.permute(0, 3, 1, 2), (t["w"].shape[-1], t["x"].shape[-1], 3, 3),
        dy.to(t["x"].dtype).permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0).float()
    return {"x": dx, "a": da, "b": db, "w": dw, "bias": dbias, "residual": dy}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats,residual", [(False, False), (True, False), (False, True),
                                            (True, True)])
def test_passes_match_jax(dtype, stats, residual):
    t, ref = _case(dtype, stats, residual)
    got = _passes(t, stats)
    names = ["x", "a", "b", "w", "bias"] + (["residual"] if residual else [])
    for name, r in zip(names, ref):
        g = got[name]
        assert np.abs(np.asarray(r, np.float32)).max() > 0, name
        assert rel_err(to_np(g), r) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("span", [20, 63], ids=["ragged spans", "one span"])
def test_split_sums_match_jax(dtype, span):
    """The (B, C) sums of pass B and dbias of pass A taken over spans of
    ``span`` of the 63 pixels (20 + 20 + 20 + 3, or all in one), partials
    then added in span order, as the kernels split them."""
    t, ref = _case(dtype, True, True, seed=1)
    got = _passes(t, True, span=span)
    for name, r in zip(["a", "b", "bias"], [ref[1], ref[2], ref[4]]):
        assert rel_err(to_np(got[name]), r) <= TOL[dtype], name
    whole = _passes(t, True)
    for name in ("a", "b", "bias"):
        assert rel_err(to_np(got[name]), to_np(whole[name])) <= 1e-6, name


@pytest.mark.parametrize("shape,splits", [
    ((1, 37, 53, 64), 3),      # ragged H*W: the last span is partial
    ((2, 7, 9, 16), 1),        # one span
    ((16, 64, 64, 256), 8),    # train_256's 64px core: 128 KB a program
    ((2, 512, 512, 128), 128), # train_1024's packed shell: four programs an SM
])
def test_pass_plan_covers_each_pixel_once(shape, splits):
    b, h, w, c = shape
    p = k3_passes.plan(b, h, w, c, sms=132)
    assert p.splits == splits
    assert p.span % p.block_hw == 0 and p.block_hw * p.block_c <= 4096
    covered = np.zeros(h * w, dtype=np.int64)
    for s in range(p.splits):
        covered[s * p.span:min((s + 1) * p.span, h * w)] += 1
    assert (covered == 1).all()


def test_passes_take_the_plain_versions_on_the_cpu():
    t, _ = _case("float32", True, False, seed=2)
    ds = torch.randn_like(t["x"])
    assert all(torch.equal(g, r) for g, r in zip(
        k3_passes.chain(t["x"], ds, t["a"], t["b"]),
        k3_passes.chain_plain(t["x"], ds, t["a"], t["b"])))
    assert all(torch.equal(g, r) for g, r in zip(
        k3_passes.fold(t["dy"], t["y"], t["ds1"], None),
        k3_passes.fold_plain(t["dy"], t["y"], t["ds1"], None)))
    assert k3_passes.launch_counts == {"K3·A": 0, "K3·B": 0}
