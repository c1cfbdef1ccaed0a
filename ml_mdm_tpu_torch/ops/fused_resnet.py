"""Fused affine + SiLU + 3x3 convolution (kernel K2, with its modes K2·N
and K2·proj).

``affine_silu_conv3x3`` replaces ``ml_mdm_tpu/ops/fused_resnet.py``
``affine_silu_conv3x3`` (the Pallas ``_kernel``):

    y = conv3x3(silu(x * a + b), w, padding 1) + bias [+ residual]

over NHWC, with per-(batch, channel) f32 coefficients a, b (GroupNorm with
FiLM folded in). As in the JAX package, x, a, b and w may each be a tuple
of N operands (K2·N): the op then convolves the channel concatenation
``concat_k(silu(x_k * a_k + b_k))`` without building it. With
``proj_kernel`` (one (C_k, Cout) matrix per operand) and ``proj_bias`` it
also returns the ResNet's 1x1 shortcut ``concat_k(x_k) @ P + pb`` of the
RAW operands (K2·proj). With ``emit_stats`` it returns the f32 sum and sum
of squares of the stored y per (batch, output channel), for the next
GroupNorm. Outputs come in the JAX order: y, then (s1, s2), then proj.

The CUDA kernel is ``csrc/fused_resnet.cu`` (its header says what bounds
it on the H100 and how it is laid out). It is built with ``nvcc`` for
``sm_90a`` at first use into ``ml_mdm_tpu_torch/_build/`` and loaded with
ctypes. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

``affine_silu_conv3x3_vjp`` (kernel K3, replacing the JAX package's
``custom_vjp`` of the same name) is the differentiable single-operand
form for training. Its forward is K2. Its backward follows the JAX
``_vjp_bwd``: the data gradient is again a 3x3 stride-1 convolution, of
dy with the flipped, io-transposed weights, and runs through K2; the
derivative chain (SiLU', the affine, the (B, C) reductions) is f32 plain
PyTorch, and the weight gradient is the library's conv weight-gradient,
as the JAX package leaves both to XLA. It stashes only x, a, b, w and,
with ``emit_stats``, y: the SiLU input is recomputed from x. The backward
and its two convolutions are named profiler ranges ("K3 backward", "K3 dx
(K2)", "K3 dw (library)"), so a trace can split the backward's device
time; a range costs a few microseconds of host time with the profiler
off.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ml_mdm_tpu_torch.ops import cuda_build

# launches of the CUDA kernel since the counts were last set to 0: "K2"
# counts every launch, "K2·N" those with more than one operand, "K2·proj"
# those that also emit the shortcut and "K3" those of K3's backward (the
# data gradient)
launch_counts = {"K2": 0, "K2·N": 0, "K2·proj": 0, "K3": 0}
MAX_OPERANDS = 4


def reset_launch_counts() -> None:
    for mode in launch_counts:
        launch_counts[mode] = 0


def _as_tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def affine_silu_conv3x3_plain(x, a, b, w, bias, residual=None, *,
                              apply_silu: bool = True,
                              emit_stats: bool = False,
                              proj_kernel=None, proj_bias=None):
    """Plain PyTorch version (``reference_affine_silu_conv3x3`` of the JAX
    package, plus the stats and shortcut outputs). x: (B, H, W, C) or a
    tuple of (B, H, W, C_k); a, b: (B, C) or tuples of (B, C_k); w:
    (3, 3, C, Cout) HWIO or a tuple of (3, 3, C_k, Cout); bias: (Cout,) or
    None; residual: (B, H, W, Cout); proj_kernel: (C, Cout2) or a tuple of
    (C_k, Cout2); proj_bias: (Cout2,) or None.

    The activation is rounded to x's dtype, the weights are cast to it,
    products accumulate in f32 and bias and residual are added in f32
    before one rounding to x's dtype. The stats square the stored output
    in f32. The shortcut multiplies the raw operands and P, both in x's
    dtype, in f32, adds pb in f32 and rounds once."""
    xs, a_s, b_s, ws = (_as_tuple(v) for v in (x, a, b, w))
    dt = xs[0].dtype
    acts = []
    for xk, ak, bk in zip(xs, a_s, b_s):
        v = xk.float() * ak.float()[:, None, None, :] + bk.float()[:, None, None, :]
        if apply_silu:
            v = F.silu(v)
        acts.append(v.to(dt))
    v = torch.cat(acts, dim=-1).float()
    wk = torch.cat([wi.to(dt) for wi in ws], dim=2).float().permute(3, 2, 0, 1)
    y = F.conv2d(v.permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    y = y.to(dt)
    outs = [y]
    if emit_stats:
        yf = y.float()
        outs += [yf.sum(dim=(1, 2)), yf.square().sum(dim=(1, 2))]
    if proj_kernel is not None:
        raw = torch.cat([xk.to(dt) for xk in xs], dim=-1).float()
        pk = torch.cat([p.to(dt) for p in _as_tuple(proj_kernel)], dim=0).float()
        p = raw @ pk
        if proj_bias is not None:
            p = p + proj_bias.float()
        outs.append(p.to(dt))
    return outs[0] if len(outs) == 1 else tuple(outs)


def affine_silu_conv3x3(x, a, b, w, bias, residual=None, *,
                        apply_silu: bool = True, emit_stats: bool = False,
                        proj_kernel=None, proj_bias=None):
    """Same contract as ``affine_silu_conv3x3_plain``. Returns y, or the
    tuple of y, (s1, s2) with ``emit_stats`` and proj with
    ``proj_kernel``."""
    if _as_tuple(x)[0].device.type == "cpu":
        return affine_silu_conv3x3_plain(
            x, a, b, w, bias, residual, apply_silu=apply_silu,
            emit_stats=emit_stats, proj_kernel=proj_kernel, proj_bias=proj_bias,
        )
    return _launch(x, a, b, w, bias, residual, apply_silu, emit_stats,
                   proj_kernel, proj_bias)


def conv3x3_fast(x, w, bias, residual=None):
    """3x3 stride-1 convolution with padding 1 (no affine, no SiLU)
    through the same kernel (``conv3x3_fast`` of the JAX package)."""
    bsz, c = x.shape[0], x.shape[-1]
    ones = torch.ones((bsz, c), device=x.device, dtype=torch.float32)
    zeros = torch.zeros_like(ones)
    if bias is None:
        bias = torch.zeros((w.shape[-1],), device=x.device, dtype=torch.float32)
    return affine_silu_conv3x3(x, ones, zeros, w, bias, residual,
                               apply_silu=False)


class _AffineSiluConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w, bias, residual, emit_stats):
        out = affine_silu_conv3x3(x, a, b, w, bias, residual, emit_stats=emit_stats)
        ctx.set_materialize_grads(False)
        ctx.emit_stats = emit_stats
        ctx.has_bias, ctx.has_res = bias is not None, residual is not None
        # y, for the stats' cotangent, is the next layer's input anyway
        ctx.save_for_backward(x, a, b, w, out[0] if emit_stats else None)
        return out

    @staticmethod
    def backward(ctx, dy, ds1=None, ds2=None):
        with record_function("K3 backward"):
            x, a, b, w, y = ctx.saved_tensors
            cout = w.shape[-1]
            if dy is None:
                dy = x.new_zeros(x.shape[:3] + (cout,))
            if ds1 is not None or ds2 is not None:
                d = dy.float()
                if ds1 is not None:
                    d = d + ds1[:, None, None, :]
                if ds2 is not None:
                    d = d + 2.0 * y.float() * ds2[:, None, None, :]
                dy = d.to(dy.dtype)
            a_c, b_c = a.float()[:, None, None, :], b.float()[:, None, None, :]
            v = x.float() * a_c + b_c
            sig = torch.sigmoid(v)
            s_store = v * sig
            dact = sig * (1.0 + v * (1.0 - sig))
            # data gradient: the 3x3 conv of dy with the flipped, io-transposed
            # weights, through K2 (the plain version for a CPU tensor)
            with record_function("K3 dx (K2)"):
                ds = conv3x3_fast(dy, w.flip(0, 1).transpose(2, 3), None)
                if dy.is_cuda:
                    launch_counts["K3"] += 1
            dv = ds.float() * dact
            dx = (dv * a_c).to(x.dtype)
            da = (dv * x.float()).sum(dim=(1, 2)).to(a.dtype)
            db = dv.sum(dim=(1, 2)).to(b.dtype)
            dbias = dy.float().sum(dim=(0, 1, 2)) if ctx.has_bias else None
            # weight gradient: the library's conv weight-gradient of the stored
            # activation against dy, in x's dtype (f32 accumulation inside)
            with record_function("K3 dw (library)"):
                dw = torch.nn.grad.conv2d_weight(
                    s_store.to(x.dtype).permute(0, 3, 1, 2), (cout, x.shape[-1], 3, 3),
                    dy.to(x.dtype).permute(0, 3, 1, 2), padding=1,
                ).permute(2, 3, 1, 0).to(w.dtype)
            dres = dy if ctx.has_res else None
            return dx, da, db, dw, dbias, dres, None


def affine_silu_conv3x3_vjp(x, a, b, w, bias, residual=None, *,
                            emit_stats: bool = False):
    """Differentiable ``affine_silu_conv3x3`` of one operand, always with
    the SiLU (kernel K3): the same forward and outputs, with the backward
    above. On a CUDA tensor both directions launch K2 or raise; K2 takes
    bf16 only."""
    return _AffineSiluConv3x3.apply(x, a, b, w, bias, residual, emit_stats)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, at a 16-byte aligned address (the kernel loads 8 bf16
    at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, a, b, w, bias, residual, apply_silu, emit_stats,
            proj_kernel, proj_bias):
    xs, a_s, b_s, ws = (_as_tuple(v) for v in (x, a, b, w))
    x0 = xs[0]
    if not x0.is_cuda:
        raise RuntimeError(f"affine_silu_conv3x3: no kernel for device {x0.device}")
    n = len(xs)
    if not 1 <= n <= MAX_OPERANDS or not len(a_s) == len(b_s) == len(ws) == n:
        raise ValueError(
            f"affine_silu_conv3x3: {n} operands with {len(a_s)}/{len(b_s)}/"
            f"{len(ws)} a/b/w; the kernel takes 1 to {MAX_OPERANDS}"
        )
    lib = load_library()
    if x0.dim() != 4:
        raise ValueError(f"affine_silu_conv3x3: expected (B, H, W, C), got {tuple(x0.shape)}")
    bsz, h, wd = x0.shape[:3]
    cout = ws[0].shape[-1]
    cs = []
    for xk, wk in zip(xs, ws):
        if xk.dtype != torch.bfloat16:
            raise TypeError(f"affine_silu_conv3x3: the CUDA kernel takes bf16, got {xk.dtype}")
        if xk.device != x0.device or xk.shape[:3] != (bsz, h, wd):
            raise ValueError("affine_silu_conv3x3: operands differ in device or (B, H, W)")
        c = xk.shape[3]
        if tuple(wk.shape) != (3, 3, c, cout):
            raise ValueError(f"affine_silu_conv3x3: weight {tuple(wk.shape)} for C={c}, Cout={cout}")
        if c % 8 or cout % 8:
            raise ValueError(
                f"affine_silu_conv3x3: C={c} and Cout={cout} must be multiples of 8"
            )
        cs.append(c)
    ctot = sum(cs)
    dev = x0.device
    xs = [_aligned(xk) for xk in xs]
    a = torch.cat([ak.to(dev, torch.float32).reshape(bsz, c)
                   for ak, c in zip(a_s, cs)], dim=1).contiguous()
    b = torch.cat([bk.to(dev, torch.float32).reshape(bsz, c)
                   for bk, c in zip(b_s, cs)], dim=1).contiguous()
    # (3, 3, C, Cout) per operand -> (Cout, 9, sum C): each output channel's
    # taps x channels of the concatenation
    wt = torch.cat([wk.to(dev, torch.bfloat16) for wk in ws], dim=2)
    wt = wt.permute(3, 0, 1, 2).reshape(cout, 9 * ctot).contiguous()
    if bias is None:
        bias = torch.zeros((cout,), device=dev)
    bias = bias.to(dev, torch.float32).contiguous()
    if residual is not None:
        if residual.shape != (bsz, h, wd, cout) or residual.dtype != x0.dtype:
            raise ValueError("affine_silu_conv3x3: residual must match y")
        residual = _aligned(residual)
    y = torch.empty((bsz, h, wd, cout), device=dev, dtype=x0.dtype)
    s1 = s2 = pw = pb = proj = None
    if emit_stats:
        s1 = torch.zeros((bsz, cout), device=dev, dtype=torch.float32)
        s2 = torch.zeros_like(s1)
    if proj_kernel is not None:
        pks = _as_tuple(proj_kernel)
        if len(pks) != n or any(tuple(p.shape) != (c, cout) for p, c in zip(pks, cs)):
            raise ValueError(
                f"affine_silu_conv3x3: the kernel's shortcut takes one (C_k, {cout}) "
                f"matrix per operand, got {[tuple(p.shape) for p in pks]}"
            )
        pw = torch.cat([p.to(dev, torch.bfloat16) for p in pks], dim=0).t().contiguous()
        pb = (torch.zeros((cout,), device=dev) if proj_bias is None
              else proj_bias.to(dev, torch.float32).contiguous())
        proj = torch.empty_like(y)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    x_ptrs = (ctypes.c_void_p * n)(*[xk.data_ptr() for xk in xs])
    c_arr = (ctypes.c_int * n)(*cs)
    with torch.cuda.device(dev):  # the C side launches on the current device
        err = lib.ml_mdm_affine_silu_conv3x3(
            x_ptrs, c_arr, n, ptr(a), ptr(b), ptr(wt), ptr(bias), ptr(residual),
            ptr(pw), ptr(pb), ptr(y), ptr(proj), ptr(s1), ptr(s2),
            bsz, h, wd, cout, int(apply_silu),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(
            f"affine_silu_conv3x3: CUDA error {err} at launch "
            f"(operands {[tuple(xk.shape) for xk in xs]}, Cout {cout})"
        )
    launch_counts["K2"] += 1
    if n > 1:
        launch_counts["K2·N"] += 1
    if proj is not None:
        launch_counts["K2·proj"] += 1
    outs = [y]
    if emit_stats:
        outs += [s1, s2]
    if proj is not None:
        outs.append(proj)
    return outs[0] if len(outs) == 1 else tuple(outs)


def build_library() -> Path:
    """Compile ``csrc/fused_resnet.cu`` for sm_90a (``ops/cuda_build.py``).
    Returns the shared library's path; ``<path>.log`` keeps nvcc's output."""
    return cuda_build.build_library("fused_resnet")


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ml_mdm_affine_silu_conv3x3
    fn.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib
