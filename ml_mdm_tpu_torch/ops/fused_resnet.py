"""Fused affine + SiLU + 3x3 convolution (kernel K2, with its modes K2·N,
K2·proj, K2·struct and K2·pipe).

``affine_silu_conv3x3`` replaces ``ml_mdm_tpu/ops/fused_resnet.py``
``affine_silu_conv3x3`` (the Pallas ``_kernel`` and ``_kernel_pipelined``):

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

``packed_struct`` (K2·struct): x is space-to-depth packed
(``ops/space_to_depth.py``) and w is the packed (3, 3, 4C, 4Cout) kernel
(``pack_conv3x3_kernel``, or its flip and io-transpose) or its combined
(2, 2, 4C, 4Cout) form from ``struct_weights``. The packed kernel is 75%
structural zeros, so the 9 taps collapse to 4 products over parity-selected
neighbours (the JAX ``_struct_dots``); the result is the dense packed
convolution's. Every operand's 4C is a multiple of 32 on the card.

``pipelined`` (K2·pipe): the launch overlaps the next channel chunk's loads
with this chunk's tensor-core products. The JAX package pipelines launches
of at least 4 TPU row blocks; the port's rule is its own (``pipelines``):
by default (``None``) a launch pipelines when ``perf().fused_pipelined`` is
on (``ML_MDM_TPU_FUSED_PIPELINED``, default 1), its operands hold at least
``PIPELINE_MIN_CHUNKS`` chunks of 32 channels and its grid has at least
``PIPELINE_MIN_BLOCKS`` thread blocks; True asks for it wherever there are
that many chunks, False never. The block threshold is the one that gave the
least time summed over the 147 launch shapes of the sampling forwards and
the ``train_1024`` step, each timed pipelined and serial on an H100
(``chip_smoke.py``; PERF.md): below it the pipelined launch was
2-15% slower summed, above it 1-5% faster. An unpacked 32-channel launch
is one chunk and runs serially. The result is the serial kernel's.

The CUDA kernel is ``csrc/fused_resnet.cu`` (its header says what bounds
it on the H100 and how it is laid out). It is built with ``nvcc`` for
``sm_90a`` at first use into ``ml_mdm_tpu_torch/_build/`` and loaded with
ctypes. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

``affine_silu_conv3x3_vjp`` (kernel K3, replacing the JAX package's
``custom_vjp`` of the same name) is the differentiable single-operand
form for training. Its forward is K2. Its backward follows the JAX
``_vjp_bwd``: the data gradient is again a 3x3 stride-1 convolution, of
dy with the flipped, io-transposed weights, and runs through K2 (K2·struct
for a packed kernel, whose flip and io-transpose keep the zero pattern);
the derivative chain (SiLU', the affine, the (B, C) reductions) is f32
plain PyTorch, and the weight gradient is the library's conv
weight-gradient or, packed, ``struct_wgrad``'s four products, as the JAX
package leaves both to XLA. It stashes only x, a, b, w and, with
``emit_stats``, y: the SiLU input is recomputed from x. The backward and its
two convolutions are named profiler ranges ("K3 backward", "K3 dx (K2)",
"K3 dw (library)"), so a trace can split the backward's device time; a
range costs a few microseconds of host time with the profiler off.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ml_mdm_tpu_torch.ops import cuda_build
from ml_mdm_tpu_torch.perf import perf

# launches of the CUDA kernel since the counts were last set to 0: "K2"
# counts every launch, "K2·N" those with more than one operand, "K2·proj"
# those that also emit the shortcut, "K2·struct" the packed ones, "K2·pipe"
# the pipelined ones and "K3" those of K3's backward (the data gradient)
launch_counts = {"K2": 0, "K2·N": 0, "K2·proj": 0, "K2·struct": 0, "K2·pipe": 0, "K3": 0}
MAX_OPERANDS = 4
CHUNK = 32  # input channels per reduction chunk of the kernel
PIPELINE_MIN_CHUNKS = 2
PIPELINE_MIN_BLOCKS = 4096
BM, BN = 128, 64  # output pixels and channels of one thread block


def reset_launch_counts() -> None:
    for mode in launch_counts:
        launch_counts[mode] = 0


def _as_tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def grid_blocks(bsz: int, h: int, w: int, cout: int) -> int:
    """Thread blocks of a launch: one per tile of TH x TW output pixels
    (TW = min(W, 32), TH = BM / TW) and 64 output channels."""
    tw = min(w, 32)
    th = BM // tw
    return bsz * -(-h // th) * -(-w // tw) * -(-cout // BN)


def pipelines(cs, bsz: int, h: int, w: int, cout: int, pipelined=None) -> bool:
    """Whether a launch over operands of ``cs`` channels and a (bsz, h, w,
    cout) output runs K2·pipe: at least PIPELINE_MIN_CHUNKS chunks of 32
    channels, and ``pipelined``, or for None the ``fused_pipelined`` gate
    and at least PIPELINE_MIN_BLOCKS thread blocks."""
    if sum(-(-c // CHUNK) for c in cs) < PIPELINE_MIN_CHUNKS:
        return False
    if pipelined is not None:
        return bool(pipelined)
    return perf().fused_pipelined and grid_blocks(bsz, h, w, cout) >= PIPELINE_MIN_BLOCKS


# -- K2·struct's pieces (``_struct_weights``, ``_struct_dots``, ``_struct_wgrad``) --


def struct_weights(wp: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) packed kernel -> (2, 2, C, Cout) combined taps:
    [[centre, left + right], [up + down, the four corners]]. Exact for
    kernels from ``pack_conv3x3_kernel`` and their flip and io-transpose
    (flip and transpose first: the combined form is not closed under the
    flip)."""
    return torch.stack([
        torch.stack([wp[1, 1], wp[1, 0] + wp[1, 2]]),
        torch.stack([wp[0, 1] + wp[2, 1], wp[0, 0] + wp[0, 2] + wp[2, 0] + wp[2, 2]]),
    ])


def _struct_buffers(s: torch.Tensor):
    """The 4 parity-selected views of an activated packed tensor s (B, H, W,
    C) that the combined taps multiply, zero outside the image: the centre;
    the column select (the left neighbour for channels whose ej bit, bit 0
    of the packed channel index, is 1, else the right one); the row select
    (the pixel above for ei = bit 1 set, else below); and the row select's
    column select."""
    lane = torch.arange(s.shape[-1], device=s.device)
    ei, ej = ((lane >> 1) & 1).bool(), (lane & 1).bool()
    up = F.pad(s, (0, 0, 0, 0, 1, 0))[:, :-1]
    down = F.pad(s, (0, 0, 0, 0, 0, 1))[:, 1:]
    out = []
    for buf in (s, torch.where(ei, up, down)):
        left = F.pad(buf, (0, 0, 1, 0))[:, :, :-1]
        right = F.pad(buf, (0, 0, 0, 1))[:, :, 1:]
        out += [buf, torch.where(ej, left, right)]
    return out


def struct_wgrad(s: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The packed kernel's (3, 3, C, Cout) cotangent from 4 products (the
    JAX ``_struct_wgrad``): s (B, H, W, C) the activated input, dy (B, H, W,
    Cout). Each combined tap's cotangent is the product of its buffer with
    dy over the pixels; ``struct_weights``' transpose copies it to every
    packed tap it sums. Right on ``pack_conv3x3_kernel``'s image only: pull
    it back through that transform before comparing it with a dense
    gradient. In s's dtype (products accumulated in f32)."""
    c, cout = s.shape[-1], dy.shape[-1]
    d2 = dy.reshape(-1, cout)
    ac, ab, bc, bb = (buf.reshape(-1, c).t() @ d2 for buf in _struct_buffers(s))
    return torch.stack([torch.stack([bb, bc, bb]), torch.stack([ab, ac, ab]),
                        torch.stack([bb, bc, bb])])


def affine_silu_conv3x3_plain(x, a, b, w, bias, residual=None, *,
                              apply_silu: bool = True,
                              emit_stats: bool = False,
                              proj_kernel=None, proj_bias=None,
                              pipelined=None, packed_struct: bool = False):
    """Plain PyTorch version (``reference_affine_silu_conv3x3`` of the JAX
    package, plus the stats and shortcut outputs and the packed mode). x:
    (B, H, W, C) or a tuple of (B, H, W, C_k); a, b: (B, C) or tuples of
    (B, C_k); w: (3, 3, C, Cout) HWIO or a tuple of (3, 3, C_k, Cout) (with
    ``packed_struct`` also the combined (2, 2, C_k, Cout) form); bias:
    (Cout,) or None; residual: (B, H, W, Cout); proj_kernel: (C, Cout2) or a
    tuple of (C_k, Cout2); proj_bias: (Cout2,) or None. ``pipelined``
    changes nothing here.

    The activation is rounded to x's dtype, the weights are cast to it,
    products accumulate in f32 and bias and residual are added in f32
    before one rounding to x's dtype. With ``packed_struct`` the products
    are the 4 combined taps over ``_struct_buffers``. The stats square the
    stored output in f32. The shortcut multiplies the raw operands and P,
    both in x's dtype, in f32, adds pb in f32 and rounds once."""
    xs, a_s, b_s, ws = (_as_tuple(v) for v in (x, a, b, w))
    dt = xs[0].dtype
    acts = []
    for xk, ak, bk in zip(xs, a_s, b_s):
        v = xk.float() * ak.float()[:, None, None, :] + bk.float()[:, None, None, :]
        if apply_silu:
            v = F.silu(v)
        acts.append(v.to(dt))
    v = torch.cat(acts, dim=-1).float()
    if packed_struct:
        wq = torch.cat([(struct_weights(wi) if wi.shape[0] == 3 else wi).to(dt)
                        for wi in ws], dim=2).float()
        y = sum(buf @ wq[i // 2, i % 2] for i, buf in enumerate(_struct_buffers(v)))
    else:
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
                        proj_kernel=None, proj_bias=None,
                        pipelined=None, packed_struct: bool = False):
    """Same contract as ``affine_silu_conv3x3_plain``. Returns y, or the
    tuple of y, (s1, s2) with ``emit_stats`` and proj with
    ``proj_kernel``."""
    kw = dict(apply_silu=apply_silu, emit_stats=emit_stats, proj_kernel=proj_kernel,
              proj_bias=proj_bias, pipelined=pipelined, packed_struct=packed_struct)
    if _as_tuple(x)[0].device.type == "cpu":
        return affine_silu_conv3x3_plain(x, a, b, w, bias, residual, **kw)
    return _launch(x, a, b, w, bias, residual, **kw)


def conv3x3_fast(x, w, bias, residual=None, packed_struct: bool = False):
    """3x3 stride-1 convolution with padding 1 (no affine, no SiLU)
    through the same kernel (``conv3x3_fast`` of the JAX package). Packed,
    a channel count that is not a multiple of 32 (the packed image's 12) is
    padded with zero channels, and the kernel with zero rows: the same
    convolution in whole chunks."""
    c = x.shape[-1]
    if packed_struct and c % CHUNK:
        pad = CHUNK - c % CHUNK
        x, w, c = F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad)), c + pad
    ones = torch.ones((x.shape[0], c), device=x.device, dtype=torch.float32)
    zeros = torch.zeros_like(ones)
    if bias is None:
        bias = torch.zeros((w.shape[-1],), device=x.device, dtype=torch.float32)
    return affine_silu_conv3x3(x, ones, zeros, w, bias, residual,
                               apply_silu=False, packed_struct=packed_struct)


class _AffineSiluConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w, bias, residual, emit_stats, packed_struct):
        out = affine_silu_conv3x3(x, a, b, w, bias, residual, emit_stats=emit_stats,
                                  packed_struct=packed_struct)
        ctx.set_materialize_grads(False)
        ctx.emit_stats, ctx.packed_struct = emit_stats, packed_struct
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
                ds = conv3x3_fast(dy, w.flip(0, 1).transpose(2, 3), None,
                                  packed_struct=ctx.packed_struct)
                if dy.is_cuda:
                    launch_counts["K3"] += 1
            dv = ds.float() * dact
            dx = (dv * a_c).to(x.dtype)
            da = (dv * x.float()).sum(dim=(1, 2)).to(a.dtype)
            db = dv.sum(dim=(1, 2)).to(b.dtype)
            dbias = dy.float().sum(dim=(0, 1, 2)) if ctx.has_bias else None
            # weight gradient, in x's dtype (f32 accumulation inside): the
            # library's conv weight-gradient of the stored activation against
            # dy, or packed the 4 products of the combined taps
            with record_function("K3 dw (library)"):
                s_x, dy_x = s_store.to(x.dtype), dy.to(x.dtype)
                if ctx.packed_struct:
                    dw = struct_wgrad(s_x, dy_x).to(w.dtype)
                else:
                    dw = torch.nn.grad.conv2d_weight(
                        s_x.permute(0, 3, 1, 2), (cout, x.shape[-1], 3, 3),
                        dy_x.permute(0, 3, 1, 2), padding=1,
                    ).permute(2, 3, 1, 0).to(w.dtype)
            dres = dy if ctx.has_res else None
            return dx, da, db, dw, dbias, dres, None, None


def affine_silu_conv3x3_vjp(x, a, b, w, bias, residual=None, *,
                            emit_stats: bool = False, packed_struct: bool = False):
    """Differentiable ``affine_silu_conv3x3`` of one operand, always with
    the SiLU (kernel K3): the same forward and outputs, with the backward
    above. With ``packed_struct`` x is packed and w the (3, 3, 4C, 4Cout)
    packed kernel (``pack_conv3x3_kernel``: autograd carries its cotangent
    on to the unpacked weights). On a CUDA tensor both directions launch K2
    or raise; K2 takes bf16 only."""
    if packed_struct and w.shape[0] != 3:
        raise ValueError("affine_silu_conv3x3_vjp: the packed mode takes the (3, 3, ...) "
                         "packed kernel, whose flip gives the data gradient's")
    return _AffineSiluConv3x3.apply(x, a, b, w, bias, residual, emit_stats, packed_struct)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, at a 16-byte aligned address (the kernel loads 8 bf16
    at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, a, b, w, bias, residual, *, apply_silu, emit_stats, proj_kernel, proj_bias,
            pipelined, packed_struct):
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
    if packed_struct:  # the combined taps, (2, 2, C, Cout)
        ws = tuple(struct_weights(wk) if wk.shape[0] == 3 else wk for wk in ws)
    kh = 2 if packed_struct else 3
    cs = []
    for xk, wk in zip(xs, ws):
        if xk.dtype != torch.bfloat16:
            raise TypeError(f"affine_silu_conv3x3: the CUDA kernel takes bf16, got {xk.dtype}")
        if xk.device != x0.device or xk.shape[:3] != (bsz, h, wd):
            raise ValueError("affine_silu_conv3x3: operands differ in device or (B, H, W)")
        c = xk.shape[3]
        if tuple(wk.shape) != (kh, kh, c, cout):
            raise ValueError(f"affine_silu_conv3x3: weight {tuple(wk.shape)} for C={c}, Cout={cout}")
        if c % (CHUNK if packed_struct else 8) or cout % 8:
            raise ValueError(
                f"affine_silu_conv3x3: C={c} must be a multiple of "
                f"{CHUNK if packed_struct else 8}{' (packed)' if packed_struct else ''} "
                f"and Cout={cout} of 8"
            )
        cs.append(c)
    ctot = sum(cs)
    pipe = pipelines(cs, bsz, h, wd, cout, pipelined)
    dev = x0.device
    xs = [_aligned(xk) for xk in xs]
    a = torch.cat([ak.to(dev, torch.float32).reshape(bsz, c)
                   for ak, c in zip(a_s, cs)], dim=1).contiguous()
    b = torch.cat([bk.to(dev, torch.float32).reshape(bsz, c)
                   for bk, c in zip(b_s, cs)], dim=1).contiguous()
    # (kh, kh, C, Cout) per operand -> (Cout, taps, sum C): each output
    # channel's taps x channels of the concatenation; packed, each chunk of
    # 32 channels in the kernel's parity-class order (channel i*4 + code at
    # code*8 + i)
    wt = torch.cat([wk.to(dev, torch.bfloat16) for wk in ws], dim=2)
    wt = wt.permute(3, 0, 1, 2).reshape(cout, kh * kh, ctot)
    if packed_struct:
        wt = wt.reshape(cout, 4, ctot // CHUNK, CHUNK // 4, 4).transpose(-1, -2)
    wt = wt.reshape(cout, kh * kh * ctot).contiguous()
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
            bsz, h, wd, cout, int(apply_silu), int(packed_struct), int(pipe),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(
            f"affine_silu_conv3x3: CUDA error {err} at launch "
            f"(operands {[tuple(xk.shape) for xk in xs]}, Cout {cout}, "
            f"packed_struct {packed_struct}, pipelined {pipe})"
        )
    launch_counts["K2"] += 1
    for mode, on in (("K2·N", n > 1), ("K2·proj", proj is not None),
                     ("K2·struct", packed_struct), ("K2·pipe", pipe)):
        if on:
            launch_counts[mode] += 1
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
        + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib
