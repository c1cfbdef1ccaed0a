"""K3's elementwise chain as two fused passes (Triton), with their plain
versions.

K3 (``ops/fused_resnet.py`` ``affine_silu_conv3x3_vjp``) replaces the JAX
package's ``custom_vjp`` backward ``_vjp_bwd``, whose derivative chain (the
stats' cotangents folded into dy, SiLU', the affine, the (B, C) sums) XLA
fuses; the JAX default ``vjp_chain_bf16_min_side`` 0 keeps it in f32. The
port has no fuser, and as some 15 eager operations, each writing a whole
f32 tensor, the chain was the largest device item of a training step. Here
it is two passes that read and write each element once:

  pass A, ``fold`` (with ``emit_stats`` only), over dy, y (B, H, W, Cout)
  and the stats' cotangents ds1, ds2 (B, Cout):
      dy' = dy + ds1 + 2 y ds2 in f32, rounded to dy's dtype, and dbias,
      the per-Cout sum of dy' (as rounded) over (B, H, W);
  pass B, ``chain``, over x and ds = K2's data gradient (B, H, W, C), and
  a, b (B, C):
      v = x a + b, sig = sigmoid(v), dv = ds sig (1 + v (1 - sig)),
      dx = dv a and s = v sig, each rounded to x's dtype (s is the weight
      gradient's input), and per (B, C) the sums da of dv x and db of dv.

Both are bound by bytes on the H100 (about 8 bytes an element, against
tens of operations), so Triton's masked block loads are enough: a grid of
(batch, channel block, span of H*W) programs, the split chosen by K1's
``gn_stats.plan`` (about four programs an SM, each reading at least 128 KB),
each writing one partial sum per channel and span; the partials are then
added by one ``torch.sum`` over the spans, in a fixed order, so two calls
give the same bits. The plain versions compute what the eager chain
computed; a CPU tensor takes them, a CUDA tensor launches the kernels (bf16
or f32 tensors, contiguous) or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ml_mdm_tpu_torch.ops import gn_stats

# launches of the Triton kernels since the counts were last set to 0
launch_counts = {"K3·A": 0, "K3·B": 0}
_WARPS = 8


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _span_sums(t: torch.Tensor, span: Optional[int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, C) sums over H*W; with ``span``, the partial sum
    of each span of ``span`` pixels first, then the partials in span
    order, as the kernels add them."""
    if span is None:
        return t.sum(dim=(1, 2))
    flat = t.reshape(t.shape[0], -1, t.shape[-1])
    return torch.stack([p.sum(dim=1) for p in flat.split(span, dim=1)], dim=1).sum(dim=1)


def fold_plain(dy: torch.Tensor, y: torch.Tensor, ds1: Optional[torch.Tensor],
               ds2: Optional[torch.Tensor], span: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A's plain version: (dy', dbias). ``span``: take the sums over
    spans of that many pixels, as the kernel does."""
    d = dy.float()
    if ds1 is not None:
        d = d + ds1[:, None, None, :]
    if ds2 is not None:
        d = d + 2.0 * y.float() * ds2[:, None, None, :]
    d = d.to(dy.dtype)
    if span is None:
        return d, d.float().sum(dim=(0, 1, 2))
    return d, _span_sums(d.float(), span).sum(dim=0)


def chain_plain(x: torch.Tensor, ds: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                span: Optional[int] = None):
    """Pass B's plain version: (dx, s, da, db), da and db f32. ``span``:
    take the sums over spans of that many pixels, as the kernel does."""
    a_c, b_c = a.float()[:, None, None, :], b.float()[:, None, None, :]
    v = x.float() * a_c + b_c
    sig = torch.sigmoid(v)
    dact = sig * (1.0 + v * (1.0 - sig))
    dv = ds.float() * dact
    dx = (dv * a_c).to(x.dtype)
    s = (v * sig).to(x.dtype)
    return dx, s, _span_sums(dv * x.float(), span), _span_sums(dv, span)


def plan(bsz: int, h: int, w: int, c: int, sms: int = gn_stats.H100_SMS) -> gn_stats.Plan:
    """The split of one pass over (B, H, W, C): K1's, for two 2-byte inputs
    an element."""
    return gn_stats.plan(bsz, h, w, c, itemsize=4, sms=sms)


def fold(dy: torch.Tensor, y: Optional[torch.Tensor], ds1: Optional[torch.Tensor],
         ds2: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A: (dy', dbias). A CPU tensor takes ``fold_plain``."""
    if dy.device.type == "cpu":
        return fold_plain(dy, y, ds1, ds2)
    _check(dy, "fold")
    bsz, h, w, c = dy.shape
    p = _plan(bsz, h, w, c, _sm_count(dy.device.index))
    dy = dy.contiguous()
    out = torch.empty_like(dy)
    part = torch.empty((bsz * p.splits, c), device=dy.device, dtype=torch.float32)
    has1, has2 = ds1 is not None, ds2 is not None
    if has2:
        _check(y, "fold")
        y = y.contiguous()
    with torch.cuda.device(dy.device):
        _kernels()[0][(bsz, -(-c // p.block_c), p.splits)](
            dy, y if has2 else dy, ds1.contiguous() if has1 else dy,
            ds2.contiguous() if has2 else dy, out, part, h * w, c, p.span, p.splits,
            BLOCK_HW=p.block_hw, BLOCK_C=p.block_c, HAS1=has1, HAS2=has2, num_warps=_WARPS)
    launch_counts["K3·A"] += 1
    return out, part.sum(dim=0)


def chain(x: torch.Tensor, ds: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Pass B: (dx, s, da, db). A CPU tensor takes ``chain_plain``."""
    if x.device.type == "cpu":
        return chain_plain(x, ds, a, b)
    _check(x, "chain")
    _check(ds, "chain")
    bsz, h, w, c = x.shape
    p = _plan(bsz, h, w, c, _sm_count(x.device.index))
    x, ds = x.contiguous(), ds.contiguous()
    dx, s = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty((2, bsz, p.splits, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _kernels()[1][(bsz, -(-c // p.block_c), p.splits)](
            x, ds, a.float().contiguous(), b.float().contiguous(), dx, s, part, h * w, c,
            p.span, p.splits, BLOCK_HW=p.block_hw, BLOCK_C=p.block_c, num_warps=_WARPS)
    launch_counts["K3·B"] += 1
    da, db = part.sum(dim=2)
    return dx, s, da, db


def _check(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise RuntimeError(f"k3_passes.{what}: no kernel for device {t.device}")
    if t.dim() != 4 or t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k3_passes.{what}: expected a (B, H, W, C) bf16 or f32 tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if t.shape[1] * t.shape[2] * t.shape[3] >= 2**31:
        raise ValueError(f"k3_passes.{what}: {tuple(t.shape)} has 2^31 elements or more per row")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_plan = functools.lru_cache(maxsize=1024)(plan)


@functools.cache
def _kernels():
    """The two @triton.jit kernels, defined at first use so that the module
    imports where triton is absent."""
    import triton
    import triton.language

    # the Triton compiler resolves the names a kernel uses in the globals
    # of its module, not in the enclosing function
    globals()["tl"] = triton.language

    @triton.jit
    def k3_fold_kernel(dy_ptr, y_ptr, s1_ptr, s2_ptr, out_ptr, part_ptr, hw, c, span, n_split,
                       BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr,
                       HAS1: tl.constexpr, HAS2: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        split = tl.program_id(2)
        offs_c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < c
        base = b * hw * c
        if HAS1:
            s1 = tl.load(s1_ptr + b * c + offs_c, mask=cmask, other=0.0)
        if HAS2:
            s2 = tl.load(s2_ptr + b * c + offs_c, mask=cmask, other=0.0)
        start = split * span
        end = tl.minimum(start + span, hw)
        acc = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        for p0 in range(start, end, BLOCK_HW):
            offs_p = p0 + tl.arange(0, BLOCK_HW)
            m = (offs_p[:, None] < end) & cmask[None, :]
            idx = base + offs_p[:, None] * c + offs_c[None, :]
            d = tl.load(dy_ptr + idx, mask=m, other=0.0, eviction_policy="evict_first")
            d = d.to(tl.float32)
            if HAS1:
                d = d + s1[None, :]
            if HAS2:
                yv = tl.load(y_ptr + idx, mask=m, other=0.0, eviction_policy="evict_first")
                d = d + 2.0 * yv.to(tl.float32) * s2[None, :]
            dq = d.to(out_ptr.dtype.element_ty)
            tl.store(out_ptr + idx, dq, mask=m)
            acc += tl.where(m, dq.to(tl.float32), 0.0)
        tl.store(part_ptr + (b * n_split + split) * c + offs_c, tl.sum(acc, axis=0), mask=cmask)

    @triton.jit
    def k3_chain_kernel(x_ptr, ds_ptr, a_ptr, b_ptr, dx_ptr, s_ptr, part_ptr, hw, c, span,
                        n_split, BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        n_b = tl.num_programs(0).to(tl.int64)
        split = tl.program_id(2)
        offs_c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < c
        base = b * hw * c
        av = tl.load(a_ptr + b * c + offs_c, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * c + offs_c, mask=cmask, other=0.0)
        start = split * span
        end = tl.minimum(start + span, hw)
        acc_a = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        for p0 in range(start, end, BLOCK_HW):
            offs_p = p0 + tl.arange(0, BLOCK_HW)
            m = (offs_p[:, None] < end) & cmask[None, :]
            idx = base + offs_p[:, None] * c + offs_c[None, :]
            xv = tl.load(x_ptr + idx, mask=m, other=0.0, eviction_policy="evict_first")
            xv = xv.to(tl.float32)
            g = tl.load(ds_ptr + idx, mask=m, other=0.0, eviction_policy="evict_first")
            g = g.to(tl.float32)
            v = xv * av[None, :] + bv[None, :]
            sig = tl.sigmoid(v)
            dv = g * (sig * (1.0 + v * (1.0 - sig)))
            tl.store(dx_ptr + idx, (dv * av[None, :]).to(dx_ptr.dtype.element_ty), mask=m)
            tl.store(s_ptr + idx, (v * sig).to(s_ptr.dtype.element_ty), mask=m)
            acc_a += tl.where(m, dv * xv, 0.0)
            acc_b += tl.where(m, dv, 0.0)
        out = (b * n_split + split) * c + offs_c
        tl.store(part_ptr + out, tl.sum(acc_a, axis=0), mask=cmask)
        tl.store(part_ptr + n_b * n_split * c + out, tl.sum(acc_b, axis=0), mask=cmask)

    return k3_fold_kernel, k3_chain_kernel
