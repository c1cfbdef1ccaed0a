"""Per-channel spatial sums for GroupNorm statistics (kernel K1).

Replaces ``ml_mdm_tpu/ops/gn_stats.py`` ``spatial_sums`` and its Pallas
kernel ``_spatial_sums_kernel``: s1 = sum_{h,w} x and s2 = sum_{h,w} x*x
over an NHWC activation, in f32, with x upcast to f32 before it is squared.

On the H100 the kernel is bound by memory bandwidth: it reads each element
once and does three operations on it. The Triton kernel therefore streams
the activation once with wide masked block loads: one program owns one
(batch, channel-block) pair and loops over H*W, keeping a 2-D f32
accumulator in registers that it reduces once at the end. Every sum is
finished inside one program, so there are no atomics and the result does
not depend on launch order.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

# launches of the Triton kernel since the count was last set to 0
launch_count = 0

_BLOCK_HW = 64
_BLOCK_C = 64


def spatial_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> (s1, s2): (B, C) f32 sums of x and of x*x."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))


def spatial_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> (s1, s2): (B, C) f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the Triton kernel."""
    if x.device.type == "cpu":
        return spatial_sums_plain(x)
    return _launch(x)


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    import triton

    global launch_count
    if not x.is_cuda:
        raise RuntimeError(f"spatial_sums: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"spatial_sums: expected (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"spatial_sums: unsupported dtype {x.dtype}")
    x = x.contiguous()
    bsz, h, w, c = x.shape
    s1 = torch.empty((bsz, c), device=x.device, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    grid = (bsz, triton.cdiv(c, _BLOCK_C))
    with torch.cuda.device(x.device):
        _kernel()[grid](
            x, s1, s2, h * w, c,
            BLOCK_HW=_BLOCK_HW, BLOCK_C=_BLOCK_C, num_warps=4,
        )
    launch_count += 1
    return s1, s2


@functools.cache
def _kernel():
    """The @triton.jit kernel, defined at first use so that the module
    imports where triton is absent."""
    import triton
    import triton.language

    # the Triton compiler resolves the names a kernel uses in the globals
    # of its module, not in the enclosing function
    globals()["tl"] = triton.language

    @triton.jit
    def spatial_sums_kernel(x_ptr, s1_ptr, s2_ptr, hw, c,
                            BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        offs_c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < c
        base = x_ptr + b * hw * c
        acc1 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        for start in range(0, hw, BLOCK_HW):
            offs_p = start + tl.arange(0, BLOCK_HW)
            m = (offs_p[:, None] < hw) & cmask[None, :]
            v = tl.load(base + offs_p[:, None] * c + offs_c[None, :],
                        mask=m, other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        tl.store(s1_ptr + b * c + offs_c, tl.sum(acc1, axis=0), mask=cmask)
        tl.store(s2_ptr + b * c + offs_c, tl.sum(acc2, axis=0), mask=cmask)

    return spatial_sums_kernel
