"""Per-channel spatial sums for GroupNorm statistics (kernel K1).

Replaces ``ml_mdm_tpu/ops/gn_stats.py`` ``spatial_sums`` and its Pallas
kernel ``_spatial_sums_kernel``: s1 = sum_{h,w} x and s2 = sum_{h,w} x*x
over an NHWC activation, in f32, with x upcast to f32 before it is squared.

On the H100 the kernel is bound by memory bandwidth: it reads each element
once and does three operations on it. What it needs is enough loads in
flight, so the Triton kernel splits the work three ways: a grid of
(batch, channel block, span of H*W) programs, with the number of spans
chosen from the shape by ``plan`` (about four programs per SM wherever
the tensor has that much work, and at least 128 KB read by each). A
program streams its span with wide masked block loads (two steps' loads
issued before they are added; marked to leave L2 first, since the
activation is read once), into a 2-D f32 accumulator, and writes one
partial sum per channel to a (B, S, C) scratch. It then takes an int32
ticket for its (batch, channel block); the program that draws the last
one adds the S partials (16 at a time, the groups in split order) and
resets the ticket. No float atomics: every sum is taken in the same order
on every run, so the result is the same bit for bit from run to run, and
one launch does it all. With one span a program writes its sums directly.

``spatial_sums`` is differentiable (the JAX package's ``custom_vjp``,
``_bwd``): dx = ds1 + 2 x ds2 in f32, rounded to x's dtype, in plain
PyTorch as the JAX package computes it in plain jnp.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Tuple

import torch

# launches of the Triton kernel since the count was last set to 0
launch_count = 0

_TILE = 4096            # elements a program loads per step (BLOCK_HW x BLOCK_C)
_UNROLL = 2             # steps whose loads a program issues before it adds them
_WARPS = 4
_FINISH = 16            # partial sums the finishing program loads at once
_PROGRAMS_PER_SM = 4    # programs to aim for, per SM, where the work allows
_MIN_BYTES = 128 * 1024  # the least a program reads, where the work allows
H100_SMS = 132


class Plan(NamedTuple):
    """The launch of one call: BLOCK_C channels and BLOCK_HW pixels a step;
    ``splits`` programs along H*W for each (batch, channel block), the s-th
    covering pixels [s * span, min((s + 1) * span, H*W))."""
    block_c: int
    block_hw: int
    splits: int
    span: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan(bsz: int, h: int, w: int, c: int, itemsize: int = 2, sms: int = H100_SMS) -> Plan:
    """The split of one (B, H, W, C) call. BLOCK_C is min(64, the power of
    two >= C), so at C <= 64 no channel lane idles and a program's pixels
    are one contiguous span of memory. The number of spans S is the larger
    of 1 and the smaller of (a) what brings the grid to _PROGRAMS_PER_SM
    programs per SM and (b) what still gives each program _MIN_BYTES; the
    span is then rounded up to whole loop steps (_UNROLL x BLOCK_HW
    pixels), which can lower S."""
    hw = h * w
    block_c = min(64, _pow2_at_least(c))
    block_hw = min(_TILE // block_c, _pow2_at_least(hw))
    step = block_hw * _UNROLL
    base = bsz * -(-c // block_c)
    by_grid = -(-_PROGRAMS_PER_SM * sms // base)
    by_work = hw * min(c, block_c) * itemsize // _MIN_BYTES
    splits = max(1, min(by_grid, by_work))
    span = -(-hw // splits)
    span = -(-span // step) * step
    return Plan(block_c, block_hw, -(-hw // span), span)


def spatial_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> (s1, s2): (B, C) f32 sums of x and of x*x."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))


class _SpatialSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return spatial_sums_plain(x)
        return _launch(x)

    @staticmethod
    def backward(ctx, ds1, ds2):
        (x,) = ctx.saved_tensors
        dx = ds1[:, None, None, :] + 2.0 * x.float() * ds2[:, None, None, :]
        return dx.to(x.dtype)


def spatial_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> (s1, s2): (B, C) f32, differentiable. A CPU tensor
    takes the plain version; a CUDA tensor launches the Triton kernel. An x
    that needs no gradient skips the autograd wrapper (the same launch,
    less host work)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SpatialSums.apply(x)
    return spatial_sums_plain(x) if x.device.type == "cpu" else _launch(x)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_plan = functools.lru_cache(maxsize=1024)(plan)


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global launch_count
    if not x.is_cuda:
        raise RuntimeError(f"spatial_sums: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"spatial_sums: expected (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"spatial_sums: unsupported dtype {x.dtype}")
    x = x.contiguous()
    bsz, h, w, c = x.shape
    if h * w * c >= 2**31:
        raise ValueError(f"spatial_sums: {tuple(x.shape)} has 2^31 elements or more per row")
    index = x.device.index
    p = _plan(bsz, h, w, c, x.element_size(), _sm_count(index))
    n_cblk = -(-c // p.block_c)
    sums = torch.empty((2, bsz, c), device=x.device, dtype=torch.float32)  # s1, s2
    if p.splits == 1:
        part = tickets = sums  # not read
    else:
        part = torch.empty((2, bsz, p.splits, c), device=x.device, dtype=torch.float32)
        tickets = ticket_buffer(index, bsz * n_cblk)
    # the launch goes to the current device: switch only when x is elsewhere
    with torch.cuda.device(index) if index != torch.cuda.current_device() else _NO_SWITCH:
        _kernel()[(bsz, n_cblk, p.splits)](
            x, part, sums, tickets, h * w, c, p.span, p.splits,
            BLOCK_HW=p.block_hw, BLOCK_C=p.block_c, UNROLL=_UNROLL, FINISH=_FINISH,
            num_warps=_WARPS,
        )
    launch_count += 1
    return sums[0], sums[1]


_NO_SWITCH = contextlib.nullcontext()
_TICKETS = {}


def ticket_buffer(index: int, n: int) -> torch.Tensor:
    """At least n int32 tickets, all 0, for the current stream of device
    ``index``: each call's last programs set theirs back to 0, so a buffer
    serves every later call on its stream (calls on one stream never
    overlap) without a fill. K2's statistics (``ops/fused_resnet.py``) take
    their tickets from the same buffer."""
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), device=torch.device("cuda", index), dtype=torch.int32)
        _TICKETS[key] = buf
    return buf


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
    def spatial_sums_kernel(x_ptr, p1_ptr, s1_ptr, ticket_ptr, hw, c, span, n_split,
                            BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr,
                            UNROLL: tl.constexpr, FINISH: tl.constexpr):
        # the sums of x*x, and their partials, follow those of x in one buffer
        b = tl.program_id(0).to(tl.int64)
        n_b = tl.num_programs(0).to(tl.int64)
        s2_ptr = s1_ptr + n_b * c
        p2_ptr = p1_ptr + n_b * n_split * c
        cb = tl.program_id(1)
        split = tl.program_id(2)
        offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < c
        base = x_ptr + b * hw * c
        start = split * span
        end = tl.minimum(start + span, hw)
        acc1 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        for p0 in range(start, end, BLOCK_HW * UNROLL):
            for u in tl.static_range(UNROLL):
                offs_p = p0 + u * BLOCK_HW + tl.arange(0, BLOCK_HW)
                m = (offs_p[:, None] < end) & cmask[None, :]
                v = tl.load(base + offs_p[:, None] * c + offs_c[None, :],
                            mask=m, other=0.0, eviction_policy="evict_first").to(tl.float32)
                acc1 += v
                acc2 += v * v
        r1 = tl.sum(acc1, axis=0)
        r2 = tl.sum(acc2, axis=0)
        if n_split == 1:
            tl.store(s1_ptr + b * c + offs_c, r1, mask=cmask)
            tl.store(s2_ptr + b * c + offs_c, r2, mask=cmask)
        else:
            out = (b * n_split + split) * c + offs_c
            tl.store(p1_ptr + out, r1, mask=cmask)
            tl.store(p2_ptr + out, r2, mask=cmask)
            # every thread's partials out before the ticket (release), and
            # the last ticket's holder reads them all after it (acquire)
            tl.debug_barrier()
            ticket = ticket_ptr + b * tl.num_programs(1) + cb
            drawn = tl.atomic_add(ticket, 1, sem="acq_rel", scope="gpu")
            if drawn == n_split - 1:
                # FINISH partials a step, summed by one fixed tree, the steps
                # in split order: the same sums on every run
                t1 = tl.zeros([BLOCK_C], dtype=tl.float32)
                t2 = tl.zeros([BLOCK_C], dtype=tl.float32)
                for k0 in range(0, n_split, FINISH):
                    ks = k0 + tl.arange(0, FINISH)
                    at = (b * n_split + ks[:, None]) * c + offs_c[None, :]
                    mk = (ks[:, None] < n_split) & cmask[None, :]
                    t1 += tl.sum(tl.load(p1_ptr + at, mask=mk, other=0.0, cache_modifier=".cg"),
                                 axis=0)
                    t2 += tl.sum(tl.load(p2_ptr + at, mask=mk, other=0.0, cache_modifier=".cg"),
                                 axis=0)
                tl.store(s1_ptr + b * c + offs_c, t1, mask=cmask)
                tl.store(s2_ptr + b * c + offs_c, t2, mask=cmask)
                tl.atomic_xchg(ticket, 0, sem="relaxed", scope="gpu")  # ready for the next call

    return spatial_sums_kernel
