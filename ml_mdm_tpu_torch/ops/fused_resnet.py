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
GroupNorm, each taken in one fixed order (``stats_order``: no float
atomics), so the same inputs give the same bits on every call, as in the
JAX package. Outputs come in the JAX order: y, then (s1, s2), then proj.

``packed_struct`` (K2·struct): x is space-to-depth packed
(``ops/space_to_depth.py``) and w is the packed (3, 3, 4C, 4Cout) kernel
(``pack_conv3x3_kernel``, or its flip and io-transpose) or its combined
(2, 2, 4C, 4Cout) form from ``struct_weights``. The packed kernel is 75%
structural zeros, so the 9 taps collapse to 4 products over parity-selected
neighbours (the JAX ``_struct_dots``); the result is the dense packed
convolution's. On the card every operand's 4C is a multiple of 8, as
unpacked.

``pipelined`` (K2·pipe, packed launches only): the launch overlaps the
next channel chunk's loads with this chunk's tensor-core products. The
kernel does so at every launch, packed or not, so ``pipelined`` changes no
launch's result or time; it only says which packed launches count as
K2·pipe, by the port's rule (``pipelines``), which keeps the launches the
earlier packed kernel pipelined: by default (``None``) a packed launch
counts when ``perf().fused_pipelined`` is on (``ML_MDM_TPU_FUSED_PIPELINED``,
default 1), its operands hold at least ``PIPELINE_MIN_CHUNKS`` chunks of 64
channels and its plan at least ``PIPELINE_MIN_TILES`` output tiles; True
asks for it wherever there are that many chunks, False never. (The JAX
package pipelines launches of at least 4 TPU row blocks.)

One CUDA kernel in ``csrc/fused_resnet.cu`` (its header says what bounds it
on the H100 and how it is laid out): the implicit-GEMM kernel on
``wgmma``, at 9 taps for every unpacked launch and at the 4 combined taps
for every packed one, whose tile, N tile, ring depth and grid ``conv_plan``
chooses and whose weights ``conv_weight_layout`` lays out (``K2Weights``
keeps that layout across calls). It is built with ``nvcc`` for ``sm_90a``
at first use into ``ml_mdm_tpu_torch/_build/`` and loaded with ctypes. A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Without a and b (``conv3x3_fast``) the prologue is the identity.

``affine_silu_conv3x3_vjp`` (kernel K3, replacing the JAX package's
``custom_vjp`` of the same name) is the differentiable single-operand
form for training. Its forward is K2. Its backward follows the JAX
``_vjp_bwd`` (with ``vjp_chain_bf16_min_side`` at its default 0: the chain
in f32): with ``emit_stats`` pass A folds the stats' cotangents into dy
(``ops/k3_passes.py``); the data gradient is a 3x3 stride-1 convolution of
dy with the flipped, io-transposed weights through K2's identity prologue
(K2·struct for a packed kernel, whose flip and io-transpose keep the zero
pattern); pass B runs the derivative chain (SiLU', the affine, the (B, C)
sums) in one pass over x and that convolution; the weight gradient is the
library's conv weight-gradient of pass B's bf16 activation or, packed,
``struct_wgrad``'s four products, as the JAX package leaves both to XLA. It
stashes only x, a, b, w and, with ``emit_stats``, y: the SiLU input is
recomputed from x. The backward, its passes and its two convolutions run
in spans ("K3 backward", "K3 pass A (fold)", "K3 dx (K2)", "K3 pass B
(chain)", "K3 dw (library)"; ``tracing.py``: profiler ranges while a
profiler records), so a trace can split the backward's device time.

Each forward K2 launch runs in the span of its modes (``k2_range``: "K2",
"K2·N·proj", "K2·struct·pipe", ...), so a trace can give K2's device time
without kernel names. No K2 span opens inside a backward pass: K3's data
gradient runs under "K3 dx (K2)", and remat's recomputed forward under its
own span.

``conv3x3_vjp`` is the differentiable identity-prologue convolution (a
dropout ResNet's conv2, whose input is no affine-SiLU of a stored tensor):
K2's identity prologue forward, and K3's backward without its passes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ml_mdm_tpu_torch.ops import cuda_build, gn_stats, k3_passes
from ml_mdm_tpu_torch.perf import perf
from ml_mdm_tpu_torch.tracing import span

# launches of the CUDA kernels since the counts were last set to 0: "K2"
# counts every launch, "K2·N" those with more than one operand, "K2·proj"
# those that also emit the shortcut, "K2·struct" the packed ones, "K2·pipe"
# the pipelined (packed) ones, "K3" those of K3's backward (the data
# gradient) and "K3·id" those of them in ``conv3x3_vjp``'s backward (K3
# without the chain)
launch_counts = {"K2": 0, "K2·N": 0, "K2·proj": 0, "K2·struct": 0, "K2·pipe": 0, "K3": 0,
                 "K3·id": 0}
MAX_OPERANDS = 4

# the wgmma kernel: chunks of 64 channels (one 128-byte row of the 128-byte
# swizzle), (N tile, m64 tiles a warpgroup) in the order the plan tries
# them, the ring's deepest, a block's shared-memory limit
WG_CHUNK = 64
CANDIDATES = ((128, 2), (256, 1), (128, 1), (64, 2), (64, 1))
MAX_STAGES = 8
SMEM_LIMIT = 232448
H100_SMS = 132
STAT_WARPS = 8  # warps of a block, each with a slot of column sums (``stats_order``)
# K2·pipe's rule (``pipelines``) in the kernel's terms: chunks of 64
# channels, output tiles of the plan. At every packed launch shape of the
# three models (N tiles of 128 and tiles of 8 x 32 pixels) it selects the
# launches the earlier packed kernel pipelined: those of at least 4096 of
# its blocks of 128 pixels x 64 channels
PIPELINE_MIN_CHUNKS = 2
PIPELINE_MIN_TILES = 1024


def reset_launch_counts() -> None:
    for mode in launch_counts:
        launch_counts[mode] = 0
    k3_passes.reset_launch_counts()


def _as_tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


class K2Weights:
    """One launch's weights, one tensor per operand: the (3, 3, C_k, Cout)
    kernels of the 3x3 convolution (packed: also their combined (2, 2,
    C_k, Cout) form) or the (C_k, Cout) matrices of the shortcut, with the
    kernel's layout of them (``conv_weight_layout``, packed or not) made at
    the first launch that needs it and kept. Pass it as ``w`` or
    ``proj_kernel`` to keep the layout across calls: sampling keeps one per
    module (``models/layers.py`` ``cached_weights``). The plain version
    reads ``tensors``."""

    def __init__(self, tensors):
        self.tensors = _as_tuple(tensors)
        self._layouts = {}

    def layout(self, device, packed: bool = False) -> torch.Tensor:
        key = (device, bool(packed))
        if key not in self._layouts:
            self._layouts[key] = conv_weight_layout(tuple(t.to(device) for t in self.tensors),
                                                    packed)
        return self._layouts[key]


def _kernels(w):
    """The per-operand weight tensors of ``w``: a tensor, a tuple of them or
    a ``K2Weights``."""
    return w.tensors if isinstance(w, K2Weights) else _as_tuple(w)


def output_tiles(bsz: int, h: int, w: int, cout: int) -> int:
    """Output tiles (pixel tile, N tile) of a packed launch's plan on an
    H100: what its persistent blocks walk."""
    return _plan(bsz, h, w, (WG_CHUNK,), cout, H100_SMS, False, True).tiles


def pipelines(cs, bsz: int, h: int, w: int, cout: int, pipelined=None,
              packed_struct: bool = False) -> bool:
    """Whether a launch over operands of ``cs`` channels and a (bsz, h, w,
    cout) output counts as K2·pipe: a packed launch of at least
    PIPELINE_MIN_CHUNKS chunks of 64 channels (each operand's channels in
    whole chunks), and ``pipelined``, or for None the ``fused_pipelined``
    gate and at least PIPELINE_MIN_TILES output tiles. Never an unpacked
    launch. The kernel stages the next chunk under this one's products at
    every launch, so the answer changes no result."""
    if not packed_struct or sum(-(-c // WG_CHUNK) for c in cs) < PIPELINE_MIN_CHUNKS:
        return False
    if pipelined is not None:
        return bool(pipelined)
    return perf().fused_pipelined and output_tiles(bsz, h, w, cout) >= PIPELINE_MIN_TILES


# -- the kernel's plan and weight layout --------------------------------------


class ConvPlan(NamedTuple):
    """One launch: a block owns a tile of ``th`` x ``tw`` output pixels (at
    most 128 ``mt``: two warpgroups of ``mt`` m64 tiles) by ``bn`` output
    channels; the weights come through a ring of ``stages`` slots of one
    tap's (bn x 64) slice; ``smem`` dynamic shared-memory bytes; ``grid``
    blocks, ``persistent``: each walks the ``tiles`` output tiles (pixel
    tile, N tile) block, block + grid, ...; ``l2_bytes`` what the launch
    reads from L2: per output tile its weight slices (9 taps, or the 4
    combined ones packed, and the shortcut's) and, per chunk of 64
    channels, its raw tile and halo."""
    th: int
    tw: int
    bn: int
    mt: int
    stages: int
    smem: int
    grid: int
    persistent: bool
    l2_bytes: int
    tiles: int


def smem_bytes(bn: int, th: int, tw: int, stages: int) -> int:
    """Dynamic shared memory of a launch (``csrc/conv3x3_wgmma.cuh``
    ``wg_smem_bytes``): the ring, two activated tiles and the raw tile (128
    bytes a staged pixel), the ring's barriers, two chunks' coefficients a
    and b, the stats' per-warp slots where they do not fit in an activated
    tile (``stats_order``) and 1024 bytes of alignment slack."""
    own_slots = 0 if _slots_in_tile(bn, th, tw) else STAT_WARPS * 2 * 4 * bn
    return (1024 + stages * bn * 128 + 3 * (th + 2) * (tw + 2) * 128 + 16 * stages + 1024
            + own_slots)


def _slots_in_tile(bn: int, th: int, tw: int) -> bool:
    """Whether the stats' per-warp slots, [warp][s1, s2][bn] f32, fit in one
    activated tile (128 bytes a staged pixel) (the kernel's
    ``slots_in_tile``)."""
    return STAT_WARPS * 2 * 4 * bn <= (th + 2) * (tw + 2) * 128


def conv_plan(bsz: int, h: int, w: int, cs, cout: int, sms: int = H100_SMS,
              proj: bool = False, packed: bool = False) -> ConvPlan:
    """The plan of one launch over operands of ``cs`` channels (an int or a
    tuple) and a (bsz, h, w, cout) output, unpacked or packed (the same
    tiles and ring; 4 taps a chunk, not 9). The tile is TW =
    min(W, 32) columns by TH = min(128 mt / TW, H, 32) rows. The (N tile,
    m64 tiles) pairs are tried in CANDIDATES' order, skipping an N tile
    wider than Cout rounded up to 64 and mt = 2 where the tile would not
    fill the second pair of m64 tiles. The first with at least ``sms``
    output tiles is taken (M = 256 pixels and N = 128 first: at the 64px
    shapes this halves the weight traffic from L2 against M = 128 at
    N = 256); else the one with the most output tiles (a smaller N before a
    smaller M, so that a launch of few pixels, such as the 64px CFG
    request's 16 rows at 16^2 x 768, still spreads over the SMs). The grid
    is one persistent block an SM, or one a tile where there are fewer
    tiles. The ring takes as many slots, up to MAX_STAGES, as fit beside
    the tiles in SMEM_LIMIT."""
    cs = tuple(int(c) for c in _as_tuple(cs))
    n_q = sum(-(-c // WG_CHUNK) for c in cs)
    taps = 4 if packed else 9
    cpad = -(-cout // 64) * 64
    best = None
    for bn, mt in CANDIDATES:
        if bn > max(64, cpad):
            continue
        tw = min(w, 32)
        th = max(1, min(128 * mt // tw, h, 32))
        if mt > 1 and th * tw <= 128 * (mt - 1):
            continue
        stages = min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(bn, th, tw, 0)) // (bn * 128 + 16))
        if stages < 2:
            continue
        tiles = bsz * -(-h // th) * -(-w // tw)
        work = tiles * -(-cout // bn)  # output tiles
        l2 = (tiles * n_q * (taps + proj) * cpad * 128
              + work * n_q * (1 + proj) * (th + 2) * (tw + 2) * 128)
        plan = ConvPlan(th, tw, bn, mt, stages, smem_bytes(bn, th, tw, stages), min(work, sms),
                        True, l2, work)
        if work >= sms:
            return plan
        if best is None or work > best.grid:
            best = plan
    return best


class StatsOrder(NamedTuple):
    """How a launch with ``emit_stats`` takes s1 and s2 (``csrc/
    fused_resnet.cu``), with no float atomic, so that they are the same bits
    on every run. In a block, thread (warpgroup wg, warp wp, lane l) adds
    its rows of a column, (wg mt + i) 64 + 16 wp + l / 4 + 8 h for m64 tile
    i = 0..mt-1, then h = 0, 1, to 0.0; shuffles add the warp's 8 row groups
    (lane xor 4, 8, 16 in that order); warp w = 4 wg + wp writes the sum to
    its slot, and the block adds the ``STAT_WARPS`` slots in warp order.
    That is the pixel tile's sum. With one tile an image it is the image's;
    else each tile writes it to row t of the f32 ``scratch`` (s1's plane,
    then s2's) and takes one of the int32 ``tickets`` (one an (image, N
    tile)); the block that draws the last adds rows 0, 1, ... in order.
    ``tiles`` gives, for each row t, the tile's first output pixel (r0, c0)
    in the image. ``slots_in_tile``: the slots live in the activated tile of
    the tile's last chunk (else in shared memory of their own,
    ``smem_bytes``)."""
    tiles: tuple
    scratch: tuple
    tickets: int
    slots_in_tile: bool


def stats_order(plan: ConvPlan, bsz: int, h: int, w: int, cout: int) -> StatsOrder:
    """The stats' order of adding and their scratch at ``plan`` (a
    ``conv_plan``) for a (bsz, h, w, cout) output: the pixel tiles of an
    image in the kernel's tile order (row-major over the tile grid), the
    scratch's shape ((2, bsz, tiles, cout); () with one tile, when the
    sums are written directly) and the number of tickets (0 with one
    tile)."""
    tiles = tuple((r, c) for r in range(0, h, plan.th) for c in range(0, w, plan.tw))
    slots = _slots_in_tile(plan.bn, plan.th, plan.tw)
    if len(tiles) == 1:
        return StatsOrder(tiles, (), 0, slots)
    return StatsOrder(tiles, (2, bsz, len(tiles), cout), bsz * -(-cout // plan.bn), slots)


def struct_tap_offsets(tw: int):
    """The packed kernel's 16 staged offsets, [4 tap + ks]: where the A rows
    of combined tap ``tap`` = 2 rsel + csel at k-step ``ks`` start, from the
    tile's output pixel 0, in a staged tile of rows TW + 2 pixels wide. K-step
    ks holds parity class (ei, ej) = (ks >> 1, ks & 1) (``conv_weight_layout``),
    so each pair is one shift (dr, dc): a row select reads the row above for
    ei = 1 and below for ei = 0, a column select the column left for ej = 1
    and right for ej = 0 (the JAX ``_struct_dots``)."""
    sw = tw + 2
    out = []
    for tap in range(4):
        for ks in range(4):
            dr = (-1 if ks >> 1 else 1) if tap >> 1 else 0
            dc = (-1 if ks & 1 else 1) if tap & 1 else 0
            out.append((1 + dr) * sw + 1 + dc)
    return tuple(out)


def conv_weight_layout(ws, packed: bool = False) -> torch.Tensor:
    """The kernel's weights: ``ws`` one tensor per operand, the (3, 3, C_k,
    Cout) kernels of the convolution (packed: the packed kernels, which go
    through ``struct_weights``, or their combined (2, 2, C_k, Cout) form) or
    the (C_k, Cout) matrices of the shortcut (one tap). Returns (n_q, taps,
    cpad, 64) bf16: chunk q of 64 input channels over the operands (each
    operand's channels zero-padded to whole chunks), tap ky*3 + kx (packed:
    combined tap 2 rsel + csel), output channel n (Cout zero-padded to cpad,
    a multiple of 64), and the chunk's 64 channels of row n (packed: in the
    staged parity-class order, channel 4 i + code at position 16 code + i,
    code = 2 ei + ej) stored as 8 groups of 8 with group j at position
    j ^ (n mod 8): the 128-byte swizzle in which ``wgmma`` reads a K-major B
    operand by descriptor. Each (q, tap) slice is contiguous, and so is any
    run of its rows, so a block's slice comes in by one bulk copy."""
    if packed:
        ws = tuple(struct_weights(t) if t.dim() == 4 and t.shape[0] == 3 else t for t in ws)
    ws = tuple(t if t.dim() == 4 else t[None, None] for t in ws)
    cout = ws[0].shape[-1]
    cpad = -(-cout // 64) * 64
    blocks = []
    for wk in ws:
        kh, kw, c, _ = wk.shape
        cp = -(-c // WG_CHUNK) * WG_CHUNK
        wk = wk.to(torch.bfloat16).reshape(kh * kw, c, cout)
        if (cp, cpad) != (c, cout):
            wk = F.pad(wk, (0, cpad - cout, 0, cp - c))
        blocks.append(wk.reshape(kh * kw, cp // WG_CHUNK, WG_CHUNK, cpad))
    wt = (blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)).permute(1, 0, 3, 2)
    return torch.gather(wt, 3, _layout_order(cpad, packed, wt.device).expand(wt.shape))


@functools.lru_cache(maxsize=64)
def _layout_order(cpad: int, packed: bool, device) -> torch.Tensor:
    """(cpad, 64) int64: the chunk channel that each element (n, position)
    of a weight row holds: position 8 g + e of row n is element e of 16-byte
    group g ^ (n mod 8), logical position 8 (g ^ (n mod 8)) + e; packed, the
    channel at logical position p is 4 (p mod 16) + p // 16. Made once per
    (cpad, packing, device), so that a launch lays its weights out by one
    gather."""
    n = torch.arange(cpad)[:, None]
    pos = torch.arange(WG_CHUNK)[None, :]
    p = 8 * ((pos // 8) ^ (n % 8)) + pos % 8
    if packed:
        p = 4 * (p % 16) + p // 16
    return p.to(device)


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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in f32 (``preferred_element_type=
    jnp.float32``): on the card cuBLAS's bf16 product with an f32 output,
    elsewhere the product of the f32 upcasts (the same products: a bf16
    value is exact in f32)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def struct_wgrad(s: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The packed kernel's (3, 3, C, Cout) cotangent from 4 products (the
    JAX ``_struct_wgrad``): s (B, H, W, C) the activated input, dy (B, H, W,
    Cout). Each combined tap's cotangent is the product of its buffer with
    dy over the pixels; ``struct_weights``' transpose copies it to every
    packed tap it sums. Right on ``pack_conv3x3_kernel``'s image only: pull
    it back through that transform before comparing it with a dense
    gradient. In f32, as the JAX products are kept: the products of s's and
    dy's dtype accumulated in f32 and never rounded to bf16 (the caller
    casts to the weights' dtype)."""
    c, cout = s.shape[-1], dy.shape[-1]
    d2 = dy.reshape(-1, cout)
    ac, ab, bc, bb = (_mm_f32(buf.reshape(-1, c).t(), d2) for buf in _struct_buffers(s))
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
    (B, C_k), or both None for the identity prologue; w: (3, 3, C, Cout)
    HWIO or a tuple of (3, 3, C_k, Cout) (with ``packed_struct`` also the
    combined (2, 2, C_k, Cout) form), or a ``K2Weights``; bias: (Cout,) or
    None; residual: (B, H, W, Cout); proj_kernel: (C, Cout2), a tuple of
    (C_k, Cout2) or a ``K2Weights``; proj_bias: (Cout2,) or None.
    ``pipelined`` changes nothing here.

    The activation is rounded to x's dtype, the weights are cast to it,
    products accumulate in f32 and bias and residual are added in f32
    before one rounding to x's dtype. With ``packed_struct`` the products
    are the 4 combined taps over ``_struct_buffers``. The stats square the
    stored output in f32. The shortcut multiplies the raw operands and P,
    both in x's dtype, in f32, adds pb in f32 and rounds once."""
    xs, ws = _as_tuple(x), _kernels(w)
    a_s, b_s = (_as_tuple(a), _as_tuple(b)) if a is not None else ((None,) * len(xs),) * 2
    dt = xs[0].dtype
    acts = []
    for xk, ak, bk in zip(xs, a_s, b_s):
        if ak is None:
            acts.append(xk)
            continue
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
        pk = torch.cat([p.to(dt) for p in _kernels(proj_kernel)], dim=0).float()
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
    ``proj_kernel``. ``pipelined`` concerns packed launches only (see the
    module's docstring)."""
    kw = dict(apply_silu=apply_silu, emit_stats=emit_stats, proj_kernel=proj_kernel,
              proj_bias=proj_bias, pipelined=pipelined, packed_struct=packed_struct)
    xs = _as_tuple(x)
    with span(lambda: k2_range(xs, w, proj_kernel is not None, pipelined, packed_struct)):
        if xs[0].device.type == "cpu":
            return affine_silu_conv3x3_plain(x, a, b, w, bias, residual, **kw)
        return _launch(x, a, b, w, bias, residual, **kw)


def k2_range(xs, w, proj: bool, pipelined, packed_struct: bool) -> str:
    """The range of a forward K2 launch over the operands ``xs``: "K2" and
    its modes in a fixed order, joined by "·" ("K2·N·proj", "K2·struct·pipe")."""
    cs, (bsz, h, wd) = [xk.shape[-1] for xk in xs], xs[0].shape[:3]
    pipe = pipelines(cs, bsz, h, wd, _kernels(w)[0].shape[-1], pipelined, packed_struct)
    return "·".join(["K2"] + [m for m, on in (("N", len(xs) > 1), ("proj", proj),
                                              ("struct", packed_struct), ("pipe", pipe)) if on])


def conv3x3_fast(x, w, bias, residual=None, packed_struct: bool = False):
    """3x3 stride-1 convolution with padding 1 (no affine, no SiLU: K2's
    identity prologue, which reads no coefficients) through the same
    kernel (``conv3x3_fast`` of the JAX package). Packed, a channel count
    that is not a multiple of 8 (the packed image's 12) is padded with zero
    channels, and the kernel with zero rows: the same convolution in whole
    16-byte groups (the kernel pads to its chunks of 64 itself)."""
    c = x.shape[-1]
    if packed_struct and c % 8:
        pad = 8 - c % 8
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad))
    return affine_silu_conv3x3(x, None, None, w, bias, residual, apply_silu=False,
                               packed_struct=packed_struct)


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
        with span("K3 backward", backward=True):
            x, a, b, w, y = ctx.saved_tensors
            cout = w.shape[-1]
            if dy is None:
                dy = x.new_zeros(x.shape[:3] + (cout,))
            if ds1 is not None or ds2 is not None:
                # dy' = dy + ds1 + 2 y ds2 in f32, rounded to dy's dtype, and
                # its per-channel sums for dbias in the same pass
                with span("K3 pass A (fold)", backward=True):
                    dy, dbias = k3_passes.fold(dy, y, ds1, ds2)
            else:
                dbias = dy.float().sum(dim=(0, 1, 2)) if ctx.has_bias else None
            # data gradient: the 3x3 conv of dy with the flipped, io-transposed
            # weights, through K2's identity prologue (the plain version for a
            # CPU tensor)
            with span("K3 dx (K2)", backward=True):
                ds = conv3x3_fast(dy, w.flip(0, 1).transpose(2, 3), None,
                                  packed_struct=ctx.packed_struct)
                if dy.is_cuda:
                    launch_counts["K3"] += 1
            # the chain in f32: v = x a + b, dv = ds SiLU'(v), dx = dv a, the
            # activation s = SiLU(v) for the weight gradient, the (B, C) sums
            with span("K3 pass B (chain)", backward=True):
                dx, s_x, da, db = k3_passes.chain(x, ds, a, b)
            # weight gradient: the library's conv weight-gradient of the
            # stored activation against dy, in x's dtype (f32 accumulation
            # inside), or packed the 4 products of the combined taps, kept
            # in f32 (as the JAX package's two branches)
            with span("K3 dw (library)", backward=True):
                dy_x = dy.to(x.dtype)
                if ctx.packed_struct:
                    dw = struct_wgrad(s_x, dy_x).to(w.dtype)
                else:
                    dw = torch.nn.grad.conv2d_weight(
                        s_x.permute(0, 3, 1, 2), (cout, x.shape[-1], 3, 3),
                        dy_x.permute(0, 3, 1, 2), padding=1,
                    ).permute(2, 3, 1, 0).to(w.dtype)
            dres = dy if ctx.has_res else None
            return (dx, da.to(a.dtype), db.to(b.dtype), dw, dbias if ctx.has_bias else None,
                    dres, None, None)


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


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, residual, packed_struct):
        y = conv3x3_fast(x, w, bias, residual, packed_struct=packed_struct)
        ctx.packed_struct = packed_struct
        ctx.has_bias, ctx.has_res = bias is not None, residual is not None
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        with span("K3 backward (identity prologue)", backward=True):
            x, w = ctx.saved_tensors
            cout = w.shape[-1]
            # K3's backward without its chain: dx is the 3x3 conv of dy with
            # the flipped, io-transposed weights through K2's identity
            # prologue (the plain version for a CPU tensor)
            with span("K3 dx (K2)", backward=True):
                dx = conv3x3_fast(dy, w.flip(0, 1).transpose(2, 3), None,
                                  packed_struct=ctx.packed_struct)
                if dy.is_cuda:
                    launch_counts["K3"] += 1
                    launch_counts["K3·id"] += 1
            with span("K3 dw (library)", backward=True):
                dy_x = dy.to(x.dtype)
                if ctx.packed_struct:
                    dw = struct_wgrad(x, dy_x).to(w.dtype)
                else:
                    dw = torch.nn.grad.conv2d_weight(
                        x.permute(0, 3, 1, 2), (cout, x.shape[-1], 3, 3),
                        dy_x.permute(0, 3, 1, 2), padding=1,
                    ).permute(2, 3, 1, 0).to(w.dtype)
            dbias = dy.float().sum(dim=(0, 1, 2)) if ctx.has_bias else None
            return dx, dw, dbias, dy if ctx.has_res else None, None


def conv3x3_vjp(x, w, bias, residual=None, *, packed_struct: bool = False):
    """Differentiable ``conv3x3_fast`` (K2's identity prologue): y = x ⊛ w +
    bias (+ residual), for a convolution whose input is no affine-SiLU of a
    stored tensor (the dropout ResNet's conv2, whose mask sits between the
    SiLU and the products). Its backward is K3's without the chain: dx
    through K2's identity prologue on the flipped, io-transposed weights, dw
    from the library (``struct_wgrad`` when packed), dbias the sums of dy,
    and dy itself for the residual; its launches count as K3's (and apart
    as "K3·id"). On a CPU
    tensor both directions run the plain version; on CUDA they launch K2 or
    raise (bf16 only). With ``packed_struct`` w is the (3, 3, 4C, 4Cout)
    packed kernel (``pack_conv3x3_kernel``)."""
    if packed_struct and w.shape[0] != 3:
        raise ValueError("conv3x3_vjp: the packed mode takes the (3, 3, ...) packed kernel, "
                         "whose flip gives the data gradient's")
    return _Conv3x3.apply(x, w, bias, residual, packed_struct)


def _is_shard(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, at a 16-byte aligned address (the kernels load 8 bf16
    at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_plan = functools.lru_cache(maxsize=4096)(conv_plan)
_stats_order = functools.lru_cache(maxsize=4096)(stats_order)


def _launch(x, a, b, w, bias, residual, *, apply_silu, emit_stats, proj_kernel, proj_bias,
            pipelined, packed_struct):
    xs, ws = _as_tuple(x), _kernels(w)
    x0 = xs[0]
    if not x0.is_cuda:
        raise RuntimeError(f"affine_silu_conv3x3: no kernel for device {x0.device}")
    if any(_is_shard(t) for t in tuple(xs) + tuple(ws)):
        # the kernel reads raw device pointers: a DTensor's is its local
        # shard's (FSDP gathers the whole parameter before a stage runs)
        raise TypeError("affine_silu_conv3x3: a DTensor shard; the kernel takes whole tensors")
    n = len(xs)
    if (a is None) != (b is None):
        raise ValueError("affine_silu_conv3x3: a and b are given together or not at all")
    identity = a is None
    a_s, b_s = ((None,) * n,) * 2 if identity else (_as_tuple(a), _as_tuple(b))
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
        kh = wk.shape[0] if wk.dim() == 4 else 0
        if kh not in ((3, 2) if packed_struct else (3,)) or tuple(wk.shape) != (kh, kh, c, cout):
            raise ValueError(
                f"affine_silu_conv3x3: weight {tuple(wk.shape)} for C={c}, Cout={cout}")
        if c % 8 or cout % 8:
            raise ValueError(f"affine_silu_conv3x3: C={c} and Cout={cout} must be multiples of 8")
        cs.append(c)
    pipe = pipelines(cs, bsz, h, wd, cout, pipelined, packed_struct)
    dev = x0.device
    xs = [_aligned(xk) for xk in xs]
    if identity:
        a = b = None
    else:
        a = torch.cat([ak.to(dev, torch.float32).reshape(bsz, c)
                       for ak, c in zip(a_s, cs)], dim=1).contiguous()
        b = torch.cat([bk.to(dev, torch.float32).reshape(bsz, c)
                       for bk, c in zip(b_s, cs)], dim=1).contiguous()
    pks = None if proj_kernel is None else _kernels(proj_kernel)
    if pks is not None and (len(pks) != n or any(tuple(p.shape) != (c, cout)
                                                  for p, c in zip(pks, cs))):
        raise ValueError(
            f"affine_silu_conv3x3: the kernel's shortcut takes one (C_k, {cout}) "
            f"matrix per operand, got {[tuple(p.shape) for p in pks]}"
        )
    p = _plan(bsz, h, wd, tuple(cs), cout, _sm_count(dev.index), pks is not None, packed_struct)
    plan = (p.th, p.tw, p.bn, p.mt, p.stages, p.grid)
    wt = (w.layout(dev, packed_struct) if isinstance(w, K2Weights)
          else conv_weight_layout(ws, packed_struct))
    pw = (None if pks is None else proj_kernel.layout(dev, packed_struct)
          if isinstance(proj_kernel, K2Weights) else conv_weight_layout(pks, packed_struct))
    if bias is not None:
        bias = bias.to(dev, torch.float32).contiguous()
    if residual is not None:
        if residual.shape != (bsz, h, wd, cout) or residual.dtype != x0.dtype:
            raise ValueError("affine_silu_conv3x3: residual must match y")
        residual = _aligned(residual)
    y = torch.empty((bsz, h, wd, cout), device=dev, dtype=x0.dtype)
    s1 = s2 = part = tickets = pb = proj = None
    if emit_stats:
        # written by the launch, each sum in the order of ``stats_order``:
        # nothing to fill
        s1 = torch.empty((2, bsz, cout), device=dev, dtype=torch.float32)
        s1, s2 = s1[0], s1[1]
        order = _stats_order(p, bsz, h, wd, cout)
        if order.scratch:
            part = torch.empty(order.scratch, device=dev, dtype=torch.float32)
            tickets = gn_stats.ticket_buffer(dev.index, order.tickets)
    if pks is not None:
        pb = (torch.zeros((cout,), device=dev) if proj_bias is None
              else proj_bias.to(dev, torch.float32).contiguous())
        proj = torch.empty_like(y)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    x_ptrs = (ctypes.c_void_p * n)(*[xk.data_ptr() for xk in xs])
    c_arr = (ctypes.c_int * n)(*cs)
    toff = (ctypes.c_int * 16)(*struct_tap_offsets(p.tw)) if packed_struct else None
    with torch.cuda.device(dev):  # the C side launches on the current device
        err = lib.ml_mdm_affine_silu_conv3x3(
            x_ptrs, c_arr, n, ptr(a), ptr(b), ptr(wt), ptr(bias), ptr(residual),
            ptr(pw), ptr(pb), ptr(y), ptr(proj), ptr(s1), ptr(s2), ptr(part), ptr(tickets),
            bsz, h, wd, cout, int(apply_silu), int(packed_struct), int(pipe), *plan, toff,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(
            f"affine_silu_conv3x3: CUDA error {err} at launch "
            f"(operands {[tuple(xk.shape) for xk in xs]}, Cout {cout}, "
            f"packed_struct {packed_struct}, pipelined {pipe}, plan {plan})"
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
        + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    smem = lib.ml_mdm_conv3x3_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_size_t
    return lib
