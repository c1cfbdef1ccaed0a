"""The fused conv's cost decomposition on Hopper (kernels P1 and P2).

``anatomy(x, w, variant)`` replaces the JAX package's two TPU probes of
K2: ``tools/probe_kernel_anatomy.py`` ``make`` (P1) and
``tools/probe_kernel_anatomy2.py`` ``make`` (P2). Each variant is K2's own
kernel (``ops/fused_resnet.py``, ``conv3x3_wgmma_kernel``) with some of its
features switched off, so that the variants' times split K2's between the
products, the register pass, the affine, SiLU, the halo rows, the
lane-parity selects of K2·struct, the zero fill and the staging of the
next chunk under the products (K2·pipe's overlap). ``P1_ROWS`` and
``P2_ROWS`` are the rows of the two probes' tables; ``VARIANTS`` their 16
variants.

What a variant computes (``anatomy_plain``; the kernel equals it on every
cell). x is (B, H, W, C) bf16, w the taps' (n, C, C) bf16 matrices,
act(v) = bf16(silu(v * 1.01 + 0.02)) in f32 (without SiLU when ``silu``
is off); products accumulate in f32 and round once to bf16.

- P1: y = sum over t < n of src @ w[t], with src = act(x) when ``act``
  and x otherwise. Every tap multiplies the same tile: there is no
  spatial shift. n = 0 gives y = src.
- P2: act(x), staged per band of ``TH`` = 16 rows (the probe's row block)
  with one padding row above and below and one padding column each side.
  Without ``selects`` tap t reads the row shifted by t % 3 - 1 (above,
  centre, below, above) at the centre column; with ``selects`` the four
  lane-parity buffers of K2·struct (``fused_resnet._struct_buffers``: the
  centre, its column select, the row select and its column select; bit 1
  of the channel picks above over below, bit 0 left over right). With
  ``halos`` the padding rows are the neighbouring image rows, clamped at the
  image's top and bottom edges as the probe clamps them; without, taps read
  nothing across a band. Every padding cell that is not loaded from the
  image holds act(0), the activation of a zero-filled load, or 0 with
  ``zero`` (K2's rule). ``dbuf`` does not change y.

The TPU probes leave some cells undefined (scratch that is never written:
the band's padding rows without halos, the right padding column always, the
left one without the zero fill) and their double buffer reads the block
that the previous grid step wrote, so its output lags one block. The port
defines those cells as above, and its double buffer (chunks of channels in
flight inside one block, as K2·pipe) keeps y bitwise the single buffer's.

The CUDA kernel: ``csrc/kernel_anatomy.cu`` instantiates
``csrc/conv3x3_wgmma.cuh``, the source K2 runs from, with the switches its
header lists (what bounds it on the H100, and how the TPU features map onto
K2's, are said there). The host hands each launch what ``probe_plan``
(K2's tile at the probes' shape, TH a divisor of the band),
``kernel_flags`` (the switches), ``tap_offsets`` (the taps' staged offsets)
and ``weight_layout`` (K2's weight layout, in parity-class order with
selects) give. It is built with ``nvcc`` for ``sm_90a`` at first use into
``ml_mdm_tpu_torch/_build/`` and loaded with ctypes. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. On the card H
is a multiple of 16 and C of 8.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ml_mdm_tpu_torch.ops import cuda_build, fused_resnet

# launches of the CUDA kernel since the counts were last set to 0, by probe
launch_counts = {"P1": 0, "P2": 0}
TH = 16  # P2's band of rows (the TPU probes' row block)
SCALE, OFFSET = 1.01, 0.02  # the probes' affine
# the probes' instance of K2: N tile 128, two m64 tiles a warpgroup (K2's
# plan at the probes' shape, B = 4, 512^2, 128 -> 128)
BN, MT = 128, 2
# the kernel's switches (``csrc/conv3x3_wgmma.cuh``, PROBE_*); bits 8 and up
# hold the taps
ON, NO_HALO, BANDS, HALOS, FILL_ACT, DIRECT, SERIAL = 1, 2, 4, 8, 16, 32, 64


class Variant(NamedTuple):
    """One variant of the two probes (what ``kernel_flags`` maps onto K2's
    switches)."""
    probe: int
    n_taps: int
    act: bool
    silu: bool
    stage: bool
    halos: bool
    selects: bool
    zero: bool
    dbuf: bool


def p1_variant(n_taps: int, do_act: bool, silu: bool, via_scratch: bool) -> Variant:
    """P1's variant for the JAX probe's ``make`` arguments: the activation
    always goes through scratch, and SiLU only with it."""
    return Variant(1, n_taps, do_act, do_act and silu, do_act or via_scratch,
                   False, False, False, False)


def p2_variant(halos: bool, selects: bool, when_zero: bool, dbuf: bool,
               n_taps: int = 4) -> Variant:
    """P2's variant for the JAX probe's ``make`` arguments: always the
    activation with SiLU, staged."""
    return Variant(2, n_taps, True, True, True, halos, selects, when_zero, dbuf)


# the rows of the JAX probes' tables (their ``__main__``), label and make()'s arguments
P1_ROWS = (
    ("dots direct from input block", dict(n_taps=9)),
    ("dots direct, 4 taps", dict(n_taps=4)),
    ("dots direct, 1 tap", dict(n_taps=1)),
    ("copy->scratch + 9 dots", dict(n_taps=9, via_scratch=True)),
    ("act->scratch + 9 dots", dict(n_taps=9, do_act=True)),
    ("act+silu->scratch + 9 dots", dict(n_taps=9, do_act=True, silu=True)),
    ("act+silu->scratch + 4 dots", dict(n_taps=4, do_act=True, silu=True)),
    ("act+silu only (0 dots)", dict(n_taps=0, do_act=True, silu=True)),
    ("pure copy through scratch", dict(n_taps=0, via_scratch=True)),
)
_P2_BASE = dict(halos=False, selects=False, when_zero=False, dbuf=False)
P2_ROWS = (
    ("base: 4 dots, single buf", _P2_BASE),
    ("+halos", {**_P2_BASE, "halos": True}),
    ("+selects", {**_P2_BASE, "selects": True}),
    ("+when_zero", {**_P2_BASE, "when_zero": True}),
    ("+dbuf", {**_P2_BASE, "dbuf": True}),
    ("halos+selects", {**_P2_BASE, "halos": True, "selects": True}),
    ("ALL (the real kernel's shape)",
     dict(halos=True, selects=True, when_zero=True, dbuf=True)),
)


def p1_args(kw: dict) -> dict:
    """A P1 row's arguments with make()'s defaults filled in."""
    return dict(dict(do_act=False, silu=False, via_scratch=False), **kw)


VARIANTS = (tuple(p1_variant(**p1_args(kw)) for _, kw in P1_ROWS)
            + tuple(p2_variant(**kw) for _, kw in P2_ROWS))


def reset_launch_counts() -> None:
    for probe in launch_counts:
        launch_counts[probe] = 0


def _act(x: torch.Tensor, v: Variant) -> torch.Tensor:
    if not v.act:
        return x
    u = x.float() * SCALE + OFFSET
    if v.silu:
        u = F.silu(u)
    return u.to(x.dtype)


def _p2_taps(src: torch.Tensor, v: Variant):
    """P2's n tap operands, f32 (B * H * W, C) each: the activated image
    per band, padded as the module docstring says, then row-shifted or
    parity-selected."""
    b, h, wd, c = src.shape
    nb = h // TH
    fill = 0.0 if v.zero else float(_act(torch.zeros((), dtype=src.dtype), v).float())
    s = src.float().reshape(b, nb, TH, wd, c)
    if v.halos:
        band = torch.arange(nb, device=src.device) * TH
        top = src[:, (band - 1).clamp(min=0)].float()
        bottom = src[:, (band + TH).clamp(max=h - 1)].float()
    else:
        top = bottom = torch.full((b, nb, wd, c), fill, device=src.device)
    s = torch.cat([top[:, :, None], s, bottom[:, :, None]], dim=2)
    s = F.pad(s, (0, 0, 1, 1), value=fill)  # (B, nb, TH + 2, W + 2, C)
    if v.selects:
        lane = torch.arange(c, device=src.device)
        ei, ej = ((lane >> 1) & 1).bool(), (lane & 1).bool()
        buf_b = torch.where(ei, s[:, :, 0:TH], s[:, :, 2:TH + 2])
        taps = []
        for buf in (s[:, :, 1:TH + 1], buf_b):
            taps += [buf[:, :, :, 1:wd + 1],
                     torch.where(ej, buf[:, :, :, 0:wd], buf[:, :, :, 2:wd + 2])]
    else:
        taps = [s[:, :, t % 3:t % 3 + TH, 1:wd + 1] for t in range(v.n_taps)]
    return [t.reshape(-1, c) for t in taps]


def fill_cells(v: Variant, h: int, w: int) -> torch.Tensor:
    """The (H, W) output pixels whose products read a padding cell that is
    not loaded from the image: the only pixels where ``zero`` can change y.
    Without halos the first and last row of every band of ``TH``; with
    selects the first and last column. P1 has none."""
    band = torch.zeros((TH, w), dtype=torch.bool)
    if v.probe == 2 and not v.halos:
        band[[0, TH - 1]] = True
    if v.probe == 2 and v.selects:
        band[:, [0, w - 1]] = True
    return band.repeat(h // TH, 1)


def anatomy_plain(x: torch.Tensor, w: torch.Tensor, v: Variant) -> torch.Tensor:
    """Plain PyTorch version of one probe variant (the module docstring):
    x (B, H, W, C), w (n, C, C) (unread with 0 taps), y (B, H, W, C) in
    x's dtype."""
    src = _act(x, v)
    if v.n_taps == 0:
        return src.clone()
    c = x.shape[-1]
    taps = ([src.float().reshape(-1, c)] * v.n_taps if v.probe == 1 else _p2_taps(src, v))
    wf = w.to(x.dtype).float()
    y = sum(t @ wf[i] for i, t in enumerate(taps))
    return y.to(x.dtype).reshape(x.shape)


def anatomy(x: torch.Tensor, w: torch.Tensor, v: Variant) -> torch.Tensor:
    """Same contract as ``anatomy_plain``: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (bf16, one of ``VARIANTS``,
    H a multiple of 16 and C of 8) or an error."""
    if x.device.type == "cpu":
        return anatomy_plain(x, w, v)
    return _launch(x, w, v)


# -- what the host hands the kernel --------------------------------------------


class ProbePlan(NamedTuple):
    """A probe launch on K2's instance <BN, MT>: tiles of ``th`` x ``tw``
    output pixels, a weight ring of ``stages`` slots, ``smem`` dynamic
    shared-memory bytes, ``grid`` persistent blocks over ``tiles`` output
    tiles."""
    th: int
    tw: int
    stages: int
    smem: int
    grid: int
    tiles: int


def probe_plan(bsz: int, h: int, w: int, c: int, n_taps: int = 1,
               sms: int = fused_resnet.H100_SMS) -> ProbePlan:
    """K2's plan (``fused_resnet.conv_plan``) for the probes' instance: TW =
    min(W, 32), TH = min(128 MT / TW, H, 32) cut to the largest divisor of
    the band ``TH`` (so that no tile straddles two bands; at the probes'
    shape it is conv_plan's 8 x 32), the ring as deep as fits, one
    persistent block an SM. With 0 taps one N tile a pixel tile (its chunks
    are y's channels)."""
    tw = min(w, 32)
    th = max(1, min(128 * MT // tw, h, 32))
    th = 1 << (min(th, TH).bit_length() - 1)
    stages = min(fused_resnet.MAX_STAGES,
                 (fused_resnet.SMEM_LIMIT - fused_resnet.smem_bytes(BN, th, tw, 0))
                 // (BN * 128 + 16))
    tiles = bsz * -(-h // th) * -(-w // tw) * (-(-c // BN) if n_taps else 1)
    return ProbePlan(th, tw, stages, fused_resnet.smem_bytes(BN, th, tw, stages),
                     min(tiles, sms), tiles)


def kernel_flags(v: Variant) -> int:
    """The variant's switches on K2's kernel (``csrc/conv3x3_wgmma.cuh``):
    its taps; P1 without the halo, P2 over bands, with the clamped halo rows
    (``halos``) and act(0) in the cells not loaded (unless ``zero``);
    ``DIRECT`` without the staging; ``SERIAL`` without the double buffer.
    Selects are K2's packed mode; act and SiLU its run-time coefficients and
    ``apply_silu``."""
    f = ON | v.n_taps << 8
    if v.probe == 1:
        f |= NO_HALO
    else:
        f |= BANDS | (HALOS if v.halos else 0) | (0 if v.zero else FILL_ACT)
    if not v.stage:
        f |= DIRECT
    if not v.dbuf:
        f |= SERIAL
    return f


def tap_offsets(v: Variant, tw: int) -> tuple:
    """The 16 staged offsets the kernel reads its taps at, from the tile's
    output pixel 0 in a staged row of TW (+ 2 with the halo) pixels: P1's
    at 0 (the tile without halo), P2's tap t at [t], row t % 3 (the row
    shifted by t % 3 - 1) of the centre column; with selects K2·struct's
    (``fused_resnet.struct_tap_offsets``), combined tap t's k-step ks at
    [4 t + ks]."""
    if v.selects:
        return fused_resnet.struct_tap_offsets(tw)
    offs = [0 if v.probe == 1 else (t % 3) * (tw + 2) + 1 for t in range(v.n_taps)]
    return tuple(offs) + (0,) * (16 - len(offs))


def weight_layout(w: torch.Tensor, v: Variant) -> torch.Tensor:
    """The taps' (n, C, C) matrices in K2's layout (``fused_resnet.
    conv_weight_layout`` of n taps of one operand: (chunk of 64, tap, C
    padded to 64, 64) swizzled; with selects each chunk's channels in
    parity-class order, channel 4 i + code at position 16 code + i)."""
    return fused_resnet.conv_weight_layout((w[None],), packed=v.selects)


def _launch(x, w, v: Variant):
    if not x.is_cuda:
        raise RuntimeError(f"kernel_anatomy: no kernel for device {x.device}")
    if v not in VARIANTS:
        raise ValueError(f"kernel_anatomy: {v} is not one of the probes' rows")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"kernel_anatomy: the CUDA kernel takes (B, H, W, C) bf16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    bsz, h, wd, c = x.shape
    if h % TH or c % 8:
        raise ValueError(f"kernel_anatomy: H={h} must be a multiple of {TH} (P2's band) and "
                         f"C={c} of 8")
    x = fused_resnet._aligned(x)
    dev, n = x.device, v.n_taps
    if n and tuple(w.shape) != (n, c, c):
        raise ValueError(f"kernel_anatomy: weights {tuple(w.shape)} for {n} taps of C={c}")
    wt = weight_layout(w.to(dev, torch.bfloat16), v) if n else None
    a = b = None
    if v.act:
        a = torch.full((bsz, c), SCALE, device=dev)
        b = torch.full((bsz, c), OFFSET, device=dev)
    p = probe_plan(bsz, h, wd, c, n, fused_resnet._sm_count(dev.index))
    toff = (ctypes.c_int * 16)(*tap_offsets(v, p.tw))
    y = torch.empty_like(x)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    with torch.cuda.device(dev):
        err = load_library().ml_mdm_kernel_anatomy(
            kernel_flags(v), int(v.selects), ptr(x), ptr(a), ptr(b), ptr(wt), ptr(y),
            bsz, h, wd, c, int(v.silu), p.th, p.tw, p.stages, p.grid, toff,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"kernel_anatomy: CUDA error {err} at launch ({v}, x {tuple(x.shape)}, "
                           f"plan {p})")
    launch_counts[f"P{v.probe}"] += 1
    return y


def build_library() -> Path:
    """Compile ``csrc/kernel_anatomy.cu`` (with K2's ``conv3x3_wgmma.cuh``)
    for sm_90a (``ops/cuda_build.py``). Returns the shared library's path;
    ``<path>.log`` keeps nvcc's output."""
    return cuda_build.build_library("kernel_anatomy")


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ml_mdm_kernel_anatomy
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
