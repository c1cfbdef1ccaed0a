"""The fused conv's cost decomposition on Hopper (kernels P1 and P2).

``anatomy(x, w, variant)`` replaces the JAX package's two TPU probes of
K2: ``tools/probe_kernel_anatomy.py`` ``make`` (P1) and
``tools/probe_kernel_anatomy2.py`` ``make`` (P2). Each is a stripped copy
of K2 (``ops/fused_resnet.py``) that adds one of its features at a time,
so that its variants' times split K2's between the products, the
activation, the staging, the halo rows, the lane-parity selects of
K2·struct, the zero fill and K2·pipe's double buffer. ``P1_ROWS`` and
``P2_ROWS`` are the rows of the two probes' tables; ``VARIANTS`` the 16
that the CUDA kernel instantiates.

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

The CUDA kernel is ``csrc/kernel_anatomy.cu`` (its header says what bounds
it on the H100 and how it maps the TPU features). It is built with ``nvcc``
for ``sm_90a`` at first use into ``ml_mdm_tpu_torch/_build/`` and loaded
with ctypes. A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
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
TH, TW = 16, 8  # the kernel's tile: one band of the probes' rows, 8 columns
CHUNK = 32      # input channels per reduction chunk
SCALE, OFFSET = 1.01, 0.02  # the probes' affine


class Variant(NamedTuple):
    """One variant of the two probes (the CUDA kernel's template flags)."""
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
    H a multiple of 16, W of 8, C of 32) or an error."""
    if x.device.type == "cpu":
        return anatomy_plain(x, w, v)
    return _launch(x, w, v)


def _launch(x, w, v: Variant):
    if not x.is_cuda:
        raise RuntimeError(f"kernel_anatomy: no kernel for device {x.device}")
    if v not in VARIANTS:
        raise ValueError(f"kernel_anatomy: {v} is not one of the probes' rows")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"kernel_anatomy: the CUDA kernel takes (B, H, W, C) bf16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    bsz, h, wd, c = x.shape
    if h % TH or wd % TW or c % CHUNK:
        raise ValueError(f"kernel_anatomy: H={h}, W={wd}, C={c} must be multiples of "
                         f"{TH}, {TW} and {CHUNK}")
    x = fused_resnet._aligned(x)
    n = v.n_taps
    if n:
        if tuple(w.shape) != (n, c, c):
            raise ValueError(f"kernel_anatomy: weights {tuple(w.shape)} for {n} taps of C={c}")
        # (n, C in, C out) -> (C out, n, C in); with selects each chunk of 32
        # input channels in the kernel's parity-class order (channel i*4 +
        # code at code*8 + i)
        wt = w.to(x.device, torch.bfloat16).permute(2, 0, 1)
        if v.selects:
            wt = wt.reshape(c, n, c // CHUNK, CHUNK // 4, 4).transpose(-1, -2)
        wt = wt.reshape(c, n * c).contiguous()
    else:
        wt = x  # not read
    y = torch.empty_like(x)
    flags = (ctypes.c_int * 9)(*(int(f) for f in v))
    with torch.cuda.device(x.device):
        err = load_library().ml_mdm_kernel_anatomy(
            flags, ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wt.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), bsz, h, wd, c,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"kernel_anatomy: CUDA error {err} at launch ({v}, x {tuple(x.shape)})")
    launch_counts[f"P{v.probe}"] += 1
    return y


def build_library() -> Path:
    """Compile ``csrc/kernel_anatomy.cu`` for sm_90a (``ops/cuda_build.py``).
    Returns the shared library's path; ``<path>.log`` keeps nvcc's output."""
    return cuda_build.build_library("kernel_anatomy")


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ml_mdm_kernel_anatomy
    fn.argtypes = ([ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
