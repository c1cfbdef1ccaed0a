"""Space-to-depth execution of the thin shells' 3x3 convolutions
(``ml_mdm_tpu/ops/space_to_depth.py``), in PyTorch.

Folding each 2x2 block of pixels into channels ((B, H, W, C) ->
(B, H/2, W/2, 4C)) and rewriting each stride-1 3x3 convolution with an
equivalent sparse (3, 3, 4C, 4Cout) kernel computes the same function on a
quarter of the pixels with four times the channels. On the H100 the thin
shells of the nested models (32 channels at 512-1024px) fill only half of
K2's 64-channel output tile; packed they run at 128 channels.

The packed channel order is c*4 + di*2 + dj (c-major), so that GroupNorm
groups stay contiguous (group [c0, c1) -> [4c0, 4c1)) and packed GroupNorm
statistics are the unpacked ones, and per-channel vectors (biases, FiLM
and GroupNorm scales) pack as a 4x repeat.

Kernel transform: an output pixel at row y = 2i + di reads rows y + dy,
dy in {-1, 0, 1}; that row lives in packed cell i + ky at sub-row ei, with
dy = 2ky + ei - di, so

    W_packed[ky+1, kx+1, cin*4 + ei*2+ej, cout*4 + di*2+dj] = W[dy+1, dx+1, cin, cout]

and 0 elsewhere. Kernels are HWIO, as in the JAX package. Every transform
is one static gather of the kernel's taps (and a zero tap) by an index built
once, then ``permute``, so autograd carries a packed kernel's gradient back
to the unpacked parameter; each convolution also takes its transformed
kernel ready-made (``pk``), which sampling keeps from step to step
(``models/layers.py`` ``cached_weights``). The convolutions
here are the library's (``F.conv2d``), as the JAX package leaves them to
XLA, except ``packed_conv(fast=True)`` and ``packed_upsample_conv(fast=True)``
(sampling), which run through K2 (``ops/fused_resnet.py`` ``conv3x3_fast``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order c*4 + di*2 + dj."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """Inverse of ``space_to_depth``."""
    b, hh, ww, c4 = y.shape
    c = c4 // 4
    y = y.reshape(b, hh, ww, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(b, hh * 2, ww * 2, c)


def _tap_index(rows):
    """Index of each (dy, dx) tap of ``rows`` (lists of pairs) into a 3x3
    kernel's 9 taps followed by one zero tap (dy or dx outside [-1, 1])."""
    return np.array([[9 if max(abs(dy), abs(dx)) > 1 else (dy + 1) * 3 + dx + 1
                      for dy, dx in row] for row in rows])


@functools.lru_cache(maxsize=None)
def _index_on(name: str, device: torch.device) -> torch.Tensor:
    """The static gather index of a transform, on ``device`` (copied there
    once)."""
    return torch.from_numpy(_INDEX[name]).to(device)


def _gather_taps(kernel: torch.Tensor, name: str) -> torch.Tensor:
    """The (Cin, Cout) taps of a (3, 3, Cin, Cout) kernel picked by the
    static index ``name``: one gather, so the transform costs a few launches
    and autograd scatters its gradient back."""
    _, _, cin, cout = kernel.shape
    taps = torch.cat([kernel.reshape(9, cin, cout), kernel.new_zeros((1, cin, cout))])
    return taps[_index_on(name, kernel.device)]


# for each transform, (ky, kx) rows of (ei, ej[, di, dj]) picks, flattened
_INDEX = {
    "pack": _tap_index(
        [[(2 * ky + ei - di, 2 * kx + ej - dj)
          for ei in (0, 1) for ej in (0, 1) for di in (0, 1) for dj in (0, 1)]
         for ky in (-1, 0, 1) for kx in (-1, 0, 1)]).reshape(3, 3, 2, 2, 2, 2),
    "strided": _tap_index(
        [[(2 * ky + ei, 2 * kx + ej) for ei in (0, 1) for ej in (0, 1)]
         for ky in (-1, 0) for kx in (-1, 0)]).reshape(2, 2, 2, 2),
    "p2p": _tap_index(
        [[(2 * (ky - di) + ei, 2 * (kx - dj) + ej)
          for ei in (0, 1) for ej in (0, 1) for di in (0, 1) for dj in (0, 1)]
         for ky in (-1, 0, 1) for kx in (-1, 0, 1)]).reshape(3, 3, 2, 2, 2, 2),
}


def pack_conv3x3_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO -> the (3, 3, 4Cin, 4Cout) packed equivalent."""
    _, _, cin, cout = kernel.shape
    t = _gather_taps(kernel, "pack")  # (ky, kx, ei, ej, di, dj, cin, cout)
    # -> (ky, kx, cin, ei, ej, cout, di, dj): row cin*4 + ei*2+ej, column cout*4 + di*2+dj
    return t.permute(0, 1, 6, 2, 3, 7, 4, 5).reshape(3, 3, 4 * cin, 4 * cout)


def pack_conv1x1_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(1, 1, Cin, Cout) -> (1, 1, 4Cin, 4Cout): block-diagonal over the
    sub-positions (a 1x1 convolution never crosses pixels)."""
    _, _, cin, cout = kernel.shape
    eye = torch.eye(4, dtype=kernel.dtype, device=kernel.device)
    return torch.einsum("io,ab->iaob", kernel[0, 0], eye).reshape(1, 1, 4 * cin, 4 * cout)


def pack_channel_vector(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A per-channel vector (bias, FiLM or GroupNorm scale) -> packed."""
    return None if v is None else v.repeat_interleave(4, dim=-1)


def _conv_nhwc(x: torch.Tensor, k: torch.Tensor, stride: int = 1,
               padding=(1, 1, 1, 1)) -> torch.Tensor:
    """The library convolution of an NHWC x with an HWIO kernel cast to x's
    dtype; ``padding`` is (left, right, top, bottom) of the spatial axes."""
    xc = F.pad(x.permute(0, 3, 1, 2), padding)
    y = F.conv2d(xc, k.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


def packed_conv(x_packed: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None, fast: bool = False,
                pk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 3x3 (or 1x1) convolution on the packed tensor. ``kernel`` is the
    unpacked HWIO kernel, transformed here unless ``pk`` gives the packed
    form. With ``fast`` a 3x3 convolution runs through K2's packed mode
    (``conv3x3_fast(..., packed_struct=True)``), whose ``pk`` may also be
    the combined (2, 2, ...) form; a ``pk`` must come from
    ``pack_conv3x3_kernel`` of this kernel, since that mode relies on the
    packed kernel's zero pattern."""
    if kernel.shape[0] == 1:
        pk = pack_conv1x1_kernel(kernel) if pk is None else pk
        return _add_bias(_conv_nhwc(x_packed, pk, padding=(0, 0, 0, 0)),
                         pack_channel_vector(bias))
    pk = pack_conv3x3_kernel(kernel) if pk is None else pk
    if fast:
        from ml_mdm_tpu_torch.ops.fused_resnet import conv3x3_fast

        return conv3x3_fast(x_packed, pk, pack_channel_vector(bias), packed_struct=True)
    return _add_bias(_conv_nhwc(x_packed, pk), pack_channel_vector(bias))


def pack_strided_conv_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """A stride-2 3x3 convolution (padding 1) on the packed input:
    (3, 3, Cin, Cout) -> (2, 2, 4Cin, Cout). Its output lands on the packed
    grid (stride 1 there), channels unpacked: the source pixel of
    out(i, j)'s tap (dy, dx) sits in packed cell (i+ky, j+kx) at sub-position
    (ei, ej) with dy = 2ky + ei, so only ky, kx in {-1, 0} contribute."""
    _, _, cin, cout = kernel.shape
    t = _gather_taps(kernel, "strided")  # (ky, kx, ei, ej, cin, cout)
    return t.permute(0, 1, 4, 2, 3, 5).reshape(2, 2, 4 * cin, cout)


def packed_strided_conv(x_packed: torch.Tensor, kernel: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        pk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Downsample convolution on the packed tensor: (B, S/2, S/2, 4Cin) ->
    (B, S/2, S/2, Cout), the stride-2 3x3 convolution of the (B, S, S, Cin)
    image. ``pk``: ``pack_strided_conv_kernel(kernel)`` made beforehand."""
    pk = pack_strided_conv_kernel(kernel) if pk is None else pk
    return _add_bias(_conv_nhwc(x_packed, pk, padding=(1, 0, 1, 0)), bias)


def upsample_fold_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The packed upsample convolution's kernel: ``pack_conv3x3_kernel``
    summed over the input sub-positions, (3, 3, Cin, 4Cout)."""
    pk = pack_conv3x3_kernel(kernel)
    kh, kw, cin4, cout4 = pk.shape
    return pk.reshape(kh, kw, cin4 // 4, 4, cout4).sum(dim=3)


def packed_upsample_conv(x: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, in_packed: bool = False,
                         out_packed: bool = False, fast: bool = False,
                         pk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest-2x upsample then 3x3 convolution, computed packed: x (B, S, S,
    C) -> (B, 2S, 2S, Cout). The upsampled image packed on the S grid is x
    with each channel repeated 4 times, and a convolution of a repeated input
    is one of x with the kernel summed over the repeats, so the 4x-wide
    tensor is never built. ``in_packed``: x is (B, S/2, S/2, 4C), the packed
    S-side image. ``out_packed``: return the 2S-side image packed on the S
    grid, (B, S, S, 4Cout). ``fast`` runs the convolution through K2.
    ``pk``: ``upsample_fold_kernel(kernel)`` made beforehand."""
    if in_packed:
        x = depth_to_space(x)
    pk = upsample_fold_kernel(kernel) if pk is None else pk
    pb = pack_channel_vector(bias)
    if fast:
        from ml_mdm_tpu_torch.ops.fused_resnet import conv3x3_fast

        y = conv3x3_fast(x, pk, pb)
    else:
        y = _add_bias(_conv_nhwc(x, pk), pb)
    return y if out_packed else depth_to_space(y)


def pack_strided_conv_kernel_p2p(kernel: torch.Tensor) -> torch.Tensor:
    """A stride-2 3x3 convolution, packed in and packed out: (3, 3, Cin,
    Cout) -> (3, 3, 4Cin, 4Cout), applied with stride 2 on the packed grid.
    Output cell i holds downsampled rows I in {2i, 2i+1}; the source row
    4i + 2di + dy lives in input cell 2i + ky at sub-row ei with
    dy = 2(ky - di) + ei."""
    _, _, cin, cout = kernel.shape
    t = _gather_taps(kernel, "p2p")  # (ky, kx, ei, ej, di, dj, cin, cout)
    return t.permute(0, 1, 6, 2, 3, 7, 4, 5).reshape(3, 3, 4 * cin, 4 * cout)


def packed_strided_conv_p2p(x_packed: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            pk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Downsample convolution, packed to packed: (B, S/2, S/2, 4Cin) ->
    (B, S/4, S/4, 4Cout), the packed stride-2 3x3 convolution of the
    (B, S, S, Cin) image. ``pk``: ``pack_strided_conv_kernel_p2p(kernel)``
    made beforehand."""
    pk = pack_strided_conv_kernel_p2p(kernel) if pk is None else pk
    return _add_bias(_conv_nhwc(x_packed, pk, stride=2), pack_channel_vector(bias))
