"""Image resize with ``jax.image.resize``'s numbers (``cubic`` and
``bilinear``), for the nested pipeline's low-resolution residual and the
``output_inner`` panes.

``jax.image.resize(..., "cubic")`` is Keys' cubic convolution with
a = -0.5, on half-pixel centres; it drops the taps that fall outside the
image and renormalises the rest, and widens the kernel by the scale when
it shrinks an image (antialiasing). ``torch.nn.functional.interpolate``'s
bicubic uses a = -0.75 and clamps taps to the edge, so it gives other
numbers. Here each spatial axis gets the separable (in, out) weight matrix
of JAX's definition, built in numpy, and the image is contracted with it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "bilinear": _triangle}


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) f32 matrix W with resized = W^T @ signal along
    one axis, as ``jax.image.resize`` builds it (antialiased)."""
    kernel = _KERNELS[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_nhwc(x: torch.Tensor, height: int, width: int, method: str) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) in x's dtype."""
    wh = torch.from_numpy(resize_weights(x.shape[1], height, method)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weights(x.shape[2], width, method)).to(x.device, x.dtype)
    y = torch.einsum("bhwc,hp->bpwc", x, wh)
    return torch.einsum("bpwc,wq->bpqc", y, ww)
