"""Attention of the port (``ml_mdm_tpu/ops/attention.py``).

Numerics follow the JAX functions: q and k are each scaled by d^-1/4,
masked keys get -inf, and the softmax runs in f32.

Two routes, chosen as ``dot_product_attention`` of the JAX package chooses:

- the matmul route (default; JAX's ``_einsum_attention``): two
  ``torch.matmul`` calls around an f32 softmax, the logits stored in bf16
  under bf16 compute (``perf().bf16_logits``). The JAX main path computes
  this product outside any Pallas kernel, so the port leaves it to the
  library. Every masked call takes it, so the text cross-attention does.
- the flash route (``use_flash(True)`` or ``ML_MDM_TPU_FLASH=1``): an
  unmasked call whose lengths are multiples of 128 goes through
  ``flash_attention``, kernel K4, which replaces the JAX package's Pallas
  ``flash_attention`` (and stands where its flag routes to JAX's library
  kernel on a TPU). The kernel is ``csrc/flash_attention.cu`` (its header
  says what bounds it on the H100 and how it is laid out), built with
  ``nvcc`` for ``sm_90a`` at first use and loaded with ctypes. A CPU tensor
  takes the plain version ``reference_flash_attention``; a CUDA tensor
  launches the kernel or raises. It differs from the matmul route by
  design: S stays in f32 and only P is rounded to bf16, where the matmul
  route rounds the logits and the weights.

K4 is forward only, as the JAX kernel is (no ``custom_vjp`` around it):
with the flash route on, a call whose inputs require a gradient raises
``NotImplementedError``; it does not drop to the matmul route on its own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ml_mdm_tpu_torch.ops import cuda_build
from ml_mdm_tpu_torch.perf import perf

# launches of the CUDA kernel since the count was last set to 0
launch_count = 0

_FLASH_OVERRIDE: Optional[bool] = None


def use_flash(enabled: Optional[bool]) -> None:
    """Force the flash route on or off; None gives the choice back to the
    environment (``ML_MDM_TPU_FLASH``)."""
    global _FLASH_OVERRIDE
    _FLASH_OVERRIDE = None if enabled is None else bool(enabled)


def _use_flash() -> bool:
    if _FLASH_OVERRIDE is not None:
        return _FLASH_OVERRIDE
    return perf().flash


def _flash_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX shape rule (Lq and Lk multiples of 128, D <= 256); on CUDA
    also what the kernel takes: bf16, D a multiple of 16 up to 128 (its
    output accumulator is D/2 f32 registers a thread; wider heads would
    need another tiling, and no shipped model has them)."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[-1]
    if lq % 128 or lk % 128 or d > 256:
        return False
    if q.is_cuda:
        return q.dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
    return True


def matmul_attention(q, k, v, mask=None):
    """The matmul route: q (B, Lq, H, D), k/v (B, Lk, H, D), mask (B, Lk) or
    None -> (B, Lq, H, D)."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    qh = (q * scale).transpose(1, 2)  # (B, H, Lq, D)
    kh = (k * scale).transpose(1, 2)
    if q.dtype == torch.bfloat16 and not perf().bf16_logits:
        qh, kh = qh.float(), kh.float()  # bf16 products are exact in f32
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # (B, H, Lq, Lk)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
    weights = torch.softmax(logits, dim=-1, dtype=torch.float32).to(v.dtype)
    return torch.matmul(weights, v.transpose(1, 2)).transpose(1, 2)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D), mask: (B, Lk) or None
    -> (B, Lq, H, D)."""
    if _use_flash() and mask is None and _flash_supported(q, k):
        return flash_attention(q, k, v)
    return matmul_attention(q, k, v, mask)


def reference_flash_attention(q, k, v):
    """Plain PyTorch version of K4: everything upcast to f32, q and k each
    scaled by d^-1/4, f32 softmax, f32 second product, output in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    qh = (q.float() * scale).transpose(1, 2)
    kh = (k.float() * scale).transpose(1, 2)
    weights = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)), dim=-1)
    return torch.matmul(weights, v.float().transpose(1, 2)).transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v):
    """Blocked online-softmax attention without a mask (kernel K4): q
    (B, Lq, H, D), k/v (B, Lk, H, D) -> (B, Lq, H, D) in q's dtype. The
    operands may be strided views (the chunks of one qkv tensor)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward (the JAX kernel has none either): turn the "
            "flash route off (use_flash(False)) to differentiate through attention"
        )
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v)
    if not q.is_cuda:
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v)


def _addressable(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel's tensor maps can address it: the last axis
    contiguous, the other strides positive multiples of 8 elements (TMA
    takes strides in multiples of 16 bytes) and the base 16-byte aligned.
    The model's views are; anything else is copied."""
    if t.stride(-1) != 1 or any(s % 8 or s <= 0 for s in t.stride()[:-1]):
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v):
    global launch_count
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected (B, L, H, D) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bsz, lq, heads, d = q.shape
    lk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (bsz, heads, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head width")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: the CUDA kernel takes bf16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: operands on different devices")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash_attention: the CUDA kernel takes D a multiple of 16 up to "
                         f"128, got {d}")
    if 0 in (bsz, lq, lk, heads):
        raise ValueError(f"flash_attention: empty operands {tuple(q.shape)}, {tuple(k.shape)}")
    lib = load_library()
    q, k, v = (_addressable(t) for t in (q, k, v))
    out = torch.empty((bsz, lq, heads, d), device=q.device, dtype=q.dtype)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):  # the C side launches on the current device
        err = lib.ml_mdm_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, lq, lk, heads, d, *strides, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err == -1:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused the operands "
                           f"(q {tuple(q.shape)} strides {q.stride()}, k {tuple(k.shape)} "
                           f"strides {k.stride()}, v strides {v.stride()})")
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)})")
    launch_count += 1
    return out


def build_library():
    """Compile ``csrc/flash_attention.cu`` for sm_90a (``ops/cuda_build.py``).
    Returns the shared library's path; ``<path>.log`` keeps nvcc's output."""
    return cuda_build.build_library("flash_attention")


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ml_mdm_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
