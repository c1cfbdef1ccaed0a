"""Attention of the port (``ml_mdm_tpu/ops/attention.py``).

Numerics follow the JAX functions: q and k are each scaled by d^-1/4,
masked keys get -inf, and the softmax runs in f32.

Two routes, chosen as ``dot_product_attention`` of the JAX package chooses:

- the matmul route (default; JAX's ``_einsum_attention``): two
  ``torch.matmul`` calls around an f32 softmax, the logits stored in bf16
  under bf16 compute (``perf().bf16_logits``), the weights normalised and
  rounded to the compute dtype before the second product. The JAX main
  path computes this product outside any Pallas kernel. Every masked call
  takes it, so the text cross-attention does. On the card, a 2-D
  ``SelfAttention`` whose operands are bf16 and need no gradient (every
  sampling path) computes this route's math for both its branches, self
  and text, in one launch of kernel K6 (``self_and_text_attention``): the
  logits stay in the kernel's shared memory and never reach device
  memory. K6 is in ``csrc/flash_attention.cu`` beside K4; its header there
  says how it keeps the route's definition. Training, the CPU, f32 and
  ``UNet.use_kernels(False)`` keep the two ``matmul_attention`` calls and
  their sum, op for op.
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
  route rounds the logits and the weights. Where K6 serves a layer with
  the flash route on, the self branch stays on K4 and K6 takes the text
  branch alone, adding K4's output to it.

K4 and K6 are forward only, as the JAX kernel is (no ``custom_vjp`` around
it): with the flash route on, a call whose inputs require a gradient raises
``NotImplementedError``; it does not drop to the matmul route on its own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ml_mdm_tpu_torch.ops import cuda_build
from ml_mdm_tpu_torch.ops.norm_coeffs import _on, needs_grad
from ml_mdm_tpu_torch.perf import perf
from ml_mdm_tpu_torch.tracing import span

# launches of K4 and of K6 since each count was last set to 0
launch_count = 0
k6_launch_count = 0

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
    fn = lib.ml_mdm_two_branch_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 17
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


# -- K6: SelfAttention's self and text branches in one launch ----------------

K6_MAX_TEXT = 128  # text keys K6 takes: four tiles of 32
_K6_SMEM = 232448  # shared memory a block may have on the H100


def _k6_supported(d: int) -> bool:
    """Head widths K6 takes: multiples of 16 up to 128 (the widths of the
    wgmma products; K4 takes the same)."""
    return d % 16 == 0 and 16 <= d <= 128


def _k6_fits(length: int, lt: int, d: int, round_s: bool) -> bool:
    """Whether a K6 block's shared memory holds its 64 query rows' logits
    for the longer branch's whole key row (``length`` self keys in tiles of
    64, 0 for no self branch; ``lt`` text keys in tiles of 32), in bf16
    where ``round_s``, else f32, beside Q and the least ring of three K/V
    stages, with one consumer warpgroup: the kernel's ``k6_smem``
    (``csrc/flash_attention.cu``; it takes a second warpgroup only where
    the two warpgroups' stores fit too). In bf16 at D = 64 the self length
    may reach 1,536, in f32 768."""
    f, n_kt, n_tt = (1 if round_s else 2), -(-length // 64), -(-lt // 32)
    u4 = max(n_kt * 4 * f, n_tt * 2 * f)  # 16-byte words a thread
    return 1024 + 4 * 64 * d * 2 + u4 * 2048 + 8 * 17 <= _K6_SMEM


def k6_takes(kernels: bool, q, k_c=None, v_c=None) -> bool:
    """``k6_route``'s conditions but the device: the module's ``kernels``
    on, q bf16 with a head width K6 takes, at most ``K6_MAX_TEXT`` text
    keys, the logits' store within a block's shared memory, and no operand
    that needs a gradient (K6 has no backward: training keeps the matmul
    route, as K5's norms keep their plain chains)."""
    lt = 0 if k_c is None else k_c.shape[1]
    return (kernels and q.dtype == torch.bfloat16 and _k6_supported(q.shape[-1])
            and lt <= K6_MAX_TEXT and _k6_fits(q.shape[1], lt, q.shape[-1], perf().bf16_logits)
            and not needs_grad(q, k_c, v_c))


def k6_route(kernels: bool, q, k_c=None, v_c=None) -> bool:
    """Whether ``SelfAttention`` computes its branches through K6
    (``self_and_text_attention``): q on the card and ``k6_takes``."""
    return q.is_cuda and k6_takes(kernels, q, k_c, v_c)


def self_and_text_attention(q, k, v, k_c=None, v_c=None, mask=None):
    """``SelfAttention``'s attention where ``k6_route`` holds: q, k, v
    (B, L, H, D), k_c, v_c (B, Lt, H, D) or None, mask (B, Lt) or None ->
    attn(q, k, v) + attn(q, k_c, v_c, mask), (B, L, H, D) contiguous in q's
    dtype, by K6 (``two_branch_attention``). With the flash route on and
    the self branch's lengths supported there, K4 takes that branch and K6
    the text branch, with K4's output added."""
    if _use_flash() and _flash_supported(q, k):
        own = flash_attention(q, k, v)
        return own if k_c is None else two_branch_attention(q, None, None, k_c, v_c, mask,
                                                            add=own)
    return two_branch_attention(q, k, v, k_c, v_c, mask)


def two_branch_attention_plain(q, k, v, k_c=None, v_c=None, mask=None, add=None):
    """K6's plain version, written to the matmul route's definition: q and
    k each scaled by d^-1/4 in their dtype (as ``matmul_attention`` scales
    them), each branch's logits from exact products summed in f32 and, in
    bf16 under ``perf().bf16_logits``, rounded to bf16; -inf at masked
    keys; the softmax in f32 over the branch's whole key row; the weights
    normalised, then rounded to v's dtype; the products in f32. The two
    branches (either may be None) and ``add`` (B, L, H, D) are summed in
    f32 and rounded once to q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    qh = (q * scale).transpose(1, 2).float()
    round_logits = q.dtype == torch.bfloat16 and perf().bf16_logits

    def branch(kb, vb, m):
        logits = torch.matmul(qh, (kb * scale).transpose(1, 2).float().transpose(-1, -2))
        if round_logits:
            logits = logits.to(torch.bfloat16).float()
        if m is not None:
            logits = logits.masked_fill(m[:, None, None, :] == 0, float("-inf"))
        weights = torch.softmax(logits, dim=-1).to(vb.dtype).float()
        return torch.matmul(weights, vb.transpose(1, 2).float())

    out = torch.zeros_like(qh) if add is None else add.float().transpose(1, 2)
    if k is not None:
        out = out + branch(k, v, None)
    if k_c is not None:
        out = out + branch(k_c, v_c, mask)
    return out.transpose(1, 2).to(q.dtype).contiguous()


def two_branch_attention(q, k, v, k_c=None, v_c=None, mask=None, add=None):
    """Kernel K6: attn(q, k, v) + attn(q, k_c, v_c, mask) + add on the
    matmul route's definition (``two_branch_attention_plain``) in one
    launch. q, k, v (B, L, H, D) (k and v None: no self branch), k_c, v_c
    (B, Lt, H, D) or None, mask (B, Lt) or None, add (B, L, H, D) or None
    -> (B, L, H, D) contiguous in q's dtype. The operands may be strided
    views (the chunks of one qkv tensor). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16, D a multiple of 16 up
    to 128, Lt <= ``K6_MAX_TEXT``, the logits within ``_k6_fits``) or
    raises, and so does a call whose inputs require a gradient. The kernel
    is in ``csrc/flash_attention.cu`` beside K4 (its header says how it
    keeps the definition and what bounds it), so one ``nvcc`` builds both.
    Opens the span "K6" (``tracing.py``), inside "unet: attention" in a
    U-Net forward."""
    if needs_grad(q, k, v, k_c, v_c, add):
        raise NotImplementedError("two_branch_attention (K6) has no backward: take "
                                  "matmul_attention to differentiate through attention")
    with span("K6"):
        if q.device.type == "cpu":
            return two_branch_attention_plain(q, k, v, k_c, v_c, mask, add)
        if not q.is_cuda:
            raise RuntimeError(f"two_branch_attention: no kernel for device {q.device}")
        return _launch_k6(q, k, v, k_c, v_c, mask, add)


def _launch_k6(q, k, v, k_c, v_c, mask, add):
    global k6_launch_count
    has_self, has_text = k is not None, k_c is not None
    if not has_self and not has_text:
        raise ValueError("two_branch_attention: neither branch given")
    ops = [t for t in (q, k, v, k_c, v_c, add) if t is not None]
    if any(t.dtype != torch.bfloat16 or t.device != q.device or t.dim() != 4 for t in ops):
        raise ValueError("two_branch_attention: every operand a (B, L, H, D) bf16 tensor on "
                         f"{q.device}")
    bsz, length, heads, d = q.shape
    if not _k6_supported(d):
        raise ValueError(f"two_branch_attention: the kernel takes D a multiple of 16 up to "
                         f"128, got {d}")
    if (has_self and (k.shape != q.shape or v.shape != q.shape)) or (
            add is not None and add.shape != q.shape):
        raise ValueError(f"two_branch_attention: k, v and add must be {tuple(q.shape)}")
    lt = 0
    if has_text:
        lt = k_c.shape[1]
        if (k_c.shape != v_c.shape or (k_c.shape[0], k_c.shape[2], k_c.shape[3]) != (bsz, heads, d)
                or not 1 <= lt <= K6_MAX_TEXT):
            raise ValueError(f"two_branch_attention: k_c, v_c {tuple(k_c.shape)}, "
                             f"{tuple(v_c.shape)} for q {tuple(q.shape)} (1 to {K6_MAX_TEXT} keys)")
        if mask is not None:
            if mask.shape != (bsz, lt) or mask.device != q.device:
                raise ValueError(f"two_branch_attention: mask {tuple(mask.shape)}, not "
                                 f"{(bsz, lt)} on {q.device}")
            mask = (mask if mask.dtype == torch.bool else mask != 0).view(torch.uint8)
    round_s = perf().bf16_logits
    if not _k6_fits(length if has_self else 0, lt, d, round_s):
        raise ValueError(f"two_branch_attention: the logits of {length} keys do not fit a "
                         "block's shared memory")
    if add is not None and not add.is_contiguous():
        add = add.contiguous()
    out = torch.empty((bsz, length, heads, d), device=q.device, dtype=q.dtype)
    if out.numel() == 0:
        return out
    q, k, v, k_c, v_c = (None if t is None else _addressable(t) for t in (q, k, v, k_c, v_c))
    strides = [s for t in (q, k, v, k_c, v_c)
               for s in (t.stride()[:3] if t is not None else (0, 0, 0))]
    lib = load_library()
    with _on(q.device):
        err = lib.ml_mdm_two_branch_attention(
            *(None if t is None else t.data_ptr() for t in (q, k, v, k_c, v_c, mask, add)),
            out.data_ptr(), bsz, length, lt, heads, d, *strides,
            *(mask.stride() if mask is not None else (0, 0)), 1.0 / (d ** 0.25), int(round_s),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err == -1:
        raise RuntimeError(f"two_branch_attention: cuTensorMapEncodeTiled refused the operands "
                           f"(q {tuple(q.shape)} strides {q.stride()})")
    if err != 0:
        raise RuntimeError(f"two_branch_attention: CUDA error {err} at launch "
                           f"(q {tuple(q.shape)}, Lt {lt})")
    k6_launch_count += 1
    return out
