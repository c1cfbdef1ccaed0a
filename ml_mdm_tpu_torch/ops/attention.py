"""Plain attention of the port: ``ml_mdm_tpu/ops/attention.py``
``_einsum_attention``.

The JAX main path computes this product outside any Pallas kernel (its
flash kernel is opt-in and off by default), so the port runs it as two
``torch.matmul`` calls. Numerics follow the JAX function: q and k are each
scaled by d^-1/4, under bf16 the logits are stored in bf16, masked keys get
-inf, and the softmax runs in f32.
"""
from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D), mask: (B, Lk) or None
    -> (B, Lq, H, D)."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    qh = (q * scale).transpose(1, 2)  # (B, H, Lq, D)
    kh = (k * scale).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # (B, H, Lq, Lk)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
    weights = torch.softmax(logits, dim=-1, dtype=torch.float32).to(v.dtype)
    return torch.matmul(weights, v.transpose(1, 2)).transpose(1, 2)
