"""Exponential moving average of parameters (``ml_mdm_tpu/models/model_ema.py``).

The port updates the EMA copies in place with one fused pass over the
list of tensors. The decay is 0 while the counter (the step before this
update) is below ``warmup_steps``, so the EMA then copies the parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass
class EmaConfig:
    decay: float = 0.9999
    warmup_steps: int = 0


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               counter: int, config: EmaConfig = EmaConfig()) -> None:
    """ema = decay * ema + (1 - decay) * param, in place."""
    decay = config.decay if counter >= config.warmup_steps else 0.0
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
