"""Learning-rate schedule of the port (``ml_mdm_tpu/lr_scaler.py``): linear
warmup to the peak, then constant. The step is clamped to at least 1."""
from __future__ import annotations

from typing import Callable


class LRScaler:
    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def get_lr_schedule(self, warmup_steps: int, base_lr: float) -> Callable[[int], float]:
        scale = self.scale

        def schedule(step: int) -> float:
            step = max(int(step), 1)
            if step < warmup_steps:
                return base_lr * scale * step / max(1, warmup_steps)
            return base_lr * scale

        return schedule
