"""Training step of the port (``ml_mdm_tpu/trainer.py``): loss, backward,
the clip and NaN-skip fold, Adam, EMA.

Semantics kept from the JAX package:

- Adam (the JAX package's AdamW option has weight decay 0, so it is the
  same update), eps 1e-8, with the learning rate ``schedule(count)``,
  where count is the number of updates taken before this one; the bias
  corrections use count + 1, as optax's do;
- the global norm of the f32 gradients, and one scalar
  ``clip / max(norm, clip)`` on them;
- a step whose loss or gradient norm is not finite changes nothing: not
  the parameters, the Adam moments or count, the EMA or the step;
- the EMA is updated inside the step, with the step before the increment
  as its warmup counter;
- gradient accumulation over microbatches, a Python loop in place of
  ``lax.scan``.

The parameters are the module's own (f32 for training; the module's
compute dtype, bf16 in the training presets, is what the convs and dense
layers run in). The batch's floating tensors are cast to the compute
dtype before the loss, as the JAX ``loss_fn`` casts them.

The NaN skip is a host check: the step reads the loss and the norm back
(one synchronisation per step) and, when either is not finite, returns
without calling the optimizer, so nothing changes. In exchange the
update needs no masked copies of the parameters, moments and EMA. Adam is
``torch.optim.Adam`` (fused on CUDA), whose update is optax's: its bias
corrections use its own step count, which advances only when ``step()``
is called, and the learning rate is set to ``schedule(count)`` before
each call. Adam and the EMA run in the profiler ranges "trainer: Adam"
and "trainer: EMA".
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ml_mdm_tpu_torch.lr_scaler import LRScaler
from ml_mdm_tpu_torch.models.model_ema import EmaConfig, ema_update


@dataclass
class TrainerConfig:
    lr: float = 5e-5
    warmup_steps: int = 5000
    gradient_clip_norm: float = 2.0
    num_gradient_accumulations: int = 1
    loss_factor: float = 1.0
    lr_scaling_factor: float = 1.0
    ema_decay: float = 0.9999
    ema_warmup_steps: int = 0


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]
    ema_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Adam

    @classmethod
    def create(cls, module: torch.nn.Module) -> "TrainState":
        params = dict(module.named_parameters())
        ema = {k: p.detach().clone() for k, p in params.items()}
        return cls(0, params, ema, make_optimizer(params.values()))


def make_optimizer(params: Iterable[torch.Tensor]) -> torch.optim.Adam:
    """optax.adam(schedule, eps=1e-8) (b1 0.9, b2 0.999, eps_root 0) over
    ``params``; the train step sets the learning rate before each update.
    The clip is not part of the optimizer: the step folds it into one
    scalar."""
    params = list(params)
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            fused=all(p.is_cuda for p in params))


def make_schedule(config: TrainerConfig) -> Callable[[int], float]:
    """The learning rate as a function of the updates taken before."""
    return LRScaler(config.lr_scaling_factor).get_lr_schedule(
        config.warmup_steps, config.lr)


def adam_count(optimizer: torch.optim.Adam) -> int:
    """The updates ``optimizer`` has taken (optax's ``count``)."""
    first = optimizer.param_groups[0]["params"][0]
    st = optimizer.state.get(first)
    return int(st["step"]) if st else 0


def weighted_loss(losses, weights, loss_factor: float = 1.0):
    if weights is None:
        loss = losses.mean()
    else:
        loss = (losses * weights).sum() / weights.sum()
    return loss * loss_factor


def _microbatch(tree, i: int, n: int):
    """Rows [i * B/n, (i + 1) * B/n) of every tensor of rank >= 1 in a
    batch, a noise dict or a list of tensors."""
    if torch.is_tensor(tree):
        if tree.dim() == 0:
            return tree
        mb = tree.shape[0] // n
        return tree[i * mb:(i + 1) * mb]
    if isinstance(tree, dict):
        return {k: _microbatch(v, i, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_microbatch(v, i, n) for v in tree)
    return tree


def make_train_step(pipeline, config: TrainerConfig):
    """Returns train_step(state, batch, generator=None, noise=None) ->
    (state, metrics). ``batch`` holds images (B, H, W, C), lm_outputs,
    lm_mask and any micro-conditions; ``noise`` holds keyword arguments of
    ``pipeline.get_loss`` (``time``, ``eps``) for the whole batch, else the
    loss draws them from ``generator``. With num_gradient_accumulations
    > 1, B must be divisible by it; each microbatch's rows (and noise) go
    through loss and backward before one update. The batch is cast to the
    module's compute dtype. The state is updated in place; metrics are the
    loss, the gradient norm and ``skipped``."""
    dtype = pipeline.vision_module.dtype
    schedule = make_schedule(config)
    ema_cfg = EmaConfig(config.ema_decay, config.ema_warmup_steps)
    accum = config.num_gradient_accumulations

    def loss_fn(batch, generator, noise):
        batch = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
                 for k, v in batch.items()}
        losses, _, _, _, _, weights = pipeline.get_loss(batch, generator, **noise)
        return weighted_loss(losses.float(), None if weights is None else weights.float(),
                             config.loss_factor)

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Dict[str, Any]] = None):
        params: List[torch.Tensor] = list(state.params.values())
        for p in params:
            p.grad = None
        loss = 0.0
        for i in range(accum):
            mb = (batch, noise or {}) if accum == 1 else (
                _microbatch(batch, i, accum), _microbatch(noise or {}, i, accum))
            micro_loss = loss_fn(mb[0], generator, mb[1])
            micro_loss.backward()
            loss = loss + micro_loss.detach()
        loss = loss / accum
        # optax updates every parameter, one without a gradient too (its
        # moments decay); torch.optim.Adam passes over a None gradient
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        loss_v, norm_v = torch.stack([loss.float(), norm.float()]).tolist()
        ok = math.isfinite(loss_v) and math.isfinite(norm_v)
        metrics = {"loss": loss_v, "grad_norm": norm_v, "skipped": int(not ok)}
        if ok:
            clip = config.gradient_clip_norm
            if clip and clip > 0:
                torch._foreach_mul_(grads, clip / max(norm_v, clip))
            with record_function("trainer: Adam"):
                for group in state.optimizer.param_groups:
                    group["lr"] = schedule(adam_count(state.optimizer))
                state.optimizer.step()
            with record_function("trainer: EMA"):
                ema_update(state.ema_params.values(), params, state.step, ema_cfg)
            state.step += 1
        for p in params:
            p.grad = None
        return state, metrics

    return train_step


class RobustLossTracker:
    """tanh-clipped EMA of the loss and its variance, for outlier-resistant
    logging (host side)."""

    def __init__(self, wt: float = 0.01, clip: float = 3.0):
        self.wt = wt
        self.clip = clip
        self.exp_avg_loss = 0.0
        self.exp_avg_loss_var = 0.0
        self.best_avg_loss = 1e12
        self._initialized = False

    def load(self, exp_avg_loss, exp_avg_loss_var, best_avg_loss):
        self.exp_avg_loss = exp_avg_loss
        self.exp_avg_loss_var = exp_avg_loss_var
        self.best_avg_loss = best_avg_loss
        self._initialized = True

    def update(self, loss_val: float):
        if not self._initialized:
            self.exp_avg_loss = loss_val
            self.exp_avg_loss_var = loss_val ** 2
            self.best_avg_loss = loss_val
            self._initialized = True
            return
        std = np.sqrt(max(1.0, self.exp_avg_loss_var))
        delta = loss_val - self.exp_avg_loss
        clipped = self.exp_avg_loss + std * self.clip * np.tanh(delta / std / self.clip)
        self.exp_avg_loss = self.exp_avg_loss * (1 - self.wt) + self.wt * clipped
        self.exp_avg_loss_var = (self.exp_avg_loss_var * (1 - self.wt)
                                 + self.wt * (clipped - self.exp_avg_loss) ** 2)
        self.best_avg_loss = min(self.best_avg_loss, self.exp_avg_loss)
