"""Training step of the port (``ml_mdm_tpu/trainer.py``): loss, backward,
the clip and NaN-skip fold, Adam, EMA.

Semantics kept from the JAX package:

- Adam, eps 1e-8, with the learning rate ``schedule(count)``, where count
  is the number of updates taken before this one; the bias corrections use
  count + 1, as optax's do. ``use_adamw`` selects ``torch.optim.AdamW``
  with weight decay 0, as the JAX package selects ``optax.adamw`` with
  weight decay 0: the same update;
- ``adam_mu_dtype`` "bfloat16" keeps Adam's first moment in bf16 (the
  second stays f32), as ``optax.adam(mu_dtype=jnp.bfloat16)`` does:
  ``BF16MomentAdam`` (``torch.optim.Adam`` keeps its moments in the
  parameter's dtype);
- ``freeze_mask`` (``make_optimizer``, from the CLI's ``freeze_inner_unet``)
  labels parameters "freeze" or "train", as the JAX ``optax.
  multi_transform`` with ``set_to_zero``: a frozen parameter has no
  moments and takes no update, but its gradient still counts in the
  clip's global norm;
- the global norm of the f32 gradients, and one scalar
  ``clip / max(norm, clip)`` on them;
- a step whose loss or gradient norm is not finite changes nothing: not
  the parameters, the Adam moments or count, the EMA or the step;
- the EMA is updated inside the step, with the step before the increment
  as its warmup counter;
- gradient accumulation over microbatches, a Python loop in place of
  ``lax.scan``;
- ``remat`` with ``remat_save_conv_max_side`` (selective rematerialisation,
  the JAX ``make_remat_policy``): the forward of every U-Net stage
  (``ResNetBlockStage``) whose convolutions run at a physical side above
  ``remat_save_conv_max_side`` (a packed stage's is half its image side)
  runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
  and is recomputed in the backward; the smaller stages keep their
  activations. The JAX policy saves the conv outputs tagged with a side at
  or below the threshold and every matmul output, and recomputes the rest of
  the whole loss: the port recomputes whole large stages, matmuls inside
  them too (their dense time layers), and keeps everything outside them (the
  embeddings, the loss). At 0 every stage is recomputed, as the JAX
  dots-only policy recomputes every convolution.

Under FSDP (``TrainState.layout``, ``parallel.mesh.shard_module``) the
sharded parameters are ``DTensor``s whose gradients FSDP reduce-scatters
(averaged over every process); the step takes their local shards, averages
the whole (replicated) gradients and the loss with ``all_reduce``, takes
the global norm (``FsdpLayout.grad_norm``: every process clips by the same
scalar and skips alike), and steps Adam and the EMA on the shards, which
the optimizer and the EMA hold; ``adam_count`` and the schedule are as
before. After an update it drops the cached sampling weights
(``models.layers.invalidate_cached_weights``).

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
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ml_mdm_tpu_torch.lr_scaler import LRScaler
from ml_mdm_tpu_torch.models.layers import invalidate_cached_weights
from ml_mdm_tpu_torch.models.model_ema import EmaConfig, ema_update


@dataclass
class TrainerConfig:
    lr: float = 5e-5
    warmup_steps: int = 5000
    gradient_clip_norm: float = 2.0
    use_adamw: bool = False
    num_gradient_accumulations: int = 1
    loss_factor: float = 1.0
    lr_scaling_factor: float = 1.0
    ema_decay: float = 0.9999
    ema_warmup_steps: int = 0
    remat: bool = False
    remat_save_conv_max_side: int = 128
    adam_mu_dtype: str = "float32"


@dataclass
class TrainState:
    """The module's parameters by name, their EMA, the optimizer and the
    step. Under FSDP (``layout``, ``parallel.mesh.FsdpLayout``) a sharded
    parameter is a ``DTensor`` and its EMA, its Adam moments and the
    optimizer's own parameter are this process's shard (``local_params``)."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    ema_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    layout: Any = None

    @classmethod
    def create(cls, module: torch.nn.Module, config: Optional[TrainerConfig] = None,
               freeze_mask: Optional[Dict[str, str]] = None, layout=None) -> "TrainState":
        params = dict(module.named_parameters())
        local = _local_params(params, layout)
        ema = {k: p.detach().clone() for k, p in local.items()}
        return cls(0, params, ema, make_optimizer(local, config, freeze_mask), layout)

    def local_params(self) -> Dict[str, torch.Tensor]:
        """Each parameter's local part, which the optimizer updates: its
        shard under FSDP, else the parameter itself."""
        return _local_params(self.params, self.layout)


def _local_params(params: Dict[str, torch.Tensor], layout) -> Dict[str, torch.Tensor]:
    return params if layout is None else {k: layout.local(p) for k, p in params.items()}


class BF16MomentAdam(torch.optim.Optimizer):
    """Adam with its first moment kept in a low-precision dtype, step for
    step ``optax.scale_by_adam(mu_dtype=...)`` followed by the learning
    rate: mu = (1 - b1) g + (b1 mu), where b1 mu is a product in the
    moment's dtype with b1 rounded to it (JAX's weak-typed scalar);
    nu = (1 - b2) g^2 + b2 nu in f32; the update mu / (1 - b1^count) over
    sqrt(nu / (1 - b2^count)) + eps, from the f32 mu before it is rounded
    to the moment's dtype. The state keys are ``torch.optim.Adam``'s
    (``step``, ``exp_avg``, ``exp_avg_sq``)."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1_low = float(torch.tensor(b1).to(self.mu_dtype))
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
            if not params:
                continue
            count = torch.tensor(float(self.state[params[0]]["step"]), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
            grads = [p.grad.float() for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            mu32 = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu32, [m.float() for m in torch._foreach_mul(mus, b1_low)])
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu32, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            for m, new in zip(mus, mu32):
                m.copy_(new)
        return None

    def load_state_dict(self, state_dict):
        # torch casts every loaded moment to its parameter's dtype: the
        # first moment goes back to its own (bf16 -> f32 -> bf16 is exact)
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


def make_optimizer(params: Dict[str, torch.Tensor], config: Optional[TrainerConfig] = None,
                   freeze_mask: Optional[Dict[str, str]] = None) -> torch.optim.Optimizer:
    """optax.adam(schedule, eps=1e-8) (b1 0.9, b2 0.999, eps_root 0), or
    optax.adamw with weight decay 0 (``config.use_adamw``), over ``params``
    (by name), with the first moment in ``config.adam_mu_dtype``; the train
    step sets the learning rate before each update. The parameters
    ``freeze_mask`` labels "freeze" are left out: no moments, no update. The
    clip is not part of the optimizer: the step folds it into one scalar."""
    config = config or TrainerConfig()
    params = [p for k, p in params.items() if (freeze_mask or {}).get(k) != "freeze"]
    kw = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    mu_dtype = getattr(torch, config.adam_mu_dtype)
    if mu_dtype != torch.float32:
        return BF16MomentAdam(params, mu_dtype=mu_dtype, **kw)
    fused = bool(params) and all(p.is_cuda for p in params)
    if config.use_adamw:
        return torch.optim.AdamW(params, weight_decay=0.0, fused=fused, **kw)
    return torch.optim.Adam(params, fused=fused, **kw)


def make_schedule(config: TrainerConfig) -> Callable[[int], float]:
    """The learning rate as a function of the updates taken before."""
    return LRScaler(config.lr_scaling_factor).get_lr_schedule(
        config.warmup_steps, config.lr)


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """The updates ``optimizer`` has taken (optax's ``count``)."""
    first = optimizer.param_groups[0]["params"][0]
    st = optimizer.state.get(first)
    return int(st["step"]) if st else 0


def set_remat(module: torch.nn.Module, save_side: Optional[int]) -> None:
    """Recompute in the backward every stage of ``module`` whose physical
    side is above ``save_side`` (None: none)."""
    for m in module.modules():
        if hasattr(m, "remat_above"):
            m.remat_above = save_side


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


def make_train_step(pipeline, config: TrainerConfig,
                    all_reduce: Optional[Callable[[List[torch.Tensor]], None]] = None):
    """Returns train_step(state, batch, generator=None, noise=None) ->
    (state, metrics). ``batch`` holds images (B, H, W, C), lm_outputs,
    lm_mask and any micro-conditions; ``noise`` holds keyword arguments of
    ``pipeline.get_loss`` (``time``, ``eps``) for the whole batch, else the
    loss draws them from ``generator``. With num_gradient_accumulations
    > 1, B must be divisible by it; each microbatch's rows (and noise) go
    through loss and backward before one update. The batch is cast to the
    module's compute dtype. The state is updated in place; metrics are the
    loss, the gradient norm and ``skipped``. With ``config.remat`` it sets
    the module's stages to recompute (``set_remat``). ``all_reduce``, in a
    data-parallel run, averages in place a list of tensors over the
    processes (``parallel.mesh.all_reduce_mean``): the step hands it the
    loss and the gradients before the norm."""
    dtype = pipeline.vision_module.dtype
    set_remat(pipeline.vision_module,
              config.remat_save_conv_max_side if config.remat else None)
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
        names = list(state.params)
        params: List[torch.Tensor] = list(state.params.values())
        layout = state.layout
        local = list(state.local_params().values())
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
        # under FSDP the sharded gradients arrive reduce-scattered (averaged
        # over every process): the step works on their local shards, and
        # hands the optimizer each shard as the gradient of its parameter's
        grads = [p.grad for p in params] if layout is None else [layout.local(p.grad)
                                                                 for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        if all_reduce is not None:
            loss = loss.float().reshape(1)
            all_reduce([loss] + [g for n, g in zip(names, grads)
                                 if layout is None or n not in layout.dims])
            loss = loss[0]
        if layout is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        else:
            # the global norm (the shards' squares summed over fsdp), so that
            # every process clips by one scalar and skips alike
            norm = layout.grad_norm(names, grads)
        loss_v, norm_v = torch.stack([loss.float(), norm.float()]).tolist()
        ok = math.isfinite(loss_v) and math.isfinite(norm_v)
        metrics = {"loss": loss_v, "grad_norm": norm_v, "skipped": int(not ok)}
        if ok:
            clip = config.gradient_clip_norm
            if clip and clip > 0:
                torch._foreach_mul_(grads, clip / max(norm_v, clip))
            if layout is not None:
                for t, g in zip(local, grads):
                    t.grad = g
            with record_function("trainer: Adam"):
                for group in state.optimizer.param_groups:
                    group["lr"] = schedule(adam_count(state.optimizer))
                state.optimizer.step()
            with record_function("trainer: EMA"):
                ema_update(state.ema_params.values(), local, state.step, ema_cfg)
            state.step += 1
            if layout is not None:
                # the gathered parameters reuse their storage and keep their
                # version counters: drop the sampling weights built from them
                invalidate_cached_weights()
        for p in params + local:
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
