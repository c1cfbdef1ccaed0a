"""The plain reference of sampling and of one training step, float32.

A frozen copy of the port's plain arithmetic (``ml_mdm_tpu_torch/
samplers.py``, ``diffusion.py``, ``trainer.py``, ``lr_scaler.py``,
``models/model_ema.py``), reduced to what the benchmark's cells run:

- the DEEPFLOYD (squared-cosine) schedule, shifted per resolution by
  (scale)^power in the SNR for a nested model;
- DDIM with eta 0 over ``num_inference_steps`` resampled steps, x0 clipped
  to [-1, 1] at every step, classifier-free guidance over [uncond; cond]
  text rows;
- V-prediction with the DDPM (epsilon) loss target, one MSE per image and
  resolution, weighted by ``multi_res_weights``;
- one training step: the gradient of the mean loss, its global norm, the
  clip, Adam (optax's: bias corrections at count + 1, the learning rate of
  the linear warmup at the count before) and the EMA.

It imports nothing of the port. The caller hands it the weights, the noise,
the text, the timesteps and the images that the program got.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference.model import UNet


def squaredcos_gammas(n: int) -> np.ndarray:
    """gamma_0 = 1 and the squared-cosine schedule's cumulative products, in
    float32 (the port's ``schedule_squaredcos_cap_v2``)."""
    def alpha_bar(ts: float) -> float:
        return math.cos((ts + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [0.0] + [min(1.0 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999)
                     for i in range(n)]
    return np.exp(np.cumsum(np.log(1.0 - np.asarray(betas)))).astype(np.float32)


class Schedule:
    """The gamma table of a model YAML's ``sampler_config`` and the
    resolutions' scales (highest first; [1] for a single U-Net)."""

    def __init__(self, sampler_cfg: Dict, scales: Sequence[int]):
        if str(sampler_cfg.get("schedule_type")) != "DEEPFLOYD":
            raise NotImplementedError("the reference holds the DEEPFLOYD schedule only")
        if str(sampler_cfg.get("prediction_type")) != "V_PREDICTION":
            raise NotImplementedError("the reference holds V-prediction only")
        if float(sampler_cfg.get("rescale_schedule", 1.0)) != 1.0:
            raise NotImplementedError("the reference holds rescale_schedule 1 only")
        self.n = int(sampler_cfg.get("num_diffusion_steps", 1000))
        self.gammas = torch.from_numpy(squaredcos_gammas(self.n))
        self.shifted = bool(sampler_cfg.get("schedule_shifted", False))
        self.power = float(sampler_cfg.get("schedule_shifted_power", 1.0))
        self.target = str(sampler_cfg.get("loss_target_type") or "V_PREDICTION")
        self.scales = list(scales)

    def gamma(self, t: torch.Tensor) -> List[torch.Tensor]:
        """(B, 1, 1, 1) gamma at integer timesteps t, per resolution."""
        g = self.gammas.to(t.device)[t].reshape(-1, 1, 1, 1)
        if not self.shifted:
            return [g for _ in self.scales]
        out = []
        for s in self.scales:
            if s > 1:
                snr = g / (1.0 - g)
                out.append(1.0 / (1.0 + float(s) ** self.power / torch.clamp(snr, min=1e-20)))
            else:
                out.append(g)
        return out

    def timesteps(self, num_inference_steps: int) -> List[int]:
        ratio = (self.n + 1) / (num_inference_steps + 1)
        return (np.arange(num_inference_steps + 1) * ratio).round()[::-1].astype(np.int64).tolist()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@torch.no_grad()
def sample(model: UNet, sched: Schedule, noise, text: torch.Tensor, mask: torch.Tensor,
           guidance: float, num_inference_steps: int) -> torch.Tensor:
    """DDIM, eta 0, from ``noise`` (one (B, H, W, 3) per resolution) with
    ``text``/``mask`` of 2B rows [uncond; cond] (B rows without guidance):
    the highest resolution in [-1, 1]."""
    xs = [x.float() for x in _as_list(noise)]
    nested = len(xs) > 1
    b = xs[0].shape[0]
    ts = sched.timesteps(num_inference_steps)
    for t, t_last in zip(ts[:-1], ts[1:]):
        tt = torch.full((b,), t, dtype=torch.long, device=xs[0].device)
        g_t = sched.gamma(tt)
        g_s = sched.gamma(torch.full_like(tt, t_last))
        inp = xs if nested else xs[0]
        if guidance != 1.0:
            inp = [torch.cat([x, x]) for x in xs] if nested else torch.cat([xs[0], xs[0]])
            preds = _as_list(model(inp, torch.cat([tt, tt]) - 1, text, mask))
            preds = [pu + guidance * (pc - pu) for pu, pc in (p.chunk(2) for p in preds)]
        else:
            preds = _as_list(model(inp, tt - 1, text, mask))
        new = []
        for x, p, g, gl in zip(xs, preds, g_t, g_s):
            x0 = torch.clamp(x * torch.sqrt(g) - p * torch.sqrt(1.0 - g), -1.0, 1.0)
            eps = (x - x0 * torch.sqrt(g)) / torch.sqrt(1.0 - g)
            new.append(x0 * torch.sqrt(gl) + eps * torch.sqrt(1.0 - gl))
        xs = new
    return torch.clamp(xs[0], -1.0, 1.0)


def image_pyramid(images: torch.Tensor, scales: Sequence[int]) -> List[torch.Tensor]:
    out = [images]
    for i in range(1, len(scales)):
        r = scales[i - 1] // scales[i]
        b, h, w, c = out[-1].shape
        out.append(out[-1].reshape(b, h // r, r, w // r, r, c).mean(dim=(2, 4)))
    return out


def per_image_loss(model: UNet, sched: Schedule, images, text, mask, time, eps,
                   weights: Sequence[float]) -> torch.Tensor:
    """(B,) weighted loss of each image: the images at every resolution,
    noised at each one's gamma with its own ``eps``, V-predicted, and the
    MSE of the predicted epsilon (the DDPM target; of V with a V target)."""
    xs = image_pyramid(images, sched.scales)
    gs = sched.gamma(time + 1)
    x_t = [torch.sqrt(g) * x + torch.sqrt(1.0 - g) * e for x, g, e in zip(xs, gs, eps)]
    preds = _as_list(model(x_t if len(x_t) > 1 else x_t[0], time, text, mask))
    loss = 0.0
    for x, e, xt, p, g, w in zip(xs, eps, x_t, preds, gs, weights):
        if sched.target == "DDPM":
            x0 = xt * torch.sqrt(g) - p * torch.sqrt(1.0 - g)
            pred, tgt = (xt - x0 * torch.sqrt(g)) / torch.sqrt(1.0 - g), e
        else:
            pred, tgt = p, torch.sqrt(g) * e - torch.sqrt(1.0 - g) * x
        loss = loss + w * (pred - tgt).square().mean(dim=(1, 2, 3))
    return loss


class TrainReference:
    """The training step's plain counterpart, on the reference module's own
    float32 parameters: Adam's moments, the EMA and the step count."""

    def __init__(self, model: UNet, sched: Schedule, lr: float, warmup: int, clip: float,
                 ema_decay: float, weights: Sequence[float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.model, self.sched = model, sched
        self.lr, self.warmup, self.clip, self.decay = lr, warmup, clip, ema_decay
        self.weights = list(weights)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.params = dict(model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.ema = {k: p.detach().clone() for k, p in self.params.items()}
        self.count = 0

    def schedule(self, count: int) -> float:
        step = max(count, 1)
        return self.lr * step / max(1, self.warmup) if step < self.warmup else self.lr

    def step(self, images, text, mask, time, eps, rows: int) -> Dict[str, object]:
        """One step on the batch, its gradient summed over blocks of
        ``rows`` images. Returns the loss, the clipped gradient per leaf
        and the global norm."""
        b = images.shape[0]
        for p in self.params.values():
            p.grad = None
        total = 0.0
        for lo in range(0, b, rows):
            sl = slice(lo, lo + rows)
            losses = per_image_loss(self.model, self.sched, images[sl], text[sl], mask[sl],
                                    time[sl], [e[sl] for e in eps], self.weights)
            (losses.sum() / b).backward()
            total += float(losses.detach().sum())
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()])))
        scale = self.clip / max(norm, self.clip) if self.clip > 0 else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        lr = self.schedule(self.count)
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = (self.v[k] / bc2).sqrt_().add_(self.eps)
                p.sub_(lr * (self.m[k] / bc1) / denom)
            for k, p in self.params.items():
                self.ema[k].mul_(self.decay).add_(p, alpha=1.0 - self.decay)
            for p in self.params.values():
                p.grad = None
        self.count += 1
        return {"loss": total / b, "grads": grads, "norm": norm}


def set_float32_exact() -> None:
    """TF32 off for float32 products: the reference's precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[k].float() for k in names])).tolist()
    return dict(zip(names, norms))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the larger of the reference's norm of that leaf and of the median leaf
    (of ``keep``, by default every leaf)."""
    names = list(ref) if keep is None else list(keep)
    median = float(np.median([ref[k] for k in names]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names}
