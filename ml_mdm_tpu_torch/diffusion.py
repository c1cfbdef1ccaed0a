"""Diffusion pipelines of the port: the model wrappers, the training losses
and the sampling entries.

Counterpart of ``ml_mdm_tpu/diffusion.py`` ``Model``, ``Diffusion``,
``NestedModel`` and ``NestedDiffusion``: ``get_loss`` of both pipelines
(without the JAX package's packed loss boundary: the port does not pack)
and ``sample``. A pipeline owns its U-Net module, so there is no separate
params argument; ``vision_module.train()`` selects the training route of
its ResNets. A loss takes its timesteps and noise from the caller or
draws them from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ml_mdm_tpu_torch.config import DiffusionConfig, NestedDiffusionConfig
from ml_mdm_tpu_torch.samplers import NestedSampler, Sampler
from ml_mdm_tpu_torch.utils.resize import resize_nhwc


def avg_pool_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """r x r average pooling in NHWC."""
    if r == 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, h // r, r, w // r, r, c).mean(dim=(2, 4))


def subsample_frames(x: torch.Tensor, n: int, step: int, n_out: int) -> torch.Tensor:
    """x (B, n*h, n*w, C) holds n*n frames of (h, w) as an n x n grid, in
    row-major order. Keeps every ``step``-th frame and lays the kept
    n_out*n_out frames out as an n_out x n_out grid."""
    b, hh, ww, c = x.shape
    h, w = hh // n, ww // n
    frames = x.reshape(b, n, h, n, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, h, w, c)
    frames = frames[:, ::step]
    return (frames.reshape(b, n_out, n_out, h, w, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, n_out * h, n_out * w, c))


def image_pyramid(images: torch.Tensor, scales: Sequence[int],
                  is_temporal: Sequence[bool]) -> List[torch.Tensor]:
    """The training images at every resolution, highest first
    (``NestedDiffusion.get_loss`` of the JAX package): each level is the
    one above avg-pooled by the ratio between them, or, where the shell
    above it resamples across frames (``is_temporal``, one flag per shell,
    outermost first), the one above with its 4 x 4 grid of frames
    subsampled: every (scales[0] / scale)^2-th frame kept, the grid's side
    divided by the ratio."""
    out, grid = [images], 4
    for i in range(1, len(scales)):
        r = scales[0] // scales[i]
        rr = scales[i - 1] // scales[i]
        if is_temporal[i - 1]:
            out.append(subsample_frames(out[-1], grid, r * r, grid // rr))
            grid //= rr
        else:
            out.append(avg_pool_nhwc(out[-1], rr))
    return out


def _mse_per_image(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Mean over all but the batch axis of the squared difference, squared
    in the difference's dtype and accumulated in f32."""
    return (pred - tgt).square().mean(dim=tuple(range(1, pred.dim())), dtype=torch.float32)


class Model:
    """model_fn(x_t, t, lm_outputs, lm_mask, micros) around the vision
    module, with the optional tanh output bound."""

    def __init__(self, vision_module: torch.nn.Module,
                 diffusion_config: DiffusionConfig):
        self.vision_module = vision_module
        self._output_scale = diffusion_config.model_output_scale

    def __call__(self, x_t, times, lm_outputs, lm_mask, micros):
        out = self.vision_module(x_t, times, lm_outputs, lm_mask, micros)
        if self._output_scale != 0:
            s = self._output_scale
            out = torch.tanh(out / s) * s
        return out


class Diffusion:
    def __init__(self, vision_module: torch.nn.Module,
                 diffusion_config: DiffusionConfig):
        self.model = Model(vision_module, diffusion_config)
        self.sampler = Sampler(diffusion_config.sampler_config)
        self.config = diffusion_config

    @property
    def vision_module(self) -> torch.nn.Module:
        return self.model.vision_module

    def get_micro_conditioning(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        conditions = self.vision_module.conditions
        if conditions is None:
            return {}
        return {k: sample[k] for k in conditions if k in sample}

    def get_pred_for_training(self, x_t, pred, g):
        """The prediction converted to the loss target's type."""
        sc = self.config.sampler_config
        if sc.loss_target_type == sc.prediction_type:
            return pred
        x0, _ = self.sampler.get_x0_eps_from_pred(x_t, pred, g, sc.prediction_type)
        return self.sampler.get_pred_from_x0_xt(x_t, x0, g, sc.loss_target_type)

    def get_loss(self, sample: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 *, time: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        """Per-image training loss of ``sample`` (``images`` (B, H, W, C) in
        [-1, 1], ``lm_outputs``, ``lm_mask``, micro-conditions). The
        timesteps ``time`` (B,) and the noise ``eps`` are given or drawn
        from ``generator``. Returns (losses (B,) f32, time, x_t, model
        output, target, VDM weights or None)."""
        images = sample["images"]
        eps, g, g_last, weights, time = self.sampler.get_eps_time(images, generator, time, eps)
        if not self.config.use_vdm_loss_weights:
            weights = None
        x_t = self.sampler.get_xt(self.sampler.get_image_rescaled(images), eps, g)
        means = self.model(x_t, time, sample["lm_outputs"], sample["lm_mask"],
                           self.get_micro_conditioning(sample))
        tgt = self.sampler.get_prediction_targets(
            images, eps, g, g_last, self.config.sampler_config.loss_target_type)
        pred = self.get_pred_for_training(x_t, means, g)
        return _mse_per_image(pred, tgt), time, x_t, means, tgt, weights

    def get_noise(self, num_examples: int, image_side: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f32 normal noise (B, side, side, C) on the module's device."""
        c = self.vision_module.input_channels
        return torch.randn((num_examples, image_side, image_side, c),
                           generator=generator,
                           device=self.vision_module.conv_in.weight.device)

    @torch.no_grad()
    def sample(self, num_examples: int, sample: Dict[str, Any], image_side: int,
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
        """Text-conditioned sampling. ``sample`` holds ``lm_outputs``
        (B or 2B rows with guidance) and ``lm_mask``; the initial noise is
        ``noise`` (B, side, side, C) or drawn from ``generator``. Keyword
        arguments go to ``Sampler.sample`` (num_inference_steps, ddim_eta,
        guidance_scale, resample_steps, t_start). Returns images in
        [-1, 1], NHWC."""
        if noise is None:
            noise = self.get_noise(num_examples, image_side, generator)
        return self.sampler.sample(
            self.model, noise, sample["lm_outputs"], sample["lm_mask"],
            self.get_micro_conditioning(sample), generator, **kwargs,
        )


class NestedModel(Model):
    """model_fn([x_hi, ..., x_lo], t, lm_outputs, lm_mask, micros) around a
    ``NestedUNet``: one prediction per resolution, each with the optional
    tanh bound, and the low-resolution residual unless
    ``no_use_residual``. With ``mixed_ratio`` (the cumulative share of rows
    each resolution keeps, highest first) each resolution runs only on its
    first rows, and its prediction is padded back to the batch with
    zeros."""

    def __init__(self, vision_module: torch.nn.Module,
                 diffusion_config: NestedDiffusionConfig, sampler: NestedSampler):
        super().__init__(vision_module, diffusion_config)
        self.diffusion_config = diffusion_config
        self.sampler = sampler

    def _low_res_residual(self, x_t, p_t, times):
        """Adds the low resolution's x0 to the high resolution's prediction:
        x0 of level 1 is predicted at its shifted gamma, clipped to [-1, 1],
        upsampled with JAX's cubic resize and divided by the ratio, and its
        prediction at level 0 is added to level 0's (``NestedModel.
        _low_res_residual`` of the JAX package)."""
        if self.diffusion_config.mixed_ratio is not None:
            raise ValueError("the low-resolution residual does not support mixed batches")
        x_hi, x_lo = x_t[0], x_t[1]
        pred, pred_low = p_t[0], p_t[1]
        smp = self.sampler
        scales = list(self.vision_module.nest_ratio) + [1]
        g_list = smp.get_gammas(smp.read_gamma(times + 1), scales)
        x0_low = smp.get_x0_eps_from_pred(x_lo, pred_low, g_list[1], return_eps=False)
        x0_low = torch.clamp(x0_low, -1.0, 1.0)
        ratio = x_hi.shape[1] // x_lo.shape[1]
        x0_up = resize_nhwc(x0_low, x0_low.shape[1] * ratio, x0_low.shape[2] * ratio,
                            "cubic") / ratio
        pred = pred + smp.get_pred_from_x0_xt(x_hi, x0_up, g_list[0])
        return [pred, pred_low] + list(p_t[2:])

    def __call__(self, x_t, times, lm_outputs, lm_mask, micros,
                 mixed_ratio: Optional[Sequence[float]] = None):
        batch = x_t[0].shape[0]
        if mixed_ratio is not None:
            x_t = [x[: int(m * x.shape[0])] for x, m in zip(x_t, mixed_ratio)]
        p_t = self.vision_module(x_t, times, lm_outputs, lm_mask, micros)
        if self._output_scale != 0:
            s = self._output_scale
            p_t = [torch.tanh(p / s) * s for p in p_t]
        if mixed_ratio is not None:
            p_t = [torch.cat([p, p.new_zeros((batch - p.shape[0],) + p.shape[1:])])
                   if p.shape[0] < batch else p for p in p_t]
        if not self.diffusion_config.no_use_residual:
            p_t = self._low_res_residual(x_t, p_t, times)
        return p_t


class NestedDiffusion(Diffusion):
    """Nested (Matryoshka) pipeline: all resolutions denoised jointly by one
    ``NestedUNet``; a sample is the highest resolution."""

    def __init__(self, vision_module: torch.nn.Module,
                 diffusion_config: NestedDiffusionConfig):
        self.sampler = NestedSampler(diffusion_config.sampler_config)
        self.model = NestedModel(vision_module, diffusion_config, self.sampler)
        self.config = diffusion_config
        self.mixed_ratio = None
        if diffusion_config.mixed_ratio:
            mr = np.cumsum(np.asarray(
                [float(v) for v in str(diffusion_config.mixed_ratio).split(":")]))
            self.mixed_ratio = (mr / mr[-1]).tolist()

    @property
    def scales(self) -> List[int]:
        """Downsampling ratio of each resolution, highest first, e.g.
        [16, 4, 1]."""
        return list(self.vision_module.nest_ratio) + [1]

    def get_loss(self, sample: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 *, time: Optional[torch.Tensor] = None,
                 eps: Optional[Sequence[torch.Tensor]] = None):
        """Nested training loss: the images at every resolution
        (``image_pyramid``), each noised at its shifted gamma with its own
        normals, the loss of the highest resolution (of every one with ``use_double_loss``,
        weighted by ``multi_res_weights``), and with ``mixed_ratio`` each
        resolution's loss divided by its row share and kept on its rows.
        ``eps`` is one normal tensor per resolution, highest first (else
        drawn from ``generator``). Returns (losses (B,) f32, time, x_t,
        prediction and target at the highest resolution, VDM weights or
        None)."""
        images = sample["images"]
        cfg = self.config
        scales = self.scales
        eps0, g, g_last, weights, time = self.sampler.get_eps_time(
            images, generator, time, None if eps is None else eps[0])
        if not cfg.use_vdm_loss_weights:
            weights = None
        images_list = image_pyramid(images, scales, self.vision_module.is_temporal)
        g_list = self.sampler.get_gammas(g, scales)
        g_last_list = self.sampler.get_gammas(g_last, scales)
        eps_list = [eps0]
        for i, x in enumerate(images_list[1:], start=1):
            eps_list.append(
                torch.randn(x.shape, generator=generator, device=x.device, dtype=eps0.dtype)
                if eps is None else eps[i].to(x.device, eps0.dtype))
        x_t = self.sampler.get_xt(images_list, eps_list, g_list, scales)
        p_t = self.model(x_t, time, sample["lm_outputs"], sample["lm_mask"],
                         self.get_micro_conditioning(sample), mixed_ratio=self.mixed_ratio)
        tgt = self.sampler.get_prediction_targets(
            images_list, eps_list, g_list, g_last_list, scales,
            cfg.sampler_config.loss_target_type)
        pred = [self.get_pred_for_training(x, p, gi) for x, p, gi in zip(x_t, p_t, g_list)]
        if cfg.multi_res_weights is not None:
            if not cfg.use_double_loss:
                raise ValueError("multi_res_weights needs use_double_loss")
            w = [float(v) for v in str(cfg.multi_res_weights).split(":")]
        else:
            w = [1.0] * len(x_t)
        loss = 0.0
        for i in range(len(x_t)):
            if i == 0 or cfg.use_double_loss:
                loss_i = _mse_per_image(pred[i], tgt[i])
                if self.mixed_ratio is not None:
                    loss_i = loss_i / self.mixed_ratio[i]
                    keep = int(self.mixed_ratio[i] * loss_i.shape[0])
                    rows = torch.arange(loss_i.shape[0], device=loss_i.device)
                    loss_i = loss_i * (rows < keep).to(loss_i.dtype)
            else:
                loss_i = pred[i].mean() * 0.0
            loss = loss + loss_i * w[i]
        return loss, time, x_t[0], pred[0], tgt[0], weights

    def get_noise(self, num_examples: int, image_side: int,
                  generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """f32 normal x_T at every resolution, on the module's device."""
        return self.sampler.init_noise(
            num_examples, self.vision_module.input_channels, image_side,
            self.scales, generator, device=self.vision_module.conv_in.weight.device)

    @torch.no_grad()
    def sample(self, num_examples: int, sample: Dict[str, Any], image_side: int,
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[List[torch.Tensor]] = None, **kwargs) -> torch.Tensor:
        """Text-conditioned nested sampling; ``noise`` is the list of x_T
        per resolution (else drawn from ``generator``). Keyword arguments go
        to ``NestedSampler.sample`` (num_inference_steps, ddim_eta,
        guidance_scale, resample_steps, t_start, output_inner, step_noise).
        Returns images in [-1, 1], NHWC, at ``image_side``."""
        if noise is None:
            noise = self.get_noise(num_examples, image_side, generator)
        return self.sampler.sample(
            self.model, noise, sample["lm_outputs"], sample["lm_mask"],
            self.get_micro_conditioning(sample), generator,
            scales=self.scales, **kwargs,
        )
