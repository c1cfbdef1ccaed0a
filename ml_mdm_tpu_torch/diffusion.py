"""Diffusion pipelines of the port: the model wrappers and sampling entries.

Counterpart of ``ml_mdm_tpu/diffusion.py`` ``Model``, ``Diffusion``,
``NestedModel`` and ``NestedDiffusion`` (sampling only; the training loss
is not ported yet). A pipeline owns its U-Net module, so there is no
separate params argument.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ml_mdm_tpu_torch.config import DiffusionConfig, NestedDiffusionConfig
from ml_mdm_tpu_torch.samplers import NestedSampler, Sampler
from ml_mdm_tpu_torch.utils.resize import resize_nhwc


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
    ``no_use_residual``."""

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

    def __call__(self, x_t, times, lm_outputs, lm_mask, micros):
        p_t = self.vision_module(x_t, times, lm_outputs, lm_mask, micros)
        if self._output_scale != 0:
            s = self._output_scale
            p_t = [torch.tanh(p / s) * s for p in p_t]
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

    @property
    def scales(self) -> List[int]:
        """Downsampling ratio of each resolution, highest first, e.g.
        [16, 4, 1]."""
        return list(self.vision_module.nest_ratio) + [1]

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
