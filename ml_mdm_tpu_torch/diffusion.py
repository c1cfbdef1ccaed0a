"""Diffusion pipeline of the port: the model wrapper and sampling entry.

Counterpart of ``ml_mdm_tpu/diffusion.py`` ``Model`` and ``Diffusion``
(sampling only; the training loss is not ported yet). The pipeline owns
the U-Net module, so there is no separate params argument.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ml_mdm_tpu_torch.config import DiffusionConfig
from ml_mdm_tpu_torch.samplers import Sampler


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
