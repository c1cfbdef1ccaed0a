"""The flagship cc12m_64x64 preset of the port, with seeded random weights.

Counterpart of ``__graft_entry__._flagship_64px`` and the bench preset
(``bench.py`` ``main``): the cc12m_64x64 U-Net (channels 256/512/768, two
ResNets per level, attention at levels 1 and 2 with text cross-attention
and the attention FFN, micro-conditioning ``scale:64``), 2048-wide text
features projected to 2048, DEEPFLOYD schedule, V-prediction. The
released checkpoints and the T5 text tower are not in the repository, so
weights are random, made from a seed.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ml_mdm_tpu_torch.config import (
    DiffusionConfig,
    ResNetConfig,
    SamplerConfig,
    UNetConfig,
)
from ml_mdm_tpu_torch.diffusion import Diffusion
from ml_mdm_tpu_torch.models.unet import UNet

# layers the JAX package initialises to zero (its output projections)
_ZERO_INIT = ("conv2", "conv_out", "proj_out", "ffn.3")


def flagship_configs(scaled: bool = False) -> Tuple[UNetConfig, DiffusionConfig, int, int]:
    """(unet config, diffusion config, text width, image side) of the
    flagship; ``scaled`` gives the tiny variant of the same structure."""
    if scaled:
        ucfg = UNetConfig(
            resolution_channels=[32, 64, 96],
            num_resnets_per_resolution=[1, 1, 1],
            attention_levels=[1, 2],
            num_attention_layers=[0, 1, 1],
            conditioning_feature_dim=32,
            conditioning_feature_proj_dim=24,
            masked_cross_attention=0,
            micro_conditioning="scale:16",
            resnet_config=ResNetConfig(num_groups_norm=8, use_attention_ffn=False),
        )
        lm_dim, side = 32, 16
    else:
        ucfg = UNetConfig(
            resolution_channels=[256, 512, 768],
            num_resnets_per_resolution=[2, 2, 2],
            attention_levels=[1, 2],
            num_attention_layers=[0, 1, 5],
            conditioning_feature_dim=2048,
            conditioning_feature_proj_dim=2048,
            masked_cross_attention=0,
            micro_conditioning="scale:64",
            resnet_config=ResNetConfig(num_groups_norm=32, use_attention_ffn=True),
        )
        lm_dim, side = 2048, 64
    dcfg = DiffusionConfig(
        sampler_config=SamplerConfig(
            num_diffusion_steps=1000,
            schedule_type="DEEPFLOYD",
            prediction_type="V_PREDICTION",
            loss_target_type="DDPM",
        ),
        use_vdm_loss_weights=False,
    )
    return ucfg, dcfg, lm_dim, side


@torch.no_grad()
def init_params_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded initialisation in place. Weights of rank >= 2 are normal with
    std 1/sqrt(fan_in) (the JAX package's lecun-normal scale), norm weights
    are 1, and the leaves the JAX package initialises to zero (biases and
    the zero-init output projections) are filled with normals times 0.02:
    a U-Net with those leaves at zero outputs exactly 0."""
    for name, p in module.named_parameters():
        noise = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
        owner, leaf = name.rsplit(".", 1)
        zero_init = (
            leaf == "bias"
            or owner.endswith(_ZERO_INIT)
            or (owner.startswith("cond_layers.") and owner.endswith(".1"))
        )
        if zero_init:
            p.copy_(noise * 0.02)
        elif p.dim() >= 2:
            p.copy_(noise / math.sqrt(p[0].numel()))
        else:
            p.fill_(1.0)
    return module


def flagship_64px(device, seed: int = 0,
                  scaled: bool = False) -> Tuple[Diffusion, int, int]:
    """Build the flagship pipeline on ``device`` with bf16 weights from
    ``seed`` (bf16 weights and compute, as the bench preset runs).
    Returns (pipeline, text width, image side)."""
    ucfg, dcfg, lm_dim, side = flagship_configs(scaled)
    with torch.device("meta"):
        unet = UNet(3, 3, ucfg)
    unet = unet.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_params_(unet, gen)
    unet = unet.to(torch.bfloat16).eval()
    return Diffusion(unet, dcfg), lm_dim, side
