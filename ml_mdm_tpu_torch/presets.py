"""The port's model presets, with seeded random weights, configs built in
code (the machine with the card may lack PyYAML).

- ``flagship_64px``: counterpart of ``__graft_entry__._flagship_64px`` and
  the bench preset (``bench.py`` ``main``): the cc12m_64x64 U-Net
  (channels 256/512/768, two ResNets per level, attention at levels 1 and
  2 with text cross-attention and the attention FFN, micro-conditioning
  ``scale:64``), 2048-wide text features projected to 2048, DEEPFLOYD
  schedule, V-prediction.
- ``cc12m_256x256`` and ``cc12m_1024x1024``: the nested models of
  ``configs/models/cc12m_256x256.yaml`` (a 256px shell of 64/128/256
  channels around that 64px core) and ``cc12m_1024x1024.yaml`` (a 1024px
  shell of 32/32/64 channels around the 256px shell), with the outer
  ``conditioning_feature_dim`` set to the T5-XL width 2048 as ``bench.py``
  sets it (without it the YAMLs give the model no text conditioning).

The released checkpoints and the T5 text tower are not in the repository,
so weights are random, made from a seed. By default a preset samples: bf16
weights and compute, ``eval()``. With ``train=True`` it trains as the JAX
package's ``train_256`` bench preset does: the same seeded weights kept in
f32, bf16 compute, ``train()``.
"""
from __future__ import annotations

import copy
import math
import re
from typing import Tuple

import torch

from ml_mdm_tpu_torch.config import (
    DiffusionConfig,
    NestedDiffusionConfig,
    NestedUNetConfig,
    ResNetConfig,
    SamplerConfig,
    UNetConfig,
)
from ml_mdm_tpu_torch.diffusion import Diffusion, NestedDiffusion
from ml_mdm_tpu_torch.models.nested_unet import NestedUNet
from ml_mdm_tpu_torch.models.unet import UNet

# layers the JAX package initialises to zero (its output projections and
# the nested adapters)
_ZERO_INIT = ("conv2", "conv_out", "proj_out", "ffn.3", "main.3", "in_adapter", "out_adapter")
NESTED_PRESETS = ("cc12m_256x256", "cc12m_1024x1024")


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
            or re.search(r"(^|\.)cond_layers\.[^.]+\.1$", owner) is not None
        )
        if zero_init:
            p.copy_(noise * 0.02)
        elif p.dim() >= 2:
            p.copy_(noise / math.sqrt(p[0].numel()))
        else:
            p.fill_(1.0)
    return module


def _build(cls, ucfg, device, seed: int, train: bool):
    """The U-Net with seeded weights: bf16 in eval mode, or f32 with bf16
    compute in training mode."""
    with torch.device("meta"):
        unet = cls(3, 3, ucfg)
    unet = unet.to_empty(device=device)
    init_params_(unet, torch.Generator(device=device).manual_seed(seed))
    if train:
        return unet.set_compute_dtype(torch.bfloat16).train()
    return unet.to(torch.bfloat16).eval()


def flagship_64px(device, seed: int = 0, scaled: bool = False,
                  train: bool = False) -> Tuple[Diffusion, int, int]:
    """Build the flagship pipeline on ``device`` with weights from ``seed``
    (bf16 weights and compute, as the bench preset runs, or with ``train``
    f32 weights and bf16 compute). Returns (pipeline, text width, image
    side)."""
    ucfg, dcfg, lm_dim, side = flagship_configs(scaled)
    return Diffusion(_build(UNet, ucfg, device, seed, train), dcfg), lm_dim, side


def _shell(channels, resnets, micro: str, temporal_dim: int, groups: int,
           inner, **kw) -> NestedUNetConfig:
    """A conv-only shell of the nested models (no attention, no mid blocks)."""
    return NestedUNetConfig(
        resolution_channels=list(channels), num_resnets_per_resolution=list(resnets),
        attention_levels=[], num_attention_layers=[0] * len(channels),
        masked_cross_attention=1, micro_conditioning=micro,
        temporal_dim=temporal_dim, initialize_inner_with_pretrained=None,
        resnet_config=ResNetConfig(num_groups_norm=groups, use_attention_ffn=False),
        inner_config=inner, **kw,
    )


def nested_configs(name: str, scaled: bool = False
                   ) -> Tuple[NestedUNetConfig, NestedDiffusionConfig, int, int]:
    """(U-Net config, diffusion config, text width, image side) of a nested
    preset; ``scaled`` gives a tiny variant of the same structure (the
    scaled flagship as its core, 16- and 8-channel shells)."""
    if name not in NESTED_PRESETS:
        raise ValueError(f"unknown nested preset {name!r}; known: {NESTED_PRESETS}")
    core, _, lm_dim, core_side = flagship_configs(scaled)
    core = copy.deepcopy(core)
    core.conditioning_feature_dim = -1  # handed down by the outer shell
    core.nesting = True
    tdim = core.resolution_channels[0] * 4  # the shells add the core's cond_emb
    groups = core.resnet_config.num_groups_norm
    proj = core.conditioning_feature_proj_dim
    mid_ch, outer_ch = ([16, 16, 32], [8, 8, 16]) if scaled else ([64, 128, 256], [32, 32, 64])
    sc = dict(num_diffusion_steps=1000, schedule_type="DEEPFLOYD",
              prediction_type="V_PREDICTION", loss_target_type="DDPM",
              rescale_signal=1, schedule_shifted=True)
    if name == "cc12m_256x256":
        ucfg = _shell(mid_ch, [2, 2, 1], "scale:256", tdim, groups, core,
                      conditioning_feature_dim=lm_dim, skip_normalization=True)
        dcfg = NestedDiffusionConfig(
            sampler_config=SamplerConfig(**sc), use_vdm_loss_weights=False,
            use_double_loss=True, no_use_residual=True, mixed_ratio="2:1")
        return ucfg, dcfg, lm_dim, core_side * 4
    middle = _shell(mid_ch, [2, 2, 1], "scale:256", tdim, groups, core,
                    conditioning_feature_proj_dim=proj, nesting=True,
                    skip_normalization=False)
    ucfg = _shell(outer_ch, [2, 2, 1], "scale:1024", tdim, groups, middle,
                  conditioning_feature_dim=lm_dim, conditioning_feature_proj_dim=proj,
                  skip_normalization=True)
    dcfg = NestedDiffusionConfig(
        sampler_config=SamplerConfig(**sc, schedule_shifted_power=2),
        use_vdm_loss_weights=False, use_double_loss=True, no_use_residual=True,
        multi_res_weights="16:4:1")
    return ucfg, dcfg, lm_dim, core_side * 16


def nested_preset(name: str, device, seed: int = 0, scaled: bool = False,
                  train: bool = False) -> Tuple[NestedDiffusion, int, int]:
    """Build a nested preset on ``device`` with weights from ``seed`` (bf16,
    or with ``train`` f32 weights and bf16 compute). Returns (pipeline,
    text width, image side)."""
    ucfg, dcfg, lm_dim, side = nested_configs(name, scaled)
    return NestedDiffusion(_build(NestedUNet, ucfg, device, seed, train), dcfg), lm_dim, side


def cc12m_256x256(device, seed: int = 0) -> Tuple[NestedDiffusion, int, int]:
    return nested_preset("cc12m_256x256", device, seed)


def cc12m_1024x1024(device, seed: int = 0) -> Tuple[NestedDiffusion, int, int]:
    return nested_preset("cc12m_1024x1024", device, seed)
