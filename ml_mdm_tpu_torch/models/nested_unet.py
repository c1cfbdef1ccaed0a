"""Nested (Matryoshka) U-Net of the port: an outer shell whose middle is a
whole inner U-Net (``ml_mdm_tpu/models/nested_unet.py`` ``NestedUNet``).

The shell is a ``UNet`` without mid blocks, at the highest resolution. Its
down path ends at the inner U-Net's resolution, where the zero-init
``in_adapter`` (3x3 conv) hands its features to the inner U-Net, and the
zero-init ``out_adapter`` adds the inner U-Net's last features back before
the shell's up path. The forward takes one image per resolution,
``[x_hi, ..., x_lo]``, and returns one prediction per resolution in the
same order. Every shell has its own time and micro-conditioning
embeddings; the text conditioning is the innermost U-Net's, shared by all.
When the high-resolution batch is smaller than the low-resolution one (a
mixed batch), the inner U-Net's extra rows get zero features.

The shell follows its own packing plan (``models/unet.py`` ``pack_plan``).
When its bottom level ran packed, the adapters are the one place that
needs the plain layout: the features are unpacked before ``in_adapter``
and packed again after the inner U-Net's are added back.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn

from ml_mdm_tpu_torch.config import (
    Nested2UNetConfig,
    Nested3UNetConfig,
    Nested4UNetConfig,
    NestedUNetConfig,
    register_model,
    register_model_config,
)
from ml_mdm_tpu_torch.models.layers import conv2d_nhwc
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from ml_mdm_tpu_torch.models.unet import UNet


def compute_nest_ratio(config) -> List[int]:
    """Downsampling ratio of each shell to the innermost resolution,
    outermost first (e.g. [16, 4] for the 1024/256/64 model)."""
    ratio = int(2 ** (len(config.resolution_channels) - 1))
    if config.temporal_mode and not config.temporal_spatial_ds:
        ratio = int(np.sqrt(ratio))
    inner = getattr(config, "inner_config", None)
    if inner is not None and getattr(inner, "inner_config", None) is not None:
        inner_ratios = compute_nest_ratio(inner)
        return [ratio * inner_ratios[0]] + inner_ratios
    return [ratio]


for _name, _cls in (("nested_unet", NestedUNetConfig), ("nested2_unet", Nested2UNetConfig),
                   ("nested3_unet", Nested3UNetConfig), ("nested4_unet", Nested4UNetConfig)):
    register_model_config(_name, "nested_unet")(_cls)


@register_model("nested_unet")
class NestedUNet(UNet):
    def __init__(self, input_channels: int, output_channels: int,
                 config: NestedUNetConfig, cond_dim_override=None, text_dim=None):
        super().__init__(input_channels, output_channels, config, cond_dim_override,
                         text_dim)
        inner_cfg = config.inner_config
        inner_cls = NestedUNet if getattr(inner_cfg, "inner_config", None) is not None else UNet
        self.inner_unet = inner_cls(input_channels, output_channels, inner_cfg,
                                    cond_dim_override=self.effective_cond_dim,
                                    text_dim=self.text_dim)
        if not config.skip_inner_unet_input:
            self.in_adapter = nn.Conv2d(config.resolution_channels[-1],
                                        inner_cfg.resolution_channels[0], 3, padding=1)
        self.out_adapter = nn.Conv2d(inner_cfg.resolution_channels[0],
                                     config.resolution_channels[-1], 3, padding=1)
        if config.interp_conditioning:
            # in the reference checkpoints; no forward uses them
            self.interp_layer1 = nn.Linear(self.temporal_dim // 4, self.temporal_dim)
            self.interp_layer2 = nn.Linear(self.temporal_dim, self.temporal_dim)

    @property
    def nest_ratio(self) -> List[int]:
        return compute_nest_ratio(self.config)

    @property
    def is_temporal(self) -> List[bool]:
        """For each shell, outermost first, whether it resamples across
        frames (``temporal_mode`` without ``temporal_spatial_ds``)."""
        flags = []
        cfg = self.config
        while getattr(cfg, "inner_config", None) is not None:
            flags.append(bool(cfg.temporal_mode and not cfg.temporal_spatial_ds))
            cfg = cfg.inner_config
        return flags

    def forward_conditioning(self, conditioning, cond_mask):
        return self.inner_unet.forward_conditioning(conditioning, cond_mask)

    def forward_denoising(self, x_t, times, cond_emb=None, conditioning=None,
                          cond_mask=None, micros=None):
        cfg = self.config
        temb = self.time_embedding(times, cond_emb, micros)
        x_feat = None
        if cfg.nesting:
            x_t, x_feat = x_t
        bh, bl = x_t[0].shape[0], x_t[1].shape[0]
        plan = self._pack_plan(x_t[0])
        x = self.forward_input_layer(x_t[0], normalize=not cfg.skip_normalization,
                                     packed=plan[0])
        if x_feat is not None:
            x = x + x_feat  # plan[0] is False for an inner shell
        cm = cond_mask[:bh] if cond_mask is not None else None
        cond_hi = conditioning[:bh] if conditioning is not None else None
        x, skips = self.forward_downsample(x, temb[:bh], cond_hi, cm, plan)
        if plan[-1]:
            x = s2d.depth_to_space(x)

        dt = self.dtype
        x_inner = (conv2d_nhwc(x, self.in_adapter, dt) if hasattr(self, "in_adapter")
                   else None)
        if x_inner is not None and bh < bl:
            pad = x_inner.new_zeros((bl - bh,) + tuple(x_inner.shape[1:]))
            x_inner = torch.cat([x_inner, pad], dim=0)
        x_low, x_inner = self.inner_unet.forward_denoising(
            (list(x_t[1:]), x_inner), times, cond_emb, conditioning, cond_mask, micros)
        x = x + conv2d_nhwc(x_inner, self.out_adapter, dt)[:bh]
        if plan[-1]:
            x = s2d.space_to_depth(x)

        x = self.forward_upsample(x, temb[:bh], cond_hi, cm, skips, plan)
        out = [self.forward_output_layer(x, packed=plan[0])]
        out += x_low if isinstance(x_low, list) else [x_low]
        if cfg.nesting:
            return out, x
        return out
