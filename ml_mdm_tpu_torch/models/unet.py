"""Text-conditioned diffusion U-Net of the port (NHWC, PyTorch).

Counterpart of ``ml_mdm_tpu/models/unet.py`` ``UNet`` without packing,
nesting, temporal mode or the learned lm_head: sinusoidal time embedding
and its 2-layer MLP, pooled-text conditioning added to the time embedding,
micro-conditioning (``scale:64``), the down path, two mid blocks, the up
path with skip concats, and ``norm_out`` / ``conv_out``.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ml_mdm_tpu_torch.config import UNetConfig
from ml_mdm_tpu_torch.models.layers import (
    GroupNormF32,
    ResNetBlockStage,
    conv2d_nhwc,
)


def parse_micro_conditions(spec: Optional[str]) -> Optional[Dict[str, float]]:
    if spec is None or spec == "" or str(spec).lower() == "none":
        return None
    return {
        c.split(":")[0]: float(c.split(":")[1]) for c in str(spec).split(",")
    }


def sinusoidal_frequencies(temporal_dim: int) -> np.ndarray:
    """Frequency table shared by the time and micro-conditioning embeddings."""
    half_dim = temporal_dim // 8
    emb = math.log(10000) / half_dim
    return np.exp(np.arange(half_dim, dtype=np.float64) * -emb).astype(np.float32)


def sinusoidal_embedding(times: torch.Tensor, temporal_dim: int) -> torch.Tensor:
    freqs = torch.from_numpy(sinusoidal_frequencies(temporal_dim)).to(times.device)
    temb = times.float().reshape(-1, 1) * freqs[None, :]
    return torch.cat([torch.sin(temb), torch.cos(temb)], dim=1)


class UNet(nn.Module):
    def __init__(self, input_channels: int, output_channels: int,
                 config: UNetConfig):
        super().__init__()
        cfg = config
        if cfg.nesting or cfg.temporal_mode or cfg.num_temporal_attention_layers:
            raise NotImplementedError("nested and temporal U-Nets are not ported yet")
        if cfg.num_lm_head_layers:
            raise NotImplementedError("the learned lm_head is not ported yet")
        self.config = cfg
        self.input_channels = input_channels
        self.output_channels = output_channels
        tdim = self.temporal_dim
        cond_dim = self.effective_cond_dim
        sin_dim = 2 * (tdim // 8)

        self.temb_layer1 = nn.Linear(sin_dim, tdim)
        self.temb_layer2 = nn.Linear(tdim, tdim)
        self.has_cond = cond_dim > 0 and not cfg.skip_cond_emb
        if self.has_cond:
            self.cond_emb = nn.Linear(cond_dim, tdim, bias=False)
        self.conditions = parse_micro_conditions(cfg.micro_conditioning)
        if self.conditions is not None:
            self.cond_layers = nn.ModuleDict({
                key: nn.ModuleList([nn.Linear(sin_dim, tdim), nn.Linear(tdim, tdim)])
                for key in self.conditions
            })

        channels = cfg.resolution_channels[0]
        self.conv_in = nn.Conv2d(input_channels, channels, 3, padding=1)

        skip_channels = [channels]
        num_res = len(cfg.resolution_channels)
        down = []
        for i in range(num_res):
            stage_cfgs = []
            for _ in range(cfg.num_resnets_per_resolution[i]):
                rc = copy.copy(cfg.resnet_config)
                rc.num_channels = channels
                rc.output_channels = cfg.resolution_channels[i]
                skip_channels.append(rc.output_channels)
                stage_cfgs.append(rc)
                channels = rc.output_channels
            if i != num_res - 1:
                skip_channels.append(stage_cfgs[-1].output_channels)
            down.append(ResNetBlockStage(
                tdim, cfg.num_resnets_per_resolution[i], self._n_attn(i),
                downsample_output=i != num_res - 1, upsample_output=False,
                resnet_configs=stage_cfgs,
                conditioning_feature_dim=(
                    cond_dim if i in cfg.attention_levels else -1),
            ))
        self.down_blocks = nn.ModuleList(down)

        rc = copy.copy(cfg.resnet_config)
        rc.num_channels = channels
        rc.output_channels = channels
        if not cfg.skip_mid_blocks:
            self.mid_blocks = nn.ModuleList([
                ResNetBlockStage(tdim, 1, 1, False, False, [rc],
                                 conditioning_feature_dim=cond_dim),
                ResNetBlockStage(tdim, 1, 0, False, False, [copy.copy(rc)]),
            ])

        up = []
        for i in reversed(range(num_res)):
            stage_cfgs = []
            for _ in range(cfg.num_resnets_per_resolution[i] + 1):
                rc = copy.copy(cfg.resnet_config)
                rc.num_channels = channels + skip_channels.pop()
                rc.output_channels = cfg.resolution_channels[i]
                stage_cfgs.append(rc)
                channels = rc.output_channels
            up.append(ResNetBlockStage(
                tdim, cfg.num_resnets_per_resolution[i] + 1, self._n_attn(i),
                downsample_output=False, upsample_output=i != 0,
                resnet_configs=stage_cfgs,
                conditioning_feature_dim=(
                    cond_dim if i in cfg.attention_levels else -1),
            ))
        self.up_blocks = nn.ModuleList(up)

        self.norm_out = GroupNormF32(cfg.resnet_config.num_groups_norm, channels)
        self.conv_out = nn.Conv2d(channels, output_channels, 3, padding=1)
        if self.has_cond and cfg.conditioning_feature_proj_dim > 0:
            self.lm_proj = nn.Linear(cfg.conditioning_feature_dim, cond_dim)

    def _n_attn(self, level: int) -> int:
        cfg = self.config
        return cfg.num_attention_layers[level] if level in cfg.attention_levels else 0

    @property
    def temporal_dim(self) -> int:
        cfg = self.config
        return cfg.resolution_channels[0] * 4 if cfg.temporal_dim is None else cfg.temporal_dim

    @property
    def effective_cond_dim(self) -> int:
        """conditioning_feature_dim after the optional projection."""
        cfg = self.config
        in_dim = cfg.conditioning_feature_dim
        if in_dim > 0 and cfg.conditioning_feature_proj_dim > 0:
            return cfg.conditioning_feature_proj_dim
        return in_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def use_kernels(self, enabled: bool = True) -> "UNet":
        """Route the ResNet convs and 4-D bf16 GroupNorm statistics through
        the hand kernels (the default) or through their plain versions."""
        for m in self.modules():
            if hasattr(m, "kernels"):
                m.kernels = enabled
        return self

    # -- forward pieces ------------------------------------------------------

    def create_temporal_embedding(self, times, ff_layers=None):
        layer1, layer2 = ff_layers or (self.temb_layer1, self.temb_layer2)
        temb = sinusoidal_embedding(times, self.temporal_dim).to(self.dtype)
        return layer2(F.silu(layer1(temb)))

    def forward_conditioning(self, conditioning, cond_mask):
        cfg = self.config
        if cfg.conditioning_feature_proj_dim > 0:
            conditioning = self.lm_proj(conditioning.to(self.dtype))
        if cond_mask is None:
            y = conditioning.mean(dim=1)
        else:
            mask = cond_mask.to(conditioning.dtype)
            denom = mask.sum(dim=1, keepdim=True)
            y = (mask[..., None] * conditioning).sum(dim=1) / torch.clamp(denom, min=1e-6)
        if not cfg.masked_cross_attention:
            cond_mask = None
        return self.cond_emb(y), conditioning, cond_mask

    def forward_micro_conditioning(self, times, micros):
        temb = 0.0
        for key, default in self.conditions.items():
            micro = micros.get(key)
            if micro is None:
                micro = torch.full(times.shape, default, device=times.device)
            micro = micro.float()
            if key == "scale":
                micro = torch.clamp(micro / default, max=1.0) * default
            else:
                micro = micro * 1000.0
            temb = temb + self.create_temporal_embedding(
                micro, ff_layers=tuple(self.cond_layers[key]))
        return temb

    def forward_denoising(self, x_t, times, cond_emb=None, conditioning=None,
                          cond_mask=None, micros=None):
        micros = micros or {}
        temb = self.create_temporal_embedding(times)
        if cond_emb is not None:
            temb = temb + cond_emb
        if self.conditions is not None:
            temb = temb + self.forward_micro_conditioning(times, micros)

        x = conv2d_nhwc(x_t, self.conv_in)
        skips = [x]
        for block in self.down_blocks:
            x, acts = block(x, temb, conditioning=conditioning, cond_mask=cond_mask)
            skips.extend(acts)
        if not self.config.skip_mid_blocks:
            x, _ = self.mid_blocks[0](x, temb, conditioning=conditioning,
                                      cond_mask=cond_mask)
            x, _ = self.mid_blocks[1](x, temb)
        num_res = len(self.config.resolution_channels)
        for i, block in enumerate(self.up_blocks):
            num_skip = self.config.num_resnets_per_resolution[num_res - 1 - i] + 1
            skip_connections = skips[-num_skip:][::-1]
            del skips[-num_skip:]
            x, _ = block(x, temb, skip_activations=skip_connections,
                         conditioning=conditioning, cond_mask=cond_mask)
        return conv2d_nhwc(F.silu(self.norm_out(x)), self.conv_out)

    def forward(self, x_t, times, conditioning=None, cond_mask=None, micros=None):
        """x_t (B, H, W, C_in), times (B,) int -> prediction (B, H, W, C_out)
        in the weights' dtype."""
        cond_emb = None
        if self.effective_cond_dim > 0:
            cond_emb, conditioning, cond_mask = self.forward_conditioning(
                conditioning, cond_mask)
        return self.forward_denoising(x_t, times, cond_emb, conditioning,
                                      cond_mask, micros)
