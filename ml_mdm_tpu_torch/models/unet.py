"""Text-conditioned diffusion U-Net of the port (NHWC, PyTorch).

Counterpart of ``ml_mdm_tpu/models/unet.py`` ``UNet`` without packing:
sinusoidal time embedding and its 2-layer MLP, the optional learned
lm-head (self-attention blocks over the text features), pooled-text
conditioning added to the time embedding, micro-conditioning
(``scale:64``), the down path, two mid blocks, the up path with skip
concats, and ``norm_out`` / ``conv_out``. A temporal U-Net
(``temporal_mode``, ``num_temporal_attention_layers``) takes the frames of
its videos as ``(b t)`` rows beside per-video times and text. The forward
comes in the JAX package's pieces (input layer, down path, up path, output
layer), which ``models/nested_unet.py`` reuses for its shells. With
``nesting`` the U-Net is the inner level of a nested one: it takes
``(x_t, x_feat)``, adds the shell's features after its input layer, and
returns ``(x_out, x)``, its output and its last features.

The U-Net computes in its ``dtype``: the compute dtype that
``set_compute_dtype`` sets (bf16 on f32 parameters for training, as the
JAX package's ``dtype=bfloat16`` modules), by default the parameters'
own. ``train()`` switches every ResNet to the training route.
"""
from __future__ import annotations

import copy
import functools
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
    SelfAttention1DBlock,
    conv2d_nhwc,
    dense,
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


@functools.lru_cache(maxsize=None)
def _frequencies_on(temporal_dim: int, device: torch.device) -> torch.Tensor:
    """The frequency table on ``device``, copied there once (a copy from host
    memory synchronises the stream)."""
    return torch.from_numpy(sinusoidal_frequencies(temporal_dim)).to(device)


def sinusoidal_embedding(times: torch.Tensor, temporal_dim: int) -> torch.Tensor:
    freqs = _frequencies_on(temporal_dim, times.device)
    temb = times.float().reshape(-1, 1) * freqs[None, :]
    return torch.cat([torch.sin(temb), torch.cos(temb)], dim=1)


class UNet(nn.Module):
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, input_channels: int, output_channels: int,
                 config: UNetConfig, cond_dim_override: Optional[int] = None,
                 text_dim: Optional[int] = None):
        """``cond_dim_override``: the conditioning width an outer nested
        shell hands down (its effective width), in place of the config's.
        ``text_dim``: the width of the text features themselves, which
        ``lm_proj`` takes (Flax infers it from the data); by default the
        input conditioning width."""
        super().__init__()
        cfg = config
        self.config = cfg
        self.cond_dim_override = cond_dim_override
        self.text_dim = self.input_conditioning_feature_dim if text_dim is None else text_dim
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
                **self._temporal_args(i),
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
                **self._temporal_args(i),
            ))
        self.up_blocks = nn.ModuleList(up)

        self.norm_out = GroupNormF32(cfg.resnet_config.num_groups_norm, channels)
        self.conv_out = nn.Conv2d(channels, output_channels, 3, padding=1)
        if self.has_cond and cfg.conditioning_feature_proj_dim > 0:
            self.lm_proj = nn.Linear(self.text_dim, cond_dim)
        if self.has_cond and cfg.num_lm_head_layers:
            self.lm_head = nn.ModuleList(
                SelfAttention1DBlock(cond_dim) for _ in range(cfg.num_lm_head_layers))

    def _temporal_args(self, level: int) -> dict:
        """What the down and up stages of ``level`` take of the temporal
        fields (the mid blocks take none)."""
        cfg = self.config
        n = cfg.num_temporal_attention_layers
        return dict(temporal_mode=cfg.temporal_mode,
                    temporal_pos_emb=cfg.temporal_positional_encoding,
                    temporal_spatial_ds=cfg.temporal_spatial_ds,
                    num_temporal_attention_layers=None if n is None else n[level])

    def _n_attn(self, level: int) -> int:
        cfg = self.config
        return cfg.num_attention_layers[level] if level in cfg.attention_levels else 0

    @property
    def temporal_dim(self) -> int:
        cfg = self.config
        return cfg.resolution_channels[0] * 4 if cfg.temporal_dim is None else cfg.temporal_dim

    @property
    def input_conditioning_feature_dim(self) -> int:
        if self.cond_dim_override is not None:
            return self.cond_dim_override
        return self.config.conditioning_feature_dim

    @property
    def effective_cond_dim(self) -> int:
        """conditioning_feature_dim after the optional projection."""
        cfg = self.config
        in_dim = self.input_conditioning_feature_dim
        if in_dim > 0 and cfg.conditioning_feature_proj_dim > 0:
            return cfg.conditioning_feature_proj_dim
        return in_dim

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (by default the parameters' dtype)."""
        return self.compute_dtype or self.conv_in.weight.dtype

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "UNet":
        """Compute in ``dtype`` whatever the parameters' dtype: every conv
        and dense layer casts its input, weight and bias to it at use (None:
        the parameters' dtype)."""
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

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
        dt = self.dtype
        temb = sinusoidal_embedding(times, self.temporal_dim).to(dt)
        return dense(F.silu(dense(temb, layer1, dt)), layer2, dt)

    def forward_conditioning(self, conditioning, cond_mask):
        cfg = self.config
        if cfg.conditioning_feature_proj_dim > 0:
            conditioning = dense(conditioning, self.lm_proj, self.dtype)
        heads = getattr(self, "lm_head", ())
        for head in heads:  # masked only under masked_cross_attention
            conditioning = head(conditioning,
                                mask=cond_mask if cfg.masked_cross_attention else None)
        if cond_mask is None or (not cfg.masked_cross_attention and len(heads) > 0):
            y = conditioning.mean(dim=1)
        else:
            mask = cond_mask.to(conditioning.dtype)
            denom = mask.sum(dim=1, keepdim=True)
            y = (mask[..., None] * conditioning).sum(dim=1) / torch.clamp(denom, min=1e-6)
        if not cfg.masked_cross_attention:
            cond_mask = None
        return dense(y, self.cond_emb, self.dtype), conditioning, cond_mask

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

    def time_embedding(self, times, cond_emb=None, micros=None):
        """The time embedding plus the pooled text (``cond_emb``) and the
        micro-conditioning embeddings."""
        temb = self.create_temporal_embedding(times)
        if cond_emb is not None:
            temb = temb + cond_emb
        if self.conditions is not None:
            temb = temb + self.forward_micro_conditioning(times, micros or {})
        return temb

    def forward_input_layer(self, x_t, normalize: bool = False):
        """conv_in, after dividing each image by its standard deviation
        (over H, W, C, ddof 1, in f32) when ``normalize``."""
        if isinstance(x_t, (list, tuple)) and len(x_t) == 1:
            x_t = x_t[0]
        if normalize:
            std = x_t.float().std(dim=(1, 2, 3), keepdim=True, correction=1)
            x_t = x_t / std.to(x_t.dtype)
        return conv2d_nhwc(x_t, self.conv_in, self.dtype)

    def forward_downsample(self, x, temb, conditioning=None, cond_mask=None):
        """The down path; returns (x, the skip activations)."""
        skips = [x]
        for block in self.down_blocks:
            x, acts = block(x, temb, conditioning=conditioning, cond_mask=cond_mask)
            skips.extend(acts)
        return x, skips

    def forward_upsample(self, x, temb, conditioning, cond_mask, skip_activations):
        """The up path, each stage taking its skips in reverse order."""
        skips = list(skip_activations)
        num_res = len(self.config.resolution_channels)
        for i, block in enumerate(self.up_blocks):
            num_skip = self.config.num_resnets_per_resolution[num_res - 1 - i] + 1
            skip_connections = skips[-num_skip:][::-1]
            del skips[-num_skip:]
            x, _ = block(x, temb, skip_activations=skip_connections,
                         conditioning=conditioning, cond_mask=cond_mask)
        return x

    def forward_output_layer(self, x):
        return conv2d_nhwc(F.silu(self.norm_out(x)), self.conv_out, self.dtype)

    def forward_denoising(self, x_t, times, cond_emb=None, conditioning=None,
                          cond_mask=None, micros=None):
        temb = self.time_embedding(times, cond_emb, micros)
        x_feat = None
        if self.config.nesting:
            x_t, x_feat = x_t
        x = self.forward_input_layer(x_t)
        if x_feat is not None:
            x = x + x_feat
        x, skips = self.forward_downsample(x, temb, conditioning, cond_mask)
        if not self.config.skip_mid_blocks:
            x, _ = self.mid_blocks[0](x, temb, conditioning=conditioning,
                                      cond_mask=cond_mask)
            x, _ = self.mid_blocks[1](x, temb)
        x = self.forward_upsample(x, temb, conditioning, cond_mask, skips)
        x_out = self.forward_output_layer(x)
        if self.config.nesting:
            return x_out, x
        return x_out

    def forward(self, x_t, times, conditioning=None, cond_mask=None, micros=None):
        """x_t (B, H, W, C_in), times (B,) int -> prediction (B, H, W, C_out)
        in the compute dtype (a nested U-Net takes and returns one image
        per resolution, highest first)."""
        cond_emb = None
        if self.effective_cond_dim > 0:
            cond_emb, conditioning, cond_mask = self.forward_conditioning(
                conditioning, cond_mask)
        return self.forward_denoising(x_t, times, cond_emb, conditioning,
                                      cond_mask, micros)
