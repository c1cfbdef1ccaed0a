"""Text-conditioned diffusion U-Net of the port (NHWC, PyTorch).

Counterpart of ``ml_mdm_tpu/models/unet.py`` ``UNet``: sinusoidal time
embedding and its 2-layer MLP, the optional learned
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

Space-to-depth packing follows the JAX package's plan (``pack_plan``): a
stage of at most 64 channels at a large side runs packed (``models/layers.py``
``stage_packs_at``), and where stage i of the plan packs, its boundary
tensors stay packed, so a packed stage 0 packs the image once before
``conv_in`` and unpacks the prediction after ``conv_out``. A config with
``pack_min_side = 0`` never packs. The port keeps the loss and the sampling
carry unpacked: the model packs at its own entry.

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

from ml_mdm_tpu_torch.config import UNetConfig, register_model, register_model_config
from ml_mdm_tpu_torch.models.layers import (
    GroupNormF32,
    ResNetBlockStage,
    SelfAttention1DBlock,
    cached_weights,
    conv2d_nhwc,
    dense,
    group_norm_coeffs,
    packed_struct_kernel,
    stage_packs_at,
)
from ml_mdm_tpu_torch.ops import fused_resnet
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from ml_mdm_tpu_torch.tracing import span


def parse_micro_conditions(spec: Optional[str]) -> Optional[Dict[str, float]]:
    if spec is None or spec == "" or str(spec).lower() == "none":
        return None
    return {
        c.split(":")[0]: float(c.split(":")[1]) for c in str(spec).split(",")
    }


def _n_attention(cfg: UNetConfig, level: int) -> int:
    return cfg.num_attention_layers[level] if level in cfg.attention_levels else 0


def _n_temporal_attention(cfg: UNetConfig, level: int) -> Optional[int]:
    n = cfg.num_temporal_attention_layers
    return None if n is None else n[level]


def pack_plan(cfg: UNetConfig, h: int, w: int):
    """The packed-execution plan of a forward at image size (h, w), one
    flag per level (``UNet._pack_plan`` of the JAX package): level i runs
    packed, and its boundary tensors (handoffs, skips, and for level 0 the
    input and output layers) stay packed, when its stage packs at side
    min(h, w) >> i, both sides halve evenly, and it is not the last level
    of a U-Net with mid blocks (they need the plain layout; a nested shell
    has none) nor level 0 of an inner U-Net (its features go back to the
    shell unpacked). Computed from the config alone."""
    side, n = min(h, w), len(cfg.resolution_channels)
    return [
        (i != n - 1 or cfg.skip_mid_blocks)
        and (h >> i) % 2 == 0 and (w >> i) % 2 == 0
        and stage_packs_at(side >> i, cfg.resolution_channels[i], cfg.pack_min_side,
                           _n_attention(cfg, i),
                           cfg.temporal_mode or bool(_n_temporal_attention(cfg, i)))
        and not (i == 0 and cfg.nesting)
        for i in range(n)
    ]


def packs_input(cfg: UNetConfig, side: int) -> bool:
    """Whether a forward at ``side`` runs its level 0 packed by the JAX
    package's ``UNet.packs_input`` (which sets the JAX sampling carry and
    loss boundary packed): a 32-channel conv-only level 0 at or above
    ``pack_min_side``, outside an inner U-Net. The port's plan agrees where
    this holds; it does not use the packed carry."""
    n_tattn0 = _n_temporal_attention(cfg, 0) or 0
    return bool(
        len(cfg.resolution_channels) > 1 and not cfg.nesting and side % 2 == 0
        and cfg.pack_min_side > 0 and side >= cfg.pack_min_side
        and cfg.resolution_channels[0] <= 32 and _n_attention(cfg, 0) == 0
        and n_tattn0 == 0 and not cfg.temporal_mode
    )


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


register_model_config("unet", "unet")(UNetConfig)


@register_model("unet")
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
                pack_min_side=cfg.pack_min_side, **self._temporal_args(i),
            ))
        self.down_blocks = nn.ModuleList(down)

        rc = copy.copy(cfg.resnet_config)
        rc.num_channels = channels
        rc.output_channels = channels
        if not cfg.skip_mid_blocks:
            self.mid_blocks = nn.ModuleList([
                ResNetBlockStage(tdim, 1, 1, False, False, [rc],
                                 conditioning_feature_dim=cond_dim, path="mid"),
                ResNetBlockStage(tdim, 1, 0, False, False, [copy.copy(rc)], path="mid"),
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
                pack_min_side=cfg.pack_min_side, path="up", **self._temporal_args(i),
            ))
        self.up_blocks = nn.ModuleList(up)

        self.norm_out = GroupNormF32(cfg.resnet_config.num_groups_norm, channels)
        self.conv_out = nn.Conv2d(channels, output_channels, 3, padding=1)
        if self.has_cond and cfg.conditioning_feature_proj_dim > 0:
            self.lm_proj = nn.Linear(self.text_dim, cond_dim)
        if self.has_cond and cfg.num_lm_head_layers:
            self.lm_head = nn.ModuleList(
                SelfAttention1DBlock(cond_dim) for _ in range(cfg.num_lm_head_layers))
        self.kernels = True

    def _temporal_args(self, level: int) -> dict:
        """What the down and up stages of ``level`` take of the temporal
        fields (the mid blocks take none)."""
        cfg = self.config
        return dict(temporal_mode=cfg.temporal_mode,
                    temporal_pos_emb=cfg.temporal_positional_encoding,
                    temporal_spatial_ds=cfg.temporal_spatial_ds,
                    num_temporal_attention_layers=_n_temporal_attention(cfg, level))

    def _n_attn(self, level: int) -> int:
        return _n_attention(self.config, level)

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
        """Route the ResNet convs, the packed input, output and upsample
        convs and the 4-D bf16 GroupNorm statistics through the hand kernels
        (the default) or through their plain versions."""
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

    def _pack_plan(self, x_t):
        """``pack_plan`` of this U-Net's config at x_t's size (the first of
        a list)."""
        if isinstance(x_t, (list, tuple)):
            x_t = x_t[0]
        return pack_plan(self.config, x_t.shape[1], x_t.shape[2])

    def packs_input(self, side: int) -> bool:
        return packs_input(self.config, side)

    def forward_input_layer(self, x_t, normalize: bool = False, packed: bool = False):
        """conv_in, after dividing each image by its standard deviation
        (over H, W, C, ddof 1, in f32) when ``normalize``. ``packed``: the
        image is packed first and conv_in runs on the packed tensor (3 -> 12
        channels), through K2·struct when sampling; the output is packed."""
        if isinstance(x_t, (list, tuple)) and len(x_t) == 1:
            x_t = x_t[0]
        if normalize:
            std = x_t.float().std(dim=(1, 2, 3), keepdim=True, correction=1)
            x_t = x_t / std.to(x_t.dtype)
        if not packed:
            return conv2d_nhwc(x_t, self.conv_in, self.dtype)
        xp = s2d.space_to_depth(x_t.to(self.dtype))
        k, fast = self.conv_in.weight.permute(2, 3, 1, 0), self.kernels and not self.training
        # K2·struct takes the combined taps, the library conv the packed kernel
        pk = cached_weights(self, ("conv_in", fast), [self.conv_in],
                            lambda: (packed_struct_kernel if fast else s2d.pack_conv3x3_kernel)(k))
        return s2d.packed_conv(xp, k, self.conv_in.bias, fast=fast, pk=pk)

    def forward_downsample(self, x, temb, conditioning=None, cond_mask=None, plan=None):
        """The down path; returns (x, the skip activations). ``plan``
        (``_pack_plan``) says which levels run packed; the last level's
        output keeps its own form."""
        plan = plan or [False] * len(self.down_blocks)
        skips = [x]
        for i, block in enumerate(self.down_blocks):
            x, acts = block(x, temb, conditioning=conditioning, cond_mask=cond_mask,
                            packed_in=plan[i], packed_out=plan[min(i + 1, len(plan) - 1)])
            skips.extend(acts)
        return x, skips

    def forward_upsample(self, x, temb, conditioning, cond_mask, skip_activations,
                         plan=None):
        """The up path, each stage taking its skips in reverse order; each
        stage's output leaves in the form of the level below it (level 0's
        in level 0's, for the output layer)."""
        skips = list(skip_activations)
        num_res = len(self.config.resolution_channels)
        plan = plan or [False] * num_res
        for i, block in enumerate(self.up_blocks):
            ri = num_res - 1 - i
            num_skip = self.config.num_resnets_per_resolution[ri] + 1
            skip_connections = skips[-num_skip:][::-1]
            del skips[-num_skip:]
            x, _ = block(x, temb, skip_activations=skip_connections,
                         conditioning=conditioning, cond_mask=cond_mask,
                         packed_in=plan[ri], packed_out=plan[max(ri - 1, 0)])
        return x

    def forward_output_layer(self, x, packed: bool = False):
        """norm_out, SiLU and conv_out. ``packed``: x is packed; the norm's
        scale and bias are repeated, conv_out runs on the packed tensor (K2·
        struct with the affine and SiLU fused in when sampling) and the
        prediction is unpacked."""
        if not packed:
            return conv2d_nhwc(F.silu(self.norm_out(x)), self.conv_out, self.dtype)
        n, vec = self.norm_out, s2d.pack_channel_vector
        k, bias = self.conv_out.weight.permute(2, 3, 1, 0), self.conv_out.bias
        fast = self.kernels and not self.training

        def build():
            if not fast:
                return vec(n.weight), vec(n.bias), None, None
            # the kernel stores whole groups of 8 output channels: the 12 of the
            # packed image get zero weights up to 16, and the extra are dropped
            wq, bq = packed_struct_kernel(k), vec(bias)
            pad = -wq.shape[-1] % 8
            return vec(n.weight), vec(n.bias), F.pad(wq, (0, pad)), F.pad(bq, (0, pad))

        scale, shift, wq, bq = cached_weights(self, ("conv_out", fast), [n, self.conv_out], build)
        a, b = group_norm_coeffs(x, scale, shift, n.num_groups, kernels=n.kernels)
        if fast:
            y = fused_resnet.affine_silu_conv3x3(x, a, b, wq, bq, packed_struct=True)
            y = y[..., :4 * k.shape[-1]]
        else:
            dt = x.dtype
            y = s2d.packed_conv(F.silu(x * a.to(dt)[:, None, None, :] + b.to(dt)[:, None, None, :]),
                                k.to(self.dtype), bias)
        return s2d.depth_to_space(y)

    def forward_denoising(self, x_t, times, cond_emb=None, conditioning=None,
                          cond_mask=None, micros=None):
        temb = self.time_embedding(times, cond_emb, micros)
        x_feat = None
        if self.config.nesting:
            x_t, x_feat = x_t
        plan = self._pack_plan(x_t)
        x = self.forward_input_layer(x_t, packed=plan[0])
        if x_feat is not None:
            x = x + x_feat  # plan[0] is False for an inner U-Net
        x, skips = self.forward_downsample(x, temb, conditioning, cond_mask, plan)
        if not self.config.skip_mid_blocks:
            x, _ = self.mid_blocks[0](x, temb, conditioning=conditioning,
                                      cond_mask=cond_mask)
            x, _ = self.mid_blocks[1](x, temb)
        x = self.forward_upsample(x, temb, conditioning, cond_mask, skips, plan)
        x_out = self.forward_output_layer(x, packed=plan[0])
        if self.config.nesting:
            return x_out, x
        return x_out

    def forward(self, x_t, times, conditioning=None, cond_mask=None, micros=None):
        """x_t (B, H, W, C_in), times (B,) int -> prediction (B, H, W, C_out)
        in the compute dtype (a nested U-Net takes and returns one image
        per resolution, highest first). It runs in the span "unet: forward"
        (``tracing.py``); a nested U-Net's inner levels open none."""
        with span("unet: forward"):
            cond_emb = None
            if self.effective_cond_dim > 0:
                cond_emb, conditioning, cond_mask = self.forward_conditioning(
                    conditioning, cond_mask)
            return self.forward_denoising(x_t, times, cond_emb, conditioning,
                                          cond_mask, micros)
