"""Building blocks of the port's U-Net (NHWC tensors, PyTorch modules).

Counterpart of ``ml_mdm_tpu/models/layers.py``, unpacked and non-temporal
only. Activations keep the JAX layout (B, H, W, C); a 3x3 convolution runs
on the ``permute(0, 3, 1, 2)`` view, which is channels-last in memory.
Parameter names are the reference torch names
(``down_blocks.0.resnets.1.conv1.weight``), so JAX weights load through
``utils.convert.params_from_jax`` and ``load_state_dict(strict=True)``.

Modules that own a hand kernel carry a ``kernels`` attribute (default
True). With it, the ResNet block and every 4-D bf16 GroupNorm call the
kernel wrappers, which launch the kernel on a CUDA tensor and run the
plain version on a CPU tensor. ``UNet.use_kernels(False)`` makes them call
the plain versions on any device, so the two paths can be compared on the
card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ml_mdm_tpu_torch.config import ResNetConfig
from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats
from ml_mdm_tpu_torch.ops.attention import dot_product_attention


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample in NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU under f32, the tanh form under bf16 (as in the JAX
    package, where the two agree to below a bf16 rounding)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class GELU(nn.Module):
    """Parameterless slot ``ffn.2`` of the attention FFN."""

    def forward(self, x):
        return gelu(x)


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply a torch Conv2d to an NHWC tensor, in x's dtype."""
    y = conv(x.permute(0, 3, 1, 2).to(conv.weight.dtype))
    return y.permute(0, 2, 3, 1)


def dense_1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 Conv2d applied as a dense layer over the last axis."""
    w = conv.weight
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]), conv.bias)


def _gn_affine_from_moments(mean, var, scale, bias, g, eps: float):
    """(B, g) moments -> (a, b), each (B, C) f32, with
    GroupNorm(x) * scale + bias == x * a + b."""
    bsz = mean.shape[0]
    c = scale.shape[0]
    inv = torch.rsqrt(var + eps)
    inv_c = inv[:, :, None].expand(bsz, g, c // g).reshape(bsz, c)
    mean_c = mean[:, :, None].expand(bsz, g, c // g).reshape(bsz, c)
    a = inv_c * scale.float()
    return a, bias.float() - mean_c * a


def group_norm_coeffs_from_sums(s1, s2, n_spatial: int, scale, bias, g: int,
                                eps: float = 1e-5):
    """GroupNorm coefficients from per-channel spatial sums s1, s2 (B, C)
    f32 over ``n_spatial`` positions: the one-pass E[x^2] - mean^2 form."""
    bsz, c = s1.shape
    n = n_spatial * (c // g)
    mean = s1.reshape(bsz, g, c // g).sum(-1) / n
    msq = s2.reshape(bsz, g, c // g).sum(-1) / n
    var = torch.clamp(msq - mean.square(), min=0.0)
    return _gn_affine_from_moments(mean, var, scale, bias, g, eps)


def group_norm_coeffs(x, scale, bias, g: int, eps: float = 1e-5,
                      kernels: bool = True):
    """(a, b), each (B, C) f32, with x * a + b == GroupNorm(x)*scale + bias.

    bf16: one-pass E[x^2] - mean^2 from the spatial sums (kernel K1 on a
    4-D CUDA tensor when ``kernels``). f32: the centred two-pass form, where
    the cancellation of the one-pass form would lose real precision."""
    bsz, c = x.shape[0], x.shape[-1]
    if x.dtype == torch.bfloat16:
        if x.dim() == 4 and kernels:
            s1, s2 = gn_stats.spatial_sums(x)
        else:
            s1, s2 = gn_stats.spatial_sums_plain(x.reshape(bsz, -1, 1, c))
        n_spatial = x[0, ..., 0].numel()
        return group_norm_coeffs_from_sums(s1, s2, n_spatial, scale, bias, g, eps)
    xg = x.float().reshape(bsz, -1, g, c // g)
    mean = xg.mean(dim=(1, 3))
    var = (xg - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return _gn_affine_from_moments(mean, var, scale, bias, g, eps)


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, C) -> broadcastable against x (B, ..., C), in x's dtype."""
    return v.reshape((v.shape[0],) + (1,) * (x.dim() - 2) + (v.shape[1],)).to(x.dtype)


class GroupNormF32(nn.Module):
    """GroupNorm with f32 statistics, applied as one x * a + b in x's dtype."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.kernels = True

    def affine_coeffs(self, x):
        return group_norm_coeffs(x, self.weight, self.bias, self.num_groups,
                                 kernels=self.kernels)

    def forward(self, x):
        a, b = self.affine_coeffs(x)
        return x * _bcast(a, x) + _bcast(b, x)


class LayerNormF32(nn.Module):
    """LayerNorm over the last axis with f32 statistics."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        if x.dtype == torch.bfloat16:
            var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        else:
            var = (xf - mean).square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-5)
        scale = self.weight.float()
        a = (inv * scale).to(x.dtype)
        b = (self.bias.float() - mean * inv * scale).to(x.dtype)
        return x * a + b


class ResNet(nn.Module):
    """GroupNorm + SiLU + 3x3 conv ResNet block with FiLM time injection
    (``ml_mdm_tpu/models/layers.py`` ``ResNet``), in the structure of its
    fused path ``_forward``: conv1 through K2 with its output's sums,
    norm2 from those sums, FiLM folded into norm2's affine, and conv2
    through K2 with the residual added in the kernel."""

    def __init__(self, config: ResNetConfig, temporal_dim: int):
        super().__init__()
        self.config = config
        cin, cout = config.num_channels, config.output_channels
        self.norm1 = GroupNormF32(config.num_groups_norm, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_layer = nn.Linear(temporal_dim, 2 * cout)
        self.norm2 = GroupNormF32(config.num_groups_norm, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cout != cin:
            self.conv3 = nn.Conv2d(cin, cout, 1)
        self.kernels = True

    def _conv(self, conv, h, a, b, residual=None, emit_stats=False):
        fn = (fused_resnet.affine_silu_conv3x3 if self.kernels
              else fused_resnet.affine_silu_conv3x3_plain)
        return fn(h, a, b, conv.weight.permute(2, 3, 1, 0), conv.bias, residual,
                  emit_stats=emit_stats)

    def forward(self, x, temb):
        cfg = self.config
        a1, b1 = group_norm_coeffs(x, self.norm1.weight, self.norm1.bias,
                                   cfg.num_groups_norm, kernels=self.kernels)
        h, hs1, hs2 = self._conv(self.conv1, x, a1, b1, emit_stats=True)
        t = self.time_layer(F.silu(temb)).float()
        ta, tb = t.chunk(2, dim=-1)
        a2, b2 = group_norm_coeffs_from_sums(
            hs1, hs2, h.shape[1] * h.shape[2], self.norm2.weight,
            self.norm2.bias, cfg.num_groups_norm,
        )
        a2 = a2 * (1.0 + ta)
        b2 = b2 * (1.0 + ta) + tb
        res = conv2d_nhwc(x, self.conv3) if hasattr(self, "conv3") else x
        return self._conv(self.conv2, h, a2, b2, res)


class SelfAttention(nn.Module):
    """2-D self-attention with the text cross-attention branch
    (``ml_mdm_tpu/models/layers.py`` ``SelfAttention``): the cross branch
    shares q and is added before the shared zero-init ``proj_out``; the
    optional FFN is ``ffn.0-3`` (GroupNorm, 1x1 conv, GELU, 1x1 conv)."""

    def __init__(self, channels: int, cond_dim: Optional[int] = None,
                 use_attention_ffn: bool = False, num_heads: int = 8):
        super().__init__()
        self.heads = num_heads
        self.cond_dim = cond_dim if cond_dim is not None and cond_dim > 0 else 0
        self.norm = GroupNormF32(32, channels)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        if self.cond_dim:
            self.norm_cond = LayerNormF32(self.cond_dim)
            self.kv_cond = nn.Linear(self.cond_dim, 2 * channels)
        self.proj_out = nn.Conv2d(channels, channels, 1)
        self.use_attention_ffn = use_attention_ffn
        if use_attention_ffn:
            self.ffn = nn.Sequential(
                GroupNormF32(32, channels),
                nn.Conv2d(channels, 4 * channels, 1),
                GELU(),
                nn.Conv2d(4 * channels, channels, 1),
            )

    def _attention(self, q, k, v, mask=None):
        b, lq, c = q.shape
        ch = c // self.heads
        out = dot_product_attention(
            q.reshape(b, lq, self.heads, ch),
            k.reshape(b, -1, self.heads, ch),
            v.reshape(b, -1, self.heads, ch),
            mask=mask,
        )
        return out.reshape(b, lq, c)

    def forward(self, x, cond=None, cond_mask=None):
        b, h, w, c = x.shape
        qkv = dense_1x1(self.norm(x), self.qkv).reshape(b, h * w, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        out = self._attention(q, k, v)
        if self.cond_dim:
            kv = self.kv_cond(self.norm_cond(cond))
            k_c, v_c = kv.chunk(2, dim=-1)
            out = out + self._attention(q, k_c, v_c, mask=cond_mask)
        x = x + dense_1x1(out, self.proj_out).reshape(b, h, w, c)
        if self.use_attention_ffn:
            f = self.ffn
            x = x + dense_1x1(f[2](dense_1x1(f[0](x), f[1])), f[3])
        return x


class ResNetBlockStage(nn.Module):
    """One resolution stage: N ResNets (each followed by its attention
    layers) and an optional resample; ``ml_mdm_tpu/models/layers.py``
    ``ResNetBlockStage``, unpacked and non-temporal. Downsampling is a
    stride-2 3x3 conv; upsampling is nearest-2x followed by a 3x3 conv."""

    def __init__(self, temporal_dim: int, num_residual_blocks: int,
                 num_attention_layers: int, downsample_output: bool,
                 upsample_output: bool, resnet_configs: Sequence[ResNetConfig],
                 conditioning_feature_dim: int = -1):
        super().__init__()
        if downsample_output and upsample_output:
            raise ValueError("a stage either down- or upsamples")
        self.num_residual_blocks = num_residual_blocks
        self.num_attention_layers = num_attention_layers
        self.downsample_output = downsample_output
        self.upsample_output = upsample_output
        self.resnets = nn.ModuleList(
            ResNet(cfg, temporal_dim)
            for cfg in resnet_configs[:num_residual_blocks]
        )
        if num_attention_layers > 0:
            self.attn = nn.ModuleList(
                SelfAttention(
                    resnet_configs[i].output_channels,
                    cond_dim=conditioning_feature_dim,
                    use_attention_ffn=resnet_configs[i].use_attention_ffn,
                )
                for i in range(num_residual_blocks)
                for _ in range(num_attention_layers)
            )
        out_ch = resnet_configs[-1].output_channels
        if downsample_output:
            self.resample = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=1)
        elif upsample_output:
            self.resample = nn.Conv2d(out_ch, out_ch, 3, padding=1)

    def forward(self, x, temb, skip_activations: Optional[List[torch.Tensor]] = None,
                conditioning=None, cond_mask=None):
        """Returns (x, activations): the stage output and the activation
        after each ResNet (and after the resample) for the skip path."""
        activations = []
        skips = list(skip_activations) if skip_activations is not None else None
        for i in range(self.num_residual_blocks):
            if skips is not None:
                x = torch.cat([x, skips.pop(0)], dim=-1)
            x = self.resnets[i](x, temb)
            n_attn = self.num_attention_layers
            for j in range(n_attn):
                x = self.attn[i * n_attn + j](x, conditioning, cond_mask)
            activations.append(x)
        if self.downsample_output or self.upsample_output:
            if self.upsample_output:
                x = nearest_upsample_2x(x)
            x = conv2d_nhwc(x, self.resample)
            activations.append(x)
        return x, activations
