"""The plain reference of the Matryoshka U-Nets: float32 PyTorch, no kernel,
no packing, no cache.

A frozen copy of the port's plain code (``ml_mdm_tpu_torch/models/unet.py``,
``models/nested_unet.py`` and ``models/layers.py`` with ``use_kernels(False)``
and packing off), reduced to what the benchmark's configurations use: the
U-Net with its time, text and micro-conditioning embeddings, ResNets with
FiLM, 2-D self-attention with the text cross-attention and the attention
FFN, the mid blocks, and the nested shells with their adapters. It reads the
model YAML's mapping itself (``UNetConfig`` here is a small copy of the
port's defaults) and imports nothing of the port. Parameter names and
shapes are the port's, so one state dict loads into both with
``strict=True``.

Departures from the port's plain path, all exact in real arithmetic: the
GroupNorm statistics are the centred two-pass form everywhere (the port
takes the one-pass form from conv1's sums for norm2), GELU is the erf form
(the port takes the tanh form under bf16), and a packed stage is its
unpacked convolution.

``QUANT`` selects the precision of every product's operands: None computes
in float32 (TF32 off, the caller's switch), "fp8" rounds each operand of a
convolution, dense layer and attention product to float8 e4m3 with one
scale a tensor (its largest magnitude to 448) before the float32 product:
the control of the correctness check. The rounding is straight through:
the backward takes the float32 gradient of the rounded forward, so only
the forward is in fp8 (an fp8 cast inside autograd would round the
gradients too, without a scale, and flush nearly all of them to 0).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

QUANT: Optional[str] = None
FP8_MAX = 448.0


def quant(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the precision ``QUANT`` selects (a no-op by default)."""
    if QUANT is None:
        return t
    if QUANT != "fp8":
        raise ValueError(f"unknown precision {QUANT!r}")
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())  # straight through: the backward stays in float32


def conv(x: torch.Tensor, layer: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """NHWC convolution with the layer's padding."""
    y = F.conv2d(quant(x.permute(0, 3, 1, 2)), quant(layer.weight), layer.bias,
                 stride, layer.padding)
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """A Linear, or a 1x1 Conv2d, over the last axis."""
    w = layer.weight
    return F.linear(quant(x), quant(w.reshape(w.shape[0], -1)), layer.bias)


# -- configuration (the YAML's keys, with the port's defaults) -----------------

def _int_list(v, n=None) -> List[int]:
    if isinstance(v, str):
        v = [int(s) for s in v.split(",")] if v else []
    v = [] if v is None else [int(s) for s in v]
    if n is not None and len(v) == 1:
        v = v * n
    return v


@dataclass
class UNetConfig:
    resolution_channels: List[int]
    num_resnets_per_resolution: List[int]
    attention_levels: List[int]
    num_attention_layers: List[int]
    conditioning_feature_dim: int = -1
    conditioning_feature_proj_dim: int = -1
    masked_cross_attention: int = 1
    micro_conditioning: Optional[str] = None
    skip_mid_blocks: bool = False
    skip_cond_emb: bool = False
    nesting: bool = False
    temporal_dim: Optional[int] = None
    num_groups_norm: int = 32
    use_attention_ffn: bool = False
    skip_inner_unet_input: bool = False
    skip_normalization: bool = False
    inner: Optional["UNetConfig"] = None

    @classmethod
    def from_yaml(cls, d: Dict, nested: bool = False) -> "UNetConfig":
        """The ``unet_config`` mapping of a model YAML (``nested``: a shell,
        whose defaults skip the mid blocks and the text embedding)."""
        unsupported = {"num_lm_head_layers": 0, "temporal_mode": False,
                       "num_temporal_attention_layers": None, "interp_conditioning": False}
        for key, plain in unsupported.items():
            if d.get(key, plain) not in (plain, None, "None", 0, False):
                raise NotImplementedError(f"the reference has no {key}={d[key]!r}")
        rc = d.get("resnet_config") or {}
        if float(rc.get("dropout", 0.0)) != 0.0:
            raise NotImplementedError("the reference has no dropout")
        chans = _int_list(d["resolution_channels"])
        n = len(chans)
        levels = d.get("attention_levels", [])
        inner = d.get("inner_config")
        temporal_dim = d.get("temporal_dim")
        return cls(
            resolution_channels=chans,
            num_resnets_per_resolution=_int_list(d.get("num_resnets_per_resolution", 2), n),
            attention_levels=_int_list(levels) if levels not in (None, "") else [],
            num_attention_layers=_int_list(d.get("num_attention_layers", 1), n),
            conditioning_feature_dim=int(d.get("conditioning_feature_dim", -1)),
            conditioning_feature_proj_dim=int(d.get("conditioning_feature_proj_dim", -1)),
            masked_cross_attention=int(d.get("masked_cross_attention", 1)),
            micro_conditioning=d.get("micro_conditioning"),
            skip_mid_blocks=bool(d.get("skip_mid_blocks", nested)),
            skip_cond_emb=bool(d.get("skip_cond_emb", nested)),
            nesting=bool(d.get("nesting", False)),
            temporal_dim=None if temporal_dim in (None, "None") else int(temporal_dim),
            num_groups_norm=int(rc.get("num_groups_norm", 32)),
            use_attention_ffn=bool(rc.get("use_attention_ffn", False)),
            skip_inner_unet_input=bool(d.get("skip_inner_unet_input", False)),
            skip_normalization=bool(d.get("skip_normalization", False)),
            inner=None if inner is None else cls.from_yaml(inner, "inner_config" in inner),
        )

    def n_attn(self, level: int) -> int:
        return self.num_attention_layers[level] if level in self.attention_levels else 0


# -- layers ------------------------------------------------------------------

class GroupNormF32(nn.Module):
    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        xg = x.reshape(b, -1, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        return y * self.weight + self.bias


class LayerNormF32(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class ResNet(nn.Module):
    """GroupNorm, SiLU, 3x3 conv; GroupNorm with FiLM from the time
    embedding, SiLU, 3x3 conv; plus x, through a 1x1 conv where the width
    changes."""

    def __init__(self, cin: int, cout: int, tdim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNormF32(groups, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_layer = nn.Linear(tdim, 2 * cout)
        self.norm2 = GroupNormF32(groups, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cout != cin:
            self.conv3 = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb):
        h = conv(F.silu(self.norm1(x)), self.conv1)
        ta, tb = dense(F.silu(temb), self.time_layer).chunk(2, dim=-1)
        h = self.norm2(h) * (1.0 + ta[:, None, None, :]) + tb[:, None, None, :]
        res = dense(x, self.conv3) if hasattr(self, "conv3") else x
        return conv(F.silu(h), self.conv2) + res


def attention(q, k, v, heads: int, mask=None):
    """q (B, Lq, C), k/v (B, Lk, C), mask (B, Lk) or None: q and k each
    scaled by d^-1/4, softmax over the keys."""
    b, lq, c = q.shape
    d = c // heads
    scale = d ** -0.25
    qh = (q * scale).reshape(b, lq, heads, d).transpose(1, 2)
    kh = (k * scale).reshape(b, -1, heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, heads, d).transpose(1, 2)
    logits = torch.matmul(quant(qh), quant(kh).transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(quant(weights), quant(vh)).transpose(1, 2).reshape(b, lq, c)


class SelfAttention(nn.Module):
    heads = 8

    def __init__(self, channels: int, cond_dim: int, ffn: bool):
        super().__init__()
        self.cond_dim = max(cond_dim, 0)
        self.norm = GroupNormF32(32, channels)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        if self.cond_dim:
            self.norm_cond = LayerNormF32(self.cond_dim)
            self.kv_cond = nn.Linear(self.cond_dim, 2 * channels)
        self.proj_out = nn.Conv2d(channels, channels, 1)
        if ffn:
            self.ffn = nn.Sequential(GroupNormF32(32, channels),
                                     nn.Conv2d(channels, 4 * channels, 1), nn.GELU(),
                                     nn.Conv2d(4 * channels, channels, 1))

    def forward(self, x, cond=None, cond_mask=None):
        b, h, w, c = x.shape
        q, k, v = dense(self.norm(x), self.qkv).reshape(b, h * w, 3 * c).chunk(3, dim=-1)
        out = attention(q, k, v, self.heads)
        if self.cond_dim:
            kc, vc = dense(self.norm_cond(cond), self.kv_cond).chunk(2, dim=-1)
            out = out + attention(q, kc, vc, self.heads, cond_mask)
        x = x + dense(out, self.proj_out).reshape(b, h, w, c)
        if hasattr(self, "ffn"):
            f = self.ffn
            x = x + dense(F.gelu(dense(f[0](x), f[1])), f[3])
        return x


class Stage(nn.Module):
    """ResNets, each followed by its attention layers, then an optional
    stride-2 downsample or nearest-2x upsample conv. Parameter names are
    the port's ``ResNetBlockStage``."""

    def __init__(self, chans_in: List[int], cout: int, tdim: int, groups: int,
                 n_attn: int, cond_dim: int, ffn: bool, down: bool, up: bool):
        super().__init__()
        self.n_attn = n_attn
        self.down, self.up = down, up
        self.resnets = nn.ModuleList(ResNet(ci, cout, tdim, groups) for ci in chans_in)
        if n_attn:
            self.attn = nn.ModuleList(SelfAttention(cout, cond_dim, ffn)
                                      for _ in range(len(chans_in) * n_attn))
        if down:
            self.resample = nn.Conv2d(cout, cout, 3, stride=2, padding=1)
        elif up:
            self.resample = nn.Conv2d(cout, cout, 3, padding=1)

    def forward(self, x, temb, skips=None, cond=None, cond_mask=None):
        acts = []
        skips = list(skips) if skips is not None else None
        for i, resnet in enumerate(self.resnets):
            if skips is not None:
                x = torch.cat([x, skips.pop(0)], dim=-1)
            x = resnet(x, temb)
            for j in range(self.n_attn):
                x = self.attn[i * self.n_attn + j](x, cond, cond_mask)
            acts.append(x)
        if self.down:
            x = conv(x, self.resample, stride=2)
            acts.append(x)
        elif self.up:
            x = conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), self.resample)
            acts.append(x)
        return x, acts


def sinusoidal_embedding(times: torch.Tensor, tdim: int) -> torch.Tensor:
    half = tdim // 8
    freqs = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000) / half))
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(times.device)
    t = times.float().reshape(-1, 1) * freqs[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def micro_conditions(spec) -> Optional[Dict[str, float]]:
    if spec is None or str(spec).lower() in ("", "none"):
        return None
    return {c.split(":")[0]: float(c.split(":")[1]) for c in str(spec).split(",")}


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, cond_override: Optional[int] = None,
                 text_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        in_dim = cfg.conditioning_feature_dim if cond_override is None else cond_override
        cond_dim = cfg.conditioning_feature_proj_dim if (
            in_dim > 0 and cfg.conditioning_feature_proj_dim > 0) else in_dim
        self.cond_dim = cond_dim
        self.text_dim = in_dim if text_dim is None else text_dim
        tdim = self.tdim = cfg.temporal_dim or cfg.resolution_channels[0] * 4
        sin_dim = 2 * (tdim // 8)
        g = cfg.num_groups_norm
        self.temb_layer1 = nn.Linear(sin_dim, tdim)
        self.temb_layer2 = nn.Linear(tdim, tdim)
        self.has_cond = cond_dim > 0 and not cfg.skip_cond_emb
        if self.has_cond:
            self.cond_emb = nn.Linear(cond_dim, tdim, bias=False)
        self.conditions = micro_conditions(cfg.micro_conditioning)
        if self.conditions is not None:
            self.cond_layers = nn.ModuleDict({
                key: nn.ModuleList([nn.Linear(sin_dim, tdim), nn.Linear(tdim, tdim)])
                for key in self.conditions})
        ch = cfg.resolution_channels[0]
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        n = len(cfg.resolution_channels)
        skip_ch, down = [ch], []
        for i in range(n):
            ins = []
            for _ in range(cfg.num_resnets_per_resolution[i]):
                ins.append(ch)
                ch = cfg.resolution_channels[i]
                skip_ch.append(ch)
            if i != n - 1:
                skip_ch.append(ch)
            down.append(Stage(ins, ch, tdim, g, cfg.n_attn(i),
                              cond_dim if i in cfg.attention_levels else -1,
                              cfg.use_attention_ffn, i != n - 1, False))
        self.down_blocks = nn.ModuleList(down)
        if not cfg.skip_mid_blocks:
            self.mid_blocks = nn.ModuleList([
                Stage([ch], ch, tdim, g, 1, cond_dim, cfg.use_attention_ffn, False, False),
                Stage([ch], ch, tdim, g, 0, -1, False, False, False)])
        up = []
        for i in reversed(range(n)):
            ins = []
            for _ in range(cfg.num_resnets_per_resolution[i] + 1):
                ins.append(ch + skip_ch.pop())
                ch = cfg.resolution_channels[i]
            up.append(Stage(ins, ch, tdim, g, cfg.n_attn(i),
                            cond_dim if i in cfg.attention_levels else -1,
                            cfg.use_attention_ffn, False, i != 0))
        self.up_blocks = nn.ModuleList(up)
        self.norm_out = GroupNormF32(g, ch)
        self.conv_out = nn.Conv2d(ch, 3, 3, padding=1)
        if self.has_cond and cfg.conditioning_feature_proj_dim > 0:
            self.lm_proj = nn.Linear(self.text_dim, cond_dim)

    def embed(self, times, ff):
        l1, l2 = ff
        return dense(F.silu(dense(sinusoidal_embedding(times, self.tdim), l1)), l2)

    def forward_conditioning(self, text, mask):
        if self.cfg.conditioning_feature_proj_dim > 0:
            text = dense(text, self.lm_proj)
        if mask is None:
            pooled = text.mean(dim=1)
        else:
            m = mask.to(text.dtype)
            pooled = (m[..., None] * text).sum(dim=1) / torch.clamp(
                m.sum(dim=1, keepdim=True), min=1e-6)
        return (dense(pooled, self.cond_emb), text,
                mask if self.cfg.masked_cross_attention else None)

    def time_embedding(self, times, cond_emb):
        temb = self.embed(times, (self.temb_layer1, self.temb_layer2))
        if cond_emb is not None:
            temb = temb + cond_emb
        if self.conditions is not None:
            for key, default in self.conditions.items():
                micro = torch.full(times.shape, default, device=times.device)
                micro = (torch.clamp(micro / default, max=1.0) * default if key == "scale"
                         else micro * 1000.0)
                temb = temb + self.embed(micro, tuple(self.cond_layers[key]))
        return temb

    def input_layer(self, x, normalize=False):
        if normalize:
            x = x / x.std(dim=(1, 2, 3), keepdim=True, correction=1)
        return conv(x, self.conv_in)

    def down_path(self, x, temb, cond, mask):
        skips = [x]
        for block in self.down_blocks:
            x, acts = block(x, temb, cond=cond, cond_mask=mask)
            skips.extend(acts)
        return x, skips

    def up_path(self, x, temb, cond, mask, skips):
        n = len(self.cfg.resolution_channels)
        for i, block in enumerate(self.up_blocks):
            k = self.cfg.num_resnets_per_resolution[n - 1 - i] + 1
            sc = skips[-k:][::-1]
            del skips[-k:]
            x, _ = block(x, temb, skips=sc, cond=cond, cond_mask=mask)
        return x

    def denoise(self, x_t, times, cond_emb, cond, mask):
        temb = self.time_embedding(times, cond_emb)
        x_feat = None
        if self.cfg.nesting:
            x_t, x_feat = x_t
            x_t = x_t[0] if isinstance(x_t, (list, tuple)) else x_t
        x = self.input_layer(x_t)
        if x_feat is not None:
            x = x + x_feat
        x, skips = self.down_path(x, temb, cond, mask)
        if not self.cfg.skip_mid_blocks:
            x, _ = self.mid_blocks[0](x, temb, cond=cond, cond_mask=mask)
            x, _ = self.mid_blocks[1](x, temb)
        x = self.up_path(x, temb, cond, mask, skips)
        out = conv(F.silu(self.norm_out(x)), self.conv_out)
        return (out, x) if self.cfg.nesting else out

    def forward(self, x_t, times, text, mask):
        """x_t (B, H, W, 3) (nested: one image per resolution, highest
        first), times (B,), text (B, L, D), mask (B, L) -> prediction(s)."""
        cond_emb = cond = None
        if self.cond_dim > 0:
            cond_emb, cond, mask = self.forward_conditioning(text, mask)
        return self.denoise(x_t, times, cond_emb, cond, mask)


class NestedUNet(UNet):
    def __init__(self, cfg: UNetConfig, cond_override=None, text_dim=None):
        super().__init__(cfg, cond_override, text_dim)
        inner_cls = NestedUNet if cfg.inner.inner is not None else UNet
        self.inner_unet = inner_cls(cfg.inner, self.cond_dim, self.text_dim)
        if not cfg.skip_inner_unet_input:
            self.in_adapter = nn.Conv2d(cfg.resolution_channels[-1],
                                        cfg.inner.resolution_channels[0], 3, padding=1)
        self.out_adapter = nn.Conv2d(cfg.inner.resolution_channels[0],
                                     cfg.resolution_channels[-1], 3, padding=1)

    def forward_conditioning(self, text, mask):
        return self.inner_unet.forward_conditioning(text, mask)

    def denoise(self, x_t, times, cond_emb, cond, mask):
        temb = self.time_embedding(times, cond_emb)
        x_feat = None
        if self.cfg.nesting:
            x_t, x_feat = x_t
        x = self.input_layer(x_t[0], normalize=not self.cfg.skip_normalization)
        if x_feat is not None:
            x = x + x_feat
        x, skips = self.down_path(x, temb, cond, mask)
        x_inner = conv(x, self.in_adapter) if hasattr(self, "in_adapter") else None
        x_low, x_inner = self.inner_unet.denoise((list(x_t[1:]), x_inner), times, cond_emb,
                                                 cond, mask)
        x = x + conv(x_inner, self.out_adapter)
        x = self.up_path(x, temb, cond, mask, skips)
        out = [conv(F.silu(self.norm_out(x)), self.conv_out)]
        out += x_low if isinstance(x_low, list) else [x_low]
        return (out, x) if self.cfg.nesting else out


def build(unet_yaml: Dict, nested: bool, text_dim: int, device="cpu") -> UNet:
    """The reference module of a model YAML's ``unet_config`` (``nested``:
    a Matryoshka model), its text width ``text_dim`` handed to the
    outermost level as the command-line tools hand the text tower's
    width, with uninitialised float32 parameters on ``device``."""
    cfg = UNetConfig.from_yaml(dict(unet_yaml, conditioning_feature_dim=text_dim), nested)
    with torch.device("meta"):
        module = (NestedUNet if nested else UNet)(cfg)
    return module.to_empty(device=device)
