"""Building blocks of the port's U-Net (NHWC tensors, PyTorch modules).

Counterpart of ``ml_mdm_tpu/models/layers.py``. Activations keep the JAX
layout (B, H, W, C); a 3x3 convolution runs on the ``permute(0, 3, 1, 2)``
view, which is channels-last in memory. Parameter names are the reference
torch names (``down_blocks.0.resnets.1.conv1.weight``), so JAX weights load
through ``utils.convert.params_from_jax`` and ``load_state_dict(strict=True)``.
Parameters are never packed: a packed stage transforms its weights at use
(``ops/space_to_depth.py``), so autograd carries packed gradients back. With
gradients off (sampling) the transformed weights are built once and kept
while the parameters do not change (``cached_weights``).

Modules that own a hand kernel carry a ``kernels`` attribute (default
True). With it, the ResNet block and every 4-D bf16 GroupNorm call the
kernel wrappers, which launch the kernel on a CUDA tensor and run the
plain version on a CPU tensor. ``UNet.use_kernels(False)`` makes them call
the plain versions on any device, so the two paths can be compared on the
card.

Modules with conv or dense weights carry a ``compute_dtype`` (None: the
weights' own dtype; ``UNet.set_compute_dtype`` sets it). As a Flax module
with ``dtype=bfloat16`` does with its f32 parameters, each conv and dense
layer casts its input, weight and bias to it at use, while the norms'
scale and bias enter their f32 coefficient math uncast. So f32 parameters
train with bf16 compute, and a bf16 model's casts are no-ops.

In ``training`` mode the ResNet takes the JAX package's training
structure (its ``custom_vjp`` route), not the sampling one; see
``ResNet``. A conv-only stage of at most 64 channels at a large side runs
space-to-depth packed (``ResNetBlockStage.packs_at``), as the JAX stage
does.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ml_mdm_tpu_torch.config import ResNetConfig
from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from ml_mdm_tpu_torch.ops.attention import dot_product_attention
from ml_mdm_tpu_torch.perf import perf


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


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply a torch Conv2d to an NHWC tensor in ``dtype`` (default: the
    weight's), casting x, weight and bias to it."""
    dt = dtype or conv.weight.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), _cast(conv.bias, dt),
                 conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, layer: nn.Module,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A Linear, or a 1x1 Conv2d as a dense layer over the last axis, in
    ``dtype`` (default: the weight's), casting x, weight and bias to it."""
    w = layer.weight
    dt = dtype or w.dtype
    return F.linear(x.to(dt), w.reshape(w.shape[0], -1).to(dt), _cast(layer.bias, dt))


def conv1d_nlc(x: torch.Tensor, conv: nn.Conv1d,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply a torch Conv1d to an (N, L, C) tensor in ``dtype`` (default:
    the weight's), casting x, weight and bias to it."""
    dt = dtype or conv.weight.dtype
    y = F.conv1d(x.transpose(1, 2).to(dt), conv.weight.to(dt), _cast(conv.bias, dt),
                 conv.stride, conv.padding)
    return y.transpose(1, 2)


def frames_to_tokens(x: torch.Tensor, b: int) -> torch.Tensor:
    """((b t), h, w, c) -> ((b h w), t, c): each pixel's frames as a
    sequence."""
    bt, h, w, c = x.shape
    return x.reshape(b, bt // b, h, w, c).permute(0, 2, 3, 1, 4).reshape(b * h * w, bt // b, c)


def tokens_to_frames(y: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """((b h w), t, c) -> ((b t), h, w, c), the inverse of
    ``frames_to_tokens``."""
    t, c = y.shape[1], y.shape[2]
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).reshape(b * t, h, w, c)


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
    if x.dtype == torch.bfloat16:
        return group_norm_coeffs_concat((x,), scale, bias, g, eps, kernels)
    bsz, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(bsz, -1, g, c // g)
    mean = xg.mean(dim=(1, 3))
    var = (xg - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return _gn_affine_from_moments(mean, var, scale, bias, g, eps)


def group_norm_coeffs_concat(xs, scale, bias, g: int, eps: float = 1e-5,
                             kernels: bool = True):
    """GroupNorm coefficients of the channel concatenation of ``xs``
    without building it (``group_norm_coeffs_concat`` of the JAX package):
    per-operand spatial sums (kernel K1 on 4-D bf16 CUDA tensors when
    ``kernels``), concatenated along channels, then the one-pass
    E[x^2] - mean^2 form in every dtype, as the JAX function computes it."""
    s1s, s2s = [], []
    for x in xs:
        if x.dtype == torch.bfloat16 and x.dim() == 4 and kernels:
            s1, s2 = gn_stats.spatial_sums(x)
        else:
            s1, s2 = gn_stats.spatial_sums_plain(x.reshape(x.shape[0], -1, 1, x.shape[-1]))
        s1s.append(s1)
        s2s.append(s2)
    n_spatial = xs[0][0, ..., 0].numel()
    return group_norm_coeffs_from_sums(torch.cat(s1s, dim=-1), torch.cat(s2s, dim=-1),
                                       n_spatial, scale, bias, g, eps)


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


def _identity(v):
    return v


def packed_struct_kernel(w: torch.Tensor) -> torch.Tensor:
    """An unpacked HWIO kernel -> K2·struct's combined packed taps."""
    return fused_resnet.struct_weights(s2d.pack_conv3x3_kernel(w))


def cached_weights(owner: nn.Module, name, modules, build):
    """``build()``, a function of the parameters of ``modules`` only (packed
    kernels, repeated vectors). With gradients off it is built once and kept
    on ``owner`` while those parameters keep their storage and version
    counter (an optimizer step, ``load_state_dict`` or a move rebuilds it):
    the port's counterpart of the JAX package's ``wcache``, so that each
    denoising step does not transform the weights again. With gradients on
    it is built afresh, for autograd to reach the parameters."""
    if torch.is_grad_enabled():
        return build()
    key = tuple((p.device, p.data_ptr(), p._version) for m in modules for p in m.parameters())
    cache = owner.__dict__.setdefault("_weights_cache", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, build())
    return hit[1]


class ResNet(nn.Module):
    """GroupNorm + SiLU + 3x3 conv ResNet block with FiLM time injection
    (``ml_mdm_tpu/models/layers.py`` ``ResNet``), in the structure of its
    fused path ``_forward`` with ``fused_proj`` on: conv1 through K2 with
    its output's sums and, when the channel count changes, the 1x1
    shortcut from the same pass (K2·proj); norm2 from those sums, FiLM
    folded into norm2's affine, and conv2 through K2 with the shortcut (or
    x) added in the kernel as the residual.

    x is one (B, H, W, C) tensor or, on the up path, the tuple (x, skip)
    of the skip concat, which is never built: norm1 takes its statistics
    per operand and conv1 runs the operands through K2·N.

    In ``training`` mode it follows the JAX package's training route
    (``_forward`` with the ``custom_vjp`` convs; the JAX package takes it
    at sides of 128 and up, the port at every side): the skip concat is
    built, conv1 runs through K3 with its output's sums, norm2 comes from
    those sums with FiLM folded in, the 1x1 shortcut is a separate dense
    ``conv3``, and conv2 runs through K3 with the shortcut (or x) as the
    residual. Dropout is not ported: a training ResNet with dropout > 0
    raises.

    ``packed``: x (each operand) is space-to-depth packed, and so is the
    output. The same structure runs on the packed tensors: the GroupNorm
    scales and biases, the FiLM vectors and the conv biases repeated 4
    times (exact: the c-major packed order keeps groups contiguous), the 3x3
    convolutions as K2·struct (sampling: the combined taps of each operand's
    packed kernel; training: K3 on the packed kernel) and the shortcut with
    the block-diagonal packed 1x1 kernel."""

    compute_dtype: Optional[torch.dtype] = None

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

    def _conv(self, *args, **kw):
        fn = (fused_resnet.affine_silu_conv3x3 if self.kernels
              else fused_resnet.affine_silu_conv3x3_plain)
        return fn(*args, **kw)

    def _norm2_film(self, h, hs1, hs2, temb, scale2, bias2, vec=_identity):
        """norm2's coefficients from conv1's output sums, with FiLM folded
        in: norm2(h) * (1 + ta) + tb == h * a2 + b2 (``vec`` packs the
        per-channel FiLM vectors; ``scale2``, ``bias2`` are norm2's, packed
        alike)."""
        t = dense(F.silu(temb), self.time_layer, self.compute_dtype).float()
        if h.shape[0] > t.shape[0]:  # temporal: (b t) rows share their video's temb
            t = t.repeat_interleave(h.shape[0] // t.shape[0], dim=0)
        ta, tb = (vec(v) for v in t.chunk(2, dim=-1))
        a2, b2 = group_norm_coeffs_from_sums(
            hs1, hs2, h.shape[1] * h.shape[2], scale2, bias2, self.config.num_groups_norm)
        return a2 * (1.0 + ta), b2 * (1.0 + ta) + tb

    def _shortcut_kernel(self, packed: bool) -> torch.Tensor:
        """conv3 as a (Cin, Cout) matrix, block-diagonal (4Cin, 4Cout) packed."""
        k = self.conv3.weight.permute(2, 3, 1, 0)
        return (s2d.pack_conv1x1_kernel(k) if packed else k)[0, 0]

    def _forward_train(self, x, temb, packed: bool):
        if self.config.dropout > 0:
            raise NotImplementedError("a training ResNet with dropout > 0 is not ported yet")
        conv = (fused_resnet.affine_silu_conv3x3_vjp if self.kernels
                else fused_resnet.affine_silu_conv3x3_plain)
        vec = s2d.pack_channel_vector if packed else _identity
        kernel = s2d.pack_conv3x3_kernel if packed else _identity
        if isinstance(x, tuple):
            x = torch.cat(x, dim=-1)
        a1, b1 = group_norm_coeffs(x, vec(self.norm1.weight), vec(self.norm1.bias),
                                   self.config.num_groups_norm, kernels=self.kernels)
        h, hs1, hs2 = conv(x, a1, b1, kernel(self.conv1.weight.permute(2, 3, 1, 0)),
                           vec(self.conv1.bias), emit_stats=True, packed_struct=packed)
        a2, b2 = self._norm2_film(h, hs1, hs2, temb, vec(self.norm2.weight),
                                  vec(self.norm2.bias), vec)
        if hasattr(self, "conv3"):
            dt = self.compute_dtype or self.conv3.weight.dtype
            res = F.linear(x.to(dt), self._shortcut_kernel(packed).t().to(dt),
                           vec(self.conv3.bias).to(dt))
        else:
            res = x
        return conv(h, a2, b2, kernel(self.conv2.weight.permute(2, 3, 1, 0)),
                    vec(self.conv2.bias), res, packed_struct=packed)

    def _sampling_weights(self, cuts, packed: bool):
        """The sampling forward's weights: norm1's and norm2's scale and bias,
        conv1's kernel per operand slice ``cuts`` (of the unpacked input
        channels) and its bias, the shortcut's matrices per slice and bias,
        conv2's kernel and bias, built once per parameter version. The
        kernels and the shortcut's matrices are ``K2Weights``, which keep
        K2's device layout of them (packed or not) once a launch has made
        it. Packed: the vectors repeated, the kernels in K2·struct's
        combined form (each operand's slice packed on its own: pack(concat)
        == concat(pack) in the c-major order), the shortcut block-diagonal."""
        def build():
            vec = s2d.pack_channel_vector if packed else _identity
            kernel = packed_struct_kernel if packed else _identity
            w1 = self.conv1.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
            out = {
                "norm1": (vec(self.norm1.weight), vec(self.norm1.bias)),
                "norm2": (vec(self.norm2.weight), vec(self.norm2.bias)),
                "w1": tuple(kernel(w1[:, :, lo:hi]) for lo, hi in cuts),
                "b1": vec(self.conv1.bias),
                "w2": kernel(self.conv2.weight.permute(2, 3, 1, 0)),
                "b2": vec(self.conv2.bias),
            }
            if hasattr(self, "conv3"):
                k3 = self.conv3.weight.permute(2, 3, 1, 0)
                pack1 = s2d.pack_conv1x1_kernel if packed else _identity
                out["proj_kernel"] = tuple(pack1(k3[:, :, lo:hi])[0, 0] for lo, hi in cuts)
                out["proj_bias"] = vec(self.conv3.bias)
            for name in ("w1", "w2", "proj_kernel"):
                if name in out:
                    out[name] = fused_resnet.K2Weights(out[name])
            return out

        modules = [m for m in self.children() if m is not self.time_layer]
        return cached_weights(self, (tuple(cuts), packed), modules, build)

    def forward(self, x, temb, packed: bool = False):
        if self.training:
            return self._forward_train(x, temb, packed)
        g = self.config.num_groups_norm
        m = 4 if packed else 1  # packed channels per unpacked channel
        xs = x if isinstance(x, tuple) else (x,)
        # per-operand slices of the coefficients and of conv1's (and the
        # shortcut's) input channels
        bounds = list(itertools.accumulate([xi.shape[-1] // m for xi in xs], initial=0))
        cuts = list(zip(bounds, bounds[1:]))
        wts = self._sampling_weights(cuts, packed)
        scale1, bias1 = wts["norm1"]
        if len(xs) > 1:
            a1, b1 = group_norm_coeffs_concat(xs, scale1, bias1, g, kernels=self.kernels)
        else:
            a1, b1 = group_norm_coeffs(xs[0], scale1, bias1, g, kernels=self.kernels)
        kw = {"emit_stats": True, "packed_struct": packed}
        if "proj_kernel" in wts:
            kw["proj_kernel"], kw["proj_bias"] = wts["proj_kernel"], wts["proj_bias"]
        out = self._conv(
            xs, tuple(a1[:, m * lo:m * hi] for lo, hi in cuts),
            tuple(b1[:, m * lo:m * hi] for lo, hi in cuts), wts["w1"], wts["b1"], **kw)
        h, hs1, hs2 = out[:3]
        if "proj_kernel" in wts:
            res = out[3]
        else:
            res = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        a2, b2 = self._norm2_film(h, hs1, hs2, temb, *wts["norm2"],
                                  s2d.pack_channel_vector if packed else _identity)
        return self._conv(h, a2, b2, wts["w2"], wts["b2"], res, packed_struct=packed)


class SelfAttention(nn.Module):
    """2-D self-attention with the text cross-attention branch
    (``ml_mdm_tpu/models/layers.py`` ``SelfAttention``): the cross branch
    shares q and is added before the shared zero-init ``proj_out``; the
    optional FFN is ``ffn.0-3`` (GroupNorm, 1x1 conv, GELU, 1x1 conv)."""

    compute_dtype: Optional[torch.dtype] = None

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
        dt = self.compute_dtype
        qkv = dense(self.norm(x), self.qkv, dt).reshape(b, h * w, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        out = self._attention(q, k, v)
        if self.cond_dim:
            kv = dense(self.norm_cond(cond), self.kv_cond, dt)
            k_c, v_c = kv.chunk(2, dim=-1)
            out = out + self._attention(q, k_c, v_c, mask=cond_mask)
        x = x + dense(out, self.proj_out, dt).reshape(b, h, w, c)
        if self.use_attention_ffn:
            f = self.ffn
            x = x + dense(f[2](dense(f[0](x), f[1], dt)), f[3], dt)
        return x


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_embedding(x: torch.Tensor) -> torch.Tensor:
    """RoPE over the last axis of (B, H, L, D), angles in f32 (so a bf16
    input comes back in f32, as in the JAX package)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32, device=x.device)
                               / half))
    t = torch.arange(x.shape[-2], dtype=torch.float32, device=x.device)
    angles = torch.outer(t, freqs)
    angles = torch.cat([angles, angles], dim=-1)
    return x * torch.cos(angles) + _rotate_half(x) * torch.sin(angles)


def _num_heads(channels: int, num_heads: int, num_head_channels: int) -> int:
    if num_head_channels == -1:
        return num_heads
    if channels % num_head_channels:
        raise ValueError(f"{channels} channels do not split into heads of {num_head_channels}")
    return channels // num_head_channels


class SelfAttention1D(nn.Module):
    """Self-attention over tokens (B, L, C) with an optional key mask
    (B, L), rotary positions (``pos_emb``) and FFN
    (``ml_mdm_tpu/models/layers.py`` ``SelfAttention1D``)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, num_heads: int = 8, num_head_channels: int = -1,
                 use_attention_ffn: bool = False, pos_emb: bool = False):
        super().__init__()
        self.heads = _num_heads(channels, num_heads, num_head_channels)
        self.pos_emb = pos_emb
        self.norm = LayerNormF32(channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)
        self.use_attention_ffn = use_attention_ffn
        if use_attention_ffn:
            self.ffn = nn.Sequential(
                LayerNormF32(channels),
                nn.Linear(channels, 4 * channels),
                GELU(),
                nn.Linear(4 * channels, channels),
            )

    def forward(self, x, mask=None):
        b, l, c = x.shape
        dt = self.compute_dtype
        qkv = dense(self.norm(x), self.qkv, dt)
        q, k, v = (t.reshape(b, l, self.heads, c // self.heads) for t in qkv.chunk(3, dim=-1))
        if self.pos_emb:
            q = rotary_embedding(q.transpose(1, 2)).transpose(1, 2)
            k = rotary_embedding(k.transpose(1, 2)).transpose(1, 2)
        out = dot_product_attention(q, k, v, mask=mask).reshape(b, l, c)
        x = x + dense(out, self.proj_out, dt)
        if self.use_attention_ffn:
            f = self.ffn
            x = x + dense(f[2](dense(f[0](x), f[1], dt)), f[3], dt)
        return x


class MLP(nn.Module):
    """Pre-norm residual MLP: ``main.0-3`` are LayerNorm, Linear, GELU and
    the zero-init Linear."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, multiplier: int = 4):
        super().__init__()
        self.main = nn.Sequential(
            LayerNormF32(channels),
            nn.Linear(channels, multiplier * channels),
            GELU(),
            nn.Linear(multiplier * channels, channels),
        )

    def forward(self, x):
        m, dt = self.main, self.compute_dtype
        return x + dense(m[2](dense(m[0](x), m[1], dt)), m[3], dt)


class SelfAttention1DBlock(nn.Module):
    """Attention then MLP: one layer of the learned lm-head."""

    def __init__(self, channels: int, num_heads: int = 8, num_head_channels: int = -1,
                 mlp_multiplier: int = 4):
        super().__init__()
        self.attn = SelfAttention1D(channels, num_heads, num_head_channels)
        self.mlp = MLP(channels, mlp_multiplier)

    def forward(self, x, mask=None):
        return self.mlp(self.attn(x, mask))


class TemporalAttentionBlock(nn.Module):
    """Attention across the frames of each pixel
    (``ml_mdm_tpu/models/layers.py`` ``TemporalAttentionBlock``): x is
    ((b t), h, w, c) and temb (b, d) tells how many videos the rows hold.
    With ``down`` the block works at half the side: a stride-2 3x3 conv
    before, nearest-2x and a 3x3 conv after."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, num_heads: int = 8, num_head_channels: int = -1,
                 down: bool = False, pos_emb: bool = False):
        super().__init__()
        self.attn = SelfAttention1D(channels, num_heads, num_head_channels, pos_emb=pos_emb)
        self.mlp = MLP(channels, multiplier=4)
        self.down = down
        if down:
            self.down_conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
            self.up_conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, temb):
        x_in = x
        dt = self.compute_dtype
        if self.down:
            x = conv2d_nhwc(x, self.down_conv, dt)
        b, (_, h, w, _) = temb.shape[0], x.shape
        y = self.mlp(self.attn(frames_to_tokens(x, b)))
        x = tokens_to_frames(y, b, h, w)
        if self.down:
            x = conv2d_nhwc(nearest_upsample_2x(x), self.up_conv, dt)
        return x + x_in


def stage_packs_at(side: int, max_channels: int, pack_min_side: int,
                   num_attention_layers: int, temporal: bool) -> bool:
    """Whether a stage runs space-to-depth packed at the (unpacked) image
    side ``side`` (``ResNetBlockStage.packs_at`` of the JAX package): a
    conv-only stage of at most 32 channels from the model's
    ``pack_min_side``, of at most ``perf().pack_max_ch`` (64) channels from
    ``perf().pack64_min_side`` (256), never with attention or in temporal
    mode, never when ``pack_min_side`` is 0, and only at an even side."""
    p = perf()
    if max_channels <= 32:
        min_side = pack_min_side
    elif max_channels <= p.pack_max_ch:
        min_side = p.pack64_min_side
    else:
        return False
    return (pack_min_side > 0 and side >= min_side and side % 2 == 0
            and num_attention_layers == 0 and not temporal)


class ResNetBlockStage(nn.Module):
    """One resolution stage: N ResNets (each followed by its attention
    layers, the 2-D ones and then the temporal ones) and an optional
    resample (``ml_mdm_tpu/models/layers.py`` ``ResNetBlockStage``).
    Downsampling is a stride-2 3x3 conv; upsampling is nearest-2x followed
    by a 3x3 conv. In ``temporal_mode`` without ``temporal_spatial_ds`` the
    resample works across frames, not space: a 1-D conv over each pixel's
    frames, stride 2 down, nearest-2x then conv up. The temporal attention
    layers exist only without ``temporal_spatial_ds``, as in the JAX
    package.

    A stage for which ``packs_at`` holds runs its ResNets space-to-depth
    packed and resamples in the packed domain: down as the stride-2
    convolution on the packed tensor (packed out: ``packed_strided_conv_
    p2p``), up as the packed upsample convolution (through K2 when
    sampling). ``packed_in``: x and the incoming skips arrive packed (the
    stage must pack at that side), and the activations it emits stay
    packed; ``packed_out``: its output leaves packed. The owning U-Net
    threads its plan through these so that a packed shell's tensors never
    change layout between stages.

    ``remat_above`` (None: off; set by ``trainer.make_train_step`` with
    ``remat``): in training, a stage whose convolutions run at a physical
    side (the packed tensor's for a packed stage) above it runs under
    ``torch.utils.checkpoint`` and recomputes its forward in the backward."""

    compute_dtype: Optional[torch.dtype] = None
    remat_above: Optional[int] = None

    def __init__(self, temporal_dim: int, num_residual_blocks: int,
                 num_attention_layers: int, downsample_output: bool,
                 upsample_output: bool, resnet_configs: Sequence[ResNetConfig],
                 conditioning_feature_dim: int = -1, temporal_mode: bool = False,
                 temporal_pos_emb: bool = False, temporal_spatial_ds: bool = False,
                 num_temporal_attention_layers: Optional[int] = None,
                 pack_min_side: int = 0):
        super().__init__()
        if downsample_output and upsample_output:
            raise ValueError("a stage either down- or upsamples")
        self.num_residual_blocks = num_residual_blocks
        self.num_attention_layers = num_attention_layers
        self.downsample_output = downsample_output
        self.upsample_output = upsample_output
        self.pack_min_side = pack_min_side
        self.max_channels = max((rc.output_channels for rc in resnet_configs), default=0)
        self.temporal = temporal_mode or bool(num_temporal_attention_layers)
        self.kernels = True
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
        self.num_temporal_attention_layers = (
            0 if temporal_spatial_ds else num_temporal_attention_layers or 0)
        if self.num_temporal_attention_layers > 0:
            self.t_attn = nn.ModuleList(
                TemporalAttentionBlock(
                    resnet_configs[i].output_channels, num_head_channels=32, down=True,
                    pos_emb=temporal_pos_emb,
                )
                for i in range(num_residual_blocks)
                for _ in range(self.num_temporal_attention_layers)
            )
        out_ch = resnet_configs[-1].output_channels
        self.resample_frames = temporal_mode and not temporal_spatial_ds
        conv = nn.Conv1d if self.resample_frames else nn.Conv2d
        if downsample_output:
            self.resample = conv(out_ch, out_ch, 3, stride=2, padding=1)
        elif upsample_output:
            self.resample = conv(out_ch, out_ch, 3, padding=1)

    def packs_at(self, side: int) -> bool:
        """Whether this stage runs packed at the (unpacked) image side."""
        return stage_packs_at(side, self.max_channels, self.pack_min_side,
                              self.num_attention_layers, self.temporal)

    def _use_packing(self, x, packed_in: bool = False) -> bool:
        m = 2 if packed_in else 1
        h, w = x.shape[1] * m, x.shape[2] * m
        return w % 2 == 0 and self.packs_at(min(h, w))

    def forward(self, x, temb, skip_activations: Optional[List[torch.Tensor]] = None,
                conditioning=None, cond_mask=None, packed_in: bool = False,
                packed_out: bool = False):
        """Returns (x, activations): the stage output and the activation
        after each ResNet (and after the resample) for the skip path."""
        packed = self._use_packing(x, packed_in)
        if packed_in and not packed:
            raise ValueError("packed_in needs a stage that packs at this side")
        side = min(x.shape[1], x.shape[2]) // (2 if packed and not packed_in else 1)
        if self.training and self.remat_above is not None and side > self.remat_above:
            return checkpoint(self._forward, x, temb, skip_activations, conditioning,
                              cond_mask, packed, packed_in, packed_out, use_reentrant=False)
        return self._forward(x, temb, skip_activations, conditioning, cond_mask, packed,
                             packed_in, packed_out)

    def _forward(self, x, temb, skip_activations, conditioning, cond_mask, packed: bool,
                 packed_in: bool, packed_out: bool):
        activations = []
        skips = list(skip_activations) if skip_activations is not None else None
        repack = packed and not packed_in  # pack here, unpack what leaves
        if repack:
            x = s2d.space_to_depth(x)
        for i in range(self.num_residual_blocks):
            if skips is not None:  # the skip concat, as operands of K2·N
                skip = skips.pop(0)
                x = (x, s2d.space_to_depth(skip) if repack else skip)
            x = self.resnets[i](x, temb, packed=packed)
            n_attn = self.num_attention_layers
            for j in range(n_attn):
                x = self.attn[i * n_attn + j](x, conditioning, cond_mask)
            n_tattn = self.num_temporal_attention_layers
            for j in range(n_tattn):
                x = self.t_attn[i * n_tattn + j](x, temb)
            activations.append(s2d.depth_to_space(x) if repack else x)
        if self.downsample_output or self.upsample_output:
            x = self._resample(x, temb, packed, packed_out)
            activations.append(x)
        elif packed and not packed_out:
            x = s2d.depth_to_space(x)
        elif packed_out and not packed:
            x = s2d.space_to_depth(x)
        return x, activations

    def _resample(self, x, temb, packed: bool, packed_out: bool):
        dt = self.compute_dtype
        if self.resample_frames:
            b, (_, h, w, _) = temb.shape[0], x.shape
            y = frames_to_tokens(x, b)
            if self.upsample_output:
                y = y.repeat_interleave(2, dim=1)
            x = tokens_to_frames(conv1d_nlc(y, self.resample, dt), b, h, w)
            return s2d.space_to_depth(x) if packed_out else x
        if not (packed or packed_out):
            if self.upsample_output:
                x = nearest_upsample_2x(x)
            return conv2d_nhwc(x, self.resample, dt)
        # the exact packed rewrites of ops/space_to_depth.py, in the compute
        # dtype, their kernels kept with gradients off (cached_weights)
        x = x.to(dt or self.resample.weight.dtype)
        k, bias = self.resample.weight.permute(2, 3, 1, 0), self.resample.bias
        if self.downsample_output and not packed:  # unpacked producer, packed consumer
            return s2d.space_to_depth(conv2d_nhwc(x, self.resample, dt))
        if self.downsample_output:
            pack = s2d.pack_strided_conv_kernel_p2p if packed_out else s2d.pack_strided_conv_kernel
            conv = s2d.packed_strided_conv_p2p if packed_out else s2d.packed_strided_conv
        else:  # the upsample: one convolution of x with the kernel summed
            # over the 4 repeats of each channel of the packed upsampled image
            pack, conv = s2d.upsample_fold_kernel, functools.partial(
                s2d.packed_upsample_conv, in_packed=packed, out_packed=packed_out,
                fast=self.kernels and not self.training)
        pk = cached_weights(self, pack.__name__, [self.resample], lambda: pack(k))
        return conv(x, k, bias, pk=pk)
