"""T5 encoder of the port: the frozen text tower.

Counterpart of ``ml_mdm_tpu/language_models/t5.py``: token embedding,
pre-norm blocks with RMSNorm, a final RMSNorm; self-attention without the
1/sqrt(d) scaling, with one relative-position bias (``num_buckets``
buckets up to ``max_distance``) that block 0 owns and passes down, and the
padding mask added to the logits; the feed-forward ReLU (T5 v1.0) or
gated with the tanh GeLU (v1.1 and FLAN-T5). RMSNorm takes its variance in
f32 and the softmax runs in f32 (in f64 for an f64 encoder, the reference a
check on the card holds the f32 tower against).

The modules carry Hugging Face's parameter names (``shared.weight``,
``encoder.block.{i}.layer.0.SelfAttention.q.weight``, ...,
``encoder.final_layer_norm.weight``), so the encoder part of a Hugging
Face T5 state dict loads without a converter. ``load_t5_from_torch`` reads
such a checkpoint from a local directory with ``json`` and ``torch.load``
alone; nothing is downloaded.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = True  # flan-t5 / v1.1
    dense_act_fn: str = "gelu_new"

    @classmethod
    def from_hf_config(cls, hf):
        """From a Hugging Face ``T5Config`` or its ``config.json`` as a dict.
        A dict without ``dense_act_fn`` gets it from ``feed_forward_proj``
        as Hugging Face derives it ("gated-gelu" means "gelu_new")."""
        if isinstance(hf, dict):
            def get(k, d=None):
                return hf.get(k, d)
        else:
            def get(k, d=None):
                return getattr(hf, k, d)
        proj = str(get("feed_forward_proj", "relu"))
        return cls(
            vocab_size=get("vocab_size"),
            d_model=get("d_model"),
            d_kv=get("d_kv"),
            d_ff=get("d_ff"),
            num_layers=get("num_layers"),
            num_heads=get("num_heads"),
            relative_attention_num_buckets=get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=get("relative_attention_max_distance", 128),
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-6),
            is_gated_act=get("is_gated_act", False) or "gated" in proj,
            dense_act_fn=get("dense_act_fn",
                             "gelu_new" if proj == "gated-gelu" else proj.split("-")[-1]),
        )


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """f32 for a narrower float, else the dtype itself (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.to(_at_least_f32(x.dtype))
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)).to(x.dtype)


def _relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                              max_distance: int = 128) -> torch.Tensor:
    """Bidirectional buckets of integer relative positions: exact up to a
    quarter of the buckets, then logarithmic up to ``max_distance``, with
    the JAX package's operations in f32 in its order."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (torch.log(n.float() / max_exact + 1e-6)
                                / math.log(max_distance / max_exact)
                                * (num_buckets - max_exact)).long()
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5SelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False)
        self.k = nn.Linear(config.d_model, inner, bias=False)
        self.v = nn.Linear(config.d_model, inner, bias=False)
        self.o = nn.Linear(inner, config.d_model, bias=False)
        self.has_relative_bias = has_relative_bias
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(config.relative_attention_num_buckets,
                                                        config.num_heads)

    def compute_bias(self, length: int, device) -> torch.Tensor:
        """(1, H, L, L) f32 bias of every (query, key) pair."""
        cfg = self.config
        pos = torch.arange(length, device=device)
        buckets = _relative_position_bucket(pos[None, :] - pos[:, None],
                                            cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).float().permute(2, 0, 1)[None]

    def forward(self, x, mask=None, position_bias=None):
        cfg = self.config
        b, l, _ = x.shape
        h, dk = cfg.num_heads, cfg.d_kv

        def heads(t):
            return t.reshape(b, l, h, dk).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # no 1/sqrt(d)
        scores = scores.to(_at_least_f32(scores.dtype))
        if position_bias is None and self.has_relative_bias:
            position_bias = self.compute_bias(l, x.device)
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = torch.where(mask[:, None, None, :] == 0, -1e9, scores)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, l, h * dk)
        return self.o(out), position_bias


class T5FF(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        if config.is_gated_act:
            self.wi_0 = nn.Linear(config.d_model, config.d_ff, bias=False)
            self.wi_1 = nn.Linear(config.d_model, config.d_ff, bias=False)
        else:
            self.wi = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False)

    def _act(self, x):
        if self.config.dense_act_fn in ("gelu_new", "gelu"):
            return F.gelu(x, approximate="tanh")
        return F.relu(x)

    def forward(self, x):
        if self.config.is_gated_act:
            x = self._act(self.wi_0(x)) * self.wi_1(x)
        else:
            x = self._act(self.wi(x))
        return self.wo(x)


class _AttentionLayer(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)
        self.SelfAttention = T5SelfAttention(config, has_relative_bias)


class _FFLayer(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)
        self.DenseReluDense = T5FF(config)


class T5Block(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([_AttentionLayer(config, has_relative_bias), _FFLayer(config)])

    def forward(self, x, mask=None, position_bias=None):
        attn, ff = self.layer
        y, position_bias = attn.SelfAttention(attn.layer_norm(x), mask, position_bias)
        x = x + y
        x = x + ff.DenseReluDense(ff.layer_norm(x))
        return x, position_bias


class _Stack(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(config, has_relative_bias=(i == 0))
                                    for i in range(config.num_layers)])
        self.final_layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """input_ids (B, L) int, attention_mask (B, L) 1/0 -> (B, L, d_model)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _Stack(config)

    @property
    def embed_dim(self) -> int:
        return self.config.d_model

    def forward(self, input_ids, attention_mask=None):
        x = self.shared(input_ids)
        bias = None
        for block in self.encoder.block:
            x, bias = block(x, attention_mask, bias)
        return self.encoder.final_layer_norm(x)


@torch.no_grad()
def init_t5_(module: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """Seeded random weights in place: normal embeddings and relative
    biases, each dense weight normal with std 1/sqrt(fan_in), norms 1."""
    for name, p in module.named_parameters():
        noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
        if name.endswith("layer_norm.weight"):
            p.fill_(1.0)
        elif name == "shared.weight" or "relative_attention_bias" in name:
            p.copy_(noise)
        else:
            p.copy_(noise / math.sqrt(p.shape[1]))
    return module


def _encoder_key(key: str) -> Optional[str]:
    """The port's name of a Hugging Face T5 key, or None for a key the
    encoder does not use (the decoder, the LM head)."""
    if key in ("shared.weight", "encoder.embed_tokens.weight"):
        return "shared.weight"
    if key.startswith("encoder."):
        return key
    return None


def load_t5_from_torch(path: str, device) -> T5Encoder:
    """The encoder of a Hugging Face T5 checkpoint in the local directory
    ``path`` (``config.json`` and ``pytorch_model.bin``, or the shards that
    ``pytorch_model.bin.index.json`` names), f32 weights, in eval mode on
    ``device``. A name that is not a local directory raises."""
    device = torch.device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"text model {path!r} is not a local directory; the port reads a Hugging Face T5 "
            "checkpoint directory (config.json + pytorch_model.bin or its sharded index) "
            "and downloads nothing")
    with open(os.path.join(path, "config.json")) as f:
        cfg = T5Config.from_hf_config(json.load(f))
    index = os.path.join(path, "pytorch_model.bin.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted({fn for k, fn in weight_map.items() if _encoder_key(k)})
    else:
        files = ["pytorch_model.bin"]
    state = {}
    for fn in files:
        shard = torch.load(os.path.join(path, fn), map_location="cpu", weights_only=True,
                           mmap=True)
        for k, v in shard.items():
            name = _encoder_key(k)
            if name is not None and name not in state:
                state[name] = v.to(device, torch.float32)
    with torch.device("meta"):
        enc = T5Encoder(cfg)
    enc.load_state_dict(state, strict=True, assign=True)
    return enc.eval()
