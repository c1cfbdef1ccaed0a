"""CLIP's two towers, their image preprocessing and a local checkpoint reader:
what ``run_torchmetrics`` needs for CLIP features and CLIPScore.

Counterpart of what the JAX package's ``run_torchmetrics`` (``ClipFeatures``)
loads from ``transformers`` (``CLIPModel``, ``CLIPImageProcessor``):

- the vision tower: a patch ``Conv2d`` without bias, the class embedding,
  learned positions, ``pre_layrnorm`` (sic), pre-LN encoder layers
  (``self_attn.{q,k,v,out}_proj``, ``layer_norm1``, ``mlp.fc1``,
  ``mlp.fc2``, ``layer_norm2``; ``quick_gelu`` or GeLU as ``hidden_act``
  says), ``post_layernorm`` on the class token, ``visual_projection``
  without bias;
- the text tower: token and position embeddings, the same layers under a
  causal mask and the padding mask, ``final_layer_norm``, the pooled token
  (the end token: the first ``eos_token_id`` of each row, or the row's
  largest id where ``eos_token_id`` is 2, the older configs' value, as
  Hugging Face pools), ``text_projection`` without bias;
- ``logit_scale``.

The modules carry Hugging Face's parameter names (``vision_model.…``,
``text_model.…``), so a released checkpoint loads strict.
``load_clip_from_torch`` reads a local directory only (``config.json`` and
``model.safetensors``, parsed here, or ``pytorch_model.bin``); nothing is
downloaded. Attention runs on ``torch.matmul``: the towers' lengths (197
image tokens at 224 px and patch 16, at most 77 text tokens) are no
multiple of 128 and the text mask is causal, which the flash route (K4)
does not take. ``preprocess_images`` is the slow ``CLIPImageProcessor``'s
arithmetic on the host (PIL bicubic on uint8, the centre crop, the rescale
in f64, the normalisation in f32).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

OPENAI_CLIP_MEAN = [0.48145466, 0.4578275, 0.40821073]
OPENAI_CLIP_STD = [0.26862954, 0.26130258, 0.27577711]


@dataclass
class CLIPTowerConfig:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # the text tower's
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    # the vision tower's
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3


_TEXT_DEFAULTS = dict(hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
                      num_attention_heads=8)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                        num_attention_heads=12)


def _tower(defaults: Dict, given: Dict) -> CLIPTowerConfig:
    keys = set(CLIPTowerConfig.__dataclass_fields__)
    return CLIPTowerConfig(**{**defaults, **{k: v for k, v in given.items() if k in keys}})


@dataclass
class CLIPConfig:
    text: CLIPTowerConfig = field(default_factory=lambda: _tower(_TEXT_DEFAULTS, {}))
    vision: CLIPTowerConfig = field(default_factory=lambda: _tower(_VISION_DEFAULTS, {}))
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592

    @classmethod
    def from_hf_config(cls, hf: Dict) -> "CLIPConfig":
        """From a Hugging Face CLIP ``config.json`` as a dict: its
        ``text_config`` and ``vision_config`` (overridden by the older
        ``text_config_dict`` / ``vision_config_dict`` where a file has them),
        the missing keys at ``CLIPTextConfig``'s and ``CLIPVisionConfig``'s
        defaults."""
        text = {**(hf.get("text_config") or {}), **(hf.get("text_config_dict") or {})}
        vision = {**(hf.get("vision_config") or {}), **(hf.get("vision_config_dict") or {})}
        return cls(text=_tower(_TEXT_DEFAULTS, text), vision=_tower(_VISION_DEFAULTS, vision),
                   projection_dim=hf.get("projection_dim", 512),
                   logit_scale_init_value=hf.get("logit_scale_init_value", 2.6592))


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"CLIP hidden_act {name!r} is not supported")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = d // self.num_heads
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.q_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, allowed: Optional[torch.Tensor] = None):
        """``allowed``: (B, 1, L, L) bool, True where a query may attend."""
        b, l, d = x.shape

        def heads(t):
            return t.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.head_dim ** -0.5
        if allowed is not None:
            scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=-1)
        return self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(b, l, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, allowed=None):
        x = x + self.self_attn(self.layer_norm1(x), allowed)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, allowed=None):
        for layer in self.layers:
            x = layer(x, allowed)
        return x


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1,
                                               cfg.hidden_size)

    def forward(self, pixel_values):
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(pixel_values.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values):
        """(B, C, S, S) at the config's image size -> the pooled (B, hidden)."""
        side = self.config.image_size
        if tuple(pixel_values.shape[-2:]) != (side, side):
            raise ValueError(f"CLIP vision tower: images {tuple(pixel_values.shape)}, "
                             f"expected a side of {side}")
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(x[:, 0])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids):
        return self.token_embedding(input_ids) + self.position_embedding.weight[:input_ids.shape[1]]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, attention_mask=None):
        """input_ids (B, L) int, attention_mask (B, L) 1/0 -> the pooled
        (B, hidden) at each row's end token."""
        b, l = input_ids.shape
        allowed = torch.ones(l, l, dtype=torch.bool, device=input_ids.device).tril()[None, None]
        if attention_mask is not None:
            allowed = allowed & attention_mask.bool()[:, None, None, :]
        x = self.final_layer_norm(self.encoder(self.embeddings(input_ids), allowed))
        if self.config.eos_token_id == 2:
            end = input_ids.argmax(dim=-1)
        else:
            end = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        return x[torch.arange(b, device=x.device), end]


class CLIPModel(nn.Module):
    def __init__(self, config: CLIPConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config.text)
        self.vision_model = CLIPVisionTransformer(config.vision)
        self.visual_projection = nn.Linear(config.vision.hidden_size, config.projection_dim,
                                           bias=False)
        self.text_projection = nn.Linear(config.text.hidden_size, config.projection_dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(config.logit_scale_init_value))

    def get_image_features(self, pixel_values):
        dtype = self.visual_projection.weight.dtype
        return self.visual_projection(self.vision_model(pixel_values.to(dtype)))

    def get_text_features(self, input_ids, attention_mask=None):
        return self.text_projection(self.text_model(input_ids, attention_mask))


@torch.no_grad()
def init_clip_(model: CLIPModel, generator: torch.Generator) -> CLIPModel:
    """Seeded random weights in place: each dense and patch weight normal
    with std 1/sqrt(fan_in), the embeddings normal with std 0.02, biases 0,
    norms 1, ``logit_scale`` at its init value."""
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
        if "norm" in name:  # layer_norm1/2, final_layer_norm, pre_layrnorm, post_layernorm
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name == "logit_scale":
            p.fill_(model.config.logit_scale_init_value)
        elif name.endswith("bias"):
            p.zero_()
        elif "embedding" in name and "patch" not in name:
            p.copy_(noise * 0.02)
        else:
            p.copy_(noise / math.sqrt(p[0].numel()))
    return model


# -- checkpoints ------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                       "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file, on the CPU: an 8-byte
    little-endian header length, a JSON header of each tensor's dtype,
    shape and byte offsets, then the raw little-endian data."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        begin, end = spec["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[spec["dtype"]]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(spec["shape"]).clone()
    return out


def write_safetensors(state: Dict[str, torch.Tensor], path: str) -> None:
    """``state`` as a ``.safetensors`` file (the header padded with spaces
    to a multiple of 8 bytes, as the ``safetensors`` package writes it)."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name, t in state.items():
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def load_clip_from_torch(path: str, device) -> CLIPModel:
    """The CLIP model of a Hugging Face checkpoint in the local directory
    ``path`` (``config.json`` and ``model.safetensors`` or
    ``pytorch_model.bin``), f32 weights, in eval mode on ``device``. Older
    checkpoints' ``position_ids`` buffers are dropped; every other key must
    match. A name that is not a local directory raises."""
    device = torch.device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"CLIP model {path!r} is not a local directory; the port reads a Hugging Face CLIP "
            "checkpoint directory (config.json + model.safetensors or pytorch_model.bin) and "
            "downloads nothing")
    with open(os.path.join(path, "config.json")) as f:
        cfg = CLIPConfig.from_hf_config(json.load(f))
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        raw = read_safetensors(st)
    else:
        raw = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                         weights_only=True)
    state = {k: v.to(device, torch.float32) for k, v in raw.items()
             if not k.endswith("position_ids")}
    with torch.device("meta"):
        model = CLIPModel(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


# -- image preprocessing ---------------------------------------------------------------


def read_preprocessor_config(path: str) -> Dict:
    """``preprocessor_config.json`` of a local CLIP directory with
    ``CLIPImageProcessor``'s defaults for the keys it lacks (an integer
    ``size`` is the shortest edge, an integer ``crop_size`` a square)."""
    cfg = {"do_resize": True, "size": {"shortest_edge": 224}, "resample": 3,
           "do_center_crop": True, "crop_size": {"height": 224, "width": 224},
           "do_rescale": True, "rescale_factor": 1 / 255, "do_normalize": True,
           "image_mean": OPENAI_CLIP_MEAN, "image_std": OPENAI_CLIP_STD}
    file = os.path.join(path, "preprocessor_config.json")
    if os.path.exists(file):
        with open(file) as f:
            cfg.update(json.load(f))
    if isinstance(cfg["size"], int):
        cfg["size"] = {"shortest_edge": cfg["size"]}
    if isinstance(cfg["crop_size"], int):
        cfg["crop_size"] = {"height": cfg["crop_size"], "width": cfg["crop_size"]}
    return cfg


def _resize(img: np.ndarray, size: Dict, resample: int) -> np.ndarray:
    from PIL import Image

    h, w = img.shape[:2]
    if "shortest_edge" in size:
        short, long = (w, h) if w <= h else (h, w)
        new_short, new_long = size["shortest_edge"], int(size["shortest_edge"] * long / short)
        oh, ow = (new_long, new_short) if w <= h else (new_short, new_long)
    else:
        oh, ow = size["height"], size["width"]
    return np.array(Image.fromarray(img).resize((ow, oh), resample=resample))


def _center_crop(img: np.ndarray, crop: Dict) -> np.ndarray:
    h, w = img.shape[:2]
    ch, cw = crop["height"], crop["width"]
    top, left = int((h - ch) / 2), int((w - cw) / 2)
    if top < 0 or left < 0:
        raise ValueError(f"CLIP preprocessing: a {h}x{w} image after the resize is smaller than "
                         f"the {ch}x{cw} crop (a crop_size above the shortest edge)")
    return img[top:top + ch, left:left + cw]


def preprocess_images(images_u8: Sequence[np.ndarray], cfg: Dict) -> np.ndarray:
    """(N, 3, H, W) f32 pixel values of uint8 RGB (H, W, 3) images, as the
    slow ``CLIPImageProcessor`` computes them."""
    out: List[np.ndarray] = []
    for img in images_u8:
        img = np.asarray(img)
        if cfg["do_resize"]:
            img = _resize(img, cfg["size"], cfg["resample"])
        if cfg["do_center_crop"]:
            img = _center_crop(img, cfg["crop_size"])
        if cfg["do_rescale"]:
            img = (img.astype(np.float64) * cfg["rescale_factor"]).astype(np.float32)
        if cfg["do_normalize"]:
            img = img.astype(np.float32) if not np.issubdtype(img.dtype, np.floating) else img
            mean = np.array(cfg["image_mean"], dtype=img.dtype)
            std = np.array(cfg["image_std"], dtype=img.dtype)
            img = (img - mean) / std
        out.append(np.ascontiguousarray(img.transpose(2, 0, 1)))
    return np.stack(out).astype(np.float32, copy=False)
