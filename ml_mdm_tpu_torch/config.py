"""Configuration dataclasses of the PyTorch port (no JAX).

Field names and defaults are those of the JAX package's dataclasses
(``ml_mdm_tpu/models/unet.py`` ``UNetConfig``, ``ml_mdm_tpu/models/layers.py``
``ResNetConfig``, ``ml_mdm_tpu/samplers.py`` ``SamplerConfig`` and its enums,
``ml_mdm_tpu/diffusion.py`` ``DiffusionConfig``), so the shipped YAML files
load into either package unchanged.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Optional, Tuple


class _ParsedEnum(enum.Enum):
    """Enum that parses from YAML/CLI strings case-insensitively."""

    def __str__(self):
        return self.name.lower()

    def __repr__(self):
        return str(self)

    @classmethod
    def parse(cls, s):
        if isinstance(s, cls):
            return s
        try:
            return cls[str(s).upper()]
        except KeyError:
            raise ValueError(
                f"{cls.__name__}: unknown value {s!r}; valid: "
                f"{[m.name for m in cls]}"
            ) from None


class ScheduleType(_ParsedEnum):
    COSINE = 0
    DDPM = 2
    DEEPFLOYD = 3
    SIGMOID = 4


class PredictionType(_ParsedEnum):
    DDPM = 3
    DDIM = 4
    V_PREDICTION = 5

    @classmethod
    def parse(cls, s):
        # "HA_STYLE" (a stale value in the reference cc12m_64x64.yaml) is
        # the eps target, as in the JAX package
        if not isinstance(s, cls) and str(s).upper() == "HA_STYLE":
            return cls.DDPM
        return super().parse(s)


class ThresholdType(_ParsedEnum):
    NONE = 0
    CLIP = 1
    DYNAMIC = 2
    DYNAMIC_IF = 3


@dataclass
class SamplerConfig:
    num_diffusion_steps: int = 32
    reproject_signal: bool = False
    schedule_type: ScheduleType = ScheduleType.DDPM
    prediction_type: PredictionType = PredictionType.DDPM
    loss_target_type: Optional[PredictionType] = None
    beta_start: float = 0.0001
    beta_end: float = 0.02
    threshold_function: ThresholdType = ThresholdType.CLIP
    rescale_schedule: float = 1.0
    rescale_signal: Optional[float] = None
    schedule_shifted: bool = False
    schedule_shifted_power: float = 1.0

    def __post_init__(self):
        self.schedule_type = ScheduleType.parse(self.schedule_type)
        self.prediction_type = PredictionType.parse(self.prediction_type)
        if self.loss_target_type is None:
            self.loss_target_type = self.prediction_type
        else:
            self.loss_target_type = PredictionType.parse(self.loss_target_type)
        self.threshold_function = ThresholdType.parse(self.threshold_function)


@dataclass
class DiffusionConfig:
    sampler_config: SamplerConfig = field(default_factory=SamplerConfig)
    model_output_scale: float = 0.0
    use_vdm_loss_weights: bool = True


@dataclass
class ResNetConfig:
    num_channels: int = -1
    output_channels: int = -1
    num_groups_norm: int = 32
    dropout: float = 0.0
    use_attention_ffn: bool = False


def _parse_int_list(v, n=None):
    if isinstance(v, str):
        v = [int(x) for x in v.split(",")] if v else []
    v = list(v) if v is not None else v
    if v is not None and n is not None and len(v) == 1:
        v = v * n
    return v


@dataclass
class UNetConfig:
    num_resnets_per_resolution: Any = "2"
    temporal_dim: Optional[int] = None
    attention_levels: Any = "2,3"
    num_attention_layers: Any = "1"
    num_temporal_attention_layers: Any = None
    conditioning_feature_dim: int = -1
    conditioning_feature_proj_dim: int = -1
    num_lm_head_layers: int = 0
    masked_cross_attention: int = 1
    resolution_channels: Any = "128,256,256,512,1024"
    skip_mid_blocks: bool = False
    skip_cond_emb: bool = False
    nesting: bool = False
    micro_conditioning: Optional[str] = None
    temporal_mode: bool = False
    temporal_spatial_ds: bool = False
    temporal_positional_encoding: bool = False
    pack_min_side: int = 512
    resnet_config: ResNetConfig = field(default_factory=ResNetConfig)

    def __post_init__(self):
        self.resolution_channels = _parse_int_list(self.resolution_channels)
        n = len(self.resolution_channels)
        if self.attention_levels is None or self.attention_levels == "":
            self.attention_levels = []
        else:
            self.attention_levels = _parse_int_list(self.attention_levels)
        self.num_attention_layers = _parse_int_list(self.num_attention_layers, n)
        if len(self.num_attention_layers) != n:
            raise ValueError("num_attention_layers needs one entry per level")
        self.num_resnets_per_resolution = _parse_int_list(
            self.num_resnets_per_resolution, n
        )
        if len(self.num_resnets_per_resolution) != n:
            raise ValueError(
                "num_resnets_per_resolution needs one entry per level"
            )
        if self.num_temporal_attention_layers is not None:
            self.num_temporal_attention_layers = _parse_int_list(
                self.num_temporal_attention_layers, n
            )
        if isinstance(self.resnet_config, dict):
            self.resnet_config = ResNetConfig(**self.resnet_config)


def _from_dict(cls, data: Optional[Dict[str, Any]]):
    """Build dataclass ``cls`` from a YAML mapping, recursing into dataclass
    fields; keys the dataclass does not have are ignored, and the strings
    "None"/"null" mean None (as the JAX loader reads them)."""
    if data is None:
        return cls()
    known = {f.name: f for f in fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in known:
            continue
        if isinstance(value, str) and value in ("None", "null"):
            value = None
        default = known[key].default_factory  # type: ignore[misc]
        if isinstance(value, dict) and callable(default):
            sub = default()
            if is_dataclass(sub):
                value = _from_dict(type(sub), value)
        kwargs[key] = value
    return cls(**kwargs)


def load_model_config(path: str) -> Tuple[UNetConfig, DiffusionConfig]:
    """Read a single-UNet model YAML (e.g. configs/models/cc12m_64x64.yaml)
    into (UNetConfig, DiffusionConfig)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    model = cfg.get("model") or cfg.get("vision_model")
    if model != "unet":
        raise ValueError(f"{path}: model {model!r} is not ported (only 'unet')")
    return (
        _from_dict(UNetConfig, cfg.get("unet_config")),
        _from_dict(DiffusionConfig, cfg.get("diffusion_config")),
    )
