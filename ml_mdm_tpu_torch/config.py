"""Configuration dataclasses of the PyTorch port (no JAX).

Field names and defaults are those of the JAX package's dataclasses
(``ml_mdm_tpu/models/unet.py`` ``UNetConfig``, ``ml_mdm_tpu/models/layers.py``
``ResNetConfig``, ``ml_mdm_tpu/models/nested_unet.py`` ``NestedUNetConfig``,
``ml_mdm_tpu/samplers.py`` ``SamplerConfig`` and its enums,
``ml_mdm_tpu/diffusion.py`` ``DiffusionConfig`` and ``NestedDiffusionConfig``),
so the shipped YAML files load into either package unchanged.

Also the model and pipeline registries and ``get_arguments``, the command
line of ``ml_mdm_tpu/config.py``: the same YAML layers, overrides and
namespace, filled by the port's own modules.
"""
from __future__ import annotations

import argparse
import enum
import logging
import sys
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple


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
class NestedDiffusionConfig(DiffusionConfig):
    use_double_loss: bool = False
    multi_res_weights: Optional[str] = None
    no_use_residual: bool = False
    use_random_interp: bool = False
    mixed_ratio: Optional[str] = None
    random_downsample: bool = False
    average_downsample: bool = False
    mid_downsample: bool = False


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


@dataclass
class NestedUNetConfig(UNetConfig):
    """A shell around an inner U-Net: ``inner_config`` is a UNetConfig (the
    innermost level) or, recursively, a NestedUNetConfig."""

    inner_config: UNetConfig = field(default_factory=lambda: UNetConfig(nesting=True))
    skip_mid_blocks: bool = True
    skip_cond_emb: bool = True
    skip_inner_unet_input: bool = False
    skip_normalization: bool = False
    initialize_inner_with_pretrained: Optional[str] = None
    freeze_inner_unet: bool = False
    interp_conditioning: bool = False

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.inner_config, dict):
            cls = NestedUNetConfig if "inner_config" in self.inner_config else UNetConfig
            self.inner_config = dataclass_from_dict(cls, self.inner_config)


def dataclass_from_dict(cls, data: Optional[Dict[str, Any]], extra_sink: Optional[list] = None):
    """Build dataclass ``cls`` from a YAML mapping, recursing into dataclass
    fields; the strings "None"/"null" mean None (as the JAX loader reads
    them), and keys the dataclass does not have are ignored, or recorded
    as ``Class.key`` in ``extra_sink``. An ``inner_config`` mapping becomes
    a ``NestedUNetConfig`` if it nests again, else a ``UNetConfig``."""
    if data is None:
        return cls()
    if isinstance(data, cls):
        return data
    known = {f.name: f for f in fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in known:
            if extra_sink is not None:
                extra_sink.append(f"{cls.__name__}.{key}")
            continue
        if isinstance(value, str) and value in ("None", "null"):
            value = None
        if isinstance(value, dict):
            if key == "inner_config":
                target = NestedUNetConfig if "inner_config" in value else UNetConfig
            else:
                default = known[key].default_factory  # type: ignore[misc]
                target = type(default()) if callable(default) else None
            if target is not None and is_dataclass(target):
                value = dataclass_from_dict(target, value, extra_sink)
        kwargs[key] = value
    return cls(**kwargs)


@dataclass
class Nested2UNetConfig(NestedUNetConfig):
    """Two shells: by default the inner U-Net is itself nested."""

    inner_config: NestedUNetConfig = field(default_factory=lambda: NestedUNetConfig(
        nesting=True, initialize_inner_with_pretrained=None))


@dataclass
class Nested3UNetConfig(Nested2UNetConfig):
    inner_config: Nested2UNetConfig = field(default_factory=lambda: Nested2UNetConfig(
        nesting=True, initialize_inner_with_pretrained=None))


@dataclass
class Nested4UNetConfig(Nested3UNetConfig):
    inner_config: Nested3UNetConfig = field(default_factory=lambda: Nested3UNetConfig(
        nesting=True, initialize_inner_with_pretrained=None))


# -- registries (``ml_mdm_tpu/config.py``): filled by the port's
# ``models.unet``, ``models.nested_unet`` and ``diffusion`` modules.
# A model name maps to its config class and to the name of its module and
# pipeline (every nested model is a ``NestedUNet`` in ``NestedDiffusion``).

MODEL_CONFIG_REGISTRY: Dict[str, Dict[str, Any]] = {}
MODEL_REGISTRY: Dict[str, Any] = {}
PIPELINE_CONFIG_REGISTRY: Dict[str, Any] = {}
PIPELINE_REGISTRY: Dict[str, Any] = {}


def register_model_config(arch: str, main: str):
    def wrap(cls):
        MODEL_CONFIG_REGISTRY[arch] = {"model": main, "config": cls}
        return cls

    return wrap


def _register_in(registry: Dict[str, Any], *names):
    def wrap(cls):
        for name in names:
            registry[name] = cls
        return cls

    return wrap


def register_model(*names):
    return _register_in(MODEL_REGISTRY, *names)


def register_pipeline_config(*names):
    return _register_in(PIPELINE_CONFIG_REGISTRY, *names)


def register_pipeline(*names):
    return _register_in(PIPELINE_REGISTRY, *names)


def _main_name(name: str) -> str:
    if name not in MODEL_CONFIG_REGISTRY:
        raise NotImplementedError(f"unknown model {name!r}")
    return MODEL_CONFIG_REGISTRY[name]["model"]


def get_model(name):
    return MODEL_REGISTRY[_main_name(name)]


def get_model_config_cls(name):
    _main_name(name)
    return MODEL_CONFIG_REGISTRY[name]["config"]


def get_pipeline(name):
    return PIPELINE_REGISTRY[_main_name(name)]


def get_pipeline_config_cls(name):
    return PIPELINE_CONFIG_REGISTRY[_main_name(name)]


def load_model_config(path: str) -> Tuple[UNetConfig, DiffusionConfig]:
    """(U-Net config, diffusion config) of a model YAML (e.g.
    configs/models/cc12m_64x64.yaml or the nested cc12m_256x256.yaml /
    cc12m_1024x1024.yaml): ``get_arguments`` on that file alone, so the
    classes come from the registries and top-level keys are routed as
    there."""
    ns = get_arguments(["--config_path", path], mode="sampler")
    return ns.unet_config, ns.diffusion_config


# -- the command line (``ml_mdm_tpu/config.py`` ``get_arguments``) ----------

# Fields accepted only so the reference YAMLs parse: they do nothing in
# either package, and a non-default value logs a warning.
INERT_COMPAT_FIELDS: Dict[str, set] = {
    "NestedDiffusionConfig": {"use_random_interp", "random_downsample", "average_downsample",
                              "mid_downsample"},
    "SamplerConfig": {"reproject_signal"},
    "ReaderConfig": {"bucket"},
}


def warn_inert_fields(cfg, _path: str = "") -> List[str]:
    """Warn about (and return the paths of) inert fields set to a
    non-default value anywhere in a config dataclass."""
    hits: List[str] = []
    if cfg is None or not is_dataclass(cfg) or isinstance(cfg, type):
        return hits
    inert = INERT_COMPAT_FIELDS.get(type(cfg).__name__, set())
    defaults = type(cfg)() if inert else None
    for f in fields(cfg):
        value = getattr(cfg, f.name)
        where = f"{_path}{type(cfg).__name__}.{f.name}"
        if f.name in inert and value != getattr(defaults, f.name):
            hits.append(where)
            logging.warning(f"Config field {where}={value!r} is accepted for reference-YAML "
                            "compatibility but has no effect")
        hits += warn_inert_fields(value, _path=f"{where}: ")
    return hits


def _add_common_arguments(p: argparse.ArgumentParser):
    p.add_argument("--loglevel", type=str, default="INFO")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--fp16", type=int, default=0,
                   help="bf16 compute (name kept for YAML compatibility)")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--output-dir", type=str, default="")
    p.add_argument("--vocab_file", type=str, default="data/c4_wpm.vocab")
    p.add_argument("--pretrained-vision-file", type=str, default=None)
    p.add_argument("--categorical-conditioning", type=int, default=0)
    p.add_argument("--text-model", type=str, default="google/flan-t5-xl",
                   help="a local Hugging Face T5 checkpoint directory, or random:<width>")
    p.add_argument("--model", "--vision-model", dest="model", type=str, default="unet")
    p.add_argument("--use-precomputed-text-embeddings", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--num-training-steps", type=int, default=850000)
    p.add_argument("--num-epochs", type=int, default=20000)


def _add_trainer_arguments(p):
    p.add_argument("--multinode", type=int, default=1)
    p.add_argument("--local-rank", type=int, default=0)
    p.add_argument("--use-adamw", action="store_true")
    p.add_argument("--file-list", type=str, default="cifar10-32/train.csv")
    p.add_argument("--log-freq", type=int, default=100)
    p.add_argument("--save-freq", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr-scaling-factor", type=float, default=0.8)
    p.add_argument("--gradient-clip-norm", type=float, default=2.0)
    p.add_argument("--warmup-steps", type=int, default=5000)
    p.add_argument("--num-gradient-accumulations", type=int, default=1)
    p.add_argument("--remat", type=int, default=0)
    p.add_argument("--loss-factor", type=float, default=1)
    p.add_argument("--resume-from-ema", action="store_true")
    p.add_argument("--resume-from-train-state", type=str, default=None)
    p.add_argument("--mesh-shape", type=str, default=None)


def _add_sampler_arguments(p):
    p.add_argument("--model-file", type=str, default="")
    p.add_argument("--test-file-list", type=str, default="")
    p.add_argument("--sample-dir", type=str, default="samples")
    p.add_argument("--eval-freq", type=int, default=1000)
    p.add_argument("--sample-image-size", type=int, default=-1)
    p.add_argument("--port", type=int, default=19231)
    p.add_argument("--min-examples", type=int, default=10000)


def _add_evaluator_arguments(p):
    p.add_argument("--test-file-list", type=str, default="")
    p.add_argument("--sample-dir", type=str, default="samples")
    p.add_argument("--eval-freq", type=int, default=1000)
    p.add_argument("--sample-image-size", type=int, default=-1)
    p.add_argument("--num-eval-batches", type=int, default=500)


def _add_demo_arguments(p):
    p.add_argument("--sample-dir", type=str, default="samples")
    p.add_argument("--sample-image-size", type=int, default=-1)
    p.add_argument("--port", type=int, default=19231)
    p.add_argument("--model-file", type=str, default="")
    p.add_argument("--config-dir", type=str, default="configs/models")
    p.add_argument("--model-dir", type=str, default=".")


_MODE_EXTRAS = {
    "trainer": _add_trainer_arguments,
    "sampler": _add_sampler_arguments,
    "evaluator": _add_evaluator_arguments,
    "demo": _add_demo_arguments,
}
_SECTIONS = ("unet_config", "diffusion_config", "reader_config")


def get_arguments(args=None, mode: str = "trainer", additional_config_paths=()):
    """The command line ``args`` (default ``sys.argv[1:]``) and the YAML
    files it names (``--config_path``, ``--reader-config-file``,
    ``--model-config-file``, after ``additional_config_paths``) as one
    namespace, the same as the JAX package's for every ``mode`` ("trainer",
    "sampler", "evaluator", "demo") except ``--device``, "cuda" here: YAML
    keys (dashes read as underscores) set the arguments the command line
    leaves unset; ``unet_config``, ``diffusion_config`` and
    ``reader_config`` become the model's config dataclasses; a top-level
    key naming a field of one of them lands there; ``--section.field
    value`` overrides a field; unknown keys are listed in ``extra_config``."""
    import yaml

    # fill the registries
    from ml_mdm_tpu_torch import diffusion  # noqa: F401
    from ml_mdm_tpu_torch.models import nested_unet  # noqa: F401
    from ml_mdm_tpu_torch.reader import ReaderConfig

    if mode not in _MODE_EXTRAS:
        raise NotImplementedError(mode)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config_path", "--config-path", dest="config_path", type=str,
                     default=None)
    pre.add_argument("--model", "--vision-model", dest="model", type=str, default=None)
    pre.add_argument("--reader-config-file", type=str, default=None)
    pre.add_argument("--model-config-file", type=str, default=None)
    pre_args, _ = pre.parse_known_args(args)

    yaml_cfg: Dict[str, Any] = {}
    paths = list(additional_config_paths) + [
        p for p in (pre_args.reader_config_file, pre_args.model_config_file,
                    pre_args.config_path) if p]
    for path in paths:
        with open(path) as f:
            layer = yaml.safe_load(f) or {}
        yaml_cfg.update({str(k).replace("-", "_"): v for k, v in layer.items()})
    model_name = (pre_args.model or yaml_cfg.get("model") or yaml_cfg.get("vision_model")
                  or "unet")

    parser = argparse.ArgumentParser(description=f"ml_mdm_tpu_torch {mode}")
    parser.add_argument("--config_path", "--config-path", dest="config_path", type=str,
                        default=None)
    parser.add_argument("--reader-config-file", type=str, default=None)
    parser.add_argument("--model-config-file", type=str, default=None)
    _add_common_arguments(parser)
    _MODE_EXTRAS[mode](parser)
    ns, unknown = parser.parse_known_args(args)
    ns.model = model_name

    cli_set = _explicit_cli_dests(parser, args)
    extra = []
    for key, value in yaml_cfg.items():
        if key in _SECTIONS:
            continue
        if hasattr(ns, key):
            if key not in cli_set:
                setattr(ns, key, value)
        else:
            extra.append(key)

    sink: List[str] = []
    ns.unet_config = dataclass_from_dict(get_model_config_cls(model_name),
                                         yaml_cfg.get("unet_config"), sink)
    ns.diffusion_config = dataclass_from_dict(get_pipeline_config_cls(model_name),
                                              yaml_cfg.get("diffusion_config"), sink)
    ns.reader_config = dataclass_from_dict(ReaderConfig, yaml_cfg.get("reader_config"), sink)

    targets = [ns.diffusion_config, getattr(ns.diffusion_config, "sampler_config", None),
               ns.unet_config, ns.reader_config]
    routed = set()
    for key in extra:
        for target in targets:
            if target is not None and hasattr(target, key):
                value = yaml_cfg[key]
                setattr(target, key, None if value in ("None", "null") else value)
                routed.add(key)
                break
    extra = [k for k in extra if k not in routed]

    _apply_dotted_overrides(ns, unknown)
    ns.extra_config = sorted(set(extra + sink))
    if ns.extra_config:
        logging.info(f"Ignoring unknown config keys: {ns.extra_config}")
    for section in (ns.unet_config, ns.diffusion_config, ns.reader_config):
        warn_inert_fields(section)
    return ns


def _explicit_cli_dests(parser, args):
    """The dests given explicitly on the command line (they beat YAML)."""
    argv = list(sys.argv[1:]) if args is None else list(args)
    dests = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if opt in argv or any(a.startswith(opt + "=") for a in argv):
                dests.add(action.dest)
    return dests


def _apply_dotted_overrides(ns, unknown):
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not (tok.startswith("--") and "." in tok):
            i += 1
            continue
        if "=" in tok:
            key, value = tok[2:].split("=", 1)
            i += 1
        else:
            key = tok[2:]
            value = unknown[i + 1] if i + 1 < len(unknown) else None
            i += 2
        parts = key.replace("-", "_").split(".")
        obj = ns
        for part in parts[:-1]:
            obj = getattr(obj, part, None)
            if obj is None:
                break
        if obj is not None and hasattr(obj, parts[-1]):
            setattr(obj, parts[-1], _coerce_like(getattr(obj, parts[-1]), value))


def _coerce_like(old, value):
    if isinstance(old, bool):
        return str(value).lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)):
        import yaml

        return yaml.safe_load(value)
    return value
