"""The system under test: the port's pipeline built as its command-line
tools build it, from a configuration file's YAML, with the benchmark's
weights loaded by name.

This is the one file of the harness besides the drivers that imports the
program (``ml_mdm_tpu_torch``); the drivers take from it only the pipeline
and the training step.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import torch

# what the model configuration's YAML keys are, and where the command line
# routes a top-level key that names a field of one of them
_SECTIONS = ("unet_config", "diffusion_config", "reader_config")


def _configs(config: Dict):
    from ml_mdm_tpu_torch import diffusion  # noqa: F401  (fills the registries)
    from ml_mdm_tpu_torch.config import (dataclass_from_dict, get_model_config_cls,
                                         get_pipeline_config_cls)
    from ml_mdm_tpu_torch.models import nested_unet  # noqa: F401

    yaml = config["yaml"]
    name = yaml["model"]
    ucfg = dataclass_from_dict(get_model_config_cls(name), copy.deepcopy(yaml["unet_config"]))
    dcfg = dataclass_from_dict(get_pipeline_config_cls(name),
                               copy.deepcopy(yaml["diffusion_config"]))
    for key, value in yaml.items():  # ``config.get_arguments``' routing
        if key in _SECTIONS:
            continue
        for target in (dcfg, dcfg.sampler_config, ucfg):
            if hasattr(target, key):
                setattr(target, key, value)
                break
    # the text tower's width, as the command-line tools set it
    ucfg.conditioning_feature_dim = config["text_width"]
    return name, ucfg, dcfg


def named_shapes(config: Dict) -> List[Tuple[str, Sequence[int]]]:
    """The port's parameters of a configuration, by name, with their shapes."""
    from ml_mdm_tpu_torch.config import get_model

    name, ucfg, _ = _configs(config)
    with torch.device("meta"):
        module = get_model(name)(3, 3, ucfg)
    return [(k, tuple(p.shape)) for k, p in module.named_parameters()]


def build(config: Dict, weights: Dict[str, torch.Tensor], device, train: bool):
    """The pipeline with ``weights`` loaded (``strict=True``): in eval mode
    in the weights' dtype, or in training mode with bf16 compute."""
    from ml_mdm_tpu_torch.config import get_model, get_pipeline

    name, ucfg, dcfg = _configs(config)
    dtype = next(iter(weights.values())).dtype
    with torch.device("meta"):
        module = get_model(name)(3, 3, ucfg).to(dtype)
    module = module.to_empty(device=device)
    module.load_state_dict(weights, strict=True)
    if train:
        module.set_compute_dtype(torch.bfloat16).train()
    else:
        module.eval()
    return get_pipeline(name)(module, dcfg)

