"""Vision-model checkpoints in the reference's ``.pth`` format.

Counterpart of the ``.pth`` half of ``ml_mdm_tpu/utils/checkpoint.py``
``save_vision_model`` / ``load_vision_model`` (the format of
``ml_mdm_tpu/utils/torch_compat.py``): one ``torch.save`` of
``{"state_dict": <reference torch names>, **other_items}``. The port's
modules carry the reference names and layouts, so a state dict goes in and
out as it is. Loading is non-strict, as in the JAX package: the key
differences are reported and the shared keys are loaded, with
``load_state_dict`` (never through ``.data``: the sampling weights cached
by ``models/layers.py`` ``cached_weights`` are keyed on each parameter's
version). Orbax directories, the JAX package's native format, are the
train state's and not read here.
"""
from __future__ import annotations

import logging
import os
import pickle
import types
from typing import Any, Dict, Optional, Tuple

import torch


def save_vision_model(path: str, module: torch.nn.Module,
                      other_items: Optional[Dict[str, Any]] = None) -> None:
    """Write ``module``'s parameters (and buffers) to the ``.pth`` file
    ``path``, with ``other_items`` beside them."""
    if not path.endswith(".pth"):
        raise ValueError(f"{path!r}: the port writes vision checkpoints as .pth files only")
    checkpoint = {"state_dict": {k: v.detach().cpu() for k, v in module.state_dict().items()}}
    checkpoint.update(other_items or {})
    torch.save(checkpoint, path)


class _Placeholder:
    """Stands in for a class a checkpoint pickled that no longer imports
    (reference checkpoints pickle their argparse namespaces)."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            logging.debug(f"checkpoint references missing {module}.{name}; placeholder used")
            return type(name, (_Placeholder,), {})


# ``torch.load``'s pickle_module: a zip-format checkpoint (every ``torch.save``
# since torch 1.6) is read through its ``Unpickler``
_TOLERANT_PICKLE = types.ModuleType("ml_mdm_tpu_torch_tolerant_pickle")
_TOLERANT_PICKLE.Unpickler = _TolerantUnpickler


def load_vision_model(path: str, module: torch.nn.Module) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Load the ``.pth`` file ``path`` into ``module``, non-strict: the keys
    and shapes both sides share are loaded, and the checkpoint keys the
    module lacks and the module keys the checkpoint lacks are reported.
    Returns (module, the checkpoint's other items)."""
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory (an Orbax checkpoint of the JAX package); "
                         "the port reads vision checkpoints from .pth files only")
    logging.info(f"Loading torch checkpoint: {path}")
    checkpoint = torch.load(path, map_location="cpu", weights_only=False,
                            pickle_module=_TOLERANT_PICKLE)
    state_dict = checkpoint.get("state_dict", checkpoint)
    own = module.state_dict()
    shared = {k: v for k, v in state_dict.items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
    unmatched = sorted(set(state_dict) - set(shared))
    unfilled = sorted(set(own) - set(shared))
    if unmatched or unfilled:
        logging.warning(f"{path}: {len(unmatched)} checkpoint keys not loaded {unmatched}, "
                        f"{len(unfilled)} module keys not in the checkpoint {unfilled}")
    module.load_state_dict(shared, strict=False)
    return module, {k: v for k, v in checkpoint.items() if k != "state_dict"}
