"""Checkpoints: the vision model's ``.pth`` files, the train state, the
inner U-Net's warm start and the choice of the file to resume from.

Counterpart of ``ml_mdm_tpu/utils/checkpoint.py``:

- ``save_vision_model`` / ``load_vision_model``: the reference's ``.pth``
  format (that of ``ml_mdm_tpu/utils/torch_compat.py``), one
  ``torch.save`` of ``{"state_dict": <reference torch names>,
  **other_items}``. The port's modules carry the reference names and
  layouts, so a state dict goes in and out as it is. Loading is
  non-strict, as in the JAX package: the key differences are reported and
  the shared keys are loaded.
- ``save_train_state`` / ``load_train_state``: the JAX package writes the
  train state with Orbax; the port writes a directory ``train_state_N``
  holding one ``torch.save`` (``state.pt``) of the step, the parameters,
  the EMA, the optimizer's state (both Adam moments and its count) and the
  other items (the ``RobustLossTracker`` stats), and beside it the same
  ``train_meta.json`` as the JAX package. It restores all of them bit for
  bit. The file holds whole tensors in one format: an FSDP run gathers its
  shards to write it and takes its shards when it reads one
  (``module_state_dict`` and ``ema_state_dict`` gather the ``.pth`` files'
  tensors likewise), so a data-parallel and an FSDP run resume from each
  other's saves.
- ``apply_inner_warm_start`` loads the ``.pth`` files that
  ``initialize_inner_with_pretrained`` names into the inner U-Nets,
  fetching an ``s3://`` path first as the JAX package does; an Orbax
  directory, which the JAX package also reads, raises here.
- ``select_resume_checkpoint``: ``--resume-from-ema``'s redirection of a
  ``vis_model_noema_N.pth`` to its EMA sibling.

Parameters are written with ``load_state_dict`` or ``copy_`` under
``no_grad``, never through ``.data``: the sampling weights cached by
``models/layers.py`` ``cached_weights`` are keyed on each parameter's
version.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import types
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch


def save_vision_model(path: str, module: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                      other_items: Optional[Dict[str, Any]] = None) -> None:
    """Write ``module``'s parameters (and buffers), or a state dict, to the
    ``.pth`` file ``path``, with ``other_items`` beside them."""
    if not path.endswith(".pth"):
        raise ValueError(f"{path!r}: the port writes vision checkpoints as .pth files only")
    state = module if isinstance(module, Mapping) else module.state_dict()
    checkpoint = {"state_dict": {k: v.detach().cpu() for k, v in state.items()}}
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


def _resolve_pretrained_path(path: str) -> str:
    """The local file a warm start names, as the JAX package resolves it
    (``ml_mdm_tpu/utils/checkpoint.py`` ``_resolve_pretrained_path``): an
    ``s3://`` path, or a ``bucket/key`` path that is no local file and
    starts with neither ``.`` nor ``/``, is downloaded once by process 0
    through ``s3_helpers`` (which raises without ``boto3``) into the file
    named by the path with its slashes as underscores, and every process
    meets at a barrier; a missing file raises (a warm start never silently
    trains from scratch)."""
    if path.startswith("s3://") or (
            "/" in path and not os.path.exists(path) and not path.startswith((".", "/"))):
        from ml_mdm_tpu_torch import s3_helpers
        from ml_mdm_tpu_torch.distributed import barrier, get_rank

        local_file = path.replace("s3://", "").replace("/", "_")
        if get_rank() == 0 and not os.path.exists(local_file):
            s3_helpers.download_object_from_full_path(path, download_path=local_file)
        barrier("inner_warm_start_download")
        path = local_file
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"initialize_inner_with_pretrained: checkpoint {path!r} not found (set the field "
            "to a local .pth path or an s3:// url, or remove it to train the inner UNet from "
            "scratch)")
    return path


def apply_inner_warm_start(module: torch.nn.Module, unet_config) -> torch.nn.Module:
    """Load the inner U-Nets of a nested ``module`` from the checkpoints
    that ``initialize_inner_with_pretrained`` names, level by level of
    ``unet_config`` (the Matryoshka recipe: the 256px model's inner U-Net
    starts from a trained 64px model). Call it before the EMA copy is made,
    so both start from the loaded weights. Non-strict, as
    ``load_vision_model``; the outer shells are untouched."""
    cfg, key_path = unet_config, []
    while cfg is not None and hasattr(cfg, "inner_config"):
        key_path.append("inner_unet")
        pretrained = getattr(cfg, "initialize_inner_with_pretrained", None)
        if pretrained:
            local = _resolve_pretrained_path(str(pretrained))
            logging.info(f"Warm-starting {'.'.join(key_path)} from {local}")
            load_vision_model(local, module.get_submodule(".".join(key_path)))
        cfg = getattr(cfg, "inner_config", None)
    return module


def select_resume_checkpoint(path: str, resume_from_ema: bool) -> str:
    """With ``--resume-from-ema``, a ``vis_model_noema_N.pth`` path becomes
    its EMA sibling ``vis_model_N.pth`` where that exists (the trainer
    writes both); otherwise ``path`` itself."""
    if not resume_from_ema:
        return path
    base = os.path.basename(path)
    if "noema_" not in base:
        return path  # the EMA file already, by its name
    sibling = os.path.join(os.path.dirname(path), base.replace("noema_", ""))
    if os.path.exists(sibling):
        logging.info(f"--resume-from-ema: loading {sibling} instead of {path}")
        return sibling
    logging.warning(f"--resume-from-ema set but EMA sibling {sibling} not found; loading {path}")
    return path


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.integer, np.floating)):  # np.float64 is a float too
            out[k] = v.item()
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[k] = v.item()
        else:
            out[k] = str(v)
    return out


def optimizer_names(state) -> list:
    """The parameter name of each of the optimizer's parameters, in the
    order of its state dict's indices."""
    name_of = {id(t): k for k, t in state.local_params().items()}
    return [name_of[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _map_moments(sd: Dict[str, Any], names, convert) -> Dict[str, Any]:
    """An optimizer state dict with each moment (each state tensor that is
    not a scalar) of parameter ``names[i]`` passed through ``convert(name,
    tensor)``: a new dict, the tensors of ``sd`` untouched."""
    return {"param_groups": sd["param_groups"],
            "state": {i: {key: convert(names[i], v) if torch.is_tensor(v) and v.dim() > 0 else v
                          for key, v in st.items()} for i, st in sd["state"].items()}}


def module_state_dict(module: torch.nn.Module, layout=None) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every tensor whole: under FSDP
    (``layout``) each sharded parameter gathered (a collective: every
    process calls it)."""
    sd = module.state_dict()
    return sd if layout is None else {k: layout.full(v) for k, v in sd.items()}


def ema_state_dict(state) -> Dict[str, torch.Tensor]:
    """The EMA copy by name, whole (under FSDP gathered: a collective)."""
    layout = state.layout
    if layout is None:
        return dict(state.ema_params)
    return {k: layout.full_local(k, v) for k, v in state.ema_params.items()}


def save_train_state(path: str, state, other_items: Optional[Dict[str, Any]] = None,
                     write_meta: bool = True) -> None:
    """Write ``state`` (``trainer.TrainState``) to the directory ``path``:
    ``state.pt`` and, with ``other_items``, ``train_meta.json``. Only the
    process with ``write_meta`` (rank 0) writes. In a data-parallel run
    every process holds the same state; under FSDP (``state.layout``) every
    process must call: the shards of the parameters, the EMA and the Adam
    moments are gathered, so the file holds whole tensors in the
    data-parallel format and either layout resumes from it."""
    layout = state.layout
    if not write_meta and layout is None:
        return

    def host(t):
        return t.detach().cpu() if write_meta else None

    if layout is None:
        params = {k: host(p) for k, p in state.params.items()}
        optimizer = state.optimizer.state_dict()
    else:
        params = {k: host(layout.full(p)) for k, p in state.params.items()}
        optimizer = _map_moments(state.optimizer.state_dict(), optimizer_names(state),
                                 lambda k, v: host(layout.full_local(k, v)))
    ema = {k: host(v) for k, v in ema_state_dict(state).items()}
    if not write_meta:
        return
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": int(state.step),
        "params": params,
        "ema_params": ema,
        "optimizer": optimizer,
        "other_items": _jsonable(other_items or {}),
    }
    tmp = os.path.join(path, f"state.pt.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    if other_items:
        with open(os.path.join(path, "train_meta.json"), "w") as f:
            json.dump(_jsonable(other_items), f)


@torch.no_grad()
def load_train_state(path: str, state):
    """Restore ``state`` (built over the same module and optimizer) from
    the directory ``path`` in place: parameters (``copy_``), EMA, the
    optimizer's state and the step, bit for bit. Under FSDP
    (``state.layout``) each process takes its shard of every whole tensor.
    Returns (state, the other items of ``train_meta.json``)."""
    if not os.path.exists(os.path.join(path, "state.pt")):
        raise FileNotFoundError(f"{path!r} holds no state.pt (an Orbax train state of the JAX "
                                "package is not read by the port)")
    payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    missing = set(state.params) ^ set(payload["params"])
    if missing:
        raise ValueError(f"{path}: the train state's parameters differ from the model's: "
                         f"{sorted(missing)[:8]}")
    layout = state.layout

    def shard(k, v):
        return v if layout is None else layout.shard_of(k, v)

    for k, t in state.local_params().items():
        t.copy_(shard(k, payload["params"][k]))
        state.ema_params[k].copy_(shard(k, payload["ema_params"][k]))
    optimizer = payload["optimizer"]
    if layout is not None:
        optimizer = _map_moments(optimizer, optimizer_names(state), shard)
    state.optimizer.load_state_dict(optimizer)
    state.step = int(payload["step"])
    other = dict(payload.get("other_items", {}))
    meta = os.path.join(path, "train_meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            other.update(json.load(f))
    return state, other
