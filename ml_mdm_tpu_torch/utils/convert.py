"""JAX parameter trees (as numpy arrays) -> the port's state_dict.

Repeats the mapping of ``ml_mdm_tpu/utils/torch_compat.py``
``params_to_torch_state_dict`` without importing JAX:

- ``down_blocks_0 / resnets_1 / conv1 / kernel`` becomes
  ``down_blocks.0.resnets.1.conv1.weight`` (a trailing ``_<int>`` is a list
  index; ``cond_layers_<key>_<i>`` becomes ``cond_layers.<key>.<i>``);
- conv kernels go HWIO -> OIHW, the 1-D conv of a temporal stage's frame
  resample KIO -> OIK, dense kernels (in, out) -> (out, in);
- dense layers of a 2-D attention block (``qkv``, ``proj_out``, ``ffn_1``,
  ``ffn_3`` under a path component ``attn_<i>``) were 1x1 convolutions in
  torch and get two trailing unit axes; those of the 1-D attention blocks
  (``lm_head_<i>/attn``, ``t_attn_<i>/attn``) stay ``nn.Linear``;
- norm ``scale`` becomes ``weight``.

``train_state_from_jax`` carries a whole JAX ``TrainState`` (parameters,
EMA copy, optax Adam moments and count, step) into the port's
``trainer.TrainState`` with the same mapping.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# dense layers that are 1x1 Conv2d in the torch 2-D attention block
_ATTN2D_DENSE = {"qkv", "proj_out", "ffn_1", "ffn_3"}


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _torch_name(path: Tuple[str, ...]) -> List[str]:
    comps: List[str] = []
    for p in path:
        if p.startswith("cond_layers_"):
            key, idx = p[len("cond_layers_"):].rsplit("_", 1)
            comps.extend(["cond_layers", key, idx])
            continue
        head, _, tail = p.rpartition("_")
        if tail.isdigit() and head:
            comps.extend([head, tail])
        else:
            comps.append(p)
    return comps


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (a JAX params tree after
    ``jax.device_get``) -> {torch name: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        leaf = path[-1]
        in_2d_attn = any(re.fullmatch(r"attn_\d+", p) for p in path)
        v = np.asarray(value)
        if leaf == "kernel":
            name = "weight"
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 3:
                v = v.transpose(2, 1, 0)
            else:
                v = v.transpose(1, 0)
                if in_2d_attn and path[-2] in _ATTN2D_DENSE:
                    v = v[:, :, None, None]
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        key = ".".join(_torch_name(path[:-1]) + [name])
        if v.dtype.name == "bfloat16":  # numpy has no bf16 of its own
            out[key] = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(np.array(v, order="C"))
    return out


def train_state_from_jax(state, module: torch.nn.Module):
    """A JAX ``trainer.TrainState`` after ``jax.device_get`` (numpy leaves)
    -> the port's ``trainer.TrainState`` over ``module``: the parameters
    are loaded into the module strictly, and the EMA copy and optax Adam's
    ``mu``, ``nu`` and ``count`` (the ``opt_state`` entry that has moments)
    map by the same names onto the EMA and the ``torch.optim.Adam`` state
    (``exp_avg``, ``exp_avg_sq``, ``step``) of each parameter."""
    from ml_mdm_tpu_torch.trainer import TrainState

    module.load_state_dict(params_from_jax(state.params), strict=True)
    new = TrainState.create(module)
    opt = state.opt_state
    adam = next(s for s in (opt if isinstance(opt, (tuple, list)) else (opt,))
                if hasattr(s, "mu") and hasattr(s, "nu"))
    ema, mu, nu = (params_from_jax(t) for t in (state.ema_params, adam.mu, adam.nu))
    names = list(new.params)
    for k, p in new.params.items():
        new.ema_params[k] = ema[k].to(p.device, p.dtype)
    sd = new.optimizer.state_dict()
    # load_state_dict moves the moments to each parameter's device and dtype
    sd["state"] = {i: {"step": torch.tensor(float(adam.count)), "exp_avg": mu[k],
                       "exp_avg_sq": nu[k]} for i, k in enumerate(names)}
    new.optimizer.load_state_dict(sd)
    new.step = int(state.step)
    return new
