"""JAX parameter trees (as numpy arrays) -> the port's state_dict.

Repeats the mapping of ``ml_mdm_tpu/utils/torch_compat.py``
``params_to_torch_state_dict`` without importing JAX:

- ``down_blocks_0 / resnets_1 / conv1 / kernel`` becomes
  ``down_blocks.0.resnets.1.conv1.weight`` (a trailing ``_<int>`` is a list
  index; ``cond_layers_<key>_<i>`` becomes ``cond_layers.<key>.<i>``);
- conv kernels go HWIO -> OIHW, dense kernels (in, out) -> (out, in);
- dense layers of a 2-D attention block (``qkv``, ``proj_out``, ``ffn_1``,
  ``ffn_3``) were 1x1 convolutions in torch and get two trailing unit axes;
- norm ``scale`` becomes ``weight``.
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
