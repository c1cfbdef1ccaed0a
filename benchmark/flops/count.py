"""The work of a cell, counted on the plain reference at the cell's exact
shapes on the ``meta`` device (shapes only, no arithmetic): the model's
FLOPs of a sampling forward or of a training step's forward and backward
(``torch.utils.flop_counter.FlopCounterMode``: whatever implements the
work, the count is the same, so packing does not inflate it and remat's
recompute is not in it), and every convolution's least time on the chip.

A convolution's least time is the larger of its FLOPs over the peak rate
and its bytes over the peak bandwidth, its bytes each input, weight and
output read or written once in the compute dtype (``peaks.json``: the
published peaks of each card by ``torch.cuda.get_device_name()``). Its data
and weight gradients are counted alike: the data gradient reads dy and the
weight and writes dx, the weight gradient reads x and dy and writes dw,
each as many FLOPs as the forward; the first layer's data gradient is not
needed and is not counted.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's published peaks, or None for a card the table lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


class _Convs(TorchDispatchMode):
    """Records each forward convolution's shapes: (x, w, y) sizes, stride
    and whether its input needs a gradient."""

    def __init__(self):
        super().__init__()
        self.convs: List[Dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w = args[0], args[1]
            self.convs.append({"x": x.numel(), "w": w.numel(), "y": out.numel(),
                               "flops": 2 * out.numel() * w[0].numel(),
                               "dx": bool(x.requires_grad)})
        return out


def count(fn) -> Dict:
    """Run ``fn()`` (on meta tensors) under the FLOP counter and the
    convolution recorder: {"flops": total, "convs": [...]}."""
    rec = _Convs()
    with FlopCounterMode(display=False) as fc, rec:
        fn()
    return {"flops": int(fc.get_total_flops()), "convs": rec.convs}


def conv_least_seconds(convs: List[Dict], peak: Dict[str, float], elem_bytes: int = 2,
                       backward: bool = False) -> float:
    """Sum of the convolutions' least times (of their data and weight
    gradients with ``backward``)."""
    fl, bw = peak["flops_per_s"], peak["bytes_per_s"]
    total = 0.0
    for c in convs:
        if not backward:
            total += max(c["flops"] / fl, (c["x"] + c["w"] + c["y"]) * elem_bytes / bw)
            continue
        total += max(c["flops"] / fl, (c["y"] + c["w"] + c["x"]) * elem_bytes / bw)  # dw
        if c["dx"]:
            total += max(c["flops"] / fl, (c["y"] + c["w"] + c["x"]) * elem_bytes / bw)
    return total
