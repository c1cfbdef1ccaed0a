"""What every cell of the benchmark shares: the manifest and the files it
names, the seeds, the weights and the traffic made from a seed, and the
check of the modules a run loaded. Nothing here imports the program.

Files are found by name:

- ``configs/<config>.json``: a model configuration (the YAML as run);
- ``traffic/<traffic>.json``: a traffic mix (the kind of window loop and its
  parameters), read by the one generator below;
- ``cells/<cell>.json``: a cell's correctness comparison (the rows it
  checks and the limit of each number);
- ``drivers/<kind>.py``: the window loop of a kind of traffic;
- ``metrics/<family>.py``: the reader of a per-layer metric family, the
  part of a metric's name before its first dot.
"""
from __future__ import annotations

import gc
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_mdm_tpu")

# leaves the model's own initialiser sets to zero (output projections, the
# nested adapters, biases, the micro-conditioning's second layer): here
# 0.02 times a normal, since a U-Net with them at zero outputs exactly 0
_ZERO_INIT = ("conv2", "conv_out", "proj_out", "ffn.3", "main.3", "in_adapter", "out_adapter")
_COND_SECOND = re.compile(r"(^|\.)cond_layers\.[^.]+\.1$")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(man: Dict, workload: Dict) -> Tuple[Dict, Dict, Dict]:
    """(configuration, traffic, cell) files of a workload."""
    conf = next(c for c in man["configs"] if c["name"] == workload["config"])
    return (load_json(ROOT / conf["file"]),
            load_json(BENCH / "traffic" / f"{workload['traffic']}.json"),
            load_json(BENCH / "cells" / f"{workload['name']}.json"))


def per_layer_metrics(man: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics that name ``cell`` in their ``workloads``."""
    return [m for m in man["per_layer"] if cell in m["workloads"]]


def end_to_end_metrics(man: Dict, cell: str) -> List[Dict]:
    return [m for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def mix(*parts: int) -> int:
    """A 63-bit seed from whole numbers (a seed, an index, a salt)."""
    h = 0x243F6A8885A308D3
    for p in parts:
        h = (h ^ (int(p) & (2**64 - 1))) * 0x100000001B3 % 2**64
        h ^= h >> 29
    return h % 2**63


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(*parts))


# -- weights -------------------------------------------------------------------

def init_scale(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(scale, offset) of a leaf's normals: 1/sqrt(fan in) for a weight of
    rank 2 and up, 0.02 for a bias and a zero-init leaf, and 0 then 1 for
    a norm's scale (the model's initialiser's kinds and scales)."""
    owner, leaf = name.rsplit(".", 1)
    if leaf == "bias" or owner.endswith(_ZERO_INIT) or _COND_SECOND.search(owner):
        return 0.02, 0.0
    if len(shape) >= 2:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return fan_in ** -0.5, 0.0
    return 0.0, 1.0


def make_weights(named_shapes: Sequence[Tuple[str, Sequence[int]]], seed: int, device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A state dict from ``seed``: one draw of normals for every leaf on
    ``device`` in ``dtype``, laid out by the leaves' names in sorted order,
    scaled per leaf in one pass, and the leaves as views of it."""
    named_shapes = sorted(named_shapes)
    counts, scales, offsets = [], [], []
    for name, shape in named_shapes:
        n = 1
        for s in shape:
            n *= s
        s, o = init_scale(name, shape)
        counts.append(n)
        scales.append(s)
        offsets.append(o)
    total = sum(counts)
    flat = torch.randn(total, generator=generator(device, seed, 1), device=device, dtype=dtype)
    reps = torch.tensor(counts, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(scales, device=device, dtype=dtype), reps,
                                      output_size=total))
    flat.add_(torch.repeat_interleave(torch.tensor(offsets, device=device, dtype=dtype), reps,
                                      output_size=total))
    out, at = {}, 0
    for (name, shape), n in zip(named_shapes, counts):
        out[name] = flat[at:at + n].view(tuple(shape))
        at += n
    return out


# -- traffic -----------------------------------------------------------------

def text_rows(gen: torch.Generator, device, rows: int, tokens: int, width: int,
              lengths: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text features (rows, tokens, width) in float32 holding bf16 values,
    and a mask of the first ``n`` tokens, n uniform in ``lengths``."""
    text = torch.randn((rows, tokens, width), generator=gen, device=device,
                       dtype=torch.bfloat16).float()
    n = torch.randint(lengths[0], lengths[1] + 1, (rows,), generator=gen, device=device)
    mask = (torch.arange(tokens, device=device)[None, :] < n[:, None]).to(torch.int32)
    return text, mask


def sides(config: Dict, side: int) -> List[int]:
    """The image side of every resolution, highest first."""
    out, u = [side], config["yaml"]["unet_config"]
    while "inner_config" in u:
        side //= 2 ** (len(u["resolution_channels"]) - 1)
        out.append(side)
        u = u["inner_config"]
    return out


def request_inputs(seed: int, index: int, traffic: Dict, config: Dict, device) -> Dict:
    """Request ``index`` of a sampling mix: the initial noise of every
    resolution (float32), and the text of its rows, [uncond; cond] with
    guidance: the same seed and index give the same request."""
    gen = generator(device, seed, index, 2)
    b = traffic["batch"]
    noise = [torch.randn((b, s, s, 3), generator=gen, device=device)
             for s in sides(config, config["image_side"])]
    w, t = config["text_width"], traffic["text_tokens"]
    cond, cmask = text_rows(gen, device, b, t, w, tuple(traffic["cond_tokens"]))
    if traffic["guidance_scale"] != 1.0:
        unc, umask = text_rows(gen, device, b, t, w, tuple(traffic["uncond_tokens"]))
        cond, cmask = torch.cat([unc, cond]), torch.cat([umask, cmask])
    return {"noise": noise, "text": cond, "mask": cmask}


def train_inputs(seed: int, index: int, traffic: Dict, config: Dict, device) -> Dict:
    """Step ``index`` of a training mix: images in [-1, 1], text, the
    timesteps and the noise of every resolution, all bf16 values held in
    float32, so that the program and the reference get the same numbers."""
    gen = generator(device, seed, index, 3)
    b, side = traffic["batch"], config["image_side"]
    images = (torch.rand((b, side, side, 3), generator=gen, device=device) * 2 - 1
              ).to(torch.bfloat16).float()
    text, mask = text_rows(gen, device, b, traffic["text_tokens"], config["text_width"],
                           tuple(traffic["cond_tokens"]))
    n_steps = config["yaml"]["diffusion_config"]["sampler_config"]["num_diffusion_steps"]
    time = torch.randint(0, n_steps, (b,), generator=gen, device=device)
    eps = [torch.randn((b, s, s, 3), generator=gen, device=device,
                       dtype=torch.bfloat16).float() for s in sides(config, side)]
    return {"images": images, "text": text, "mask": mask, "time": time, "eps": eps}


# -- the run's result ------------------------------------------------------------

def sync(device) -> None:
    """Wait for the device (a no-op on the CPU, where the tests run)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The device's peak of allocated memory so far (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free() -> None:
    """Return what the program held to the device's allocator."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"


def loaded_forbidden() -> List[str]:
    """Modules of the JAX package or of JAX that this process holds,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
