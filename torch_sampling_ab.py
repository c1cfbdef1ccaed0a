"""Sampling request rates of two or more checkouts of the PyTorch port
(``ml_mdm_tpu_torch``) on one GPU, in alternating fresh processes:

    python3 torch_sampling_ab.py ROOT_A ROOT_B [--order ABBA] [--out FILE]

Each letter of ``--order`` runs one process with that checkout first on
``sys.path`` (A is the first root). A process builds cc12m_256x256 and
cc12m_1024x1024 (seed 0, bf16, the port's presets), warms each with a DDIM-4
request, then times the requests as ``chip_smoke.py`` does (host clock
around a synchronised ``sample``): 256px batch 4, guidance 7.5, DDIM-50 (two
requests); 1024px batch 4, eta 1, DDIM-50 (two requests). For each model it
also times one forward at the request's rows by CUDA events and the host's
time to enqueue it (median of 3). Each process prints one JSON line; the
script prints the card's name and power limit first, then the lines, and
writes them to ``--out`` too. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LM_LEN = 32


def one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import ml_mdm_tpu_torch
    from ml_mdm_tpu_torch import presets

    if not os.path.abspath(ml_mdm_tpu_torch.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ml_mdm_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    out = {"root": root}
    runs = (("256px", presets.cc12m_256x256, dict(guidance_scale=7.5, ddim_eta=0.0), 2),
            ("1024px", presets.cc12m_1024x1024, dict(ddim_eta=1.0), 1))
    for name, build, kw, cfg_rows in runs:
        batch = 4
        pipe, lm_dim, side = build(dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(6)
        rows = cfg_rows * batch
        cond = {"lm_outputs": torch.randn((rows, LM_LEN, lm_dim), generator=gen,
                                          device=dev).to(torch.bfloat16),
                "lm_mask": torch.ones((rows, LM_LEN), device=dev, dtype=torch.bfloat16)}
        pipe.sample(batch, cond, side, gen, num_inference_steps=4, resample_steps=True, **kw)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = pipe.sample(batch, cond, side, gen, num_inference_steps=50,
                              resample_steps=True, **kw)
            torch.cuda.synchronize()
            rates.append(batch / (time.perf_counter() - t0))
            if not bool(torch.isfinite(img).all()) or tuple(img.shape) != (batch, side, side, 3):
                raise AssertionError(f"{name}: bad output {tuple(img.shape)}")
        x = pipe.get_noise(rows, side, gen)
        t = torch.full((rows,), 500, device=dev)
        lm = torch.randn((rows, LM_LEN, lm_dim), generator=gen, device=dev).to(torch.bfloat16)
        mask = torch.ones((rows, LM_LEN), device=dev, dtype=torch.bfloat16)
        ev_ms, enq_ms = [], []
        with torch.no_grad():
            pipe.model(x, t, lm, mask, {})
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                pipe.model(x, t, lm, mask, {})
                end.record()
                enq_ms.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
                ev_ms.append(start.elapsed_time(end))
        out[name] = {"samples_per_s": rates, "forward_ms": statistics.median(ev_ms),
                     "enqueue_ms": statistics.median(enq_ms), "rows": rows}
        del pipe
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.roots[0])))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sampling_ab: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lines = []
    for letter in args.order:
        root = os.path.abspath(args.roots[ord(letter) - ord("A")])
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise SystemExit(f"torch_sampling_ab: the run of {root} failed")
        lines.append(res.stdout.strip().splitlines()[-1])
        print(f"{letter} {lines[-1]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
