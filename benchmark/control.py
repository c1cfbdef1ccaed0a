"""The control of a cell's correctness check, at the cell's own size: the
reference put in the program's place, computed in the precision below the
configuration's (fp8 products for bf16), and for a training cell the
planted fault of a step that leaves half its batch out, each compared with
the float32 reference as a run compares the program. The readings set the
upper end of each limit (``PERF.md``); the benchmark's runs never run
this.

    python3 benchmark/control.py --workload <name> --seeds <n> <n> <n> [--requests <n>]
        [--program-seeds <n> ...]

``--requests``: the window's requests a sampling run would have finished,
from which the compared samples are drawn. ``--program-seeds``: first the
program's own readings of every number on these seeds, each a run of the
cell with a window of one step or request, in this one process (which
pays the imports and the builds once). One JSON line per seed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    import torch

    import common
    import run

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = common.manifest()
    workload = common.find_cell(man, args.workload)
    for seed in args.program_seeds:
        ns = argparse.Namespace(seed=seed, seconds=0, trace=0)
        ctx = run.context(ns, man, workload, torch.device("cuda", 0))
        t0 = time.perf_counter()
        res = importlib.import_module(f"drivers.{ctx.traffic['kind']}").run(ctx)
        nums = res.get("numbers", {k: v for k, (v, _) in res["compared"].items()})
        print(json.dumps({"workload": args.workload, "seed": seed, "program": nums,
                          "correct": res["correct"], "seconds": time.perf_counter() - t0}),
              flush=True)
        common.free()
    for seed in args.seeds:
        ns = argparse.Namespace(seed=seed, seconds=0, trace=0)
        ctx = run.context(ns, man, workload, torch.device("cuda", 0))
        t0 = time.perf_counter()
        out = {"workload": args.workload, "seed": seed}
        if ctx.traffic["kind"] == "sample":
            from drivers import sample

            chosen = sample.picks(ctx, args.requests)
            want = sample.reference_images(ctx, chosen)
            got = sample.reference_images(ctx, chosen, quant="fp8")
            out["fp8"] = {"image_rel_err": max(sample.relative_errors(got, want))}
        else:
            from drivers import train

            ref = train.reference_run(ctx)
            common.free()
            out["fp8"] = train.compare(train.reference_run(ctx, quant="fp8"), ref, train.clip_norm(ctx))
            common.free()
            out["half_batch"] = train.compare(train.reference_run(ctx, drop_half=True), ref,
                                              train.clip_norm(ctx))
        out["seconds"] = time.perf_counter() - t0
        common.free()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
