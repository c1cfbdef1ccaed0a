"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``ml_mdm_tpu_torch``) and
a CUDA device. Set-up (imports, weights from the seed, the pipeline, a
warm-up at the cell's shapes) is timed from the start of this script; then
the window of ``--seconds``; with ``--trace 1`` a traced part after it,
from which the cell's per-layer metrics are read; then the check of what
the window produced against the plain reference, whose numbers and limits
are the last lines of standard error and the last key of the result.

Exit codes: 0 with a result; 2 without a CUDA device (or with fewer than
the cell asks for); 3 when a module of JAX or of the JAX package is loaded
after the window; 1 on any other failure. Nothing is printed to standard
output but the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_caches() -> None:
    """Triton's kernel cache in a fixed directory of the checkout (the port
    builds its CUDA libraries into ``ml_mdm_tpu_torch/_build/``)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TRITON_HOME"] = str(CACHE / "triton_home")


def context(args, man, workload, device) -> SimpleNamespace:
    import common

    config, traffic, cell = common.cell_files(man, workload)
    os.environ.update(config["gates"])  # the port's gates as the configuration states them
    side = config["image_side"]
    sides = common.sides(config, side)
    weights = config["yaml"].get("multi_res_weights")
    return SimpleNamespace(
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
        workload=workload, config=config, traffic=traffic, cell=cell, t_start=T_START,
        log=log, nested=len(sides) > 1, scales=[s // sides[-1] for s in sides],
        loss_weights=([float(v) for v in str(weights).split(":")] if weights
                      else [1.0] * len(sides)))


def per_layer(man, name: str, layer: dict) -> dict:
    """Each per-layer metric of the cell, read by its family's reader; a
    reader that finds nothing to read returns None and the metric is left
    out."""
    import common

    out = {}
    for m in common.per_layer_metrics(man, name):
        reader = importlib.import_module(f"metrics.{m['name'].split('.')[0]}")
        value = reader.read(m["name"], layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            log(f"per-layer metric {m['name']}: nothing to read")
    return out


def breakdown(trace, host_trace) -> dict:
    """The device operations with most time in the marked window, and the
    idle gaps by what the host was doing, from the part traced with the
    host (where the profiler slows the host)."""
    return {"device_ops": [[n[:120], us / 1e6] for n, us in trace.top_ops(10)],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in host_trace.idle_gaps(10)]}


def main(argv=None) -> int:
    args = parse(argv)
    set_caches()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    import torch

    import common

    man = common.manifest()
    workload = common.find_cell(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        log(f"{args.workload} needs {workload['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    ctx = context(args, man, workload, device)
    driver = importlib.import_module(f"drivers.{ctx.traffic['kind']}")
    result = driver.run(ctx)

    found = common.loaded_forbidden()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    metrics = {k: {"value": v, "unit": next(m["unit"] for m in man["end_to_end"]
                                            if m["name"] == k)}
               for k, v in result["e2e"].items()}
    metrics["setup_s"] = {"value": result["setup_s"], "unit": "s"}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": bool(result["correct"]), "attempted": result["attempted"],
            "failed": result["failed"]}
    if args.trace:
        trace = result["trace"]
        busy, window = trace.busy_and_window()
        device_info.update(busy_s=busy / 1e6, window_s=window / 1e6)
        host = result["host_trace"]
        log(f"trace: {trace.marks} marks; {len(trace.kernels)} device operations in the "
            f"{'marked ' if trace.end else 'unmarked '}window "
            f"({busy / 1e6:.4f} s busy of {window / 1e6:.4f} s); with the host: "
            f"{len(host.host)} host events, {len(host.annotations)} range spans on the device")
        layer = dict(result["layer"], trace=trace, host_trace=host, device=device_info)
        line["metrics"] = per_layer(man, args.workload, layer)
        line["breakdown"] = breakdown(trace, host)
    else:
        line["metrics"] = metrics
    line["device"] = device_info
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result["compared"].items()}
    for k, (v, lim) in result["compared"].items():
        log(f"compared {k}: {v!r} limit {lim!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
