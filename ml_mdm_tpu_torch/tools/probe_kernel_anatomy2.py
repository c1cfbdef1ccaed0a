"""The fused conv's cost decomposition on the card, probe P2: which of
K2's features lifts the 512^2 x 128 call off the memory floor? Adds them
one at a time to the 4-product struct-like probe, K2's own kernel at 4 taps
(``ops/kernel_anatomy.py``): halo rows across its 16-row bands,
K2·struct's lane-parity selects, the zero fill and the staging of the next
chunk under the products. The counterpart of the JAX package's
``tools/probe_kernel_anatomy2.py``, with the same ``make`` (x taken once,
where the JAX probe takes it three times with halos) and the same table.

Usage (needs a CUDA device): python -m ml_mdm_tpu_torch.tools.probe_kernel_anatomy2
"""
from __future__ import annotations

import torch

from ml_mdm_tpu_torch.ops import kernel_anatomy
from ml_mdm_tpu_torch.tools import probe_kernel_anatomy as p1

B, H, W, C = p1.B, p1.H, p1.W, p1.C


def make(halos: bool, selects: bool, when_zero: bool, dbuf: bool, n_taps: int = 4):
    """Returns f(x, w): x (B, H, W, C) bf16, w (n_taps, C, C) bf16."""
    v = kernel_anatomy.p2_variant(halos, selects, when_zero, dbuf, n_taps)
    return lambda x, w: kernel_anatomy.anatomy(x, w, v)


def bench(label, n=30, **kw) -> float:
    f = make(**kw)
    x, w = p1.inputs(kw.get("n_taps", 4), (B, H, W, C))
    dt = p1.time_ms(f, x, w, n)
    print(f"{label:44s}: {dt:.4f} ms", flush=True)
    return dt


def main(n: int = 30) -> list:
    """The JAX probe's table on the card; returns the rows' times."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernel_anatomy2: needs a CUDA device (the kernel runs only on the card)")
    print(f"{torch.cuda.get_device_name(0)}: B={B} {H}x{W} C={C} bf16, K2's instance "
          f"<{kernel_anatomy.BN}, {kernel_anatomy.MT}>, "
          f"{kernel_anatomy.probe_plan(B, H, W, C)}", flush=True)
    return [bench(label, n=n, **kw) for label, kw in kernel_anatomy.P2_ROWS]


if __name__ == "__main__":
    main()
