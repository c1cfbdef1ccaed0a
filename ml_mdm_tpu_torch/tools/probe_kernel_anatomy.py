"""The fused conv's cost decomposition on the card, probe P1: K2's own
kernel with parts of it switched off (``ops/kernel_anatomy.py``) at K2's
probe shape, varying (a) the number of accumulated tap products, (b) the
activation (affine, SiLU) and (c) staging the tile through registers, to
split K2's time at 512^2 x 128 channels between its products, its
register pass, its activation and the rest of its tile.
The counterpart of the JAX package's ``tools/probe_kernel_anatomy.py``,
with the same ``make`` and the same table.

Usage (needs a CUDA device): python -m ml_mdm_tpu_torch.tools.probe_kernel_anatomy
"""
from __future__ import annotations

import torch

from ml_mdm_tpu_torch.ops import kernel_anatomy

B, H, W, C = 4, 512, 512, 128
PEAK_BF16_TENSOR = 989e12  # FLOP/s, NVIDIA H100 SXM data sheet, dense
SEED = 0


def make(n_taps: int, do_act: bool, silu: bool, via_scratch: bool):
    """Returns f(x, w): x (B, H, W, C) bf16, w (max(n_taps, 1), C, C) bf16."""
    v = kernel_anatomy.p1_variant(n_taps, do_act, silu, via_scratch)
    return lambda x, w: kernel_anatomy.anatomy(x, w, v)


def inputs(n_taps: int, shape=None, dev="cuda"):
    """x (``shape``, by default this module's (B, H, W, C)) and w, scaled as
    the JAX probe scales them, from a seeded generator."""
    shape = shape or (B, H, W, C)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    c = shape[-1]
    w = (torch.randn((max(n_taps, 1), c, c), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    return x, w


def time_ms(f, x, w, n: int) -> float:
    """Mean milliseconds of one call over n back-to-back calls (CUDA events),
    after one untimed call."""
    f(x, w)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        f(x, w)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bench(label, n_taps, do_act=False, silu=False, via_scratch=False, n=30) -> float:
    f = make(n_taps, do_act, silu, via_scratch)
    x, w = inputs(n_taps)
    dt = time_ms(f, x, w, n)
    mxu = 2 * B * H * W * C * C * n_taps / PEAK_BF16_TENSOR * 1e3
    print(f"{label:34s} taps={n_taps} act={do_act} silu={silu} "
          f"scr={via_scratch}: {dt:.4f} ms (tensor-core bound {mxu:.4f})", flush=True)
    return dt


def main(n: int = 30) -> list:
    """The JAX probe's table on the card; returns the rows' times."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernel_anatomy: needs a CUDA device (the kernel runs only on the card)")
    print(f"{torch.cuda.get_device_name(0)}: B={B} {H}x{W} C={C} bf16, K2's instance "
          f"<{kernel_anatomy.BN}, {kernel_anatomy.MT}>, "
          f"{kernel_anatomy.probe_plan(B, H, W, C)}", flush=True)
    return [bench(label, **kw, n=n) for label, kw in kernel_anatomy.P1_ROWS]


if __name__ == "__main__":
    main()
