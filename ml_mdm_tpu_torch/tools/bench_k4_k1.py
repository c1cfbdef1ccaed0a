"""Time kernels K4 and K1 alone on the card, at the shapes the model gives them.

    python -m ml_mdm_tpu_torch.tools.bench_k4_k1

K4 (``ops/attention.py`` ``flash_attention``) at the flash route's four
launch shapes (the 64px model at batch 64, the 256px request's 8 rows), on
the chunks of one qkv tensor as the model hands them over, beside
``scaled_dot_product_attention`` on the same views; K1
(``ops/gn_stats.py`` ``spatial_sums``) at the 28 launch shapes of the nested
forwards and the thin shells of the 1024px model and the 64px core, beside
its plain version, with its split plan and whether two calls give the same
bits. Each time is the median of 10 runs from CUDA events, the 50 MB L2
overwritten and the device kept busy ~0.5 ms before each, so that the
events time the device's work; beside it, the host's time a call (500
calls back to back, host clock). The bound is the larger of the bytes at
3.35 TB/s and the tensor-core FLOPs at 989 TFLOP/s (NVIDIA H100 SXM).
Without a card it exits 1. It runs against whichever ``ml_mdm_tpu_torch``
is first on the path, so ``PYTHONPATH=<another checkout> python
ml_mdm_tpu_torch/tools/bench_k4_k1.py`` times that checkout's kernels.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

K4_SHAPES = [(64, 1024, 8, 64), (64, 256, 8, 96), (8, 1024, 8, 64), (8, 256, 8, 96)]
K1_NESTED = [(b, s, s, c) for b, sc in (
    (4, ((16, 512), (16, 768), (32, 256), (32, 512), (32, 768), (64, 128), (64, 256), (64, 512),
         (128, 64), (128, 128), (128, 256), (128, 512), (256, 64), (256, 128), (256, 256),
         (512, 128))),
    (8, ((16, 512), (16, 768), (32, 256), (32, 512), (32, 768), (64, 128), (64, 256), (64, 512),
         (128, 64), (128, 128), (128, 256), (128, 512)))) for s, c in sc]
K1_MORE = [(4, 1024, 1024, 32), (2, 1024, 1024, 32), (2, 512, 512, 128), (64, 64, 64, 256),
           (64, 8, 8, 1536)]


def main() -> int:
    import torch
    import torch.nn.functional as F

    from ml_mdm_tpu_torch.ops import attention, gn_stats

    if not torch.cuda.is_available():
        print("bench_k4_k1: no CUDA device; the kernels run only on a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")

    def ms(fn, reps=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def host_us(fn, calls=500):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / calls

    g = torch.Generator(device="cuda").manual_seed(0)
    k4_ms = lib_ms = 0.0
    for b, l, h, d in K4_SHAPES:
        qkv = torch.randn((b, l, 3 * h * d), generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = (t.reshape(b, l, h, d) for t in qkv.chunk(3, dim=-1))
        ref = attention.reference_flash_attention(q, k, v).float()
        out = attention.flash_attention(q, k, v).float()
        err = float((out - ref).abs().max() / ref.abs().max())
        t = ms(lambda: attention.flash_attention(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=d ** -0.5))
        k4_ms, lib_ms = k4_ms + t, lib_ms + lib
        flops = 4 * b * h * l * l * d
        bound = 1e3 * max(flops / 989e12, 2 * b * h * d * 4 * l / 3.35e12)
        host = host_us(lambda: attention.flash_attention(q, k, v), 100)
        print(f"K4 {(b, l, h, d)}: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, rel err {err:.2e}); "
              f"library {lib:.4f} ms; bound {bound:.4f} ms; host {host:.1f} us a call", flush=True)
    print(f"K4 over {len(K4_SHAPES)} shapes: {k4_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"({k4_ms / lib_ms:.3f}x)", flush=True)

    k1_ms = plain_ms = 0.0
    for key in K1_NESTED + K1_MORE:
        x = (torch.randn(key, generator=g, device="cuda") + 0.25).to(torch.bfloat16)
        got, again, ref = gn_stats.spatial_sums(x), gn_stats.spatial_sums(x), \
            gn_stats.spatial_sums_plain(x)
        err = max(float((a - r).abs().max() / r.abs().max()) for a, r in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        t = ms(lambda: gn_stats.spatial_sums(x))
        plain = ms(lambda: gn_stats.spatial_sums_plain(x), reps=5)
        if key in K1_NESTED:
            k1_ms, plain_ms = k1_ms + t, plain_ms + plain
        nbytes = x.numel() * 2
        bound = 1e3 * (nbytes + 8 * key[0] * key[3]) / 3.35e12
        plan = gn_stats.plan(*key) if hasattr(gn_stats, "plan") else ""
        host = host_us(lambda: gn_stats.spatial_sums(x)) if x.numel() <= 2**24 else float("nan")
        print(f"K1 {key} {plan}: rel err {err:.2e}, two calls bitwise equal {same}, {t:.4f} ms "
              f"({nbytes / t / 1e6:.0f} GB/s, {bound / t:.3f} of the bound); plain {plain:.4f} ms; "
              f"host {host:.1f} us a call", flush=True)
    print(f"K1 over the nested forwards' {len(K1_NESTED)} shapes: {k1_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
