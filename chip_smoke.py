#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (ml_mdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand kernels from the sources in this checkout, holds each one
against its plain PyTorch version at the flagship cc12m_64x64 shapes (and
times both with CUDA events), then drives the port's main path: text-
conditioned DDIM sampling of the full-width cc12m_64x64 U-Net with random
weights from a seed, through ``Diffusion.sample``:

  - batch 4, 4 DDIM steps, kernel path against plain path (same weights
    and noise);
  - two requests of batch 64, DDIM-50, eta 0 (the bench preset), counting
    the kernels' launches;
  - one request of batch 8 with classifier-free guidance 5.

Every phase that fails raises, and the script exits non-zero. It needs a
CUDA device and never falls back to the CPU. The last line of its output is
one JSON object with "ok" and the device; the line before it names every
kernel with its launches, error and times.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
SIDE = 64
LM_LEN = 32

# tolerances (bf16 working type), each relative to max|plain|:
K1_TOL = 1e-5    # f32 sums in another order
K2_TOL = 2e-2    # two bf16 ULPs: fast exp in SiLU and sum order can flip a rounding
UNET_TOL = 5e-2  # those flips carried through the full U-Net (one forward)
SAMPLE_MEAN_TOL = 1e-2  # 4-step sample, mean |kernel - plain| over pixels in [-1, 1]
SAMPLE_MAX_TOL = 0.25   # 4-step sample, max |kernel - plain|


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def abs_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def cuda_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median milliseconds of fn() over reps, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flagship_shapes(unet, side: int):
    """Distinct (C, Cout, side, residual) of the ResNet convs and (C, side)
    of the 4-D GroupNorms that the flagship U-Net runs."""
    convs, norms = set(), set()
    n = len(unet.down_blocks)

    def stage(block, s):
        for r in block.resnets:
            cin, cout = r.config.num_channels, r.config.output_channels
            convs.add((cin, cout, s, False))
            convs.add((cout, cout, s, True))
            norms.add((cin, s))
        for a in getattr(block, "attn", []):
            c = a.qkv.in_channels
            norms.add((c, s))

    for i, blk in enumerate(unet.down_blocks):
        stage(blk, side >> i)
    for blk in unet.mid_blocks:
        stage(blk, side >> (n - 1))
    for i, blk in enumerate(unet.up_blocks):
        stage(blk, side >> (n - 1 - i))
    norms.add((unet.norm_out.weight.shape[0], side))
    return sorted(convs), sorted(norms)


def check_kernels(unet, dev, batch: int):
    """Each kernel against its plain version at the flagship shapes."""
    import torch
    import torch.nn.functional as F

    from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats

    convs, norms = flagship_shapes(unet, SIDE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf = torch.bfloat16
    k1 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for c, s in norms:
        x = (torch.randn((batch, s, s, c), generator=g, device=dev) + 0.25).to(bf)
        s1, s2 = gn_stats.spatial_sums(x)
        p1, p2 = gn_stats.spatial_sums_plain(x)
        err = max(rel_err(s1, p1), rel_err(s2, p2))
        if not err <= K1_TOL:
            raise AssertionError(f"K1 spatial_sums C={c} side={s}: rel err {err} > {K1_TOL}")
        ms = cuda_ms(lambda: gn_stats.spatial_sums(x))
        pms = cuda_ms(lambda: gn_stats.spatial_sums_plain(x))
        gbs = x.numel() * 2 / ms / 1e6
        log(f"K1 spatial_sums B={batch} {s}x{s} C={c}: rel_err {err:.3e} "
            f"abs_err {max(abs_err(s1, p1), abs_err(s2, p2)):.3e} kernel {ms:.4f} ms "
            f"({gbs:.0f} GB/s) plain {pms:.4f} ms")
        k1["err"] = max(k1["err"], max(abs_err(s1, p1), abs_err(s2, p2)))
        k1["ms"] += ms
        k1["plain_ms"] += pms

    k2 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for c, cout, s, residual in convs:
        x = torch.randn((batch, s, s, c), generator=g, device=dev).to(bf)
        a = torch.randn((batch, c), generator=g, device=dev) * 0.2 + 1.0
        b = torch.randn((batch, c), generator=g, device=dev) * 0.3
        w = (torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5).to(bf)
        bias = torch.randn((cout,), generator=g, device=dev) * 0.1
        res = (torch.randn((batch, s, s, cout), generator=g, device=dev).to(bf)
               if residual else None)
        stats = not residual  # conv1 emits stats, conv2 adds the residual
        out = fused_resnet.affine_silu_conv3x3(x, a, b, w, bias, res, emit_stats=stats)
        ref = fused_resnet.affine_silu_conv3x3_plain(x, a, b, w, bias, res, emit_stats=stats)
        out, ref = (out, ref) if stats else ((out,), (ref,))
        errs = [rel_err(o, r) for o, r in zip(out, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(
                f"K2 affine_silu_conv3x3 {c}->{cout} side={s}: rel errs {errs} > {K2_TOL}")
        ms = cuda_ms(lambda: fused_resnet.affine_silu_conv3x3(
            x, a, b, w, bias, res, emit_stats=stats))
        pms = cuda_ms(lambda: fused_resnet.affine_silu_conv3x3_plain(
            x, a, b, w, bias, res, emit_stats=stats), reps=3)
        # for reference only: cuDNN's bf16 conv with the same elementwise ops
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def cudnn():
            v = F.silu(xc.float() * a[:, :, None, None] + b[:, :, None, None]).to(bf)
            y = F.conv2d(v, wc, bias.to(bf), padding=1)
            return y if res is None else y + res.permute(0, 3, 1, 2)

        cms = cuda_ms(cudnn)
        tflops = 2 * batch * s * s * 9 * c * cout / ms / 1e9
        log(f"K2 affine_silu_conv3x3 B={batch} {s}x{s} {c}->{cout} "
            f"{'residual' if residual else 'stats'}: rel_errs "
            f"{', '.join(f'{e:.3e}' for e in errs)} kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) "
            f"plain(f32 conv) {pms:.4f} ms cudnn-bf16 {cms:.4f} ms")
        k2["err"] = max(k2["err"], max(abs_err(o, r) for o, r in zip(out, ref)))
        k2["ms"] += ms
        k2["plain_ms"] += pms
    log(f"summed over {len(norms)} K1 shapes: kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms")
    log(f"summed over {len(convs)} K2 shapes: kernel {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms")
    return k1, k2


def text_conditioning(dev, rows: int, lm_dim: int, gen):
    import torch

    lm = torch.randn((rows, LM_LEN, lm_dim), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.ones((rows, LM_LEN), device=dev, dtype=torch.bfloat16)
    return {"lm_outputs": lm, "lm_mask": mask}


def check_images(out, batch: int, what: str):
    import torch

    if out.shape != (batch, SIDE, SIDE, 3):
        raise AssertionError(f"{what}: shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite values")
    lo, hi = float(out.min()), float(out.max())
    if lo < -1.0 or hi > 1.0:
        raise AssertionError(f"{what}: values outside [-1, 1]: {lo} {hi}")
    inner = float((out.abs() < 0.999).float().mean())
    log(f"{what}: shape {tuple(out.shape)} finite, range [{lo:.4f}, {hi:.4f}], "
        f"share of pixels inside (-1, 1): {inner:.4f}")


def profile_forward(pipe, dev, batch: int, lm_dim: int):
    """Wall time of one batch-`batch` U-Net forward, then its device time
    by kernel and the device's idle share from a profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn((batch, SIDE, SIDE, 3), generator=gen, device=dev)
    t = torch.full((batch,), 500, device=dev)
    cond = text_conditioning(dev, batch, lm_dim, gen)
    unet = pipe.vision_module

    def forward():
        unet(x, t, cond["lm_outputs"], cond["lm_mask"], {})

    with torch.no_grad():
        ms = cuda_ms(forward, warmup=1, reps=5)
        log(f"one U-Net forward B={batch}: {ms:.3f} ms (CUDA events, median of 5)")
        for _ in range(2):  # the first profiled run pays the tracer's set-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                forward()
                torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler recorded no device time")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    start = min(e.time_range.start for e in prof.events())
    window = spans[-1][1] - start
    log(f"profile: one U-Net forward B={batch}: device busy {busy / 1e3:.3f} ms of a "
        f"{window / 1e3:.3f} ms window, idle share {1 - busy / window:.4f}")
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {tot / 1e3:9.3f} ms {100 * tot / busy:5.1f}%  x{n:<5d} {name[:88]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's check runs only on a GPU")
    from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats
    from ml_mdm_tpu_torch.presets import flagship_64px

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. build the kernels from the sources in this checkout
    t0 = time.perf_counter()
    lib_path = fused_resnet.build_library()
    fused_resnet.load_library()
    log(f"K2 build (nvcc, sm_90a) + load: {time.perf_counter() - t0:.3f} s -> {lib_path.name}")
    build_log = lib_path.with_name(lib_path.name + ".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "built in" in line:
                log(f"  nvcc: {line.strip()}")
    t0 = time.perf_counter()
    probe = torch.ones((1, 8, 8, 64), device=dev, dtype=torch.bfloat16)
    gn_stats.spatial_sums(probe)
    torch.cuda.synchronize()
    log(f"K1 first launch (Triton compile): {time.perf_counter() - t0:.3f} s")

    # 2. the flagship pipeline, and each kernel against its plain version
    t0 = time.perf_counter()
    pipe, lm_dim, side = flagship_64px(dev, seed=SEED)
    if side != SIDE:
        raise AssertionError(f"flagship side {side}")
    unet = pipe.vision_module
    n_params = sum(p.numel() for p in unet.parameters())
    log(f"flagship cc12m_64x64 built on {dev}: {n_params} parameters (bf16), "
        f"{time.perf_counter() - t0:.3f} s")
    k1, k2 = check_kernels(unet, dev, batch=64)

    # 3a. kernel path against plain path, same weights and noise
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cond4 = text_conditioning(dev, 4, lm_dim, gen)
    noise4 = torch.randn((4, SIDE, SIDE, 3), generator=gen, device=dev)
    t4 = torch.tensor([999, 700, 400, 100], device=dev)
    kw4 = dict(num_inference_steps=4, resample_steps=True, ddim_eta=0.0)
    with torch.no_grad():
        f_k = unet(noise4, t4, cond4["lm_outputs"], cond4["lm_mask"], {})
        s_k = pipe.sample(4, cond4, SIDE, noise=noise4, **kw4)
        unet.use_kernels(False)
        f_p = unet(noise4, t4, cond4["lm_outputs"], cond4["lm_mask"], {})
        s_p = pipe.sample(4, cond4, SIDE, noise=noise4, **kw4)
        unet.use_kernels(True)
    f_err = rel_err(f_k, f_p)
    s_mean = float((s_k - s_p).abs().mean())
    s_max = float((s_k - s_p).abs().max())
    log(f"kernel vs plain path, one U-Net forward B=4: rel err {f_err:.4e} (tol {UNET_TOL}), "
        f"max|plain| {float(f_p.float().abs().max()):.4f}")
    log(f"kernel vs plain path, DDIM-4 sample B=4: mean abs {s_mean:.4e} (tol {SAMPLE_MEAN_TOL}), "
        f"max abs {s_max:.4e} (tol {SAMPLE_MAX_TOL})")
    if not (f_err <= UNET_TOL and s_mean <= SAMPLE_MEAN_TOL and s_max <= SAMPLE_MAX_TOL):
        raise AssertionError("kernel path disagrees with plain path")
    check_images(s_k, 4, "DDIM-4 kernel path")

    # 3b. the main path: two batch-64 DDIM-50 requests at the bench preset
    batch, steps = 64, 50
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cond = text_conditioning(dev, batch, lm_dim, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gn_stats.launch_count = 0
    fused_resnet.launch_count = 0
    outs, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.sample(batch, cond, SIDE, gen, num_inference_steps=steps,
                          resample_steps=True, ddim_eta=0.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"K1": gn_stats.launch_count, "K2": fused_resnet.launch_count}
    peak = torch.cuda.max_memory_allocated(dev)
    for i, dt in enumerate(times):
        log(f"request {i}: batch {batch} DDIM-{steps}: {dt:.4f} s, {batch / dt:.4f} samples/s")
    log(f"peak device memory over the two requests: {peak} bytes ({peak / 2**30:.3f} GiB)")
    log(f"launches during the two requests: K1 {launches['K1']}, K2 {launches['K2']}")
    if not (launches["K1"] > 0 and launches["K2"] > 0):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    for i, out in enumerate(outs):
        check_images(out, batch, f"request {i}")

    # 3c. classifier-free guidance: batch 8, 2B text rows
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cond_cfg = text_conditioning(dev, 16, lm_dim, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.sample(8, cond_cfg, SIDE, gen, num_inference_steps=steps,
                      resample_steps=True, ddim_eta=0.0, guidance_scale=5.0)
    torch.cuda.synchronize()
    log(f"CFG request: batch 8 guidance 5 DDIM-{steps}: {time.perf_counter() - t0:.4f} s")
    check_images(out, 8, "CFG request")

    # 4. where one forward's device time goes
    profile_forward(pipe, dev, batch, lm_dim)

    kernels = [
        {"name": "spatial_sums", "route": "triton",
         "source": "ml_mdm_tpu_torch/ops/gn_stats.py",
         "replaces": "ml_mdm_tpu/ops/gn_stats.py:62",
         "launches": launches["K1"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "affine_silu_conv3x3", "route": "cuda",
         "source": "ml_mdm_tpu_torch/csrc/fused_resnet.cu",
         "replaces": "ml_mdm_tpu/ops/fused_resnet.py:481",
         "launches": launches["K2"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
