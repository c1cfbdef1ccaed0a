#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (ml_mdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand kernels from the sources in this checkout (K2 and K4 with
nvcc, one background thread each, while Triton compiles K1), then drives
each of the port's paths with random weights from a seed:

  1. cc12m_64x64 (``Diffusion.sample``): every kernel launch shape of a
     batch-64 forward held against its plain version and timed beside its
     bound and the library call (the shortcut's shapes also without the
     stats); batch 4, 4 DDIM steps, kernel path against
     plain path; one batch-64 DDIM-50 request (the bench preset); one
     batch-8 request with classifier-free guidance 5; one profiled forward.
     Then the flash route (``use_flash(True)``: every self-attention of
     the U-Net through K4): K4 at every self-attention launch shape of that
     forward, on the chunked views the model hands it, held against its
     plain version and timed beside the matmul route, the library call
     (``scaled_dot_product_attention``) and the bound; batch 4, flash path
     against matmul path (one forward, DDIM-4); two batch-64 DDIM-50
     requests; one profiled forward.
  2. cc12m_256x256 (``NestedDiffusion.sample``, a 256px shell around the
     64px core): every kernel launch shape of the request's forward
     (8 rows) checked and timed; batch 2 kernel path against plain path
     (one forward, DDIM-4); two requests of the web demo's defaults
     (batch 4, guidance 7.5, DDIM-50, eta 0); one profiled forward; then,
     with the flash route on, K4 at that forward's shapes and one more such
     request.
  3. cc12m_1024x1024 (nested2: 1024px and 256px shells around the core):
     every kernel launch shape of a batch-4 forward checked and timed; one
     untimed forward, then one request at ``bench.py`` ``sample_1024``'s
     batch and eta (batch 4, eta 1) with 50 DDIM steps of its 250; one
     ``output_inner`` call; one profiled forward.
  4. Training (``NestedDiffusion.get_loss`` and ``trainer.make_train_step``
     on cc12m_256x256 with f32 parameters and bf16 compute): every K3
     launch shape of a batch-16 step, its backward held against autograd
     of the plain version and timed beside the plain backward, the
     library's (cuDNN's dgrad and wgrad with the same elementwise chain)
     and the bound; one batch-4 step's loss and gradients, kernel path
     against plain path; the ``train_256`` preset of ``bench.py`` (batch
     16, lr 5e-5, warmup 10, clip 2.0, no remat): one untimed and five
     timed steps; one profiled step; then cc12m_64x64 (``Diffusion.
     get_loss``) at batch 32 for two steps.
  5. The attention modules no shipped config turns on, at a small size by
     necessity: two temporal U-Nets (frames as ``(b t)`` rows; temporal
     attention and the frame resample, and ``temporal_spatial_ds``) and a
     U-Net with a learned lm-head of two layers, one forward each with K1
     and K2 under them, against their ``use_kernels(False)`` forward.
     Then K2 at the one shape of the JAX package's cost-decomposition
     probes (``tools/probe_kernel_anatomy*.py``), beside its bound.

Before each request or training phase every launch count is set to 0 and
read just after it; a kernel of the path that never launched fails the
run. Every phase that fails raises, and the script exits non-zero. It
needs a CUDA device and never falls back to the CPU. The card's name and
power limit are printed near the top; the line before the last names
every kernel with its launches (K1 and K2 during the nested matmul-route
requests, K3 during the train_256 preset's timed steps, K4 during the
flash-route requests), its error and its times; the
last line is one JSON object with "ok" and the device.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
LM_LEN = 32

# tolerances (bf16 working type), each relative to max|plain|:
K1_TOL = 1e-5    # f32 sums in another order
K2_TOL = 2e-2    # two bf16 ULPs: fast exp in SiLU and sum order can flip a rounding
UNET_TOL = 5e-2  # those flips carried through the full U-Net (one forward)
SAMPLE_MEAN_TOL = 1e-2  # 4-step sample, mean |kernel - plain| over pixels in [-1, 1]
SAMPLE_MAX_TOL = 0.25   # 4-step sample, max |kernel - plain|
K4_TOL = 2e-2    # P and the output rounded to bf16; the JAX test of its kernel allows the same

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_TENSOR = 989e12  # FLOP/s
PEAK_F32 = 67e12           # FLOP/s outside the tensor cores
PEAK_HBM = 3.35e12         # bytes/s


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: {time.perf_counter() - t0:.3f} s wall")


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


_FLUSH = []


def cuda_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps, from CUDA events, with the
    50 MB L2 cache overwritten before each timed run."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- kernel launch shapes of a path ---------------------------------------


def record_launch_shapes(run):
    """Run ``run()`` with the kernel wrappers wrapped, and return the
    distinct launch shapes it gave them: K2 keys (B, H, W, operand
    channels, Cout, residual, stats, shortcut, silu) and K1 keys (B, H, W, C)."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats

    k2, k1 = set(), set()
    conv, sums = fused_resnet.affine_silu_conv3x3, gn_stats.spatial_sums

    def conv_rec(x, a, b, w, bias, residual=None, **kw):
        xs = x if isinstance(x, (tuple, list)) else (x,)
        k2.add((*xs[0].shape[:3], tuple(xi.shape[-1] for xi in xs),
                (w[0] if isinstance(w, (tuple, list)) else w).shape[-1],
                residual is not None, bool(kw.get("emit_stats")),
                kw.get("proj_kernel") is not None, kw.get("apply_silu", True)))
        return conv(x, a, b, w, bias, residual, **kw)

    def sums_rec(x):
        k1.add(tuple(x.shape))
        return sums(x)

    fused_resnet.affine_silu_conv3x3, gn_stats.spatial_sums = conv_rec, sums_rec
    try:
        with torch.no_grad():
            run()
        torch.cuda.synchronize()
    finally:
        fused_resnet.affine_silu_conv3x3, gn_stats.spatial_sums = conv, sums
    return sorted(k2), sorted(k1)


def k2_bound(key):
    """(least ms, what bounds it) for one K2 launch on the H100: each input
    read once and each output written once over HBM, the convolution and
    shortcut products over the dense bf16 tensor-core peak."""
    bsz, h, w, cs, cout, residual, stats, proj, _ = key
    ct, px = sum(cs), bsz * h * w
    flops = 2 * px * ct * cout * (9 + proj)
    nbytes = (2 * px * ct + 2 * 4 * bsz * ct + 2 * 9 * ct * cout + 4 * cout
              + 2 * px * cout * (1 + residual + proj)
              + (2 * 4 * bsz * cout if stats else 0)
              + ((2 * ct + 4) * cout if proj else 0))
    t_ops, t_bytes = flops / PEAK_BF16_TENSOR, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def k1_bound(key):
    bsz, h, w, c = key
    t_bytes = (2 * bsz * h * w * c + 2 * 4 * bsz * c) / PEAK_HBM
    t_ops = 3 * bsz * h * w * c / PEAK_F32
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _conv_inputs(key, dev, g):
    import torch

    bsz, h, w, cs, cout, residual, _, proj, _ = key
    ct = sum(cs)
    bf = torch.bfloat16
    xs = tuple(torch.randn((bsz, h, w, c), generator=g, device=dev).to(bf) for c in cs)
    a = tuple(torch.randn((bsz, c), generator=g, device=dev) * 0.2 + 1.0 for c in cs)
    b = tuple(torch.randn((bsz, c), generator=g, device=dev) * 0.3 for c in cs)
    wk = tuple((torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * ct) ** 0.5).to(bf)
               for c in cs)
    bias = torch.randn((cout,), generator=g, device=dev) * 0.1
    res = torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf) if residual else None
    kw = {}
    if proj:
        kw["proj_kernel"] = tuple((torch.randn((c, cout), generator=g, device=dev)
                                   / ct ** 0.5).to(bf) for c in cs)
        kw["proj_bias"] = torch.randn((cout,), generator=g, device=dev) * 0.1
    return xs, a, b, wk, bias, res, kw


def library_conv(xs, a, b, wk, bias, res, stats, proj_kernel=None, proj_bias=None):
    """The same function from PyTorch's own calls, for timing only:
    elementwise affine + SiLU per operand, torch.cat, cuDNN's bf16 3x3 conv,
    the residual add, the stats sums and cuDNN's bf16 1x1 conv."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    v = torch.cat([F.silu(x.float() * ak[:, None, None, :] + bk[:, None, None, :]).to(bf)
                   for x, ak, bk in zip(xs, a, b)], dim=-1).permute(0, 3, 1, 2)
    w = torch.cat(wk, dim=2).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(v, w, bias.to(bf), padding=1)
    if res is not None:
        y = y + res.permute(0, 3, 1, 2)
    out = [y]
    if stats:
        yf = y.float()
        out += [yf.sum(dim=(2, 3)), yf.square().sum(dim=(2, 3))]
    if proj_kernel is not None:
        raw = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
        pw = torch.cat(proj_kernel, dim=0).t()[:, :, None, None].contiguous(
            memory_format=torch.channels_last)
        out.append(F.conv2d(raw, pw, proj_bias.to(bf)))
    return out


def _new_totals():
    return {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "shapes": 0}


def _add(tot, err, ms, pms, lms, bound, by):
    tot["err"] = max(tot["err"], err)
    tot["ms"] += ms
    tot["plain_ms"] += pms
    tot["library_ms"] += lms if lms is not None else 0.0
    tot["bound_ms"] += bound
    tot["ops_ms" if by == "operations" else "bytes_ms"] += bound
    tot["shapes"] += 1


def check_kernels(k2_keys, k1_keys, dev, label: str):
    """Each launch shape: kernel against plain version (tolerance), then
    kernel, plain and library times and the bound. Returns per-mode
    totals: K1, K2 (every shape), K2·N (shapes with several operands),
    K2·proj (shapes with the shortcut)."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    tot = {m: _new_totals() for m in ("K1", "K2", "K2·N", "K2·proj")}
    for key in k1_keys:
        x = (torch.randn(key, generator=g, device=dev) + 0.25).to(torch.bfloat16)
        s1, s2 = gn_stats.spatial_sums(x)
        p1, p2 = gn_stats.spatial_sums_plain(x)
        err = max(rel_err(s1, p1), rel_err(s2, p2))
        if not err <= K1_TOL:
            raise AssertionError(f"K1 spatial_sums {key}: rel err {err} > {K1_TOL}")
        ms = cuda_ms(lambda: gn_stats.spatial_sums(x))
        pms = cuda_ms(lambda: gn_stats.spatial_sums_plain(x), reps=3)
        bound, by = k1_bound(key)
        log(f"{label} K1 spatial_sums {key}: rel_err {err:.3e} kernel {ms:.4f} ms "
            f"({x.numel() * 2 / ms / 1e6:.0f} GB/s) plain {pms:.4f} ms bound {bound:.4f} ms ({by})")
        _add(tot["K1"], max(abs_err(s1, p1), abs_err(s2, p2)), ms, pms, None, bound, by)
    for key in k2_keys:
        xs, a, b, wk, bias, res, kw = _conv_inputs(key, dev, g)
        stats, silu = key[6], key[8]

        def kernel():
            return fused_resnet.affine_silu_conv3x3(xs, a, b, wk, bias, res, emit_stats=stats,
                                                    apply_silu=silu, **kw)

        def plain():
            return fused_resnet.affine_silu_conv3x3_plain(xs, a, b, wk, bias, res,
                                                          emit_stats=stats, apply_silu=silu, **kw)

        out, ref = kernel(), plain()
        out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        errs = [rel_err(o, r) for o, r in zip(out, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"K2 {key}: rel errs {errs} > {K2_TOL}")
        ms = cuda_ms(kernel)
        pms = cuda_ms(plain, warmup=1, reps=3)
        lms = (cuda_ms(lambda: library_conv(xs, a, b, wk, bias, res, stats, **kw))
               if silu else None)
        bound, by = k2_bound(key)
        bsz, h, w, cs, cout = key[:5]
        tflops = 2 * bsz * h * w * sum(cs) * cout * (9 + key[7]) / ms / 1e9
        log(f"{label} K2 B={bsz} {h}x{w} {'+'.join(map(str, cs))}->{cout}"
            f"{' residual' if key[5] else ''}{' stats' if stats else ''}"
            f"{' shortcut' if key[7] else ''}: rel_errs {', '.join(f'{e:.3e}' for e in errs)} "
            f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {pms:.4f} ms "
            f"library {lms if lms is None else f'{lms:.4f}'} ms bound {bound:.4f} ms ({by})")
        err = max(abs_err(o, r) for o, r in zip(out, ref))
        modes = ["K2"] + (["K2·N"] if len(cs) > 1 else []) + (["K2·proj"] if key[7] else [])
        for m in modes:
            _add(tot[m], err, ms, pms, lms, bound, by)
    # the path runs the shortcut only beside the stats (conv1): hold its
    # shapes without them too, untimed and outside the totals
    for key in k2_keys:
        if not (key[6] and key[7]):
            continue
        xs, a, b, wk, bias, res, kw = _conv_inputs(key, dev, g)
        out = fused_resnet.affine_silu_conv3x3(xs, a, b, wk, bias, res, **kw)
        ref = fused_resnet.affine_silu_conv3x3_plain(xs, a, b, wk, bias, res, **kw)
        errs = [rel_err(o, r) for o, r in zip(out, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"K2 {key} without stats: rel errs {errs} > {K2_TOL}")
        log(f"{label} K2 {key[:5]} shortcut without stats: rel_errs "
            f"{', '.join(f'{e:.3e}' for e in errs)}")
    for m, t in tot.items():
        if t["shapes"]:
            log(f"{label} {m} over {t['shapes']} shapes: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    return tot


def merge_totals(*parts):
    out = {m: dict.fromkeys(t, 0.0) for m, t in parts[0].items()}
    for p in parts:
        for m, t in p.items():
            for k, v in t.items():
                out[m][k] = max(out[m][k], v) if k == "err" else out[m][k] + v
    return out


# -- K4: the flash route's kernel ---------------------------------------------


@contextlib.contextmanager
def flash_route():
    """The flash route on (every supported self-attention through K4), and
    the choice given back to the environment after."""
    from ml_mdm_tpu_torch.ops import attention

    attention.use_flash(True)
    try:
        yield
    finally:
        attention.use_flash(None)


def record_k4_shapes(run):
    """Run ``run()`` with the flash route on and K4's wrapper wrapped, and
    return the distinct launch shapes it gave it, (B, Lq, Lk, H, D), after
    checking that each operand was a strided view (a chunk of the qkv
    tensor), not a copy."""
    import torch

    from ml_mdm_tpu_torch.ops import attention

    keys = set()
    flash = attention.flash_attention

    def rec(q, k, v):
        if q.is_contiguous() or k.is_contiguous() or v.is_contiguous():
            raise AssertionError("K4 was handed a contiguous copy, not the qkv chunks")
        keys.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
        return flash(q, k, v)

    attention.flash_attention = rec
    try:
        with torch.no_grad(), flash_route():
            run()
        torch.cuda.synchronize()
    finally:
        attention.flash_attention = flash
    return sorted(keys)


def k4_bound(key):
    """(least ms, what bounds it) for one K4 launch on the H100: the two
    products' 4 B H Lq Lk D FLOPs over the dense bf16 tensor-core peak, or
    q, k, v read once and the output written once over HBM."""
    bsz, lq, lk, heads, d = key
    t_ops = 4 * bsz * heads * lq * lk * d / PEAK_BF16_TENSOR
    t_bytes = 2 * bsz * heads * d * (2 * lq + 2 * lk) / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def check_k4(keys, dev, label: str):
    """Each launch shape, on the chunks of one (B, L, 3 H D) tensor as the
    model hands them over: K4 against its plain version (K4_TOL of
    max|plain|), then K4's time beside the plain version's, the matmul
    route's (what the flag replaces), the library call's
    (``scaled_dot_product_attention`` on the same views, timed only) and
    the bound. Returns the totals."""
    import torch
    import torch.nn.functional as F

    from ml_mdm_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    tot = _new_totals()
    tot["matmul_ms"] = 0.0
    for key in keys:
        bsz, lq, lk, heads, d = key
        if lq != lk:
            raise AssertionError(f"K4 {key}: the model's self-attention has Lq == Lk")
        qkv = torch.randn((bsz, lq, 3 * heads * d), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = (t.reshape(bsz, lq, heads, d) for t in qkv.chunk(3, dim=-1))
        out = attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.reference_flash_attention(q, k, v)
        err = rel_err(out, ref)
        if not (err <= K4_TOL and bool(torch.isfinite(out).all())):
            raise AssertionError(f"K4 {key}: rel err {err} > {K4_TOL}")
        route_err = rel_err(attention.matmul_attention(q, k, v), ref)
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v))
        pms = cuda_ms(lambda: attention.reference_flash_attention(q, k, v), warmup=1, reps=3)
        mms = cuda_ms(lambda: attention.matmul_attention(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=d ** -0.5)
                      .transpose(1, 2))
        bound, by = k4_bound(key)
        tflops = 4 * bsz * heads * lq * lk * d / ms / 1e9
        log(f"{label} K4 B={bsz} L={lq} H={heads} D={d}: rel_err {err:.3e} (the matmul route's "
            f"against the same plain version: {route_err:.3e}) kernel {ms:.4f} ms "
            f"({tflops:.1f} TFLOP/s) plain {pms:.4f} ms matmul route {mms:.4f} ms "
            f"library {lms:.4f} ms bound {bound:.4f} ms ({by})")
        _add(tot, abs_err(out, ref), ms, pms, lms, bound, by)
        tot["matmul_ms"] += mms
    log(f"{label} K4 over {tot['shapes']} shapes: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, matmul route {tot['matmul_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return tot


def self_attention_count(unet) -> int:
    """The 2-D self-attention modules of a U-Net: each launches K4 once a
    forward on the flash route (at the shipped models' sides every one has
    a supported length)."""
    from ml_mdm_tpu_torch.models.layers import SelfAttention

    return sum(isinstance(m, SelfAttention) for m in unet.modules())


# -- requests -------------------------------------------------------------


def text_conditioning(dev, rows: int, lm_dim: int, gen):
    import torch

    lm = torch.randn((rows, LM_LEN, lm_dim), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.ones((rows, LM_LEN), device=dev, dtype=torch.bfloat16)
    return {"lm_outputs": lm, "lm_mask": mask}


def check_images(out, shape, what: str):
    import torch

    if tuple(out.shape) != tuple(shape):
        raise AssertionError(f"{what}: shape {tuple(out.shape)}, expected {tuple(shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite values")
    lo, hi = float(out.min()), float(out.max())
    if lo < -1.0 or hi > 1.0:
        raise AssertionError(f"{what}: values outside [-1, 1]: {lo} {hi}")
    inner = float((out.abs() < 0.999).float().mean())
    log(f"{what}: shape {tuple(out.shape)} finite, range [{lo:.4f}, {hi:.4f}], "
        f"share of pixels inside (-1, 1): {inner:.4f}")


SAMPLING_KERNELS = ("K1", "K2", "K2·N", "K2·proj")
FLASH_KERNELS = SAMPLING_KERNELS + ("K4",)
TRAINING_KERNELS = ("K1", "K2", "K3")


def reset_counts():
    from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats

    gn_stats.launch_count = 0
    attention.launch_count = 0
    fused_resnet.reset_launch_counts()


def read_counts(what: str, required=SAMPLING_KERNELS):
    """The launch counts since reset_counts(); fails if a kernel of the path
    (``required``) never launched."""
    from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats

    counts = {"K1": gn_stats.launch_count, **fused_resnet.launch_counts,
              "K4": attention.launch_count}
    log(f"launches during {what}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels of the path never launched: {missing}")
    if "K4" not in required and counts["K4"]:
        raise AssertionError(f"{what}: K4 launched {counts['K4']} times off the flash route")
    return counts


def run_requests(pipe, dev, what: str, n: int, batch: int, side: int, cond, gen,
                 flash: bool = False, **kw):
    """n timed sampling requests between a count reset and a count read;
    returns (counts, outputs). With ``flash`` they run on the flash route,
    and K4 must have launched once per self-attention module, step and
    request."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    outs = []
    with flash_route() if flash else contextlib.nullcontext():
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe.sample(batch, cond, side, gen, **kw))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"{what} request {i}: batch {batch}: {dt:.4f} s, {batch / dt:.4f} samples/s")
    counts = read_counts(what, FLASH_KERNELS if flash else SAMPLING_KERNELS)
    if flash:
        expected = self_attention_count(pipe.vision_module) * kw["num_inference_steps"] * n
        if counts["K4"] != expected:
            raise AssertionError(f"{what}: K4 launched {counts['K4']} times, expected "
                                 f"{expected} (self-attentions x steps x requests)")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"{what}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return counts, outs


def compare_paths(pipe, dev, lm_dim: int, side: int, what: str, batch: int, names, switch):
    """One forward and a DDIM-4 sample on two paths through the same
    weights and noise, ``switch(True)`` selecting the first of ``names``
    and ``switch(False)`` the second, under UNET_TOL, SAMPLE_MEAN_TOL and
    SAMPLE_MAX_TOL."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cond = text_conditioning(dev, batch, lm_dim, gen)
    noise = pipe.get_noise(batch, side, gen)
    t = torch.linspace(999, 100, batch, device=dev).long()
    kw = dict(num_inference_steps=4, resample_steps=True, ddim_eta=0.0)
    results = []
    with torch.no_grad():
        for first in (True, False):
            switch(first)
            f = pipe.model(noise, t, cond["lm_outputs"], cond["lm_mask"], {})
            results.append((f if isinstance(f, list) else [f],
                            pipe.sample(batch, cond, side, noise=noise, **kw)))
    (f_a, s_a), (f_b, s_b) = results
    f_err = max(rel_err(a, b) for a, b in zip(f_a, f_b))
    s_mean = float((s_a - s_b).abs().mean())
    s_max = float((s_a - s_b).abs().max())
    vs = f"{names[0]} vs {names[1]} path"
    log(f"{what} {vs}, one forward B={batch}: rel err {f_err:.4e} "
        f"(tol {UNET_TOL}) over {len(f_a)} outputs")
    log(f"{what} {vs}, DDIM-4 sample B={batch}: mean abs {s_mean:.4e} "
        f"(tol {SAMPLE_MEAN_TOL}), max abs {s_max:.4e} (tol {SAMPLE_MAX_TOL})")
    if not (f_err <= UNET_TOL and s_mean <= SAMPLE_MEAN_TOL and s_max <= SAMPLE_MAX_TOL):
        raise AssertionError(f"{what}: {names[0]} path disagrees with {names[1]} path")
    check_images(s_a, (batch, side, side, 3), f"{what} DDIM-4 {names[0]} path")


def kernel_vs_plain(pipe, dev, lm_dim: int, side: int, what: str, batch: int = 4):
    """The kernels against their plain versions through the whole model."""
    unet = pipe.vision_module
    try:
        compare_paths(pipe, dev, lm_dim, side, what, batch, ("kernel", "plain"),
                      unet.use_kernels)
    finally:
        unet.use_kernels(True)


def flash_vs_matmul(pipe, dev, lm_dim: int, side: int, what: str, batch: int = 4):
    """The flash route (K4) against the matmul route through the whole
    model; fails if the flash forwards launched no K4."""
    from ml_mdm_tpu_torch.ops import attention

    reset_counts()
    try:
        compare_paths(pipe, dev, lm_dim, side, what, batch, ("flash", "matmul"),
                      attention.use_flash)
    finally:
        attention.use_flash(None)
    expected = 5 * self_attention_count(pipe.vision_module)  # one forward and DDIM-4
    if attention.launch_count != expected:
        raise AssertionError(f"{what}: K4 launched {attention.launch_count} times on the "
                             f"flash path, expected {expected}")


def forward_inputs(pipe, dev, batch: int, side: int, lm_dim: int):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = pipe.get_noise(batch, side, gen)
    t = torch.full((batch,), 500, device=dev)
    cond = text_conditioning(dev, batch, lm_dim, gen)
    return lambda: pipe.model(x, t, cond["lm_outputs"], cond["lm_mask"], {})


def profile_forward(forward, what: str):
    """Time of one forward (CUDA events) and the host's time to enqueue it,
    then its device time by kernel and the device's idle share from a
    profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        ms = cuda_ms(forward, warmup=1, reps=3)
        enqueue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            enqueue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        log(f"{what}: one forward {ms:.3f} ms (CUDA events, median of 3); the host "
            f"enqueues it in {statistics.median(enqueue):.3f} ms (median of 3)")
        for _ in range(2):  # the first profiled run pays the tracer's set-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                forward()
                torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"{what} profile: the profiler recorded no device time")
        return ms
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
    log(f"{what} profile: device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, "
        f"idle share {1 - busy / window:.4f}")
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {tot / 1e3:9.3f} ms {100 * tot / busy:5.1f}%  x{n:<5d} {name[:88]}")
    return ms


# -- the paths --------------------------------------------------------------


def path_64(dev):
    import torch

    from ml_mdm_tpu_torch.presets import flagship_64px

    with phase("64px: build and kernel shapes"):
        pipe, lm_dim, side = flagship_64px(dev, seed=SEED)
        n_params = sum(p.numel() for p in pipe.vision_module.parameters())
        log(f"cc12m_64x64 built on {dev}: {n_params} parameters (bf16)")
        k2_keys, k1_keys = record_launch_shapes(forward_inputs(pipe, dev, 64, side, lm_dim))
        check_kernels(k2_keys, k1_keys, dev, "64px")
    with phase("64px: kernel path vs plain path"):
        kernel_vs_plain(pipe, dev, lm_dim, side, "64px")
    bench = dict(num_inference_steps=50, resample_steps=True, ddim_eta=0.0)
    with phase("64px: one batch-64 DDIM-50 request, matmul route"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        cond = text_conditioning(dev, 64, lm_dim, gen)
        _, outs = run_requests(pipe, dev, "64px", 1, 64, side, cond, gen, **bench)
        check_images(outs[0], (64, side, side, 3), "64px request 0")
    with phase("64px: CFG request"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        cond = text_conditioning(dev, 16, lm_dim, gen)
        _, outs = run_requests(pipe, dev, "64px CFG", 1, 8, side, cond, gen,
                               num_inference_steps=50, resample_steps=True, ddim_eta=0.0,
                               guidance_scale=5.0)
        check_images(outs[0], (8, side, side, 3), "64px CFG request")
    with phase("64px: profile"):
        forward = forward_inputs(pipe, dev, 64, side, lm_dim)
        profile_forward(forward, "64px B=64 matmul route")
    with phase("64px flash route: K4 at the forward's shapes"):
        n_attn = self_attention_count(pipe.vision_module)
        k4_keys = record_k4_shapes(forward)
        log(f"cc12m_64x64 has {n_attn} self-attention modules; K4 launch shapes of a "
            f"batch-64 forward (B, Lq, Lk, H, D): {k4_keys}")
        totals = check_k4(k4_keys, dev, "64px")
    with phase("64px: flash path vs matmul path"):
        flash_vs_matmul(pipe, dev, lm_dim, side, "64px")
    with phase("64px: two batch-64 DDIM-50 requests, flash route"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        cond = text_conditioning(dev, 64, lm_dim, gen)
        counts, outs = run_requests(pipe, dev, "64px flash", 2, 64, side, cond, gen,
                                    flash=True, **bench)
        for i, out in enumerate(outs):
            check_images(out, (64, side, side, 3), f"64px flash request {i}")
    with phase("64px: profile, flash route"):
        with flash_route():
            profile_forward(forward, "64px B=64 flash route")
    return totals, counts


def path_256(dev):
    import torch

    from ml_mdm_tpu_torch.presets import cc12m_256x256

    batch, guidance = 4, 7.5  # the web demo's defaults
    with phase("256px: build and kernel shapes"):
        pipe, lm_dim, side = cc12m_256x256(dev, seed=SEED)
        n_params = sum(p.numel() for p in pipe.vision_module.parameters())
        log(f"cc12m_256x256 built on {dev}: {n_params} parameters (bf16), scales {pipe.scales}")
        k2_keys, k1_keys = record_launch_shapes(
            forward_inputs(pipe, dev, 2 * batch, side, lm_dim))
        totals = check_kernels(k2_keys, k1_keys, dev, "256px")
    with phase("256px: kernel path vs plain path"):
        kernel_vs_plain(pipe, dev, lm_dim, side, "256px", batch=2)
    with phase("256px: two requests, batch 4, guidance 7.5, DDIM-50"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        cond = text_conditioning(dev, 2 * batch, lm_dim, gen)
        counts, outs = run_requests(pipe, dev, "256px", 2, batch, side, cond, gen,
                                    num_inference_steps=50, resample_steps=True,
                                    ddim_eta=0.0, guidance_scale=guidance)
        for i, out in enumerate(outs):
            check_images(out, (batch, side, side, 3), f"256px request {i}")
    with phase("256px: profile"):
        forward = forward_inputs(pipe, dev, 2 * batch, side, lm_dim)
        profile_forward(forward, "256px B=8")
    with phase("256px flash route: K4 at the forward's shapes, one request"):
        k4_keys = record_k4_shapes(forward)
        log(f"K4 launch shapes of the 256px request's forward (B, Lq, Lk, H, D): {k4_keys}")
        totals_k4 = check_k4(k4_keys, dev, "256px")
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        counts_k4, outs = run_requests(pipe, dev, "256px flash", 1, batch, side, cond, gen,
                                       flash=True, num_inference_steps=50, resample_steps=True,
                                       ddim_eta=0.0, guidance_scale=guidance)
        check_images(outs[0], (batch, side, side, 3), "256px flash request 0")
    return totals, counts, totals_k4, counts_k4


def path_1024(dev):
    import torch

    from ml_mdm_tpu_torch.presets import cc12m_1024x1024

    batch = 4
    with phase("1024px: build and kernel shapes"):
        pipe, lm_dim, side = cc12m_1024x1024(dev, seed=SEED)
        n_params = sum(p.numel() for p in pipe.vision_module.parameters())
        log(f"cc12m_1024x1024 built on {dev}: {n_params} parameters (bf16), scales {pipe.scales}")
        forward = forward_inputs(pipe, dev, batch, side, lm_dim)
        k2_keys, k1_keys = record_launch_shapes(forward)
        if not any(k[2] == 1024 for k in k2_keys):
            raise AssertionError("K2 never launched at W = 1024")
        totals = check_kernels(k2_keys, k1_keys, dev, "1024px")
    with phase("1024px: one untimed forward, then the sample_1024 request"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            forward()
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        steps = 50  # of sample_1024's 250: the same path, a fifth of the depth
        log(f"1024px untimed forward B={batch}: {fwd_ms:.3f} ms")
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        cond = text_conditioning(dev, batch, lm_dim, gen)
        counts, outs = run_requests(pipe, dev, f"1024px DDIM-{steps}", 1, batch, side, cond,
                                    gen, num_inference_steps=steps, resample_steps=True,
                                    ddim_eta=1.0)
        check_images(outs[0], (batch, side, side, 3), "1024px request")
    with phase("1024px: output_inner"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        cond = text_conditioning(dev, 2, lm_dim, gen)
        out = pipe.sample(2, cond, side, gen, num_inference_steps=4, resample_steps=True,
                          ddim_eta=1.0, output_inner=True)
        check_images(out, (2, side, len(pipe.scales) * side, 3), "1024px output_inner DDIM-4")
    with phase("1024px: profile"):
        profile_forward(forward, "1024px B=4")
    return totals, counts


# -- training ---------------------------------------------------------------


def record_k3_shapes(run):
    """Run ``run()`` (a forward and backward) with K3's wrapper wrapped, and
    return its distinct launch shapes: (B, H, W, C, Cout, residual, stats)."""
    from ml_mdm_tpu_torch.ops import fused_resnet

    keys = set()
    vjp = fused_resnet.affine_silu_conv3x3_vjp

    def rec(x, a, b, w, bias, residual=None, **kw):
        keys.add((*x.shape, w.shape[-1], residual is not None, bool(kw.get("emit_stats"))))
        return vjp(x, a, b, w, bias, residual, **kw)

    fused_resnet.affine_silu_conv3x3_vjp = rec
    try:
        run()
        import torch

        torch.cuda.synchronize()
    finally:
        fused_resnet.affine_silu_conv3x3_vjp = vjp
    return sorted(keys)


def k3_bound(key):
    """(least ms, what bounds it) for one K3 backward on the H100: the data
    and weight gradients' tensor-core FLOPs (2 x 2 B H W 9 C Cout) over the
    dense bf16 peak, or the bytes over HBM: x, dy (and y with the stats)
    read, dx written, the f32 weights read and their gradient written, and
    the (B, C) vectors."""
    bsz, h, w, c, cout, residual, stats = key
    px = bsz * h * w
    flops = 4 * px * 9 * c * cout
    nbytes = (2 * px * c * 2 + 2 * px * cout * (1 + stats) + 2 * 4 * 9 * c * cout
              + 4 * 4 * bsz * c + 4 * cout + (2 * 4 * bsz * cout if stats else 0))
    t_ops, t_bytes = flops / PEAK_BF16_TENSOR, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _k3_inputs(key, dev, g):
    """bf16 x, residual and dy; f32 coefficients, weights (as training holds
    them), bias and stats cotangents."""
    import torch

    bsz, h, w, c, cout, residual, stats = key
    bf = torch.bfloat16
    ins = [torch.randn((bsz, h, w, c), generator=g, device=dev).to(bf),
           torch.randn((bsz, c), generator=g, device=dev) * 0.2 + 1.0,
           torch.randn((bsz, c), generator=g, device=dev) * 0.3,
           torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5,
           torch.randn((cout,), generator=g, device=dev) * 0.1,
           torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf) if residual else None]
    cots = [torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf)]
    if stats:
        cots += [torch.randn((bsz, cout), generator=g, device=dev) * 1e-3,
                 torch.randn((bsz, cout), generator=g, device=dev) * 1e-4]
    return ins, cots


def _backward_of(fn, ins, cots, stats):
    """One forward through fn; returns a closure that runs its backward
    (the graph is kept, so it can run again) and returns the gradients of
    x, a, b, w, bias and the residual."""
    import torch

    leaves = [t.detach().requires_grad_(True) if t is not None else None for t in ins]
    out = fn(*leaves, emit_stats=stats)
    outs = out if stats else (out,)
    targets = [t for t in leaves if t is not None]
    return lambda: torch.autograd.grad(outs, targets, cots, retain_graph=True), outs


def library_k3_backward(x, a, b, w16, dy, y=None, ds1=None, ds2=None):
    """K3's backward with cuDNN's bf16 dgrad in place of K2 (and cuDNN's
    wgrad, as K3 has), for timing only."""
    import torch

    if y is not None:
        dy = (dy.float() + ds1[:, None, None, :] + 2.0 * y.float() * ds2[:, None, None, :]).to(dy.dtype)
    a_c, b_c = a[:, None, None, :], b[:, None, None, :]
    v = x.float() * a_c + b_c
    sig = torch.sigmoid(v)
    dact = sig * (1.0 + v * (1.0 - sig))
    w_oihw = w16.permute(3, 2, 0, 1)
    dy_nchw = dy.permute(0, 3, 1, 2)
    ds = torch.nn.grad.conv2d_input(x.permute(0, 3, 1, 2).shape, w_oihw, dy_nchw, padding=1)
    dv = ds.permute(0, 2, 3, 1).float() * dact
    dx = (dv * a_c).to(x.dtype)
    dw = torch.nn.grad.conv2d_weight((v * sig).to(x.dtype).permute(0, 3, 1, 2), w_oihw.shape,
                                     dy_nchw, padding=1)
    return dx, (dv * x.float()).sum(dim=(1, 2)), dv.sum(dim=(1, 2)), dw, dy.float().sum(dim=(0, 1, 2))


def check_k3(keys, dev):
    """Each K3 launch shape: the Function's backward against autograd of the
    plain version (K2_TOL), then the backward's time, the plain
    backward's, the library's, the weight re-layout's and the bound.
    Returns the totals."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    tot = _new_totals()
    relayout_ms = 0.0
    for key in keys:
        bsz, h, w, c, cout, residual, stats = key
        ins, cots = _k3_inputs(key, dev, g)
        kernel, outs = _backward_of(fused_resnet.affine_silu_conv3x3_vjp, ins, cots, stats)
        plain, _ = _backward_of(fused_resnet.affine_silu_conv3x3_plain, ins, cots, stats)
        got, ref = kernel(), plain()
        errs = [rel_err(o, r) for o, r in zip(got, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"K3 {key}: rel errs {errs} > {K2_TOL}")
        ms = cuda_ms(kernel)
        pms = cuda_ms(plain, warmup=1, reps=3)
        w16 = ins[3].to(torch.bfloat16)
        extra = (outs[0].detach(), *cots[1:]) if stats else ()
        lms = cuda_ms(lambda: library_k3_backward(ins[0], ins[1], ins[2], w16, cots[0], *extra))
        # the data gradient's weights as K2's wrapper lays them out per call
        rms = cuda_ms(lambda: ins[3].flip(0, 1).transpose(2, 3).to(torch.bfloat16)
                      .permute(3, 0, 1, 2).reshape(c, 9 * cout).contiguous())
        relayout_ms += rms
        bound, by = k3_bound(key)
        log(f"K3 B={bsz} {h}x{w} {c}->{cout}{' residual' if residual else ''}"
            f"{' stats' if stats else ''}: rel_errs (dx, da, db, dw, dbias"
            f"{', dres' if residual else ''}) {', '.join(f'{e:.3e}' for e in errs)} "
            f"backward {ms:.4f} ms ({4 * bsz * h * w * 9 * c * cout / ms / 1e9:.1f} TFLOP/s) "
            f"plain {pms:.4f} ms library {lms:.4f} ms weight re-layout {rms:.4f} ms "
            f"bound {bound:.4f} ms ({by})")
        _add(tot, max(abs_err(o, r) for o, r in zip(got, ref)), ms, pms, lms, bound, by)
    log(f"K3 over {tot['shapes']} shapes: backward {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms; the data gradient's weight re-layout {relayout_ms:.4f} ms")
    return tot


def train_batch(dev, rows: int, side: int, lm_dim: int, gen):
    """Random images in [-1, 1] (f32, as a reader gives them) and text."""
    import torch

    images = torch.rand((rows, side, side, 3), generator=gen, device=dev) * 2.0 - 1.0
    return {"images": images, **text_conditioning(dev, rows, lm_dim, gen)}


def flat_grads(unet):
    import torch

    return torch.cat([p.grad.flatten() for p in unet.parameters() if p.grad is not None])


def train_kernel_vs_plain(pipe, dev, lm_dim: int, side: int, batch: int = 4):
    """One step's loss and gradients through the kernels and through the
    plain versions, from the same f32 weights, timesteps and noise."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    data = {k: v.to(torch.bfloat16) for k, v in train_batch(dev, batch, side, lm_dim, gen).items()}
    time_ = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    eps = [n.to(torch.bfloat16) for n in pipe.get_noise(batch, side, gen)]
    unet = pipe.vision_module
    results = []
    for kernels in (True, False):
        unet.use_kernels(kernels).zero_grad(set_to_none=True)
        loss = pipe.get_loss(data, time=time_, eps=eps)[0].mean()
        loss.backward()
        results.append((float(loss.detach()), flat_grads(unet)))
        unet.zero_grad(set_to_none=True)
    unet.use_kernels(True)
    (lk, gk), (lp, gp) = results
    l_err = abs(lk - lp) / abs(lp)
    n_err = abs(float(gk.norm()) - float(gp.norm())) / float(gp.norm())
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    log(f"256px train, kernel vs plain path, one step B={batch}: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {l_err:.4e}, tol 1e-2); grad norm {float(gk.norm()):.6f} vs {float(gp.norm()):.6f} "
        f"(rel {n_err:.4e}, tol 5e-2); cosine {cos:.6f} (>= 0.99)")
    if not (l_err <= 1e-2 and n_err <= 5e-2 and cos >= 0.99 and torch.isfinite(gk).all()):
        raise AssertionError("256px train: kernel path disagrees with plain path")


def run_train_steps(step, state, pipe, dev, what: str, n: int, batch: int, side: int,
                    lm_dim: int, gen, timed: bool = True):
    """n training steps on fresh random batches, each timed on the host
    clock around a synchronised step; fails on a non-finite or skipped
    step. Returns the step times in seconds."""
    import torch

    times = []
    for i in range(n):
        data = train_batch(dev, batch, side, lm_dim, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        log(f"{what} step {state.step}{'' if timed else ' (untimed)'}: loss {m['loss']:.6f} "
            f"grad norm {m['grad_norm']:.6f} skipped {m['skipped']}: {dt:.4f} s, "
            f"{batch / dt:.4f} images/s")
        if m["skipped"] or not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{what}: step {i} was not finite or was skipped: {m}")
    return times


def profile_train_step(step, state, pipe, dev, batch: int, side: int, lm_dim: int, gen):
    """One training step under the profiler: the device's busy and idle
    share, the top device time by kernel, and the device time of K3's
    backward split into its data gradient (K2 and the weights' re-layout),
    its weight gradient and its elementwise chain, and of Adam and the
    EMA."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data = train_batch(dev, batch, side, lm_dim, gen)
    for _ in range(2):  # the first profiled run pays the tracer's set-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, m = step(state, data, gen)
            torch.cuda.synchronize()
    events = prof.events()
    # device events, without the device-side spans of the named ranges
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("256px train profile: the profiler recorded no device time")
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
    window = spans[-1][1] - min(e.time_range.start for e in events)
    log(f"256px train profile, one step B={batch}: device busy {busy / 1e3:.3f} ms of a "
        f"{window / 1e3:.3f} ms window, idle share {1 - busy / window:.4f}")
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {tot / 1e3:9.3f} ms {100 * tot / busy:5.1f}%  x{n:<5d} {name[:88]}")

    def range_us(name):
        """Device time of the kernels launched inside a named range."""
        return sum(e.device_time_total for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)

    k2_us = sum(tot for name, (tot, _) in by_name.items() if "affine_silu_conv3x3" in name)
    parts = {"K3 backward (all)": range_us("K3 backward"),
             "K3 data gradient, ATen part (re-layout, ones/zeros)": range_us("K3 dx (K2)"),
             "K3 weight gradient (cuDNN)": range_us("K3 dw (library)"),
             "Adam": range_us("trainer: Adam"), "EMA": range_us("trainer: EMA"),
             "K2 kernel, forward and backward (by name)": k2_us}
    parts["K3 elementwise chain"] = (parts["K3 backward (all)"] - parts["K3 weight gradient (cuDNN)"]
                                     - parts["K3 data gradient, ATen part (re-layout, ones/zeros)"])
    for name, us in parts.items():
        log(f"  {name}: {us / 1e3:.3f} ms device, {100 * us / busy:.1f}% of busy")


def path_train(dev):
    """Training: cc12m_256x256 (K3 shapes, kernel vs plain, the train_256
    preset, one profiled step), then cc12m_64x64. Returns (K3 totals, the
    launch counts of the train_256 preset's timed steps)."""
    import gc

    import torch

    from ml_mdm_tpu_torch import trainer
    from ml_mdm_tpu_torch.presets import flagship_64px, nested_preset

    batch = 16
    with phase("256px train: build and K3 shapes"):
        pipe, lm_dim, side = nested_preset("cc12m_256x256", dev, seed=SEED, train=True)
        unet = pipe.vision_module
        n_params = sum(p.numel() for p in unet.parameters())
        log(f"cc12m_256x256 built on {dev} for training: {n_params} parameters "
            f"({next(unet.parameters()).dtype}), compute {unet.dtype}, mixed_ratio "
            f"{pipe.mixed_ratio}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        data = {k: v.to(torch.bfloat16)
                for k, v in train_batch(dev, batch, side, lm_dim, gen).items()}

        def one_backward():
            unet.zero_grad(set_to_none=True)
            pipe.get_loss(data, gen)[0].mean().backward()

        keys = record_k3_shapes(one_backward)
        with_grad = {k for k, p in unet.named_parameters()
                     if p.grad is not None and bool((p.grad != 0).any())}
        log(f"{len(with_grad)} of {len(list(unet.parameters()))} parameter tensors get a "
            f"nonzero gradient; {len(keys)} K3 launch shapes")
        unet.zero_grad(set_to_none=True)
        del data
        tot_k3 = check_k3(keys, dev)
    with phase("256px train: kernel path vs plain path"):
        train_kernel_vs_plain(pipe, dev, lm_dim, side)
    with phase("256px train: the train_256 preset, 1 untimed and 5 timed steps"):
        cfg = trainer.TrainerConfig(lr=5e-5, warmup_steps=10, gradient_clip_norm=2.0)
        state = trainer.TrainState.create(unet)
        step = trainer.make_train_step(pipe, cfg)
        start = {k: p.detach().clone() for k, p in state.params.items()}
        run_train_steps(step, state, pipe, dev, "256px train", 1, batch, side, lm_dim, gen,
                        timed=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        times = run_train_steps(step, state, pipe, dev, "256px train", 5, batch, side, lm_dim, gen)
        counts = read_counts("the train_256 preset's timed steps", TRAINING_KERNELS)
        dt = sum(times) / len(times)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"256px train (batch {batch}, 10 rows at 256px, {batch} at 64px): "
            f"{1 / dt:.4f} steps/s, {batch / dt:.4f} images/s (mean of 5 steps); "
            f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
        changed = {k for k, p in state.params.items() if not torch.equal(p.detach(), start[k])}
        log(f"after {state.step} steps: {len(changed & with_grad)} of the {len(with_grad)} "
            f"parameter tensors that get a gradient changed ({len(changed)} of "
            f"{len(start)} in all)")
        if not with_grad <= changed:
            raise AssertionError(f"parameters that get a gradient did not change: "
                                 f"{sorted(with_grad - changed)[:8]}")
        ema_moved = sum(float((state.ema_params[k] - start[k]).abs().sum()) for k in start)
        p_moved = sum(float((state.params[k].detach() - start[k]).abs().sum()) for k in start)
        log(f"sum |EMA - start| {ema_moved:.6e}, sum |params - start| {p_moved:.6e}")
        if not 0.0 < ema_moved < p_moved:
            raise AssertionError("256px train: the EMA did not move, or moved past the params")
        del start
    with phase("256px train: profile one step"):
        profile_train_step(step, state, pipe, dev, batch, side, lm_dim, gen)
    del pipe, unet, state, step
    gc.collect()
    torch.cuda.empty_cache()
    with phase("64px train: Diffusion.get_loss, batch 32, 2 steps"):
        pipe, lm_dim, side = flagship_64px(dev, seed=SEED, train=True)
        cfg = trainer.TrainerConfig(lr=5e-5, warmup_steps=10, gradient_clip_norm=2.0)
        state = trainer.TrainState.create(pipe.vision_module)
        step = trainer.make_train_step(pipe, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        run_train_steps(step, state, pipe, dev, "64px train", 2, 32, side, lm_dim, gen)
        read_counts("the 64px training steps", TRAINING_KERNELS)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"64px train: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    del pipe, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return tot_k3, counts


# -- the attention modules no shipped config turns on ---------------------------


def path_new_modules(dev):
    """Temporal U-Nets and a U-Net with the learned lm-head, small by
    necessity (no shipped config sets ``temporal_mode`` or a nonzero
    ``num_lm_head_layers``): one bf16 forward each with K1 and K2 under
    the new modules, finite and within UNET_TOL of the
    ``use_kernels(False)`` forward."""
    import dataclasses

    import torch

    from ml_mdm_tpu_torch.config import ResNetConfig, UNetConfig
    from ml_mdm_tpu_torch.models.layers import SelfAttention1DBlock, TemporalAttentionBlock
    from ml_mdm_tpu_torch.models.unet import UNet
    from ml_mdm_tpu_torch.presets import flagship_configs, init_params_

    def temporal(spatial_ds: bool, pos_emb: bool) -> UNetConfig:
        return UNetConfig(
            resolution_channels=[64, 128], num_resnets_per_resolution=[1, 1],
            attention_levels=[1], num_attention_layers=[0, 1],
            num_temporal_attention_layers=[1, 1], temporal_mode=True,
            temporal_spatial_ds=spatial_ds, temporal_positional_encoding=pos_emb,
            conditioning_feature_dim=-1, masked_cross_attention=0,
            resnet_config=ResNetConfig(num_groups_norm=8, use_attention_ffn=False))

    lm_cfg, _, lm_dim, _ = flagship_configs(scaled=True)
    videos, frames, side = 2, 4, 32
    cases = [
        ("temporal U-Net (frame resample, temporal attention, rotary positions)",
         temporal(False, True), videos * frames, 0, TemporalAttentionBlock, 6),
        ("temporal U-Net (temporal_spatial_ds)", temporal(True, False), videos * frames, 0,
         TemporalAttentionBlock, 0),
        ("U-Net with num_lm_head_layers 2, masked",
         dataclasses.replace(lm_cfg, num_lm_head_layers=2, masked_cross_attention=1),
         videos, lm_dim, SelfAttention1DBlock, 2),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    for what, cfg, rows, text_dim, cls, n_modules in cases:
        unet = UNet(3, 3, cfg).to(dev)
        init_params_(unet, gen)
        unet = unet.to(torch.bfloat16).eval()
        found = sum(isinstance(m, cls) for m in unet.modules())
        if found != n_modules:
            raise AssertionError(f"{what}: {found} {cls.__name__} modules, expected {n_modules}")
        x = torch.randn((rows, side, side, 3), generator=gen, device=dev)
        t = torch.tensor([900, 200], device=dev)
        lm = mask = None
        if text_dim:
            lm = torch.randn((videos, LM_LEN, text_dim), generator=gen, device=dev).to(torch.bfloat16)
            mask = torch.ones((videos, LM_LEN), device=dev, dtype=torch.bfloat16)
            mask[0, LM_LEN // 2:] = 0
        reset_counts()
        with torch.no_grad():
            got = unet(x, t, lm, mask, {})
            torch.cuda.synchronize()
            counts = read_counts(what, ("K1", "K2"))
            ref = unet.use_kernels(False)(x, t, lm, mask, {})
        err = rel_err(got, ref)
        log(f"{what}, small by necessity (no shipped config has these fields on): "
            f"{n_modules} {cls.__name__} modules, rows {rows}, side {side}: out "
            f"{tuple(got.shape)}, kernel vs plain forward rel err {err:.4e} (tol {UNET_TOL}), "
            f"K1 {counts['K1']} K2 {counts['K2']} launches")
        if tuple(got.shape) != tuple(x.shape) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: output {tuple(got.shape)} not finite or misshapen")
        if not err <= UNET_TOL:
            raise AssertionError(f"{what}: kernel path disagrees with plain path")


def nvcc_report(lib_path, name: str):
    """Log what ptxas said of each kernel in a built library: registers and
    spills, with the head width of a templated instance."""
    build_log = lib_path.with_name(lib_path.name + ".log")
    if not build_log.exists():
        return
    lines, width = [], ""
    for line in build_log.read_text().splitlines():
        if "built in" in line:
            log(f"  nvcc {name}: {line.strip()}")
        elif "Compiling entry function" in line:
            m = re.search(r"flash_attention_kernelILi(\d+)E", line)
            width = f"D={m.group(1)}: " if m else ""
        elif "spill" in line or "registers" in line:
            lines.append(width + line.replace("ptxas info    :", "").strip())
            if "registers" in line:
                log(f"  nvcc {name}: " + "; ".join(lines))
                lines = []


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's check runs only on a GPU")
    from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    with phase("build the kernels (one nvcc each for K2 and K4, beside Triton's K1 compile)"):
        built, errors = {}, {}

        def build(name, module):
            try:
                built[name] = module.build_library()
            except Exception as e:  # re-raised below, in the main thread
                errors[name] = e

        threads = [threading.Thread(target=build, args=a)
                   for a in (("K2", fused_resnet), ("K4", attention))]
        t0 = time.perf_counter()
        for thread in threads:
            thread.start()
        probe = torch.ones((1, 8, 8, 64), device=dev, dtype=torch.bfloat16)
        gn_stats.spatial_sums(probe)
        torch.cuda.synchronize()
        log(f"K1 first launch (Triton compile): {time.perf_counter() - t0:.3f} s")
        for thread in threads:
            thread.join()
        for e in errors.values():
            raise e
        fused_resnet.load_library()
        attention.load_library()
        log(f"K2 and K4 build (nvcc, sm_90a) + load: {time.perf_counter() - t0:.3f} s -> "
            f"{built['K2'].name}, {built['K4'].name}")
        for name, lib_path in built.items():
            nvcc_report(lib_path, name)

    tot_k4_64, counts_k4_64 = path_64(dev)
    torch.cuda.empty_cache()
    tot_256, counts_256, tot_k4_256, counts_k4_256 = path_256(dev)
    torch.cuda.empty_cache()
    tot_1024, counts_1024 = path_1024(dev)

    torch.cuda.empty_cache()
    tot_k3, counts_train = path_train(dev)
    torch.cuda.empty_cache()
    with phase("new attention modules on the card"):
        path_new_modules(dev)
    with phase("K2 at the shape of the TPU cost-decomposition probes"):
        # tools/probe_kernel_anatomy*.py take the Pallas conv apart at B=4,
        # 512 x 512, 128 -> 128 channels, bf16; their Hopper counterpart is
        # still to write, so K2 itself is timed there beside its bound
        check_kernels([(4, 512, 512, (128,), 128, False, False, False, True)], [], dev,
                      "probe shape")

    totals = merge_totals(tot_256, tot_1024)
    totals["K3"] = tot_k3
    totals["K4"] = merge_totals({"K4": tot_k4_64}, {"K4": tot_k4_256})["K4"]
    launches = {k: counts_256[k] + counts_1024[k] for k in SAMPLING_KERNELS}
    launches["K3"] = counts_train["K3"]
    launches["K4"] = counts_k4_64["K4"] + counts_k4_256["K4"]
    log(f"launches during the nested matmul-route requests (256px and 1024px), K3's during "
        f"the train_256 preset's timed steps, K4's during the flash-route requests (64px "
        f"and 256px): {launches}")
    log(f"K4 over the 64px and 256px forwards' shapes: kernel {totals['K4']['ms']:.4f} ms, "
        f"matmul route {totals['K4']['matmul_ms']:.4f} ms, library "
        f"{totals['K4']['library_ms']:.4f} ms")
    log(f"chip_smoke: {time.perf_counter() - t_start:.3f} s wall in all")

    def entry(name, mode, route, source, replaces, library=True):
        t = totals[mode]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[mode], "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops_ms"] > t["bytes_ms"] else "bytes",
                "library_ms": t["library_ms"] if library else None}

    cu = "ml_mdm_tpu_torch/csrc/fused_resnet.cu"
    kernels = [
        entry("spatial_sums", "K1", "triton", "ml_mdm_tpu_torch/ops/gn_stats.py",
              "ml_mdm_tpu/ops/gn_stats.py:62", library=False),
        entry("affine_silu_conv3x3", "K2", "cuda", cu, "ml_mdm_tpu/ops/fused_resnet.py:481"),
        entry("affine_silu_conv3x3 (N operands)", "K2·N", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:515"),
        entry("affine_silu_conv3x3 (shortcut)", "K2·proj", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:284"),
        entry("affine_silu_conv3x3_vjp (backward)", "K3", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:744"),
        entry("flash_attention", "K4", "cuda", "ml_mdm_tpu_torch/csrc/flash_attention.cu",
              "ml_mdm_tpu/ops/attention.py:130"),
    ]
    print(json.dumps({"kernels": kernels}, ensure_ascii=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
