#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (ml_mdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand kernels from the sources in this checkout (K2, K4 and the
probes' kernel with nvcc, one background thread each, while Triton compiles
K1 and K3's two passes), then drives each of the port's paths with random
weights from a seed:

  1. cc12m_64x64 (``Diffusion.sample``): every kernel launch shape of a
     batch-64 forward held against its plain version and timed beside its
     bound and the library call (the shortcut's shapes also without the
     stats; K1's sums also held bitwise equal across two calls, with their
     GB/s and share of the bound); batch 4, 4 DDIM steps, kernel path against
     plain path; one batch-64 DDIM-50 request (the bench preset); one
     batch-8 request with classifier-free guidance 5; one profiled forward.
     Then the flash route (``use_flash(True)``: every self-attention of
     the U-Net through K4): K4 at every self-attention launch shape of that
     forward, on the chunked views the model hands it, held against its
     plain version and timed beside the matmul route, the library call
     (``scaled_dot_product_attention``) and the bound, with its TFLOP/s,
     its launches a request and launches x (time - bound); batch 4, flash path
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
     and the bound, and its two passes (K3·A, K3·B) held against their
     plain versions and timed; one batch-4 step's loss and gradients, kernel path
     against plain path; the ``train_256`` preset of ``bench.py`` (batch
     16, lr 5e-5, warmup 10, clip 2.0, no remat): one untimed and five
     timed steps; one profiled step; then cc12m_64x64 (``Diffusion.
     get_loss``) at batch 32 for two steps.
  5. The train_1024 preset (``presets.train_1024``: cc12m_1024x1024 with
     its thin shells packed, batch 2, selective remat): every K1, K2 and K3
     launch shape of one step held against its plain version and timed
     (packed launches beside the unpacked K2 at the same unpacked shape and
     the library's dense packed convolution; pipelined ones beside the serial
     K2); a batch-1 step, kernel path against plain path; 1 untimed and 3
     timed steps; one profiled step; then packing off (``pack_min_side`` 0)
     against on, for one forward at batch 4 and one step at batch 2.
  6. The attention modules no shipped config turns on, at a small size by
     necessity: two temporal U-Nets (frames as ``(b t)`` rows; temporal
     attention and the frame resample, and ``temporal_spatial_ds``) and a
     U-Net with a learned lm-head of two layers, one forward each with K1
     and K2 under them, against their ``use_kernels(False)`` forward.
  7. The cost-decomposition probes P1 and P2 (``ml_mdm_tpu_torch/tools/
     probe_kernel_anatomy{,2}.py``, the Hopper counterparts of the JAX
     package's ``tools/probe_kernel_anatomy*.py``; instances of K2's own
     kernel with parts of it switched off) at their one shape, B = 4,
     512 x 512, 128 channels, bf16: K2 itself there, beside its bound; the
     two probes' tables through their entry points; then each of their 16
     variants held against its plain version (the double buffers bitwise
     against their single buffers; a zero fill bitwise its variant without
     it off the cells it reaches, and on them different from it and within
     two bf16 ULPs of the plain version) and timed beside its bound, K2's
     time, its instance's ptxas line, the same products as one cuBLAS
     matmul and, for P1's 1-tap product and its copy, the one PyTorch call
     that computes the same; then K2's time split into its parts, each a
     difference of two of those rows.

Every K2 launch runs the implicit-GEMM kernel on wgmma, at 9 taps
unpacked and at the 4 combined taps packed (its ``conv_plan`` and the ptxas
line of its instance are logged beside each launch shape); the nested
models pack their thin shells as the JAX package does, so the 256px and
1024px phases launch K2·struct too, and K2·pipe wherever a packed launch
has at least two chunks of 64 channels and 1024 output tiles (the kernel
stages the next chunk under the products at every launch, so a pipelined
launch must give the serial one's y bit for bit). K3's backward runs its
data gradient through K2's identity prologue and its chain as two Triton
passes (K3·A with the stats, K3·B), each held against its plain version
and timed in the K3 phases. Before
each request or training phase every launch count is set to 0 and read
just after it; a kernel of the path that never launched fails the run, and
so does a packed mode launched on a path that packs nothing. The kernels a
path must launch are read from the launch shapes recorded on it. Every
phase that fails raises, and the script exits non-zero. It needs a CUDA
device and never falls back to the CPU. The card's name and power limit
are printed near the top; the line before the last names every kernel with
its launches (K1 and K2 during the nested matmul-route requests, K2 again
over the 64px forward's shapes with the launches of the 64px batch-64
request, K2·struct and K2·pipe during the 256px and 1024px matmul-route
requests and the train_1024 preset's timed steps,
K3 and its passes during the train_256 preset's timed steps, K4 during the
flash-route requests, P1 and P2 during the probes' tables), its error and
its times; the last line is one JSON object with "ok" and the device.
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
from typing import NamedTuple

SEED = 0
LM_LEN = 32

# tolerances (bf16 working type), each relative to max|plain|:
K1_TOL = 1e-5    # f32 sums in another order
K2_TOL = 2e-2    # two bf16 ULPs: fast exp in SiLU and sum order can flip a rounding
# a zero-filled probe cell against its plain version: 2 bf16 ULPs of the
# cell itself, plus 5e-4 max|ref| for a cell near 0, where one activation
# rounded the other way (fast exp, fused multiply-add) moves the sum by up
# to about 3e-4; the zero fill moves a cell by about 6e-3 (0.0101 sum w)
FILL_ULPS, FILL_FLOOR = 2, 5e-4
UNET_TOL = 5e-2  # those flips carried through the full U-Net (one forward)
SAMPLE_MEAN_TOL = 1e-2  # 4-step sample, mean |kernel - plain| over pixels in [-1, 1]
SAMPLE_MAX_TOL = 0.25   # 4-step sample, max |kernel - plain|
K4_TOL = 2e-2    # P and the output rounded to bf16; the JAX test of its kernel allows the same
K3_SUM_TOL = 1e-4  # K3's pass sums (da, db, dbias): the same f32 values summed in another order

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
    50 MB L2 cache overwritten before each timed run and the device then
    kept busy for ~1 ms (``torch.cuda._sleep``), so that the host has
    enqueued fn's launches before the device reaches them: the events time
    the device's work, not the host's (a kernel wrapper's host cost is the
    profiles' enqueue time)."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH[0].zero_()
        torch.cuda._sleep(2_000_000)  # cycles: ~1 ms at the H100's clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- kernel launch shapes of a path ---------------------------------------


class K2Key(NamedTuple):
    """One K2 launch shape: operand channels ``cs`` and ``cout`` as the
    kernel sees them (packed channels when ``struct``). ``silu`` False: the
    identity prologue (``conv3x3_fast``, K3's data gradient), the only way
    the port runs K2 without the SiLU."""
    b: int
    h: int
    w: int
    cs: tuple
    cout: int
    residual: bool
    stats: bool
    proj: bool
    silu: bool
    struct: bool
    pipe: bool

    def unpacked(self) -> "K2Key":
        """The same convolution at the unpacked shape (itself if unpacked)."""
        if not self.struct:
            return self
        return self._replace(h=2 * self.h, w=2 * self.w, cs=tuple(c // 4 for c in self.cs),
                             cout=self.cout // 4, struct=False)


def record_launch_shapes(run, grad: bool = False):
    """Run ``run()`` with the kernel wrappers wrapped (under ``no_grad``
    unless ``grad``), and return the distinct launch shapes it gave them:
    K2Keys and K1 keys (B, H, W, C)."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats

    k2, k1 = set(), set()
    conv, sums = fused_resnet.affine_silu_conv3x3, gn_stats.spatial_sums

    def conv_rec(x, a, b, w, bias, residual=None, **kw):
        xs = x if isinstance(x, (tuple, list)) else (x,)
        cs = tuple(xi.shape[-1] for xi in xs)
        cout = fused_resnet._kernels(w)[0].shape[-1]
        packed = bool(kw.get("packed_struct"))
        k2.add(K2Key(*xs[0].shape[:3], cs, cout,
                     residual is not None, bool(kw.get("emit_stats")),
                     kw.get("proj_kernel") is not None, kw.get("apply_silu", True),
                     packed, fused_resnet.pipelines(cs, *xs[0].shape[:3], cout,
                                                    kw.get("pipelined"), packed)))
        return conv(x, a, b, w, bias, residual, **kw)

    def sums_rec(x):
        k1.add(tuple(x.shape))
        return sums(x)

    fused_resnet.affine_silu_conv3x3, gn_stats.spatial_sums = conv_rec, sums_rec
    try:
        with contextlib.nullcontext() if grad else torch.no_grad():
            run()
        torch.cuda.synchronize()
    finally:
        fused_resnet.affine_silu_conv3x3, gn_stats.spatial_sums = conv, sums
    return sorted(k2), sorted(k1)


def k2_bound(key: K2Key):
    """(least ms, what bounds it) for one K2 launch on the H100: each input
    read once and each output written once over HBM, the convolution and
    shortcut products over the dense bf16 tensor-core peak. A packed launch
    reads against its unpacked convolution (the same bytes, 9 unpacked taps),
    so that both routes have one yardstick."""
    bsz, h, w, cs, cout, residual, stats, proj = key.unpacked()[:8]
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


def _conv_inputs(key: K2Key, dev, g):
    """Random bf16 operands and residual, f32 coefficients (None for the
    identity prologue) and bias, bf16 weights for a launch shape. Packed:
    the weights are the packed kernels of random unpacked ones in their
    combined form (as the model hands them over), and ``kw["dense"]`` keeps
    their (3, 3) form for the library call; the shortcut is the
    block-diagonal packed 1x1 kernel. Unpacked: the weights and the
    shortcut's matrices as ``K2Weights`` (sampling keeps them so), and
    ``kw["dense"]`` the plain tuple."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet
    from ml_mdm_tpu_torch.ops import space_to_depth as s2d

    bsz, h, w, cs, cout, residual = key[:6]
    m = 4 if key.struct else 1
    ct = sum(cs) // m
    bf = torch.bfloat16
    xs = tuple(torch.randn((bsz, h, w, c), generator=g, device=dev).to(bf) for c in cs)
    a = tuple(torch.randn((bsz, c), generator=g, device=dev) * 0.2 + 1.0 for c in cs)
    b = tuple(torch.randn((bsz, c), generator=g, device=dev) * 0.3 for c in cs)
    wk = tuple(torch.randn((3, 3, c // m, cout // m), generator=g, device=dev) / (9 * ct) ** 0.5
               for c in cs)
    bias = torch.randn((cout,), generator=g, device=dev) * 0.1
    res = torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf) if residual else None
    kw = {}
    if key.proj:
        pk = tuple(torch.randn((1, 1, c // m, cout // m), generator=g, device=dev) / ct ** 0.5
                   for c in cs)
        kw["proj_kernel"] = tuple((s2d.pack_conv1x1_kernel(p) if key.struct else p)[0, 0].to(bf)
                                  for p in pk)
        kw["proj_bias"] = torch.randn((cout,), generator=g, device=dev) * 0.1
    if not key.silu:
        a = b = None
    if key.struct:
        dense = tuple(s2d.pack_conv3x3_kernel(wi).to(bf) for wi in wk)
        return xs, a, b, tuple(fused_resnet.struct_weights(d) for d in dense), bias, res, \
            dict(kw, packed_struct=True, dense=dense)
    wk = tuple(wi.to(bf) for wi in wk)
    if key.proj:
        kw["proj_kernel"] = fused_resnet.K2Weights(kw["proj_kernel"])
    return xs, a, b, fused_resnet.K2Weights(wk), bias, res, dict(kw, dense=wk)


def library_conv(xs, a, b, wk, bias, res, stats, proj_kernel=None, proj_bias=None):
    """The same function from PyTorch's own calls, for timing only:
    elementwise affine + SiLU per operand (none for the identity prologue,
    a None), torch.cat, cuDNN's bf16 3x3 conv, the residual add, the stats
    sums and cuDNN's bf16 1x1 conv."""
    import torch
    import torch.nn.functional as F

    from ml_mdm_tpu_torch.ops import fused_resnet

    bf = torch.bfloat16
    if a is None:
        v = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
    else:
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
        pw = torch.cat(fused_resnet._kernels(proj_kernel), dim=0).t()[:, :, None, None].contiguous(
            memory_format=torch.channels_last)
        out.append(F.conv2d(raw, pw, proj_bias.to(bf)))
    return out


def _new_totals():
    return {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "shapes": 0,
            "serial_ms": 0.0, "unpacked_ms": 0.0, "paired_ms": 0.0}


def _add(tot, err, ms, pms, lms, bound, by, serial_ms=0.0, unpacked_ms=0.0):
    tot["err"] = max(tot["err"], err)
    tot["ms"] += ms
    tot["plain_ms"] += pms
    tot["library_ms"] += lms if lms is not None else 0.0
    tot["bound_ms"] += bound
    tot["ops_ms" if by == "operations" else "bytes_ms"] += bound
    tot["shapes"] += 1
    tot["serial_ms"] += serial_ms
    tot["unpacked_ms"] += unpacked_ms
    tot["paired_ms"] += ms if unpacked_ms else 0.0  # kernel time of the shapes beside it


K2_MODES = ("K2", "K2·N", "K2·proj", "K2·struct", "K2·pipe")


def _key_label(key: K2Key) -> str:
    return (f"B={key.b} {key.h}x{key.w} {'+'.join(map(str, key.cs))}->{key.cout}"
            f"{' residual' if key.residual else ''}{' stats' if key.stats else ''}"
            f"{' shortcut' if key.proj else ''}{'' if key.silu else ' no-silu'}"
            f"{' packed' if key.struct else ''}{' pipelined' if key.pipe else ''}")


def check_kernels(k2_keys, k1_keys, dev, label: str, reps: int = 5):
    """Each launch shape: kernel against plain version (tolerance), then
    kernel, plain and library times and the bound; a pipelined launch also
    beside the serial K2 (and y compared with it), a packed one beside the
    unpacked K2 at the same unpacked shape. Returns per-mode totals: K1, K2
    (every shape), K2·N (several operands), K2·proj (the shortcut),
    K2·struct (packed), K2·pipe (pipelined)."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tot = {m: _new_totals() for m in ("K1",) + K2_MODES}
    for key in k1_keys:
        x = (torch.randn(key, generator=g, device=dev) + 0.25).to(torch.bfloat16)
        s1, s2 = gn_stats.spatial_sums(x)
        t1, t2 = gn_stats.spatial_sums(x)
        if not (torch.equal(s1, t1) and torch.equal(s2, t2)):
            raise AssertionError(f"K1 spatial_sums {key}: two calls differ (the sums must be "
                                 "the same bit for bit)")
        p1, p2 = gn_stats.spatial_sums_plain(x)
        err = max(rel_err(s1, p1), rel_err(s2, p2))
        if not err <= K1_TOL:
            raise AssertionError(f"K1 spatial_sums {key}: rel err {err} > {K1_TOL}")
        ms = cuda_ms(lambda: gn_stats.spatial_sums(x), reps=reps)
        # the plain version, two torch.sum over the f32 upcast, is also the
        # one library call that computes these sums
        pms = cuda_ms(lambda: gn_stats.spatial_sums_plain(x), reps=3)
        bound, by = k1_bound(key)
        plan = gn_stats.plan(*key, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        log(f"{label} K1 spatial_sums {key} ({x.numel() * 2 / 2**20:.1f} MiB, {plan.splits} "
            f"spans): rel_err {err:.3e}, two calls bitwise equal, kernel {ms:.4f} ms "
            f"({x.numel() * 2 / ms / 1e6:.0f} GB/s, {bound / ms:.3f} of the bound) plain "
            f"(= library) {pms:.4f} ms bound {bound:.4f} ms ({by})")
        _add(tot["K1"], max(abs_err(s1, p1), abs_err(s2, p2)), ms, pms, pms, bound, by)
    for key in k2_keys:
        xs, a, b, wk, bias, res, kw = _conv_inputs(key, dev, g)
        dense = kw.pop("dense", wk)

        def kernel(**extra):
            return fused_resnet.affine_silu_conv3x3(xs, a, b, wk, bias, res, emit_stats=key.stats,
                                                    apply_silu=key.silu, **kw, **extra)

        def plain():
            return fused_resnet.affine_silu_conv3x3_plain(xs, a, b, wk, bias, res,
                                                          emit_stats=key.stats,
                                                          apply_silu=key.silu, **kw)

        out, ref = kernel(), plain()
        out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        errs = [rel_err(o, r) for o, r in zip(out, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"K2 {_key_label(key)}: rel errs {errs} > {K2_TOL}")
        ms = cuda_ms(kernel, reps=reps)
        pms = cuda_ms(plain, warmup=1, reps=3)
        lms = cuda_ms(lambda: library_conv(xs, a, b, dense, bias, res, key.stats,
                                           **{k: v for k, v in kw.items() if k.startswith("proj")}),
                      reps=reps)
        bound, by = k2_bound(key)
        extra, sms, ums = "", 0.0, 0.0
        p = fused_resnet.conv_plan(key.b, key.h, key.w, key.cs, key.cout, n_sms, key.proj,
                                   key.struct)
        ptxas = PTXAS.get((p.bn, p.mt, int(key.proj), int(key.struct)), "not in the build log")
        extra += (f" plan: tile {p.th}x{p.tw} N {p.bn} (m64 tiles {p.mt} a warpgroup), "
                  f"{p.stages} stages, {p.smem} B shared, grid {p.grid} over {p.tiles} tiles, "
                  f"L2 {p.l2_bytes / 2**20:.1f} MiB; ptxas {ptxas}")
        if key.pipe:
            serial = kernel(pipelined=False)
            serial = serial if isinstance(serial, tuple) else (serial,)
            diff = abs_err(out[0], serial[0])
            if diff != 0.0:  # one kernel runs both: the same bits
                raise AssertionError(f"K2 {_key_label(key)}: pipelined y differs from the serial "
                                     f"launch's by {diff}")
            sms = cuda_ms(lambda: kernel(pipelined=False), reps=reps)
            extra += f" serial K2 {sms:.4f} ms (y bitwise equal to it)"
        ukey = key.unpacked()
        if key.struct and ukey.cout % 8 == 0 and all(c % 8 == 0 for c in ukey.cs):
            uxs, ua, ub, uwk, ubias, ures, ukw = _conv_inputs(ukey, dev, g)
            ukw.pop("dense")
            ums = cuda_ms(lambda: fused_resnet.affine_silu_conv3x3(
                uxs, ua, ub, uwk, ubias, ures, emit_stats=key.stats, apply_silu=key.silu, **ukw),
                reps=reps)
            extra += f" unpacked K2 ({_key_label(ukey)}) {ums:.4f} ms"
        elif key.struct:  # the packed output layer: 3 unpacked channels, no K2 launch
            extra += " unpacked K2: no such launch"
        flops = 2 * ukey.b * ukey.h * ukey.w * sum(ukey.cs) * ukey.cout * (9 + key.proj)
        log(f"{label} K2 {_key_label(key)}: rel_errs {', '.join(f'{e:.3e}' for e in errs)} "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} unpacked TFLOP/s) plain {pms:.4f} ms "
            f"library {lms if lms is None else f'{lms:.4f}'} ms bound {bound:.4f} ms ({by})"
            + extra)
        err = max(abs_err(o, r) for o, r in zip(out, ref))
        modes = (["K2"] + (["K2·N"] if len(key.cs) > 1 else []) + (["K2·proj"] if key.proj else [])
                 + (["K2·struct"] if key.struct else []) + (["K2·pipe"] if key.pipe else []))
        for m in modes:
            _add(tot[m], err, ms, pms, lms, bound, by, sms, ums)
    # the path runs the shortcut only beside the stats (conv1): hold its
    # shapes without them too, untimed and outside the totals
    for key in k2_keys:
        if not (key.stats and key.proj):
            continue
        xs, a, b, wk, bias, res, kw = _conv_inputs(key, dev, g)
        kw.pop("dense", None)
        out = fused_resnet.affine_silu_conv3x3(xs, a, b, wk, bias, res, **kw)
        ref = fused_resnet.affine_silu_conv3x3_plain(xs, a, b, wk, bias, res, **kw)
        errs = [rel_err(o, r) for o, r in zip(out, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"K2 {_key_label(key)} without stats: rel errs {errs} > {K2_TOL}")
        log(f"{label} K2 {_key_label(key)} shortcut without stats: rel_errs "
            f"{', '.join(f'{e:.3e}' for e in errs)}")
    for m, t in tot.items():
        if t["shapes"]:
            log(f"{label} {m} over {t['shapes']} shapes: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms" + (f", serial K2 {t['serial_ms']:.4f} ms"
                                             if m == "K2·pipe" else "")
                + (f", unpacked K2 {t['unpacked_ms']:.4f} ms against {t['paired_ms']:.4f} ms packed "
                   f"at the same shapes" if m == "K2·struct" else ""))
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
    return its launch shapes, (B, Lq, Lk, H, D), each with its launches in
    the run, after checking that each operand was a strided view (a chunk
    of the qkv tensor), not a copy."""
    import torch

    from ml_mdm_tpu_torch.ops import attention

    keys = {}
    flash = attention.flash_attention

    def rec(q, k, v):
        if q.is_contiguous() or k.is_contiguous() or v.is_contiguous():
            raise AssertionError("K4 was handed a contiguous copy, not the qkv chunks")
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3])
        keys[key] = keys.get(key, 0) + 1
        return flash(q, k, v)

    attention.flash_attention = rec
    try:
        with torch.no_grad(), flash_route():
            run()
        torch.cuda.synchronize()
    finally:
        attention.flash_attention = flash
    return dict(sorted(keys.items()))


def k4_bound(key):
    """(least ms, what bounds it) for one K4 launch on the H100: the two
    products' 4 B H Lq Lk D FLOPs over the dense bf16 tensor-core peak, or
    q, k, v read once and the output written once over HBM."""
    bsz, lq, lk, heads, d = key
    t_ops = 4 * bsz * heads * lq * lk * d / PEAK_BF16_TENSOR
    t_bytes = 2 * bsz * heads * d * (2 * lq + 2 * lk) / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def check_k4(keys, dev, label: str, steps: int):
    """Each launch shape (``keys``: shape -> launches in one forward), on
    the chunks of one (B, L, 3 H D) tensor as the model hands them over:
    K4 against its plain version (K4_TOL of max|plain|), then K4's time,
    TFLOP/s and share of the bound beside the plain version's time, the
    matmul route's (what the flag replaces), the library call's
    (``scaled_dot_product_attention`` on the same views, timed only), and
    the launches of a request of ``steps`` steps with launches x (time -
    bound). Returns the totals."""
    import torch
    import torch.nn.functional as F

    from ml_mdm_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    tot = _new_totals()
    tot["matmul_ms"] = tot["excess_ms"] = 0.0
    for key, per_forward in keys.items():
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
        launches = per_forward * steps
        log(f"{label} K4 B={bsz} L={lq} H={heads} D={d}: rel_err {err:.3e} (the matmul route's "
            f"against the same plain version: {route_err:.3e}) kernel {ms:.4f} ms "
            f"({tflops:.1f} TFLOP/s, {bound / ms:.3f} of the bound) plain {pms:.4f} ms matmul "
            f"route {mms:.4f} ms library {lms:.4f} ms ({ms / lms:.3f}x) bound {bound:.4f} ms "
            f"({by}); {launches} launches a request ({per_forward} a forward x {steps} steps), "
            f"launches x (kernel - bound) {launches * (ms - bound):.3f} ms")
        _add(tot, abs_err(out, ref), ms, pms, lms, bound, by)
        tot["matmul_ms"] += mms
        tot["excess_ms"] += launches * (ms - bound)
    log(f"{label} K4 over {tot['shapes']} shapes: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, matmul route {tot['matmul_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms ({tot['ms'] / tot['library_ms']:.3f}x), bound "
        f"{tot['bound_ms']:.4f} ms; launches x (kernel - bound) a request "
        f"{tot['excess_ms']:.3f} ms")
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


# the kernels a path must launch: the 64px model never packs, so its
# paths launch only the unpacked K2 (no K2·struct, no K2·pipe); the nested
# paths add the packed modes their recorded launch shapes have (``modes``)
SAMPLING_KERNELS = ("K1", "K2", "K2·N", "K2·proj")
FLASH_KERNELS = SAMPLING_KERNELS + ("K4",)
TRAINING_KERNELS = ("K1", "K2", "K3", "K3·A", "K3·B")
PACKED_MODES = ("K2·struct", "K2·pipe")


def modes(k2_keys):
    """The packed modes among recorded K2 launch shapes."""
    return tuple(m for m, on in (("K2·struct", any(k.struct for k in k2_keys)),
                                 ("K2·pipe", any(k.pipe for k in k2_keys))) if on)


def reset_counts():
    from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats, kernel_anatomy
    # fused_resnet's reset also sets K3's passes (ops/k3_passes.py) to 0

    gn_stats.launch_count = 0
    attention.launch_count = 0
    fused_resnet.reset_launch_counts()
    kernel_anatomy.reset_launch_counts()


def read_counts(what: str, required=SAMPLING_KERNELS):
    """The launch counts since reset_counts(); fails if a kernel of the path
    (``required``) never launched, or a packed mode not in ``required``
    launched (a path that packs nothing runs every K2 launch on the unpacked
    kernel)."""
    from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats, k3_passes, kernel_anatomy

    counts = {"K1": gn_stats.launch_count, **fused_resnet.launch_counts,
              **k3_passes.launch_counts, "K4": attention.launch_count,
              **kernel_anatomy.launch_counts}
    log(f"launches during {what}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels of the path never launched: {missing}")
    stray = [k for k in PACKED_MODES if k not in required and counts[k]]
    if stray or counts["K2·pipe"] > counts["K2·struct"]:
        raise AssertionError(f"{what}: packed modes launched off the packed shapes: "
                             f"{[(k, counts[k]) for k in PACKED_MODES]}")
    if "K4" not in required and counts["K4"]:
        raise AssertionError(f"{what}: K4 launched {counts['K4']} times off the flash route")
    return counts


def run_requests(pipe, dev, what: str, n: int, batch: int, side: int, cond, gen,
                 flash: bool = False, required=None, **kw):
    """n timed sampling requests between a count reset and a count read;
    returns (counts, outputs). ``required``: the kernels of the path
    (default: the flagship's). With ``flash`` they run on the flash route,
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
    if required is None:
        required = FLASH_KERNELS if flash else SAMPLING_KERNELS
    counts = read_counts(what, required + (("K4",) if flash and "K4" not in required else ()))
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
        return ms, None, None
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
    return ms, busy / 1e3, window / 1e3


# -- the paths --------------------------------------------------------------


def path_64(dev):
    import torch

    from ml_mdm_tpu_torch.presets import flagship_64px

    with phase("64px: build and kernel shapes"):
        pipe, lm_dim, side = flagship_64px(dev, seed=SEED)
        n_params = sum(p.numel() for p in pipe.vision_module.parameters())
        log(f"cc12m_64x64 built on {dev}: {n_params} parameters (bf16)")
        k2_keys, k1_keys = record_launch_shapes(forward_inputs(pipe, dev, 64, side, lm_dim))
        if modes(k2_keys):
            raise AssertionError(f"64px: packed launch shapes {modes(k2_keys)}")
        tot_64 = check_kernels(k2_keys, k1_keys, dev, "64px")
    with phase("64px: kernel path vs plain path"):
        kernel_vs_plain(pipe, dev, lm_dim, side, "64px")
    bench = dict(num_inference_steps=50, resample_steps=True, ddim_eta=0.0)
    with phase("64px: one batch-64 DDIM-50 request, matmul route"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        cond = text_conditioning(dev, 64, lm_dim, gen)
        counts_64, outs = run_requests(pipe, dev, "64px", 1, 64, side, cond, gen, **bench)
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
            f"batch-64 forward (B, Lq, Lk, H, D) and their launches: {k4_keys}")
        totals = check_k4(k4_keys, dev, "64px", bench["num_inference_steps"])
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
    return totals, counts, tot_64, counts_64


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
        required = SAMPLING_KERNELS + modes(k2_keys)
        log(f"256px: the request's forward launches {required}")
        totals = check_kernels(k2_keys, k1_keys, dev, "256px")
    with phase("256px: kernel path vs plain path"):
        kernel_vs_plain(pipe, dev, lm_dim, side, "256px", batch=2)
    with phase("256px: two requests, batch 4, guidance 7.5, DDIM-50"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        cond = text_conditioning(dev, 2 * batch, lm_dim, gen)
        counts, outs = run_requests(pipe, dev, "256px", 2, batch, side, cond, gen,
                                    required=required, num_inference_steps=50,
                                    resample_steps=True, ddim_eta=0.0, guidance_scale=guidance)
        for i, out in enumerate(outs):
            check_images(out, (batch, side, side, 3), f"256px request {i}")
    with phase("256px: profile"):
        forward = forward_inputs(pipe, dev, 2 * batch, side, lm_dim)
        profile_forward(forward, "256px B=8")
    with phase("256px flash route: K4 at the forward's shapes, one request"):
        k4_keys = record_k4_shapes(forward)
        log(f"K4 launch shapes of the 256px request's forward (B, Lq, Lk, H, D) and their "
            f"launches: {k4_keys}")
        totals_k4 = check_k4(k4_keys, dev, "256px", 50)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        counts_k4, outs = run_requests(pipe, dev, "256px flash", 1, batch, side, cond, gen,
                                       flash=True, required=required + ("K4",),
                                       num_inference_steps=50, resample_steps=True,
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
        if not any(k.struct and k.w == side // 2 for k in k2_keys):
            raise AssertionError("K2·struct never launched on the packed 1024px shell (W = 512)")
        required = SAMPLING_KERNELS + modes(k2_keys)
        log(f"1024px: the request's forward launches {required}")
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
                                    gen, required=required, num_inference_steps=steps,
                                    resample_steps=True, ddim_eta=1.0)
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
    return its distinct launch shapes: (B, H, W, C, Cout, residual, stats,
    packed)."""
    from ml_mdm_tpu_torch.ops import fused_resnet

    keys = set()
    vjp = fused_resnet.affine_silu_conv3x3_vjp

    def rec(x, a, b, w, bias, residual=None, **kw):
        keys.add((*x.shape, w.shape[-1], residual is not None, bool(kw.get("emit_stats")),
                  bool(kw.get("packed_struct"))))
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
    the (B, C) vectors. A packed launch reads against its unpacked
    convolution."""
    bsz, h, w, c, cout, residual, stats, struct = key
    px = bsz * h * w
    if struct:  # the same bytes; the unpacked channels and taps
        c, cout = c // 4, cout // 4
        px *= 4
    flops = 4 * px * 9 * c * cout
    nbytes = (2 * px * c * 2 + 2 * px * cout * (1 + stats) + 2 * 4 * 9 * c * cout
              + 4 * 4 * bsz * c + 4 * cout + (2 * 4 * bsz * cout if stats else 0))
    t_ops, t_bytes = flops / PEAK_BF16_TENSOR, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _k3_inputs(key, dev, g):
    """bf16 x, residual and dy; f32 coefficients, weights (as training holds
    them; packed: the unpacked kernel, packed inside the call), bias and
    stats cotangents."""
    import torch

    bsz, h, w, c, cout, residual, stats, struct = key
    m = 4 if struct else 1
    bf = torch.bfloat16
    ins = [torch.randn((bsz, h, w, c), generator=g, device=dev).to(bf),
           torch.randn((bsz, c), generator=g, device=dev) * 0.2 + 1.0,
           torch.randn((bsz, c), generator=g, device=dev) * 0.3,
           torch.randn((3, 3, c // m, cout // m), generator=g, device=dev) / (9 * c // m) ** 0.5,
           torch.randn((cout,), generator=g, device=dev) * 0.1,
           torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf) if residual else None]
    cots = [torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf)]
    if stats:
        cots += [torch.randn((bsz, cout), generator=g, device=dev) * 1e-3,
                 torch.randn((bsz, cout), generator=g, device=dev) * 1e-4]
    return ins, cots


def _backward_of(fn, ins, cots, stats, struct):
    """One forward through fn; returns a closure that runs its backward
    (the graph is kept, so it can run again) and returns the gradients of
    x, a, b, w, bias and the residual. Packed, w is the unpacked kernel,
    packed inside, so its gradient is the unpacked one."""
    import torch

    from ml_mdm_tpu_torch.ops import space_to_depth as s2d

    leaves = [t.detach().requires_grad_(True) if t is not None else None for t in ins]
    args = list(leaves)
    if struct:
        args[3] = s2d.pack_conv3x3_kernel(leaves[3])
    out = fn(*args, emit_stats=stats, packed_struct=struct)
    outs = out if stats else (out,)
    targets = [t for t in leaves if t is not None]
    return lambda: torch.autograd.grad(outs, targets, cots, retain_graph=True), outs


def library_k3_backward(x, a, b, w16, dy, y=None, ds1=None, ds2=None):
    """K3's backward with cuDNN's bf16 dgrad in place of K2 (and cuDNN's
    wgrad, as K3 has; packed: both on the dense packed kernel), for timing
    only."""
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


def pass_bound(px: int, c: int, bsz: int, a_pass: bool):
    """(least ms, what bounds it) for one of K3's passes over px pixels of c
    channels: pass A reads dy and y (bf16) and writes dy', pass B reads x and
    the data gradient and writes dx and the activation, each with its (B, C)
    f32 vectors; about 6 (A) or 16 (B) f32 operations an element outside
    the tensor cores."""
    nbytes = 2 * px * c * (3 if a_pass else 4) + 4 * bsz * c * (3 if a_pass else 4)
    t_bytes, t_ops = nbytes / PEAK_HBM, px * c * (6 if a_pass else 16) / PEAK_F32
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def check_passes(key, ins, cots, y, dev, g, tot_a, tot_b):
    """K3's passes at one K3 launch shape: each against its plain version
    (dy', dx and the activation within K2_TOL, the sums within K3_SUM_TOL,
    the sums the same bits in two calls), then timed beside its plain
    version and its bound. Returns a log fragment."""
    import torch

    from ml_mdm_tpu_torch.ops import k3_passes

    bsz, h, w, c, cout, _, stats, _ = key
    x, a, b = ins[:3]
    ds = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    out = []
    for name, tot, run, plain, sums, ch in (
            ("pass A", tot_a, lambda: k3_passes.fold(cots[0], y, cots[1], cots[2]),
             lambda: k3_passes.fold_plain(cots[0], y, cots[1], cots[2]), (1,), cout),
            ("pass B", tot_b, lambda: k3_passes.chain(x, ds, a, b),
             lambda: k3_passes.chain_plain(x, ds, a, b), (2, 3), c)):
        if name == "pass A" and not stats:
            continue
        got, again, ref = run(), run(), plain()
        errs = [rel_err(o, r) for o, r in zip(got, ref)]
        if not all(e <= (K3_SUM_TOL if i in sums else K2_TOL) for i, e in enumerate(errs)):
            raise AssertionError(f"K3 {name} {key}: rel errs {errs}")
        if not all(torch.equal(got[i], again[i]) for i in sums):
            raise AssertionError(f"K3 {name} {key}: two calls give other sums")
        ms = cuda_ms(run)
        pms = cuda_ms(plain, warmup=1, reps=3)
        bound, by = pass_bound(bsz * h * w, ch, bsz, name == "pass A")
        _add(tot, max(abs_err(o, r) for o, r in zip(got, ref)), ms, pms, None, bound, by)
        out.append(f"{name} {ms:.4f} ms (plain {pms:.4f} ms, bound {bound:.4f} ms, {by}; "
                   f"rel errs {', '.join(f'{e:.2e}' for e in errs)}, sums bitwise equal)")
    return "; ".join(out)


def check_k3(keys, dev, label: str = "256px train"):
    """Each K3 launch shape: the Function's backward against autograd of the
    plain version (K2_TOL), then the backward's time, the plain
    backward's, the library's, the weight re-layout's and the bound; its two
    passes alone (``check_passes``). At a packed shape also the weight
    gradient's four products alone (kept in f32). Returns the totals of
    K3 and of its passes K3·A and K3·B."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet
    from ml_mdm_tpu_torch.ops import space_to_depth as s2d

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    tot, tot_a, tot_b = _new_totals(), _new_totals(), _new_totals()
    relayout_ms = 0.0
    packed = dict.fromkeys(("shapes", "ms", "dw_ms"), 0.0)
    for key in keys:
        bsz, h, w, c, cout, residual, stats, struct = key
        ins, cots = _k3_inputs(key, dev, g)
        kernel, outs = _backward_of(fused_resnet.affine_silu_conv3x3_vjp, ins, cots, stats, struct)
        plain, _ = _backward_of(fused_resnet.affine_silu_conv3x3_plain, ins, cots, stats, struct)
        got, ref = kernel(), plain()
        errs = [rel_err(o, r) for o, r in zip(got, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"K3 {key}: rel errs {errs} > {K2_TOL}")
        ms = cuda_ms(kernel)
        pms = cuda_ms(plain, warmup=1, reps=3)
        wf = s2d.pack_conv3x3_kernel(ins[3]) if struct else ins[3]
        w16 = wf.to(torch.bfloat16)
        extra = (outs[0].detach(), *cots[1:]) if stats else ()
        lms = cuda_ms(lambda: library_k3_backward(ins[0], ins[1], ins[2], w16, cots[0], *extra))
        # the data gradient's weights as K2's wrapper lays them out per call
        wt = wf.flip(0, 1).transpose(2, 3)
        rms = cuda_ms(lambda: fused_resnet.conv_weight_layout((wt,), struct))
        relayout_ms += rms
        bound, by = k3_bound(key)
        flops = 4 * bsz * h * w * 9 * c * cout / (4 if struct else 1)
        extra = ""
        if struct:
            v = ins[0].float() * ins[1][:, None, None, :] + ins[2][:, None, None, :]
            s16, dy16 = (v * torch.sigmoid(v)).to(torch.bfloat16), cots[0]
            dw_ms = cuda_ms(lambda: fused_resnet.struct_wgrad(s16, dy16))
            for k, t in (("shapes", 1), ("ms", ms), ("dw_ms", dw_ms)):
                packed[k] += t
            extra = f" dw products {dw_ms:.4f} ms"
        extra += "; " + check_passes(key, ins, cots, outs[0].detach() if stats else None, dev, g,
                                     tot_a, tot_b)
        log(f"{label} K3 B={bsz} {h}x{w} {c}->{cout}{' residual' if residual else ''}"
            f"{' stats' if stats else ''}{' packed' if struct else ''}: rel_errs (dx, da, db, "
            f"dw, dbias{', dres' if residual else ''}) {', '.join(f'{e:.3e}' for e in errs)} "
            f"backward {ms:.4f} ms ({flops / ms / 1e9:.1f} unpacked TFLOP/s) plain {pms:.4f} ms "
            f"library {lms:.4f} ms weight re-layout {rms:.4f} ms bound {bound:.4f} ms ({by})"
            + extra)
        _add(tot, max(abs_err(o, r) for o, r in zip(got, ref)), ms, pms, lms, bound, by)
    log(f"{label} K3 over {tot['shapes']} shapes: backward {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms; the data gradient's weight re-layout {relayout_ms:.4f} ms")
    if packed["shapes"]:
        log(f"{label} K3 over its {packed['shapes']:.0f} packed shapes: backward {packed['ms']:.4f} "
            f"ms, the weight gradient's f32 products alone {packed['dw_ms']:.4f} ms")
    for name, t in (("pass A (fold)", tot_a), ("pass B (chain)", tot_b)):
        log(f"{label} K3 {name} over {t['shapes']} shapes: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    return {"K3": tot, "K3·A": tot_a, "K3·B": tot_b}


def train_batch(dev, rows: int, side: int, lm_dim: int, gen):
    """Random images in [-1, 1] (f32, as a reader gives them) and text."""
    import torch

    images = torch.rand((rows, side, side, 3), generator=gen, device=dev) * 2.0 - 1.0
    return {"images": images, **text_conditioning(dev, rows, lm_dim, gen)}


def flat_grads(unet):
    import torch

    return torch.cat([p.grad.flatten() for p in unet.parameters() if p.grad is not None])


def train_kernel_vs_plain(pipe, dev, lm_dim: int, side: int, batch: int = 4,
                          label: str = "256px train"):
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
    log(f"{label}, kernel vs plain path, one step B={batch}: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {l_err:.4e}, tol 1e-2); grad norm {float(gk.norm()):.6f} vs {float(gp.norm()):.6f} "
        f"(rel {n_err:.4e}, tol 5e-2); cosine {cos:.6f} (>= 0.99)")
    if not (l_err <= 1e-2 and n_err <= 5e-2 and cos >= 0.99 and torch.isfinite(gk).all()):
        raise AssertionError(f"{label}: kernel path disagrees with plain path")


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


def profile_train_step(step, state, pipe, dev, batch: int, side: int, lm_dim: int, gen,
                       label: str = "256px train"):
    """One training step under the profiler: the device's busy and idle
    share, the top device time by kernel, and the device time of K3's
    backward split into its data gradient (K2 and the weights' layout), its
    weight gradient, its two passes (the chain) and the rest, and of Adam
    and the EMA."""
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
        log(f"{label} profile: the profiler recorded no device time")
        return None, None
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
    log(f"{label} profile, one step B={batch}: device busy {busy / 1e3:.3f} ms of a "
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

    def name_us(*names):
        """Device time of the kernels whose names contain one of ``names``."""
        return sum(tot for name, (tot, _) in by_name.items() if any(n in name for n in names))

    # the ranges hold the kernels launched through the CUDA runtime; K3's
    # Triton passes (launched by Triton's own launcher) the profiler attributes to
    # their ranges only in part, so they are counted by name, and the chain
    # (the passes and their partial sums) lies between the larger of the two
    # and their sum
    parts = {"K3 backward (the range)": range_us("K3 backward"),
             "K3 data gradient (K2 and its weight layout)": range_us("K3 dx (K2)"),
             "K3 weight gradient (cuDNN or struct_wgrad)": range_us("K3 dw (library)"),
             "K3 pass ranges A and B (partial sums, attributed launches)":
                 range_us("K3 pass A (fold)") + range_us("K3 pass B (chain)"),
             "K3 pass A (fold, Triton, by name)": name_us("k3_fold_kernel"),
             "K3 pass B (chain, Triton, by name)": name_us("k3_chain_kernel"),
             "Adam": range_us("trainer: Adam"), "EMA": range_us("trainer: EMA"),
             "K2 kernels, forward and backward (by name)": name_us("conv3x3_wgmma_kernel")}
    parts["K3 chain, at most (the Triton passes and the pass ranges)"] = (
        parts["K3 pass A (fold, Triton, by name)"] + parts["K3 pass B (chain, Triton, by name)"]
        + parts["K3 pass ranges A and B (partial sums, attributed launches)"])
    for name, us in parts.items():
        log(f"  {name}: {us / 1e3:.3f} ms device, {100 * us / busy:.1f}% of busy")
    return busy / 1e3, window / 1e3


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

        k3_box = []
        k2_keys, _ = record_launch_shapes(lambda: k3_box.append(record_k3_shapes(one_backward)),
                                          grad=True)
        keys = k3_box[0]
        required = TRAINING_KERNELS + modes(k2_keys)
        log(f"256px train: a step launches {required}")
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
        counts = read_counts("the train_256 preset's timed steps", required)
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


# -- 1024px training: the train_1024 preset ----------------------------------------


def set_packing(unet, pack_min_side: int) -> None:
    """Set ``pack_min_side`` of a built model (0: packing off): the plan
    reads the configs, each stage its own field."""
    from ml_mdm_tpu_torch.models.layers import ResNetBlockStage
    from ml_mdm_tpu_torch.presets import set_pack_min_side

    set_pack_min_side(unet.config, pack_min_side)
    for m in unet.modules():
        if isinstance(m, ResNetBlockStage):
            m.pack_min_side = pack_min_side


def level_plans(unet, side: int):
    """The pack plan of every level of a nested U-Net, outermost first."""
    import torch

    plans, m = [], unet
    while m is not None:
        plans.append(m._pack_plan(torch.zeros((1, side, side, 3))))
        side //= 2 ** (len(m.config.resolution_channels) - 1)
        m = getattr(m, "inner_unet", None)
    return plans


def packed_vs_unpacked(pipe, state, step, dev, lm_dim: int, side: int, gen):
    """pack_min_side 0 against the default on the same weights: one forward
    at batch 4 (eval mode) and one training step at batch 2, each timed and
    profiled, in the order packed, unpacked, unpacked, packed; the two
    routes' forward outputs and loss and gradients compared."""
    import torch

    unet = pipe.vision_module
    packed_at = unet.config.pack_min_side  # 512, the configs' own
    routes = (("packed", packed_at), ("unpacked", 0))
    unet.eval()
    fwd = forward_inputs(pipe, dev, 4, side, lm_dim)
    outs, times = {}, {name: [] for name, _ in routes}
    with torch.no_grad():
        for name, value in routes + routes[::-1]:
            set_packing(unet, value)
            outs[name] = fwd()
            times[name].append(cuda_ms(fwd, warmup=1, reps=3))
    busy = {}
    for name, value in routes:
        set_packing(unet, value)
        _, busy[name], _ = profile_forward(fwd, f"1024px B=4 forward, {name}")
    err = max(rel_err(a, b) for a, b in zip(outs["packed"], outs["unpacked"]))
    log(f"1024px B=4 forward, packed against unpacked (NVIDIA H100): "
        + "; ".join(f"{n} {times[n][0]:.3f} / {times[n][1]:.3f} ms (CUDA events, median of 3), "
                    f"device busy {busy[n] if busy[n] is None else f'{busy[n]:.3f}'} ms"
                    for n, _ in routes)
        + f"; rel err between the routes {err:.4e} (tol 5e-2)")
    if not err <= 5e-2:
        raise AssertionError("1024px forward: the packed route disagrees with the unpacked one")
    del outs, fwd
    unet.train()
    data = {k: v.to(torch.bfloat16) for k, v in train_batch(dev, 2, side, lm_dim, gen).items()}
    time_ = torch.randint(0, 1000, (2,), generator=gen, device=dev)
    eps = [n.to(torch.bfloat16) for n in pipe.get_noise(2, side, gen)]
    grads = {}
    for name, value in routes:
        set_packing(unet, value)
        unet.zero_grad(set_to_none=True)
        loss = pipe.get_loss(data, time=time_, eps=eps)[0].mean()
        loss.backward()
        grads[name] = (float(loss.detach()), flat_grads(unet))
        unet.zero_grad(set_to_none=True)
    (lp, gp), (lu, gu) = grads["packed"], grads["unpacked"]
    l_err = abs(lp - lu) / abs(lu)
    n_err = abs(float(gp.norm()) - float(gu.norm())) / float(gu.norm())
    cos = float(torch.nn.functional.cosine_similarity(gp, gu, dim=0))
    del grads, gp, gu
    step_s = {name: [] for name, _ in routes}
    for name, value in routes + routes[::-1]:
        set_packing(unet, value)
        step_s[name] += run_train_steps(step, state, pipe, dev, f"1024px train, {name}", 1, 2,
                                        side, lm_dim, gen)
    step_busy = {}
    for name, value in routes:
        set_packing(unet, value)
        step_busy[name], _ = profile_train_step(step, state, pipe, dev, 2, side, lm_dim, gen,
                                                f"1024px train, {name}")
    set_packing(unet, packed_at)
    log(f"1024px train step B=2, packed against unpacked (NVIDIA H100): "
        + "; ".join(f"{n} {step_s[n][0]:.4f} / {step_s[n][1]:.4f} s (host clock), device busy "
                    f"{step_busy[n] if step_busy[n] is None else f'{step_busy[n]:.3f}'} ms"
                    for n, _ in routes)
        + f"; loss rel err {l_err:.4e}, grad norm rel err {n_err:.4e} (tol 5e-2), "
        f"gradient cosine {cos:.6f}")
    if not (l_err <= 5e-2 and n_err <= 5e-2 and cos >= 0.99):
        raise AssertionError("1024px train: the packed route disagrees with the unpacked one")


def path_train_1024(dev):
    """The train_1024 preset (cc12m_1024x1024, batch 2, selective remat):
    every kernel launch shape of one step held against its plain version and
    timed; a batch-1 step, kernel path against plain path; 1 untimed and 3
    timed steps; one profiled step; packed against unpacked. Returns (the K2
    totals of the step's shapes, K3's, the launch counts of the timed
    steps)."""
    import gc

    import torch

    from ml_mdm_tpu_torch import trainer
    from ml_mdm_tpu_torch.presets import train_1024

    with phase("1024px train: build, kernel shapes of one step"):
        preset = train_1024(dev, seed=SEED)
        pipe, cfg, batch, lm_dim, side = (preset.pipeline, preset.config, preset.batch,
                                          preset.lm_dim, preset.side)
        unet = pipe.vision_module
        n_params = sum(p.numel() for p in unet.parameters())
        log(f"train_1024 built on {dev}: cc12m_1024x1024, {n_params} parameters "
            f"({next(unet.parameters()).dtype}), compute {unet.dtype}, batch {batch}, text "
            f"({preset.lm_len}, {lm_dim}), {cfg}; pack plans per level {level_plans(unet, side)}")
        trainer.set_remat(unet, cfg.remat_save_conv_max_side)  # as the step sets it
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)
        data = {k: v.to(torch.bfloat16)
                for k, v in train_batch(dev, batch, side, lm_dim, gen).items()}

        def one_backward():
            unet.zero_grad(set_to_none=True)
            pipe.get_loss(data, gen)[0].mean().backward()

        k3_box = []
        reset_counts()
        k2_keys, k1_keys = record_launch_shapes(
            lambda: k3_box.append(record_k3_shapes(one_backward)), grad=True)
        required = TRAINING_KERNELS + modes(k2_keys)
        read_counts("one train_1024 loss and backward (the recorded step)", required)
        k3_keys = k3_box[0]
        unet.zero_grad(set_to_none=True)
        del data
        log(f"{len(k2_keys)} K2 launch shapes ({sum(k.struct for k in k2_keys)} packed, "
            f"{sum(k.pipe for k in k2_keys)} pipelined), {len(k1_keys)} K1, {len(k3_keys)} K3 "
            f"({sum(k[-1] for k in k3_keys)} packed)")
        tot = check_kernels(k2_keys, k1_keys, dev, "1024px train", reps=3)
        tot_k3 = check_k3(k3_keys, dev, "1024px train")
    with phase("1024px train: kernel path vs plain path, batch 1"):
        train_kernel_vs_plain(pipe, dev, lm_dim, side, batch=1, label="1024px train")
    with phase("1024px train: the train_1024 preset, 1 untimed and 3 timed steps"):
        state = trainer.TrainState.create(unet)
        step = trainer.make_train_step(pipe, cfg)
        run_train_steps(step, state, pipe, dev, "1024px train", 1, batch, side, lm_dim, gen,
                        timed=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        times = run_train_steps(step, state, pipe, dev, "1024px train", 3, batch, side, lm_dim,
                                gen)
        counts = read_counts("the train_1024 preset's timed steps", required)
        dt = sum(times) / len(times)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"1024px train (batch {batch}; 1024px, 256px and 64px levels, remat above side "
            f"{cfg.remat_save_conv_max_side}): {1 / dt:.4f} steps/s, {batch / dt:.4f} images/s "
            f"(mean of 3 steps); peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    with phase("1024px train: profile one step"):
        profile_train_step(step, state, pipe, dev, batch, side, lm_dim, gen, "1024px train")
    with phase("1024px: packed against unpacked (forward B=4, train step B=2)"):
        packed_vs_unpacked(pipe, state, step, dev, lm_dim, side, gen)
    del pipe, unet, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return tot, tot_k3, counts


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


# -- the cost-decomposition probes P1 and P2 ------------------------------------

def probe_bound(v, shape):
    """(least ms, what bounds it) for one probe variant over x of ``shape``
    (B, H, W, C) on the H100: x read once, the weights read once and y
    written once over HBM, the products 2 B H W C^2 n over the dense bf16
    peak. The halo rows are rows of x, so they add nothing: that the tiling
    reads them twice is the kernel's cost (``halo_reread_ms``), not the
    function's."""
    bsz, h, w, c = shape
    px = bsz * h * w
    nbytes = 2 * px * c * 2 + 2 * v.n_taps * c * c
    t_ops, t_bytes = 2 * px * c * c * v.n_taps / PEAK_BF16_TENSOR, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def halo_reread_ms(shape) -> float:
    """The ms at the memory rate of reading the two halo rows of every band
    of ``kernel_anatomy.TH`` rows once more: what ``halos`` adds to a P2
    launch (every tile reads its halo rows inside a band either way)."""
    from ml_mdm_tpu_torch.ops import kernel_anatomy

    bsz, h, w, c = shape
    return 1e3 * 2 * bsz * h * w * c * 2 / kernel_anatomy.TH / PEAK_HBM


def bf16_ulp_excess(got, ref) -> float:
    """max over cells of |got - ref| / (FILL_ULPS bf16 ULPs of the cell's
    own magnitude + FILL_FLOOR max|ref|): 1 or less passes."""
    import torch

    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - r).abs() / (FILL_ULPS * ulp + FILL_FLOOR * r.abs().max())).max())


def check_fill(label, v, got, twin, x, w):
    """A zero-filling variant ``v`` (output ``got``) against ``twin``, the
    output of its variant without the zero fill and the double buffer:
    bitwise equal off ``kernel_anatomy.fill_cells``, different on them, and
    there each of the two within FILL_ULPS of its plain version."""
    import torch

    from ml_mdm_tpu_torch.ops import kernel_anatomy as ka

    fill = ka.fill_cells(v, *x.shape[1:3]).to(x.device)
    if torch.equal(got[:, fill], twin[:, fill]):
        raise AssertionError(f"probe {label}: the zero fill changes no cell it reaches")
    base = v._replace(zero=False, dbuf=False)
    excess = max(bf16_ulp_excess(out[:, fill], ka.anatomy_plain(x, w, u)[:, fill])
                 for out, u in ((got, v), (twin, base)))
    if not excess <= 1:
        raise AssertionError(f"probe {label}: on the cells the zero fill reaches, {excess:.3f} "
                             f"times the tolerance of {FILL_ULPS} bf16 ULPs from the plain version")
    return excess


def path_probes(dev, k2_ms: float):
    """The two probes' tables through their entry points (at their modules'
    shape, B = 4, 512 x 512, 128 channels, bf16) between a count reset and a
    count read, then each variant at that shape against its plain version
    (K2_TOL; a double buffer bitwise against its single buffer) and timed
    beside its bound, K2's time ``k2_ms``, its instance's ptxas line and the
    same products as one cuBLAS matmul of (B H W, C) by (C, n C), the
    products' yardstick (no PyTorch call computes a probe); then K2's split
    (``probe_split``). Returns per-probe totals and the launch counts of the
    tables."""
    import torch

    from ml_mdm_tpu_torch.ops import kernel_anatomy as ka
    from ml_mdm_tpu_torch.tools import probe_kernel_anatomy, probe_kernel_anatomy2

    shape = (probe_kernel_anatomy.B, probe_kernel_anatomy.H, probe_kernel_anatomy.W,
             probe_kernel_anatomy.C)
    log(f"probes: K2's instance <{ka.BN}, {ka.MT}> at {shape}: {ka.probe_plan(*shape)} "
        f"({ka.probe_plan(*shape, n_taps=0)} with 0 taps)")

    with phase("probes P1 and P2: the two tables through their entry points"):
        reset_counts()
        probe_kernel_anatomy.main(n=10)
        probe_kernel_anatomy2.main(n=10)
        torch.cuda.synchronize()
        counts = read_counts("the probes' tables", ("P1", "P2"))
    tot = {"P1": _new_totals(), "P2": _new_totals()}
    cublas_ms = {"P1": 0.0, "P2": 0.0}
    library_kernel_ms = {"P1": 0.0, "P2": 0.0}
    labels = [label for label, _ in ka.P1_ROWS + ka.P2_ROWS]
    times = {}
    with phase("probes P1 and P2: each variant against its plain version, timed"):
        outs = {}
        for label, v in zip(labels, ka.VARIANTS):
            x, w = probe_kernel_anatomy.inputs(v.n_taps)
            got, ref = ka.anatomy(x, w, v), ka.anatomy_plain(x, w, v)
            err = rel_err(got, ref)
            if not err <= K2_TOL:
                raise AssertionError(f"probe {label} {v}: rel err {err} > {K2_TOL}")
            outs[v] = got
            extra = ""
            if v.dbuf or v.zero:
                # bitwise the variant without the double buffer where one is
                # a row of the probe, else without the zero fill too, on the
                # cells that the zero fill does not reach
                twin = v._replace(dbuf=False)
                twin = twin if twin in outs and twin != v else twin._replace(zero=False)
                same = torch.ones(x.shape[1:3], dtype=torch.bool, device=dev)
                if v.zero != twin.zero:
                    same = ~ka.fill_cells(v, *x.shape[1:3]).to(dev)
                if not torch.equal(got[:, same], outs[twin][:, same]):
                    raise AssertionError(f"probe {label}: differs from {twin} where the zero "
                                         f"fill does not reach")
                extra = f" bitwise equal to {labels[ka.VARIANTS.index(twin)]!r}"
                if v.zero and not twin.zero:
                    excess = check_fill(label, v, got, outs[twin], x, w)
                    extra += (f" off the zero-filled cells, differs on them, and there "
                              f"{excess:.3f} of the {FILL_ULPS}-ULP tolerance from plain")
            ms = cuda_ms(lambda: ka.anatomy(x, w, v))
            pms = cuda_ms(lambda: ka.anatomy_plain(x, w, v), warmup=1, reps=3)
            cms = lms = None
            if v.n_taps:
                a = x.reshape(-1, x.shape[-1])
                wc = w.permute(1, 0, 2).reshape(x.shape[-1], -1).contiguous()
                cms = cuda_ms(lambda: a @ wc)
            library = probe_library(v, x, w)
            if library is not None:
                lib_err = rel_err(library(), ref)
                if not lib_err <= K2_TOL:
                    raise AssertionError(f"probe {label}: the library call's rel err {lib_err}")
                lms = cuda_ms(library)
                library_kernel_ms[f"P{v.probe}"] += ms
            bound, by = probe_bound(v, x.shape)
            if v.halos:
                extra += f" (the halo rows' re-read {halo_reread_ms(x.shape):.4f} ms at HBM rate)"
            name = f"P{v.probe}"
            times[label] = ms
            ptxas = PROBE_PTXAS.get((ka.kernel_flags(v), int(v.selects)), "not in the build log")
            log(f"probe {name} {label}: rel_err {err:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
                f"library {'none' if lms is None else f'{lms:.4f} ms'} bound {bound:.4f} ms "
                f"({by}) K2 {k2_ms:.4f} ms cuBLAS products "
                f"{'none' if cms is None else f'{cms:.4f} ms'}{extra}; instance "
                f"{ka.kernel_flags(v):#x} selects {int(v.selects)}: {ptxas}")
            _add(tot[name], abs_err(got, ref), ms, pms, lms, bound, by)
            cublas_ms[name] += cms or 0.0
            del got, ref, x, w
        for name, t in tot.items():
            t["cublas_products_ms"] = cublas_ms[name]
            t["library_kernel_ms"] = library_kernel_ms[name]
            t["k2_ms"] = k2_ms
            log(f"probe {name} over {t['shapes']} variants: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, cuBLAS products "
                f"{t['cublas_products_ms']:.4f} ms; "
                + (f"where one library call computes the variant, library "
                   f"{t['library_ms']:.4f} ms against the kernel's {t['library_kernel_ms']:.4f} ms"
                   if t["library_kernel_ms"] else "no library call computes a variant"))
        tot["P1"]["k2_split_ms"] = probe_split(times, k2_ms)
    return tot, counts


def probe_split(t, k2_ms: float) -> dict:
    """K2's time at the probes' shape split into additive terms, each the
    difference of two rows timed in this run (``t``: ms by row label): at 9
    taps the products, the register pass, the affine, SiLU, and what the 3x3
    shifts, the halo cells and the epilogue add (K2 against P1's act+SiLU
    row, whose next chunk is staged after its products, so this term also
    holds the overlap K2 gains by staging under them); at 4 taps, on top of
    P1's act+SiLU row, the bands (P2's row-shifted taps over K2's halo tile),
    their clamped halo rows, the selects, the zero fill and the overlap
    (P2's double buffer). Logs and returns the terms."""
    d9, c9 = t["dots direct from input block"], t["copy->scratch + 9 dots"]
    a9, s9 = t["act->scratch + 9 dots"], t["act+silu->scratch + 9 dots"]
    base = t["base: 4 dots, single buf"]
    split = {
        "9 taps: products (P1 direct)": d9,
        "9 taps: register pass (copy - direct)": c9 - d9,
        "9 taps: affine (act - copy)": a9 - c9,
        "9 taps: SiLU (act+SiLU - act)": s9 - a9,
        "9 taps: shifts, halo cells, epilogue (K2 - act+SiLU)": k2_ms - s9,
        "4 taps: P1 act+SiLU": t["act+silu->scratch + 4 dots"],
        "4 taps: bands (P2 base - P1 act+SiLU)": base - t["act+silu->scratch + 4 dots"],
        "4 taps: halos (+halos - base)": t["+halos"] - base,
        "4 taps: selects (+selects - base)": t["+selects"] - base,
        "4 taps: zero fill (+when_zero - base)": t["+when_zero"] - base,
        "4 taps: overlap (+dbuf - base)": t["+dbuf"] - base,
    }
    log(f"K2's split at the probes' shape (K2 {k2_ms:.4f} ms; the 9-tap terms add up to it):")
    for term, ms in split.items():
        share = f" ({ms / k2_ms:.3f} of K2)" if term.startswith("9") else ""
        log(f"  {term}: {ms:.4f} ms{share}")
    return split


def probe_library(v, x, w):
    """One PyTorch call that computes probe variant ``v`` on (x, w), where
    there is one: P1's one unshifted product of x (a matmul) and its copy
    of x; else None."""
    if v.probe != 1 or v.act:
        return None
    if v.n_taps == 1:
        return lambda: (x.reshape(-1, x.shape[-1]) @ w[0]).reshape(x.shape)
    return x.clone if v.n_taps == 0 else None


# ptxas's line for each K2 instance, (N tile, m64 tiles, shortcut, packed)
# -> "registers, spills", and for each probe instance of the same kernel,
# (its PROBE word, packed), from the build logs (``nvcc_report``)
PTXAS = {}
PROBE_PTXAS = {}


def nvcc_report(lib_path, name: str):
    """Log what ptxas said of each kernel in a built library: registers and
    spills, with the template arguments of an instance; keep the K2
    instances' lines in PTXAS, the probe instances' in PROBE_PTXAS."""
    build_log = lib_path.with_name(lib_path.name + ".log")
    if not build_log.exists():
        return
    lines, width, key, table = [], "", None, None
    for line in build_log.read_text().splitlines():
        if "built in" in line:
            log(f"  nvcc {name}: {line.strip()}")
        elif "Compiling entry function" in line:
            m = re.search(r"flash_attention_kernelILi(\d+)E", line)
            wg = re.search(r"conv3x3_wgmma_kernelILi(\d+)ELi(\d)ELb(\d)ELb(\d)ELi(\d+)E", line)
            key, table, width = None, None, f"D={m.group(1)}: " if m else ""
            if wg:
                bn, mt, proj, packed, probe = (int(v) for v in wg.groups())
                width = f"N {bn} m64 tiles {mt} shortcut {proj} packed {packed}"
                if probe:
                    key, table = (probe, packed), PROBE_PTXAS
                    width += f" probe {probe:#x} (taps {probe >> 8})"
                else:
                    key, table = (bn, mt, proj, packed), PTXAS
                width += ": "
        elif "spill" in line or "registers" in line:
            lines.append(line.replace("ptxas info    :", "").strip())
            if "registers" in line:
                log(f"  nvcc {name}: {width}" + "; ".join(lines))
                if table is not None:
                    table[key] = "; ".join(lines)
                lines = []


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's check runs only on a GPU")
    from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats, k3_passes, kernel_anatomy

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    with phase("build the kernels (one nvcc each for K2, K4 and P1/P2, beside Triton's K1 and "
               "K3·A/K3·B compiles)"):
        built, errors = {}, {}

        def build(name, module):
            try:
                built[name] = module.build_library()
            except Exception as e:  # re-raised below, in the main thread
                errors[name] = e

        threads = [threading.Thread(target=build, args=a)
                   for a in (("K2", fused_resnet), ("K4", attention), ("P1/P2", kernel_anatomy))]
        t0 = time.perf_counter()
        for thread in threads:
            thread.start()
        probe = torch.ones((1, 8, 8, 64), device=dev, dtype=torch.bfloat16)
        gn_stats.spatial_sums(probe)
        ab = torch.ones((1, 64), device=dev)
        k3_passes.fold(probe, probe, ab, ab)
        k3_passes.chain(probe, probe, ab, ab)
        torch.cuda.synchronize()
        log(f"K1's and K3's passes' first launches (Triton compiles): "
            f"{time.perf_counter() - t0:.3f} s")
        for thread in threads:
            thread.join()
        for e in errors.values():
            raise e
        fused_resnet.load_library()
        attention.load_library()
        kernel_anatomy.load_library()
        log(f"K2, K4 and P1/P2 build (nvcc, sm_90a) + load: {time.perf_counter() - t0:.3f} s -> "
            f"{built['K2'].name}, {built['K4'].name}, {built['P1/P2'].name}")
        for name, lib_path in built.items():
            nvcc_report(lib_path, name)

    tot_k4_64, counts_k4_64, tot_64, counts_64 = path_64(dev)
    torch.cuda.empty_cache()
    tot_256, counts_256, tot_k4_256, counts_k4_256 = path_256(dev)
    torch.cuda.empty_cache()
    tot_1024, counts_1024 = path_1024(dev)

    torch.cuda.empty_cache()
    tot_k3, counts_train = path_train(dev)
    torch.cuda.empty_cache()
    tot_t1024, tot_k3_1024, counts_t1024 = path_train_1024(dev)
    torch.cuda.empty_cache()
    with phase("new attention modules on the card"):
        path_new_modules(dev)
    with phase("K2 at the shape of the cost-decomposition probes"):
        # the probes P1 and P2 take K2 apart at B=4, 512 x 512, 128 -> 128
        # channels, bf16: K2 itself there, beside its bound
        tot_k2_probe = check_kernels(
            [K2Key(4, 512, 512, (128,), 128, False, False, False, True, False,
                   fused_resnet.pipelines((128,), 4, 512, 512, 128, None, False))], [], dev,
            "probe shape")
    torch.cuda.empty_cache()
    tot_probes, counts_probes = path_probes(dev, tot_k2_probe["K2"]["ms"])

    # K1-K2·proj over the nested sampling forwards' shapes (as in earlier
    # slices), K2·struct and K2·pipe over those and the train_1024 step's
    totals = merge_totals(tot_256, tot_1024)
    for mode in ("K2·struct", "K2·pipe"):
        totals[mode] = merge_totals(tot_256, tot_1024, tot_t1024)[mode]
    totals.update(tot_k3)
    totals["K2 64px"] = tot_64["K2"]
    totals["K4"] = merge_totals({"K4": tot_k4_64}, {"K4": tot_k4_256})["K4"]
    totals.update(tot_probes)
    launches = {k: counts_256[k] + counts_1024[k] for k in ("K1", "K2", "K2·N", "K2·proj")}
    launches.update({k: counts_256[k] + counts_1024[k] + counts_t1024[k]
                     for k in ("K2·struct", "K2·pipe")})
    launches.update({k: counts_train[k] for k in ("K3", "K3·A", "K3·B")})
    launches["K2 64px"] = counts_64["K2"]
    launches["K4"] = counts_k4_64["K4"] + counts_k4_256["K4"]
    launches.update({k: counts_probes[k] for k in ("P1", "P2")})
    log(f"launches during the nested matmul-route requests (256px and 1024px; K1-K2·proj), the "
        f"64px batch-64 request (K2 64px), the nested matmul-route requests and the "
        f"train_1024 preset's timed steps (K2·struct, K2·pipe: {counts_256['K2·struct']} + "
        f"{counts_1024['K2·struct']} + {counts_t1024['K2·struct']} and {counts_256['K2·pipe']} + "
        f"{counts_1024['K2·pipe']} + {counts_t1024['K2·pipe']}), the train_256 preset's timed "
        f"steps (K3, K3·A, K3·B), the flash-route "
        f"requests (64px and 256px; K4) and the probes' tables (P1, P2): {launches}")
    for what, t in (("64px forward's", totals["K2 64px"]), ("nested forwards'", totals["K2"])):
        log(f"K2 over the {what} {t['shapes']} shapes: kernel {t['ms']:.4f} ms "
            f"({t['ms'] / t['library_ms']:.3f}x the library), library {t['library_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms']:.3f} of it)")
    for what, t in (("train_256 step's", tot_k3["K3"]), ("train_1024 step's", tot_k3_1024["K3"])):
        log(f"K3 over the {what} {t['shapes']} shapes: backward {t['ms']:.4f} ms "
            f"({t['ms'] / t['library_ms']:.3f}x the library), plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    t4 = totals["K4"]
    log(f"K4 over the 64px and 256px forwards' shapes: kernel {t4['ms']:.4f} ms, matmul route "
        f"{t4['matmul_ms']:.4f} ms, library {t4['library_ms']:.4f} ms "
        f"({t4['ms'] / t4['library_ms']:.3f}x the library), bound {t4['bound_ms']:.4f} ms; "
        f"launches x (kernel - bound) over a 64px and a 256px request {t4['excess_ms']:.3f} ms")
    t1 = totals["K1"]
    log(f"K1 over the nested forwards' {t1['shapes']} shapes: kernel {t1['ms']:.4f} ms, plain "
        f"(= library) {t1['plain_ms']:.4f} ms ({t1['ms'] / t1['plain_ms']:.3f}x), bound "
        f"{t1['bound_ms']:.4f} ms ({t1['bound_ms'] / t1['ms']:.3f} of it)")
    log(f"chip_smoke: {time.perf_counter() - t_start:.3f} s wall in all")

    def entry(name, mode, route, source, replaces, library=True, **extra):
        t = totals[mode]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[mode], "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops_ms"] > t["bytes_ms"] else "bytes",
                "library_ms": t["library_ms"] if library else None,
                **{k: t[v] for k, v in extra.items()}}

    cu = "ml_mdm_tpu_torch/csrc/fused_resnet.cu"
    kernels = [
        entry("spatial_sums", "K1", "triton", "ml_mdm_tpu_torch/ops/gn_stats.py",
              "ml_mdm_tpu/ops/gn_stats.py:62"),
        entry("affine_silu_conv3x3", "K2", "cuda", cu, "ml_mdm_tpu/ops/fused_resnet.py:481"),
        entry("affine_silu_conv3x3 (64px main path)", "K2 64px", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:141"),
        entry("affine_silu_conv3x3 (N operands)", "K2·N", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:515"),
        entry("affine_silu_conv3x3 (shortcut)", "K2·proj", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:284"),
        entry("affine_silu_conv3x3 (packed_struct)", "K2·struct", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:92", unpacked_ms="unpacked_ms"),
        entry("affine_silu_conv3x3 (pipelined)", "K2·pipe", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:318", serial_ms="serial_ms"),
        entry("affine_silu_conv3x3_vjp (backward)", "K3", "cuda", cu,
              "ml_mdm_tpu/ops/fused_resnet.py:744"),
        entry("k3_passes.fold (K3 pass A)", "K3·A", "triton", "ml_mdm_tpu_torch/ops/k3_passes.py",
              "ml_mdm_tpu/ops/fused_resnet.py:782", library=False),
        entry("k3_passes.chain (K3 pass B)", "K3·B", "triton", "ml_mdm_tpu_torch/ops/k3_passes.py",
              "ml_mdm_tpu/ops/fused_resnet.py:782", library=False),
        entry("flash_attention", "K4", "cuda", "ml_mdm_tpu_torch/csrc/flash_attention.cu",
              "ml_mdm_tpu/ops/attention.py:130"),
        # one PyTorch call computes two of P1's variants (its 1-tap product
        # and its copy): library_ms sums those, library_kernel_ms is the
        # kernel's time on the same two; none computes a P2 variant. The
        # products' cuBLAS time stands beside every probe as a yardstick
        entry("kernel_anatomy (probe P1, 9 variants)", "P1", "cuda",
              "ml_mdm_tpu_torch/csrc/kernel_anatomy.cu", "tools/probe_kernel_anatomy.py:29",
              k2_ms="k2_ms", cublas_products_ms="cublas_products_ms",
              library_kernel_ms="library_kernel_ms", k2_split_ms="k2_split_ms"),
        entry("kernel_anatomy (probe P2, 7 variants)", "P2", "cuda",
              "ml_mdm_tpu_torch/csrc/kernel_anatomy.cu", "tools/probe_kernel_anatomy2.py:28",
              library=False, k2_ms="k2_ms", cublas_products_ms="cublas_products_ms"),
    ]
    print(json.dumps({"kernels": kernels}, ensure_ascii=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
