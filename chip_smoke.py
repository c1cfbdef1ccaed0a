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
     plain path; two batch-64 DDIM-50 requests from one seed (the bench
     preset), bitwise equal; one batch-8 request with classifier-free
     guidance 5; one profiled forward.
     Then the flash route (``use_flash(True)``: every self-attention of
     the U-Net through K4): K4 at every self-attention launch shape of that
     forward, on the chunked views the model hands it, held against its
     plain version and timed beside the matmul route, the library call
     (``scaled_dot_product_attention``) and the bound, with its TFLOP/s,
     its launches a request and launches x (time - bound); batch 4, flash path
     against matmul path (one forward, DDIM-4); two batch-64 DDIM-50
     requests from one seed, bitwise equal; one profiled forward.
  2. cc12m_256x256 (``NestedDiffusion.sample``, a 256px shell around the
     64px core): every kernel launch shape of the request's forward
     (8 rows) checked and timed; batch 2 kernel path against plain path
     (one forward, DDIM-4); two requests of the web demo's defaults
     (batch 4, guidance 7.5, DDIM-50, eta 0) from one seed, bitwise equal;
     one profiled forward; then,
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
     16, lr 5e-5, warmup 10, clip 2.0, no remat): one step twice from the
     same weights, batch and noise (loss, gradient norm, parameters and EMA
     bitwise equal), one untimed and five timed steps; one profiled step;
     then cc12m_64x64 (``Diffusion.get_loss``) at batch 32, the batch of
     phase 9's CLI: every K1, K2 and K3 launch shape of one step held
     against its plain version and timed (K3 with its two passes), one step
     twice from one seed (bitwise, as above), then one untimed and three
     timed steps (their steps/s stand beside phase 9's CLI).
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
  8. The web demo's server (``ml_mdm_tpu_torch/clis/generate_sample.py``),
     caption to image: a T5 encoder at flan-t5-xl's published shape (1.22
     billion parameters) with seeded random weights is written in bf16 to a
     temporary directory as a Hugging Face checkpoint; ``get_arguments``
     reads configs/models/cc12m_256x256.yaml with ``--text-model`` that
     directory, and ``make_builtin_server`` loads it (f32 on the card) beside
     the 256px model (seeded random weights) and serves on a free port.
     Over HTTP: ``/choices``; one plain ``/generate`` at the demo's
     defaults (batch 4, guidance 7.5, DDIM-50, eta 0, CLIP, seed 0, a
     caption and a negative prompt; the server's first, which builds the
     sampling weights' layouts); the same query streamed, which must give
     at least 2 previews and then a final image; the same query plain
     again; one more with seed 1, which must differ. K1, K2 and
     K2·struct must launch inside these four requests and K3 must not;
     every image decodes, has the grid's shape and no constant image. The
     two plain calls must be bitwise equal and the streamed image bitwise
     equal to them; it passes ``within_spread`` too, and the same query at
     DDIM-49, a planted fault, must fail that rule; with the vision model
     on its plain route a DDIM-10 stream must equal its plain request bit
     for bit (``check_stream``). Then the text
     tower's time on the request's captions (CUDA events) and the card's
     f32 tower against the same weights on the CPU.
  9. The user's training and evaluation path through the port's own CLIs,
     in this process (``path_cli``): one tar shard of 512 JPEGs (quality
     90, sides drawn from 256-512 px from the seed, captions from
     data/prompts_cc12m-64x64.tsv) and its index; the C++ data plane built
     with g++ (its result printed; where it does not build, the PIL route
     runs and is said so); the reader alone, 20 batches of 32 at the YAML's
     readers (8 threads), images/s and the decodes by route; then
     ``clis/train_parallel.main`` on configs/models/cc12m_64x64.yaml with
     the tower of phase 8 (``--fp16 1``, batch 32, 12 steps, warmup 10,
     saves at 6 and 12): every loss finite, no step skipped, both ``.pth``
     files and the train state at 6 and 12, K1, K2, K3, K3·A and K3·B
     launched, the CLI's steps/s (its own step time, steps 3-12) beside the
     64px training phase's, the peak device memory; the step-12 train state
     loaded into a fresh state, bitwise equal to what ``main`` returned; a
     resume from step 6 to 12 with one CLI iteration (text tower, step,
     metrics, next batch) profiled: its busy time and idle share; then
     ``clis/generate_batch.main`` on the step-12 EMA checkpoint: 64 samples
     at batch 32, guidance 5 with the negative prompt "low quality",
     DDIM-50, eta 0, with K1, K2, K2·N and K2·proj launched: 64 ``s_*.png``,
     the ``ref_*.png``, ``lst.json`` and ``index.html``, samples/s. The
     checkpoints (about 11 GB a save) are deleted at the end, the samples
     stay under chiprun_out/cli/ until phase 10 has read them.
 10. Evaluation through the port's ``clis/run_torchmetrics.py``
     (``path_eval``): a CLIP model at openai/clip-vit-base-patch16's
     published shape (149,620,737 parameters) with seeded random weights is
     written to a temporary directory as a Hugging Face checkpoint
     (``model.safetensors``, the preprocessor's config, a synthetic
     byte-level BPE vocabulary); its image and text features on the card
     (f32) are held against an f64 CPU run of the same tower on 4 samples
     and their captions (the card's 2-norm relative error at most twice the
     CPU's own f32 error), and each tower's features/s are timed; then ``main`` with
     ``--metrics fid,clip --feature-extractor clip`` on phase 9's 64
     samples and references must report ``fid_extractor`` "clip", a finite
     FID >= 0 and a CLIPScore in [0, 100] (wall time, peak memory); the
     references against themselves must score at most 1e-3 of the samples'
     FID, and, a planted fault, the references shifted by +40 levels more.
 11. The quality gate (``path_gate``, ``ml_mdm_tpu_torch/tools/
     quality_gate.py``, the counterpart of tests/test_quality_gate.py): the
     tiny 16px U-Net of tests/test_files/tiny_train.yaml overfit on the ten
     fixture images for 500 steps, then two seed-disjoint DDIM-20 sample
     sets from its EMA parameters; the untrained anchor's per-caption MSE
     above 0.3, the trained one below 0.05, the pixel FID lower. Twice with
     the same seeds: (a) f32 parameters, bf16 compute, on the kernels (every
     K1, K2 and K3 launch shape of one step and one probe forward first held
     against its plain version; K1, K2 and K3 must launch in training, K1
     and K2 in the probes) and (b) ``use_kernels(False)`` in f32, where no
     kernel may launch. Both must pass; where (a) fails and (b) passes, the
     plain route runs in bf16 too, to tell bf16 from a kernel fault.
 12. FSDP training through the CLI (``path_fsdp``): ``train_parallel`` on
     cc12m_64x64 (batch 32, ``--fp16 1``, phase 9's tower, a shard made as
     phase 9's) with ``--mesh-shape data:1,fsdp:N`` for 4 steps, N the
     cards, one process a card over NCCL (rank 0 in this process, the
     others spawned with torchrun's environment; one card: the CLI joins a
     one-process group, so the sharded code and its collectives run). Every
     loss finite, no step skipped, K1-K3·B launched; the step-4 train state
     loaded into a plain ``TrainState`` holds rank 0's shards bitwise; with
     one card, step 1 against the data-parallel step on the same batch and
     noise (loss 1e-2 relative, norm 5e-2), phase 9's step 1 beside; rank
     0's shard bytes beside its peak memory and phase 9's.
 13. configs/models/cifar10_32x32.yaml with dropout 0.1 (``path_cifar``),
     at its full width and batch 128, ``--fp16 1``: every K1, K2, K3 and
     identity-prologue K3 (``conv3x3_vjp``, the dropout ResNet's conv2)
     launch shape of one step held against plain and timed; a kernel step
     against a plain one with the same masks (the step tolerances); then
     ``train_parallel`` for 10 steps on a shard of 1280 class-captioned
     JPEGs (losses finite, every mask's kept fraction within 4 sigma of 0.9,
     K3·id launched; steps/s) and ``generate_batch`` on its checkpoint (128
     samples, DDIM-50; samples/s).
 14. The one-process data-parallel sampler (``path_dp_sampler``):
     ``parallel.sample_data_parallel`` on the 64px model, batch 8, guidance
     5, DDIM-25, over every card or over cuda:0 twice: on the kernels and
     on the plain route bitwise equal to one device sampling each replica's
     rows (the same call shapes).

The seed contract (``ml_mdm_tpu_torch/helpers.py`` ``reproducible``): on
one card the same inputs, noise and seed give the same bits. Each same-seed
check above (``reproducible``) is logged when made and printed again as a
"reproducible:" line before the kernels line, with a digest of the result;
a difference fails the run.

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
flash-route requests, P1 and P2 during the probes' tables; K1-K2·pipe also
the web demo's requests, which ``server_launches`` gives apart; K1, K2 64px,
K2·N, K2·proj and K3-K3·B also phase 9's CLI runs, ``cli_launches``, and
phase 11's kernel route, ``gate_launches``; phases 12-14 add their
launches, ``fsdp_launches``, ``cifar_launches`` and ``dp_sampler_launches``,
and K3 the identity-prologue backwards apart, ``identity_launches``), its error
and its times; K1, K2 64px and K3-K3·B also their check at the 64px
batch-32 training step's shapes, those of the training CLI (``cli_shapes``;
generate_batch's CFG forwards are the 64px batch-64 forward of phase 1),
and K1-K2·proj and K3-K3·B their check at the quality gate's shapes
(``gate_shapes``), and K1, K2, K3-K3·B their check at the cifar10_32x32
step's shapes (``cifar_shapes``; K3 also the identity-prologue backward's,
``identity_shapes``); the last line is one JSON object with "ok" and the
device.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
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


# the same-seed checks (the seed contract, ``helpers.reproducible``), each
# logged when made and printed again as a "reproducible:" line before the
# kernels line
REPRODUCIBLE = []


def _as_tensors(x):
    import numpy as np
    import torch

    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _as_tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _as_tensors(v)]
    if isinstance(x, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(x))]
    if isinstance(x, float):
        return [torch.tensor([x], dtype=torch.float64)]
    return [x.detach()]


def _digest(ts) -> str:
    """12 hex digits that change with the bits of the tensors: a sha256 of
    each small tensor's bytes, and of an on-device checksum of each large
    one (its bytes as int32 words, summed in int64, and weighted by their
    position modulo 2**16 + 1)."""
    import torch

    h = hashlib.sha256()
    for t in ts:
        t = t.contiguous()
        if t.numel() * t.element_size() <= 2**24:
            h.update(t.cpu().view(torch.uint8).numpy().tobytes())
            continue
        words = t.view(-1).view(torch.uint8)
        words = words[: words.numel() // 4 * 4].view(torch.int32).to(torch.int64)
        pos = torch.arange(words.numel(), device=words.device) % 65537 + 1
        h.update(torch.stack([words.sum(), (words * pos).sum()]).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def reproducible(what: str, first, second) -> None:
    """Hold two results of one path on the same inputs, noise and seed
    (tensors, arrays, floats, or lists and dicts of them) bitwise equal,
    and note the check for its "reproducible:" line. Fails on a
    difference, with its share and size."""
    import torch

    a, b = _as_tensors(first), _as_tensors(second)
    same = len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(a, b))
    n = sum(t.numel() for t in a)
    line = (f"{what}: {'bitwise equal' if same else 'DIFFERENT'} "
            f"({len(a)} tensors, {n} values, digest {_digest(a)})")
    if not same:
        bad = [(float((x.float() - y.to(x.device).float()).abs().max()),
                float((x != y.to(x.device)).float().mean()))
               for x, y in zip(a, b) if x.shape == y.shape and not torch.equal(x, y.to(x.device))]
        line += f"; {len(bad)} differ, largest |difference| and share of the first {bad[:3]}"
    REPRODUCIBLE.append(line)
    log(f"same-seed check: {line}")
    if not same:
        raise AssertionError(line)


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
                 flash: bool = False, required=None, reseed=None, **kw):
    """n timed sampling requests between a count reset and a count read;
    returns (counts, outputs). ``required``: the kernels of the path
    (default: the flagship's). With ``flash`` they run on the flash route,
    and K4 must have launched once per self-attention module, step and
    request. With ``reseed`` ``gen`` is seeded with it before each request,
    so that every request draws the same noise: their outputs must then be
    bitwise equal (``reproducible``)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    outs = []
    with flash_route() if flash else contextlib.nullcontext():
        for i in range(n):
            if reseed is not None:
                gen.manual_seed(reseed)
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
    if reseed is not None:
        for i in range(1, n):
            reproducible(f"{what}, request {i} against request 0 (the same seed)", outs[0],
                         outs[i])
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


def busy_and_window(events):
    """(device busy ms, window ms) of profiler events: the union of the
    device kernels' spans, over the span from the first event to the last
    kernel's end."""
    from torch.autograd import DeviceType

    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
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
    return busy / 1e3, (spans[-1][1] - min(e.time_range.start for e in events)) / 1e3


def top_kernels(events, busy: float, n: int):
    """Log the ``n`` kernels with the most device time (without the named
    ranges' device spans), each with its share of ``busy`` ms; returns
    name -> (us, launches) of every kernel."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            tot, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), k + 1)
    for name, (tot, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]:
        log(f"  {tot / 1e3:9.3f} ms {100 * tot / 1e3 / busy:5.1f}%  x{k:<5d} {name[:88]}")
    return by_name


def profile_forward(forward, what: str):
    """Time of one forward (CUDA events) and the host's time to enqueue it,
    then its device time by kernel and the device's idle share from a
    profiler trace."""
    import torch
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
    busy, window = busy_and_window(prof.events())
    if busy is None:
        log(f"{what} profile: the profiler recorded no device time")
        return ms, None, None
    log(f"{what} profile: device busy {busy:.3f} ms of a {window:.3f} ms window, "
        f"idle share {1 - busy / window:.4f}")
    top_kernels(prof.events(), busy, 12)
    return ms, busy, window


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
    with phase("64px: two batch-64 DDIM-50 requests from one seed, matmul route"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        cond = text_conditioning(dev, 64, lm_dim, gen)
        counts_64, outs = run_requests(pipe, dev, "64px batch-64 request, matmul route", 2, 64,
                                       side, cond, gen, reseed=SEED + 5, **bench)
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
    with phase("64px: two batch-64 DDIM-50 requests from one seed, flash route"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        cond = text_conditioning(dev, 64, lm_dim, gen)
        counts, outs = run_requests(pipe, dev, "64px batch-64 request, flash route", 2, 64,
                                    side, cond, gen, flash=True, reseed=SEED + 5, **bench)
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
    with phase("256px: two requests from one seed, batch 4, guidance 7.5, DDIM-50"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        cond = text_conditioning(dev, 2 * batch, lm_dim, gen)
        counts, outs = run_requests(pipe, dev, "256px request", 2, batch, side, cond, gen,
                                    required=required, reseed=SEED + 7, num_inference_steps=50,
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


def repeat_step(pipe, cfg, dev, what: str, batch: int, side: int, lm_dim: int):
    """One training step twice from the same weights, batch and noise (a
    fresh train state each time, the step's generator seeded alike): loss,
    gradient norm, the updated parameters and the EMA bitwise equal
    (``reproducible``). The module's parameters are set back after."""
    import torch

    from ml_mdm_tpu_torch import trainer

    unet = pipe.vision_module
    start = {k: p.detach().clone() for k, p in unet.named_parameters()}
    results = []
    for i in range(2):
        with torch.no_grad():
            for k, p in unet.named_parameters():
                p.copy_(start[k])
        state = trainer.TrainState.create(unet, cfg)
        step = trainer.make_train_step(pipe, cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED + 16)
        data = train_batch(dev, batch, side, lm_dim, gen)
        state, m = step(state, data, gen)
        if m["skipped"]:
            raise AssertionError(f"{what}: the step was skipped: {m}")
        keep = (lambda t: t.detach().clone()) if i == 0 else (lambda t: t.detach())
        results.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                        "params": {k: keep(p) for k, p in state.params.items()},
                        "ema": {k: keep(e) for k, e in state.ema_params.items()}})
        del state, step
    log(f"{what}: loss {results[0]['loss']!r} and {results[1]['loss']!r}, gradient norm "
        f"{results[0]['grad_norm']!r} and {results[1]['grad_norm']!r}")
    reproducible(f"{what}: one step twice from one seed (loss, gradient norm, parameters, EMA)",
                 results[0], results[1])
    del results
    with torch.no_grad():
        for k, p in unet.named_parameters():
            p.copy_(start[k])


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
    busy, window = busy_and_window(events)
    if busy is None:
        log(f"{label} profile: the profiler recorded no device time")
        return None, None
    log(f"{label} profile, one step B={batch}: device busy {busy:.3f} ms of a "
        f"{window:.3f} ms window, idle share {1 - busy / window:.4f}")
    by_name = top_kernels(events, busy, 15)

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
        log(f"  {name}: {us / 1e3:.3f} ms device, {100 * us / 1e3 / busy:.1f}% of busy")
    return busy, window


def path_train(dev):
    """Training: cc12m_256x256 (K3 shapes, kernel vs plain, the train_256
    preset, one profiled step), then cc12m_64x64 at batch 32 (K1, K2 and K3
    shapes, the steps). Returns (K3 totals, the launch counts of the
    train_256 preset's timed steps, the 64px steps/s, the totals of K1, K2,
    K3, K3·A and K3·B over the 64px batch-32 step's shapes)."""
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
    with phase("256px train: the train_256 preset, one step twice from one seed"):
        cfg = trainer.TrainerConfig(lr=5e-5, warmup_steps=10, gradient_clip_norm=2.0)
        repeat_step(pipe, cfg, dev, "train_256 step, batch 16", batch, side, lm_dim)
    with phase("256px train: the train_256 preset, 1 untimed and 5 timed steps"):
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
    with phase("64px train: K1, K2 and K3 launch shapes of a batch-32 step"):
        # the shapes of phase 9's CLI steps (the same model and batch)
        pipe, lm_dim, side = flagship_64px(dev, seed=SEED, train=True)
        unet = pipe.vision_module
        data = {k: v.to(torch.bfloat16)
                for k, v in train_batch(dev, 32, side, lm_dim, gen).items()}

        def one_backward():
            unet.zero_grad(set_to_none=True)
            pipe.get_loss(data, gen)[0].mean().backward()

        k3_box = []
        k2_keys, k1_keys = record_launch_shapes(
            lambda: k3_box.append(record_k3_shapes(one_backward)), grad=True)
        unet.zero_grad(set_to_none=True)
        del data
        log(f"64px train: {len(k1_keys)} K1, {len(k2_keys)} K2 and {len(k3_box[0])} K3 launch "
            f"shapes in a batch-32 step")
        tot_64 = check_kernels(k2_keys, k1_keys, dev, "64px train")
        tot_64 = {"K1": tot_64["K1"], "K2": tot_64["K2"],
                  **check_k3(k3_box[0], dev, "64px train")}
    with phase("64px train: one batch-32 step twice from one seed"):
        cfg = trainer.TrainerConfig(lr=5e-5, warmup_steps=10, gradient_clip_norm=2.0)
        repeat_step(pipe, cfg, dev, "64px step, batch 32 (the CLI's shape)", 32, side, lm_dim)
    with phase("64px train: Diffusion.get_loss, batch 32, 1 untimed and 3 timed steps"):
        state = trainer.TrainState.create(pipe.vision_module)
        step = trainer.make_train_step(pipe, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        run_train_steps(step, state, pipe, dev, "64px train", 1, 32, side, lm_dim, gen,
                        timed=False)
        times = run_train_steps(step, state, pipe, dev, "64px train", 3, 32, side, lm_dim, gen)
        read_counts("the 64px training steps", TRAINING_KERNELS)
        peak = torch.cuda.max_memory_allocated(dev)
        steps_64 = len(times) / sum(times)
        log(f"64px train (batch 32, random batches on the card): {steps_64:.4f} steps/s "
            f"(mean of 3 steps after 1 untimed); peak device memory {peak} bytes "
            f"({peak / 2**30:.3f} GiB)")
    del pipe, unet, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return tot_k3, counts, steps_64, tot_64


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


# -- the web demo's server ---------------------------------------------------

DEMO_CONFIG = "configs/models/cc12m_256x256.yaml"
# the public google/flan-t5-xl config.json, the keys the loader reads
FLAN_T5_XL = {"d_ff": 5120, "d_kv": 64, "d_model": 2048, "feed_forward_proj": "gated-gelu",
              "layer_norm_epsilon": 1e-06, "model_type": "t5", "num_heads": 32, "num_layers": 24,
              "relative_attention_max_distance": 128, "relative_attention_num_buckets": 32,
              "tie_word_embeddings": False, "vocab_size": 32128}
DEMO_QUERY = dict(prompt="a red fox in the snow at dawn", negative_prompt="blurry, low quality",
                  batch_size=4, guidance_scale=7.5, num_inference_steps=50, ddim_eta=0,
                  threshold_function="CLIP", seed=0)


def write_text_tower(dev, path: str):
    """A T5 encoder at flan-t5-xl's published shape with seeded random
    weights, written to ``path`` as a Hugging Face checkpoint directory
    (config.json + pytorch_model.bin, bf16). Returns the parameter count."""
    import torch

    from ml_mdm_tpu_torch.language_models import t5

    t0 = time.perf_counter()
    with torch.device(dev):
        enc = t5.T5Encoder(t5.T5Config.from_hf_config(FLAN_T5_XL))
    t5.init_t5_(enc, torch.Generator(device=dev).manual_seed(SEED))
    n = sum(p.numel() for p in enc.parameters())
    state = {k: v.to(torch.bfloat16).cpu() for k, v in enc.state_dict().items()}
    del enc
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with open(f"{path}/config.json", "w") as f:
        json.dump(FLAN_T5_XL, f)
    torch.save(state, f"{path}/pytorch_model.bin")
    size = sum(v.numel() * v.element_size() for v in state.values())
    log(f"text tower: {n} parameters (flan-t5-xl's encoder shape), built in "
        f"{t1 - t0:.3f} s, {size} bytes of bf16 written in {time.perf_counter() - t1:.3f} s")
    return n


def _png(b64: str):
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def check_grid(img, batch: int, side: int, what: str):
    """A decoded grid of ``batch`` images: uint8 (so finite, in [0, 255]),
    the grid's shape, no image constant."""
    import numpy as np

    cols = int(np.ceil(np.sqrt(batch)))
    rows = int(np.ceil(batch / cols))
    shape = (rows * (side + 2) - 2, cols * (side + 2) - 2, 3)
    if img.dtype != np.uint8 or img.shape != shape:
        raise AssertionError(f"{what}: {img.dtype} {img.shape}, expected uint8 {shape}")
    stds = [float(img[r * (side + 2): r * (side + 2) + side,
                      c * (side + 2): c * (side + 2) + side].std())
            for r, c in (divmod(i, cols) for i in range(batch))]
    if min(stds) <= 0:
        raise AssertionError(f"{what}: a constant image (std per image {stds})")
    log(f"{what}: {shape} uint8, per-image std {[round(v, 3) for v in stds]}")


def demo_request(url: str, query: dict, stream: bool, what: str):
    """One /generate request: (final image, wall seconds, seconds to the
    first preview or None, number of previews)."""
    import urllib.parse
    import urllib.request

    q = urllib.parse.urlencode(dict(query, **({"stream": 1} if stream else {})))
    t0 = time.perf_counter()
    resp = urllib.request.urlopen(f"{url}/generate?{q}", timeout=600)
    if not stream:
        body = json.loads(resp.read())
        return _png(body["image"]), time.perf_counter() - t0, None, 0
    kinds, first, buf, fin = [], None, b"", None
    while True:
        chunk = resp.read1(65536)  # what has arrived, not a full 64 KiB
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            if not frame.startswith(b"data: "):
                continue
            ev = json.loads(frame[6:])
            kinds.append(ev["kind"])
            if ev["kind"] == "preview" and first is None:
                first = time.perf_counter() - t0
                _png(ev["image"])
            elif ev["kind"] == "final":
                fin = ev
    wall = time.perf_counter() - t0
    if kinds.count("preview") < 2 or kinds[-1:] != ["final"]:
        raise AssertionError(f"{what}: events {kinds}")
    return _png(fin["image"]), wall, first, kinds.count("preview")


def check_tower_on_cpu(path: str, tokens, card, mask):
    """The card's f32 tower output ``card`` against the same weights (the
    directory ``path``) on the CPU in f64: the card's error may be no more
    than twice the CPU's own f32 error (both f32 outputs carry the roundings
    of 24 layers, summed in another order, so they differ from each other by
    more than 1e-4 of max|ref|: the f32-against-f32 error is logged)."""
    import torch

    from ml_mdm_tpu_torch.language_models import t5

    enc = t5.load_t5_from_torch(path, "cpu")
    ids = torch.from_numpy(tokens)
    with torch.no_grad():
        cpu32 = enc(ids, mask) * mask[..., None]
        cpu64 = enc.double()(ids, mask.double()) * mask.double()[..., None]
    e32, e_card, e_cpu = rel_err(card, cpu32), rel_err(card, cpu64), rel_err(cpu32, cpu64)
    ok = e_card <= 2 * e_cpu
    log(f"web demo text tower, card against CPU: against the f64 CPU output the card's f32 "
        f"{e_card:.4e}, the CPU's f32 {e_cpu:.4e} (limit twice the CPU's); f32 against f32 "
        f"{e32:.4e}; max|ref| {float(cpu64.abs().max()):.4f}: {ok}")
    if not ok:
        raise AssertionError("web demo: the text tower on the card disagrees with the CPU")


def _levels(a, b):
    """(largest, count, mean) of the uint8 level differences of two images."""
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), int((d > 0).sum()), float(d.mean())


def within_spread(plain, again, other, what: str) -> bool:
    """Whether ``other`` is as close to two plain images of its query as they
    are to each other: its largest level difference from each within twice
    theirs plus one level, its mean difference within twice theirs plus 0.05;
    bitwise equal where the two plain images are, as they are under the seed
    contract (``helpers.reproducible``: K2 takes its statistics in a fixed
    order, cuDNN runs deterministic algorithms). The spread is kept for a
    caller that compares calls of different shapes, whose libraries may
    choose other algorithms."""
    pp, op, oa = _levels(plain, again), _levels(other, plain), _levels(other, again)
    log(f"web demo, {what}: largest, count, mean of the level differences of {plain.size} "
        f"values: plain vs plain again {pp}, against plain {op}, against plain again {oa}")
    if pp[0] == 0:
        return op[0] == 0
    return max(op[0], oa[0]) <= 2 * pp[0] + 1 and max(op[2], oa[2]) <= 2 * pp[2] + 0.05


def check_stream(url: str, q: dict, pipe, plain, again, streamed):
    """The streamed final image against the plain ones, on the kernel
    route: the two plain calls bitwise equal, and the streamed image bitwise
    equal to them (``reproducible``); ``within_spread`` (then bitwise)
    holds it too, and a planted fault, the same query at DDIM-49, must fail
    that rule. On the vision model's plain route (``use_kernels(False)``) a
    DDIM-10 stream must equal its plain request bit for bit as well, so a
    frame off by one or a missing final clip shows on either route."""
    reproducible("web demo 256px request, kernel route: two plain calls from one seed", plain,
                 again)
    reproducible("web demo 256px request, kernel route: streamed against plain", plain,
                 streamed)
    if not within_spread(plain, again, streamed, "the streamed image (kernel route)"):
        raise AssertionError("web demo: the streamed image is not the plain one")
    fault, _, _, _ = demo_request(url, dict(q, num_inference_steps=49), False,
                                  "planted fault: DDIM-49")
    if within_spread(plain, again, fault, "a planted fault, the DDIM-49 image"):
        raise AssertionError("web demo: the stream's check accepts the DDIM-49 image")
    pipe.vision_module.use_kernels(False)
    try:
        short = dict(q, num_inference_steps=10)
        img_p, wall_p, _, _ = demo_request(url, short, False, "plain route, plain request")
        img_s, wall_s, _, _ = demo_request(url, short, True, "plain route, streamed request")
    finally:
        pipe.vision_module.use_kernels(True)
    lv = _levels(img_p, img_s)
    log(f"web demo, plain route, DDIM-10: plain {wall_p:.4f} s, streamed {wall_s:.4f} s wall; "
        f"streamed against plain {lv} (largest, count, mean): bitwise {lv[0] == 0}")
    if lv[0] != 0:
        raise AssertionError("web demo: on the plain route the streamed image is not the plain one")


def path_demo(dev, tmp: str):
    """Phase 8: the web demo's server (``ml_mdm_tpu_torch/clis/
    generate_sample.py``) on cc12m_256x256 with the flan-t5-xl-shaped text
    tower in the local directory ``tmp`` (``write_text_tower``), driven
    through HTTP."""
    import urllib.request

    import numpy as np
    import torch

    from ml_mdm_tpu_torch.clis import generate_sample as gs
    from ml_mdm_tpu_torch.config import get_arguments
    from ml_mdm_tpu_torch.reader import process_text

    q = DEMO_QUERY
    batch = q["batch_size"]
    log(f"web demo on {nvidia_smi_line()}")
    with phase("web demo: start the server (cc12m_256x256, --text-model that directory)"):
        t0 = time.perf_counter()
        args = get_arguments(["--config_path", DEMO_CONFIG, "--text-model", tmp], mode="demo")
        args.model_file = ""
        server = gs.make_builtin_server(args, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
    try:
        models = gs._CACHE[f"{DEMO_CONFIG}::"]
        pipe, side, lm = models["pipeline"], models["image_side"], models["language_model"]
        log(f"server set up in {time.perf_counter() - t0:.3f} s: text tower "
            f"{sum(p.numel() for p in lm.encoder.parameters())} parameters "
            f"({next(lm.encoder.parameters()).dtype}), vision model "
            f"{sum(p.numel() for p in pipe.vision_module.parameters())} parameters "
            f"({next(pipe.vision_module.parameters()).dtype}), side {side}, text width "
            f"{lm.embed_dim}")
        url = f"http://127.0.0.1:{server.server_port}"
        k2_keys, _ = record_launch_shapes(
            forward_inputs(pipe, dev, 2 * batch, side, lm.embed_dim))
        required = ("K1", "K2") + modes(k2_keys)
        if "K2·struct" not in required:
            raise AssertionError("web demo: the 256px forward has no packed launch shape")
        with phase("web demo: /choices, a plain request, the same streamed, plain again, "
                   "another seed"):
            choices = json.loads(urllib.request.urlopen(f"{url}/choices", timeout=60).read())
            log(f"/choices: {len(choices['configs'])} configs, "
                f"{len(choices['checkpoints'])} checkpoints")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            # the server's first request builds the sampling weights' layouts
            img_p, wall_p, _, _ = demo_request(url, q, False, "plain request")
            img_s, wall_s, first, n_prev = demo_request(url, q, True, "streamed request")
            img_r, wall_r, _, _ = demo_request(url, q, False, "plain request again")
            img_o, wall_o, _, _ = demo_request(url, dict(q, seed=1), False, "seed 1")
            counts = read_counts("the web demo's four requests", required)
            peak = torch.cuda.max_memory_allocated(dev)
            for k in ("K3", "K3·A", "K3·B"):
                if counts[k]:
                    raise AssertionError(f"web demo: {k} launched {counts[k]} times")
            log(f"web demo launches: K2·pipe {counts['K2·pipe']}, K2·N {counts['K2·N']}, "
                f"K2·proj {counts['K2·proj']}")
            for what, wall in (("plain (the first)", wall_p), ("streamed", wall_s),
                               ("plain again", wall_r), ("seed 1", wall_o)):
                log(f"web demo {what} request: batch {batch}, DDIM-{q['num_inference_steps']}, "
                    f"guidance {q['guidance_scale']}: {wall:.4f} s wall, "
                    f"{batch / wall:.4f} samples/s")
            log(f"web demo streamed request: {n_prev} previews, the first after {first:.4f} s")
            log(f"web demo: peak device memory over the requests {peak} bytes "
                f"({peak / 2**30:.3f} GiB)")
            for img, what in ((img_p, "plain"), (img_s, "streamed final"),
                              (img_r, "plain again"), (img_o, "seed 1")):
                check_grid(img, batch, side, f"web demo {what} image")
            if np.array_equal(img_o, img_p):
                raise AssertionError("web demo: seed 1 gave seed 0's image")
        with phase("web demo: the streamed image against the plain ones, a planted fault, "
                   "the plain route"):
            check_stream(url, q, pipe, img_p, img_r, img_s)
        with phase("web demo: the text tower on the request's captions, card against CPU"):
            tok = models["tokenizer"]
            tokens = np.asarray(process_text([q["negative_prompt"], q["prompt"]], tok,
                                             args.reader_config))
            ms = cuda_ms(lambda: lm({"tokens": tokens}, tok), warmup=2, reps=5)
            log(f"web demo text tower, tokens {tokens.shape}, f32: {ms:.4f} ms (CUDA events, "
                f"median of 5)")
            got, mask = lm({"tokens": tokens}, tok)
            check_tower_on_cpu(tmp, tokens, got.cpu(), mask.cpu())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        gs._CACHE.clear()
    return counts, dict(t5_ms=ms, wall_s=wall_s, first_s=first)


# -- the training CLI and generate_batch ---------------------------------------------

CLI_CONFIG = "configs/models/cc12m_64x64.yaml"
CLI_PROMPTS = "data/prompts_cc12m-64x64.tsv"
CLI_IMAGES = 512
CLI_STEPS, CLI_SAVE = 12, 6
CLI_BATCH = 32


def write_shard(path: str):
    """One tar shard of CLI_IMAGES JPEGs (quality 90), each side drawn from
    256-512 px by a generator seeded by SEED (smooth colour fields: seeded
    8 x 8 noise upsampled), captioned in turn by the lines of CLI_PROMPTS;
    its TSV and an index TSV of it. Returns the index's path."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    with open(CLI_PROMPTS, encoding="utf-8") as f:
        next(f)
        captions = [line.strip() for line in f if line.strip()]
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    size = 0
    with tarfile.open(f"{path}/images_00000.tar", "w", format=tarfile.USTAR_FORMAT) as tf, \
            open(f"{path}/images_00000.tsv", "w", encoding="utf-8") as tsv:
        tsv.write("tar\tfile\tcaption\n")
        for i in range(CLI_IMAGES):
            w, h = (int(v) for v in rng.integers(256, 513, size=2))
            small = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
            buf = io.BytesIO()
            small.resize((w, h), Image.BICUBIC).save(buf, "JPEG", quality=90)
            info = tarfile.TarInfo(f"{i:010d}.jpg")
            info.size = len(buf.getvalue())
            size += info.size
            tf.addfile(info, io.BytesIO(buf.getvalue()))
            tsv.write(f"{path}/images_00000.tar\t{info.name}\t{captions[i % len(captions)]}\n")
    with open(f"{path}/index.tsv", "w") as f:
        f.write(f"filename\n{path}/images_00000.tsv\n")
    log(f"data: {CLI_IMAGES} JPEGs (quality 90, sides 256-512 px), {size} bytes, captions from "
        f"{CLI_PROMPTS}, written in {time.perf_counter() - t0:.3f} s")
    return f"{path}/index.tsv"


class CliProfiler:
    """A profiler over one iteration of ``train_parallel.main``'s loop in
    this process: from its n-th ``load_batch`` to the next one (the text
    tower, the step, the metrics, the next reader batch), taken twice
    (n - 2 and n; the first pays the tracer's set-up) and the second kept."""

    def __init__(self, profile_at: int):
        self.profile_at = profile_at
        self.calls = 0
        self.prof = None
        self.window = None

    def __enter__(self):
        from ml_mdm_tpu_torch.clis import train_parallel

        self._tp, self._load = train_parallel, train_parallel.load_batch
        self._tp.load_batch = self._load_batch
        return self

    def _load_batch(self, *a):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.calls += 1
        n = self.profile_at
        if self.calls in (n - 2, n):
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t0 = time.perf_counter()
        elif self.calls in (n - 1, n + 1):
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.window = time.perf_counter() - self._t0
        return self._load(*a)

    def __exit__(self, *exc):
        self._tp.load_batch = self._load


def cli_args(argv, mode):
    from ml_mdm_tpu_torch.config import get_arguments

    return get_arguments(["--config_path", CLI_CONFIG, "--seed", str(SEED), "--device", "cuda",
                          *argv], mode=mode)


def check_cli_run(history, what: str, first: int, last: int):
    """Every step from ``first`` to ``last`` of ``train_parallel.main``'s
    history has a finite loss."""
    nums = [n for n, *_ in history]
    if nums != list(range(first, last + 1)):
        raise AssertionError(f"{what}: steps consumed {nums}, expected {first}..{last}")
    bad = [(n, loss) for n, loss, *_ in history if not math.isfinite(loss)]
    if bad:
        raise AssertionError(f"{what}: non-finite losses {bad}")
    log(f"{what}: losses " + ", ".join(f"{n}: {loss:.6f} (norm {norm:.4f})"
                                      for n, loss, norm, _ in history))


def state_tensors(state):
    """Parameters, EMA and the Adam state of a train state, by name."""
    out = {f"param {k}": p.detach() for k, p in state.params.items()}
    out.update({f"ema {k}": v for k, v in state.ema_params.items()})
    for k, p in state.params.items():
        for name, v in state.optimizer.state.get(p, {}).items():
            out[f"{name} {k}"] = v
    return out


def path_cli(dev, tower: str, preset_steps_s: float):
    """Phase 9: the user's path of training and evaluation through the
    port's own CLIs, in this process (so the launch counts can be read):
    a tar shard of JPEGs made from the seed, the reader alone, the C++ data
    plane, ``train_parallel`` on cc12m_64x64 at its YAML's batch with the
    flan-t5-xl-shaped tower at ``tower`` (12 steps, saves at 6 and 12), the
    train state reloaded bit for bit, a resume from step 6, and
    ``generate_batch`` on the step-12 checkpoint. The checkpoints (about 11
    GB a save) are deleted at the end; the samples stay under
    chiprun_out/."""
    import gc
    import logging
    import os
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from ml_mdm_tpu_torch import native, reader
    from ml_mdm_tpu_torch.clis import generate_batch, train_parallel
    from ml_mdm_tpu_torch.config import get_model
    from ml_mdm_tpu_torch.language_models.factory import create_tokenizer
    from ml_mdm_tpu_torch.presets import build_unet
    from ml_mdm_tpu_torch.trainer import TrainerConfig, TrainState
    from ml_mdm_tpu_torch.utils import checkpoint as ckpt

    out = os.path.abspath("chiprun_out/cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  cli: %(message)s"))
    root = logging.getLogger()
    # the CLIs' log on stdout alone for the phase (an earlier phase may
    # have given the root logger its default stderr handler)
    handlers, level = root.handlers[:], root.level
    root.handlers = [handler]
    root.setLevel(logging.INFO)
    result = {}
    try:
        with tempfile.TemporaryDirectory() as data:
            with phase("CLI: a tar shard of JPEGs and its index, from the seed"):
                index = write_shard(data)
                free = shutil.disk_usage(out).free
                log(f"disk free under {out}: {free} bytes")
            with phase("CLI: the C++ data plane (g++ at first use)"):
                ok = native.available()
                report = native.build_report()
                log(f"data plane: {report.get('command', 'already built')}: return code "
                    f"{report.get('returncode')}, {report.get('seconds', 0.0):.3f} s, "
                    f"library {report.get('path')}, available {ok}")
                if not ok:
                    log("data plane unavailable (jpeglib.h or g++ missing?): the reader decodes "
                        "with PIL and tokenizes with the Python search; output: "
                        f"{report.get('output', '')[-1500:]}")
            with phase("CLI: the reader alone, 20 batches of 32"):
                args = cli_args(["--file-list", index], "trainer")
                side = args.reader_config.image_size
                tok = create_tokenizer(args.vocab_file)
                loader = reader.get_dataset_partition(
                    0, 1, tok, CLI_BATCH, index, args.reader_config, -1, is_index_file=True)
                t0 = time.perf_counter()
                firsts = []
                try:
                    for i, batch in enumerate(loader):
                        firsts.append(time.perf_counter() - t0)
                        if batch["image"].shape != (CLI_BATCH, side, side, 3):
                            raise AssertionError(f"reader: batch shape {batch['image'].shape}")
                        if i == 19:
                            break
                finally:
                    loader.close()
                wall = firsts[-1]
                rate = 20 * CLI_BATCH / wall
                steady = 19 * CLI_BATCH / (wall - firsts[0])
                log(f"reader: 20 batches of {CLI_BATCH} in {wall:.4f} s: {rate:.2f} images/s "
                    f"({steady:.2f} after the first batch, which came at {firsts[0]:.4f} s), "
                    f"{min(args.reader_config.num_readers, 8)} workers on {os.cpu_count()} "
                    f"cores; decodes {loader.decodes}")
                result.update(reader_images_s=rate, reader_steady_images_s=steady,
                              decodes=dict(loader.decodes))
            common = ["--file-list", index, "--text-model", tower, "--fp16", "1",
                      "--batch-size", str(CLI_BATCH), "--num-training-steps", str(CLI_STEPS),
                      "--save-freq", str(CLI_SAVE), "--warmup-steps", "10"]
            run1, run2 = f"{out}/run1", f"{out}/resumed"
            with phase(f"CLI: train_parallel, cc12m_64x64, batch {CLI_BATCH}, {CLI_STEPS} steps, "
                       f"--fp16 1, saves at {CLI_SAVE} and {CLI_STEPS}"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                t0 = time.perf_counter()
                history = []
                state = train_parallel.main(cli_args(common + ["--output-dir", run1], "trainer"),
                                            history)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts_train = read_counts("the training CLI's 12 steps", TRAINING_KERNELS)
                peak = torch.cuda.max_memory_allocated(dev)
                check_cli_run(history, "CLI run", 1, CLI_STEPS)
                if state.step != CLI_STEPS:
                    raise AssertionError(f"CLI run: {CLI_STEPS - state.step} steps skipped")
                n_params = sum(p.numel() for p in state.params.values())
                per_step = statistics.fmean(t for n, *_, t in history if n > 2)
                log(f"CLI run: {n_params} parameters, {CLI_STEPS} steps in {wall:.3f} s wall "
                    f"(set-up and saves included); the CLI's step time over steps 3-{CLI_STEPS} "
                    f"{per_step * 1e3:.3f} ms: {1 / per_step:.4f} steps/s, "
                    f"{CLI_BATCH / per_step:.2f} images/s, against the 64px training phase's "
                    f"{preset_steps_s:.4f} steps/s (random batches on the card, same call); peak "
                    f"device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
                for n in (CLI_SAVE, CLI_STEPS):
                    for name in (f"vis_model_{n:06d}.pth", f"vis_model_noema_{n:06d}.pth",
                                 f"train_state_{n:06d}/state.pt",
                                 f"train_state_{n:06d}/train_meta.json"):
                        if not os.path.exists(f"{run1}/{name}"):
                            raise AssertionError(f"CLI run: {name} was not written")
                log(f"CLI run: checkpoints written at steps {CLI_SAVE} and {CLI_STEPS}: "
                    f"{sorted(os.listdir(run1))}")
                result.update(cli_steps_s=1 / per_step, cli_wall_s=wall, cli_peak=peak,
                              preset_steps_s=preset_steps_s, n_params=n_params,
                              history=history)
            with phase(f"CLI: train_state_{CLI_STEPS:06d} into a fresh state, bit for bit"):
                args = cli_args(common, "trainer")
                args.unet_config.conditioning_feature_dim = FLAN_T5_XL["d_model"]
                module = build_unet(get_model(args.model), args.unet_config, dev, SEED + 1,
                                    dtype=torch.float32).train()
                fresh = TrainState.create(module, TrainerConfig(use_adamw=True))
                fresh, other = ckpt.load_train_state(f"{run1}/train_state_{CLI_STEPS:06d}", fresh)
                want, got = state_tensors(state), state_tensors(fresh)
                if set(want) != set(got) or fresh.step != state.step:
                    raise AssertionError(f"train state: keys or step differ ({fresh.step})")
                diff = [k for k in want if want[k].dtype != got[k].dtype
                        or not torch.equal(want[k], got[k])]
                if diff:
                    raise AssertionError(f"train state: {len(diff)} tensors differ: {diff[:6]}")
                log(f"train state reloaded: step {fresh.step}, {len(want)} tensors (parameters, "
                    f"EMA, both Adam moments, counts) bitwise equal; meta {other}")
                del module, fresh, state, want, got
                gc.collect()
                torch.cuda.empty_cache()
                for name in (f"vis_model_{CLI_STEPS:06d}.pth", f"vis_model_noema_{CLI_STEPS:06d}.pth"):
                    os.remove(f"{run1}/{name}")
                shutil.rmtree(f"{run1}/train_state_{CLI_STEPS:06d}")
            with phase(f"CLI: --resume-from-train-state train_state_{CLI_SAVE:06d} to step "
                       f"{CLI_STEPS}, one iteration profiled"):
                history = []
                with CliProfiler(profile_at=CLI_STEPS - CLI_SAVE - 1) as rec:
                    state = train_parallel.main(cli_args(
                        common + ["--output-dir", run2, "--resume-from-train-state",
                                  f"{run1}/train_state_{CLI_SAVE:06d}"], "trainer"), history)
                check_cli_run(history, "resumed run", CLI_SAVE + 1, CLI_STEPS)
                if state.step != CLI_STEPS:
                    raise AssertionError(f"resumed run: ended at step {state.step}")
                busy, window = busy_and_window(rec.prof.events())
                if busy is None:
                    log("CLI iteration profile: the profiler recorded no device time")
                else:
                    log(f"CLI iteration profile (step {CLI_STEPS - 1}: text tower, step, metrics, "
                        f"next reader batch): device busy {busy:.3f} ms of a {window:.3f} ms "
                        f"window ({rec.window * 1e3:.3f} ms on the host clock), idle share "
                        f"{1 - busy / window:.4f}")
                    top_kernels(rec.prof.events(), busy, 12)
                    tower_ms = sum(e.device_time_total for e in rec.prof.events()
                                   if e.name == "text tower" and e.device_type.name == "CPU") / 1e3
                    log(f"  the text tower (its range, f32 on 32 captions): {tower_ms:.3f} ms "
                        f"device, {100 * tower_ms / busy:.1f}% of busy")
                    result["tower_ms"] = tower_ms
                result.update(busy_ms=busy, window_ms=window)
                del state
                gc.collect()
                torch.cuda.empty_cache()
            with phase(f"CLI: generate_batch on vis_model_{CLI_STEPS:06d}.pth, 64 samples, batch "
                       f"{CLI_BATCH}, guidance 5, DDIM-50, eta 0"):
                samples = f"{out}/samples"
                times = []
                reset_counts()
                t0 = time.perf_counter()
                n = generate_batch.main(
                    cli_args(["--text-model", tower, "--model-file",
                              f"{run2}/vis_model_{CLI_STEPS:06d}.pth", "--test-file-list",
                              index, "--sample-dir", samples, "--min-examples", "64",
                              "--batch-size", str(CLI_BATCH)], "sampler"),
                    negative_prompt="low quality", guidance_scale=5.0,
                    num_inference_steps=50, ddim_eta=0.0, times=times)
                wall = time.perf_counter() - t0
                counts_gen = read_counts("generate_batch", SAMPLING_KERNELS)
                rank0 = f"{samples}/rank0"
                names = sorted(os.listdir(rank0))
                s_png = [f for f in names if f.startswith("s_")]
                refs = [f for f in names if f.startswith("ref_")]
                with open(f"{rank0}/lst.json") as f:
                    manifest = json.load(f)
                if n != 64 or len(s_png) != 64 or len(refs) != 64 or sorted(manifest) != s_png \
                        or not os.path.exists(f"{samples}/index.html"):
                    raise AssertionError(f"generate_batch: {n} samples, {len(s_png)} s_*.png, "
                                         f"{len(refs)} ref_*.png, {len(manifest)} in lst.json")
                pixels = np.stack([np.asarray(Image.open(f"{rank0}/{f}")) for f in s_png])
                if pixels.shape != (64, side, side, 3) or pixels.min() == pixels.max():
                    raise AssertionError(f"generate_batch: samples {pixels.shape}, values "
                                         f"{pixels.min()}..{pixels.max()}")
                rate = n / sum(times)
                log(f"generate_batch: {n} samples, {len(refs)} references, lst.json, index.html; "
                    f"sampling {[round(t, 4) for t in times]} s: {rate:.4f} samples/s; "
                    f"{wall:.3f} s wall in all (set-up, references, checkpoint); sample pixels "
                    f"{pixels.min()}..{pixels.max()}, mean {pixels.mean():.3f}, std "
                    f"{pixels.std():.3f}")
                result.update(samples_s=rate, generate_wall_s=wall)
    finally:
        root.handlers = handlers
        root.setLevel(level)
        for run in ("run1", "resumed"):
            shutil.rmtree(f"{out}/{run}", ignore_errors=True)  # ~11 GB a save
    cli = {"K1": counts_train["K1"] + counts_gen["K1"],
           "K2 64px": counts_train["K2"] + counts_gen["K2"],
           **{k: counts_gen[k] for k in ("K2·N", "K2·proj")},
           **{k: counts_train[k] for k in ("K3", "K3·A", "K3·B")}}
    return cli, result


# -- evaluation: run_torchmetrics on phase 9's samples ---------------------------------

# openai/clip-vit-base-patch16's published config.json (its sizes, and the
# older configs' eos_token_id 2: pool at the largest id)
CLIP_B16 = {
    "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": 512,
    "logit_scale_init_value": 2.6592,
    "text_config": {"hidden_size": 512, "intermediate_size": 2048, "num_attention_heads": 8,
                    "num_hidden_layers": 12, "max_position_embeddings": 77, "vocab_size": 49408,
                    "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5, "bos_token_id": 0,
                    "eos_token_id": 2, "pad_token_id": 1, "projection_dim": 512},
    "vision_config": {"hidden_size": 768, "intermediate_size": 3072, "num_attention_heads": 12,
                      "num_hidden_layers": 12, "image_size": 224, "patch_size": 16,
                      "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5, "num_channels": 3,
                      "projection_dim": 512},
}
EVAL_SAMPLES = 64


def clip_vocab():
    """A synthetic byte-level BPE vocabulary: the 256 byte characters, their
    ``</w>`` forms, the merges that build the 200 commonest words of
    CLI_PROMPTS left to right (each product made before a later merge uses
    it), then ``<|startoftext|>`` and ``<|endoftext|>``, the largest ids.
    Returns (vocab, merges)."""
    from collections import Counter

    from ml_mdm_tpu_torch.language_models.clip_tokenizer import BYTE_ENCODER

    with open(os.path.join(HERE, CLI_PROMPTS), encoding="utf-8") as f:
        words = Counter(re.findall(r"[a-z]+", f.read().lower()))
    chars = [BYTE_ENCODER[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    merges = []
    for word, _ in sorted(words.items(), key=lambda kv: (-kv[1], kv[0]))[:200]:
        sym = list(word[:-1]) + [word[-1] + "</w>"]
        cur = sym[0]
        for nxt in sym[1:]:
            if cur + nxt not in vocab:
                merges.append((cur, nxt))
                vocab[cur + nxt] = len(vocab)
            cur += nxt
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def write_clip_tower(dev, path: str, config=CLIP_B16, image_side: int = 224):
    """A CLIP model of ``config`` (by default ViT-B/16's published shape)
    with seeded random weights (``init_clip_``), written to ``path`` as a
    Hugging Face CLIP directory: ``config.json``, ``model.safetensors``
    (f32), ``preprocessor_config.json`` (OpenAI's, at ``image_side``), and
    the tokenizer files of ``clip_vocab``. Returns the parameter count."""
    import torch

    from ml_mdm_tpu_torch.language_models import clip

    t0 = time.perf_counter()
    with torch.device(dev):
        model = clip.CLIPModel(clip.CLIPConfig.from_hf_config(config))
    clip.init_clip_(model, torch.Generator(device=dev).manual_seed(SEED))
    n = sum(p.numel() for p in model.parameters())
    clip.write_safetensors({k: v.cpu() for k, v in model.state_dict().items()},
                           f"{path}/model.safetensors")
    del model
    with open(f"{path}/config.json", "w") as f:
        json.dump(config, f)
    with open(f"{path}/preprocessor_config.json", "w") as f:
        json.dump({"crop_size": image_side, "do_center_crop": True, "do_normalize": True,
                   "do_resize": True, "feature_extractor_type": "CLIPFeatureExtractor",
                   "image_mean": clip.OPENAI_CLIP_MEAN, "image_std": clip.OPENAI_CLIP_STD,
                   "resample": 3, "size": image_side}, f)
    vocab, merges = clip_vocab()
    with open(f"{path}/vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(f"{path}/merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    specials = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
    with open(f"{path}/special_tokens_map.json", "w") as f:
        json.dump(specials, f)
    with open(f"{path}/tokenizer_config.json", "w") as f:
        json.dump({**specials, "model_max_length": 77, "tokenizer_class": "CLIPTokenizer"}, f)
    log(f"CLIP tower: {n} parameters, {len(vocab)} tokens ({len(merges)} merges), written in "
        f"{time.perf_counter() - t0:.3f} s")
    return n


def rel_err2(got, ref) -> float:
    """||got - ref|| / ||ref|| over all values (the 2-norm relative error)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-300))


def check_clip_on_cpu(path: str, feats, images, captions):
    """The card's f32 image and text features of ``feats`` (the CLI's
    ``ClipFeatures``) against the same tower on the CPU in f64: the card's
    error may be no more than twice the CPU's own f32 error (PR 11's rule
    for the T5 tower), as 2-norm relative errors over all 4 x 512 values.
    The max-norm error, logged beside, is not held to it: its ratio moves
    from draw to draw (on an NVIDIA H100 80GB HBM3, 1.52-2.33 for the image
    tower over 12 draws of 4 images, where the 2-norm's kept to 1.66-1.81:
    the card's cuBLAS f32 chain sums each layer ~1.7x less exactly than the
    CPU's)."""
    import torch

    from ml_mdm_tpu_torch.language_models import clip

    cpu = clip.load_clip_from_torch(path, "cpu")
    pixels = torch.from_numpy(clip.preprocess_images(images, feats.preprocessor))
    ids, mask = (torch.from_numpy(a) for a in feats.tokenizer(captions))
    with torch.no_grad():
        card = (feats.model.get_image_features(pixels.to(feats.device)).cpu(),
                feats.model.get_text_features(ids.to(feats.device), mask.to(feats.device)).cpu())
        cpu32 = (cpu.get_image_features(pixels), cpu.get_text_features(ids, mask))
        cpu = cpu.double()
        cpu64 = (cpu.get_image_features(pixels.double()), cpu.get_text_features(ids, mask))
    errs = {}
    for i, tower in enumerate(("image", "text")):
        e_card, e_cpu = rel_err2(card[i], cpu64[i]), rel_err2(cpu32[i], cpu64[i])
        errs[tower] = (e_card, e_cpu)
        log(f"evaluation: CLIP {tower} features of {len(images)}, card against CPU: against the "
            f"f64 CPU run the card's f32 {e_card:.4e}, the CPU's f32 {e_cpu:.4e} (2-norm relative; "
            f"limit twice the CPU's; max-norm {rel_err(card[i], cpu64[i]):.4e} and "
            f"{rel_err(cpu32[i], cpu64[i]):.4e}), f32 against f32 "
            f"{rel_err2(card[i], cpu32[i]):.4e}; |ref| {float(cpu64[i].norm()):.4f}: "
            f"{e_card <= 2 * e_cpu}")
        if not e_card <= 2 * e_cpu:
            raise AssertionError(f"evaluation: the CLIP {tower} tower on the card disagrees "
                                 "with the CPU")
    return errs


def path_eval(dev, samples: str):
    """Phase 10: ``run_torchmetrics`` on phase 9's samples with a CLIP
    ViT-B/16-shaped tower of seeded random weights written to a local
    directory; the tower held against an f64 CPU run; the references
    against themselves and, a planted fault, shifted by +40 levels."""
    import numpy as np
    import torch

    from ml_mdm_tpu_torch.clis import run_torchmetrics as rt

    result = {}
    with tempfile.TemporaryDirectory() as tower:
        with phase("evaluation: a CLIP ViT-B/16-shaped tower with seeded random weights, "
                   "written to a local directory"):
            result["clip_params"] = write_clip_tower(dev, tower)
        with phase("evaluation: the tower on the card against an f64 CPU run (4 images, "
                   "4 captions)"):
            refs, ref_caps = rt.load_images(samples, "ref_", EVAL_SAMPLES)
            images, caps = rt.load_images(samples, "s_", EVAL_SAMPLES)
            feats = rt.ClipFeatures(tower, dev)
            result["clip_errs"] = check_clip_on_cpu(tower, feats, images[:4], caps[:4])
            for what, fn, arg in (("image", feats.image_embeds, images),
                                  ("text", feats.text_embeds, caps)):
                fn(arg)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(arg)
                torch.cuda.synchronize()
                rate = len(arg) / (time.perf_counter() - t0)
                result[f"{what}_per_s"] = rate
                log(f"evaluation: the CLIP {what} tower, {len(arg)} a call (preprocessing on "
                    f"the host included): {rate:.2f} features/s")
        with phase(f"evaluation: run_torchmetrics --metrics fid,clip --feature-extractor clip on "
                   f"phase 9's {EVAL_SAMPLES} samples"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = rt.main(["--sample-dir", samples, "--metrics", "fid,clip",
                           "--feature-extractor", "clip", "--clip-model", tower,
                           "--min-examples", str(EVAL_SAMPLES), "--device", dev.type])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            log(f"evaluation: run_torchmetrics {out} in {wall:.3f} s wall (one tower load, "
                f"PNG reads, {2 * EVAL_SAMPLES} images and {EVAL_SAMPLES} captions); peak device "
                f"memory {peak} bytes ({peak / 2**30:.3f} GiB)")
            fid = out.get("fid", float("nan"))
            if out.get("fid_extractor") != "clip" or not (math.isfinite(fid) and fid >= 0):
                raise AssertionError(f"evaluation: fid {fid}, extractor {out.get('fid_extractor')}")
            if not 0 <= out.get("clip_score", -1.0) <= 100:
                raise AssertionError(f"evaluation: clip_score {out.get('clip_score')}")
            result.update(cli=out, cli_wall_s=wall, cli_peak=peak)
        with phase("evaluation: the references against themselves, and shifted by +40 levels"):
            ref_feats = feats(refs)
            shifted = np.clip(refs.astype(np.int16) + 40, 0, 255).astype(np.uint8)
            self_fid = rt.fid_from_features(ref_feats, ref_feats)
            shift_fid = rt.fid_from_features(feats(shifted), ref_feats)
            log(f"evaluation: CLIP FID of the references against themselves {self_fid:.6e}, "
                f"shifted by +40 against them {shift_fid:.6f}, the samples' {fid:.6f} (limit "
                f"for the first 1e-3 of the samples', {1e-3 * fid:.6e}; the second must exceed "
                "it)")
            if not abs(self_fid) <= 1e-3 * fid < shift_fid:
                raise AssertionError(f"evaluation: references against themselves {self_fid}, "
                                     f"shifted {shift_fid}, samples {fid}")
            result.update(self_fid=self_fid, shift_fid=shift_fid)
        del feats
        torch.cuda.empty_cache()
    return result


# -- the quality gate ------------------------------------------------------------------


def gate_run(dev, what: str, dtype, kernels: bool, shapes: bool = False):
    """The quality gate (``tools/quality_gate.py``) on one route: the anchor,
    500 steps, the trained probe, each with the launch counts read; with
    ``shapes``, first every K1, K2 and K3 launch shape of one step and of
    one probe forward held against its plain version. Returns (result,
    launches in training, launches in the probes)."""
    import torch

    from ml_mdm_tpu_torch.tools import quality_gate as qg

    gate = qg.QualityGate(dev, dtype, kernels=kernels)
    totals = {}
    if shapes:
        def one_backward():
            gate.pipeline.vision_module.zero_grad(set_to_none=True)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            batch = {k: v.to(dtype) for k, v in gate.batch.items()}
            gate.pipeline.get_loss(batch, gen)[0].mean().backward()

        k3_box = []
        k2_train, k1_train = record_launch_shapes(
            lambda: k3_box.append(record_k3_shapes(one_backward)), grad=True)
        gate.pipeline.vision_module.zero_grad(set_to_none=True)
        k2_probe, k1_probe = record_launch_shapes(lambda: gate.sample(gate.initial, 0))
        k2_keys = sorted(set(k2_train) | set(k2_probe))
        k1_keys = sorted(set(k1_train) | set(k1_probe))
        log(f"{what}: launch shapes: one step {len(k1_train)} K1, {len(k2_train)} K2, "
            f"{len(k3_box[0])} K3; one probe forward {len(k1_probe)} K1, {len(k2_probe)} K2")
        for key in k2_keys:
            log(f"  K2 {_key_label(key)}")
        totals = check_kernels(k2_keys, k1_keys, dev, "quality gate")
        totals.update(check_k3(k3_box[0], dev, "quality gate"))
    need_train = TRAINING_KERNELS if kernels else ()
    need_probe = ("K1", "K2") if kernels else ()
    reset_counts()
    mse0, fid0 = gate.probe(gate.initial)
    anchor_counts = read_counts(f"{what}: the untrained probe", need_probe)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = gate.train(qg.STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_counts = read_counts(f"{what}: {qg.STEPS} training steps", need_train)
    reset_counts()
    mse1, fid1 = gate.probe(gate.state.ema_params)
    probe_counts = read_counts(f"{what}: the trained probe", need_probe)
    counts = {k: train_counts[k] + anchor_counts[k] + probe_counts[k] for k in train_counts}
    if not kernels and any(counts.values()):
        raise AssertionError(f"{what}: kernels launched on the plain route: {counts}")
    result = {"mse_untrained": mse0, "fid_untrained": fid0, "mse_trained": mse1,
              "fid_trained": fid1, "loss": last["loss"],
              "skipped": gate.state.step != qg.STEPS, "train_seconds": seconds,
              "steps_s": qg.STEPS / seconds}
    log(f"{what}: anchor MSE {mse0:.6f} (> {qg.ANCHOR_MIN}), trained MSE {mse1:.6f} "
        f"(< {qg.MSE_MAX}), pixel FID {fid0:.6f} -> {fid1:.6f}, last loss {last['loss']:.6f}; "
        f"{qg.STEPS} steps in {seconds:.3f} s: {qg.STEPS / seconds:.4f} steps/s")
    return result, train_counts, {k: anchor_counts[k] + probe_counts[k] for k in probe_counts}, \
        totals


def path_gate(dev):
    """Phase 11: the quality gate on the card, twice with the same seeds: (a)
    the kernel route (f32 parameters, bf16 compute: K1, K2 and K3 in the
    steps, K1 and K2 in the probes, every launch shape first held against
    plain) and (b) the plain route (``use_kernels(False)``, f32, no
    kernel). Both must pass. Where (a) fails and (b) passes, the plain
    route in bf16 runs too, to tell bf16 from a kernel fault, and the phase
    fails."""
    import torch

    from ml_mdm_tpu_torch.tools import quality_gate as qg

    runs = {}
    with phase("quality gate (a), kernel route: f32 parameters, bf16 compute, 500 steps"):
        runs["a"] = gate_run(dev, "quality gate (a)", torch.bfloat16, True, shapes=True)
    with phase("quality gate (b), plain route: use_kernels(False), f32, 500 steps"):
        runs["b"] = gate_run(dev, "quality gate (b)", torch.float32, False)
    failed = {}
    for route, (result, *_rest) in runs.items():
        try:
            qg.check(result)
        except AssertionError as e:
            failed[route] = e
    if "a" in failed and "b" not in failed:
        with phase("quality gate: route (a) failed; the plain route in bf16"):
            bf16, *_ = gate_run(dev, "quality gate (plain, bf16)", torch.bfloat16, False)
            try:
                qg.check(bf16)
                log("quality gate: the plain route passes in bf16: a kernel fault")
            except AssertionError as e:
                log(f"quality gate: the plain route fails in bf16 too ({e}): bf16, not a kernel")
    for route, e in failed.items():
        raise AssertionError(f"route ({route}): {e}")
    return runs


# -- phase 12: FSDP training through the CLI --------------------------------------------

FSDP_STEPS = 4


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_bytes(state):
    """This process's parameter, gradient and optimizer bytes, counted from
    its shards (each gradient has its parameter's local shape)."""
    import torch

    local = state.local_params()
    params = sum(t.numel() * t.element_size() for t in local.values())
    opt = sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
              for v in st.values() if torch.is_tensor(v))
    return params, params, opt


def run_cli_ranks(argv, n: int, out: str, history):
    """``train_parallel`` over ``n`` processes, one a card: rank 0 in this
    process (its metrics appended to ``history``), ranks 1..n-1 spawned with
    torchrun's environment, their logs in ``out/rank<r>.log``. Returns rank
    0's state and the other ranks' last log lines."""
    from ml_mdm_tpu_torch.clis import train_parallel

    env_keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    procs = []
    try:
        if n > 1:
            port = str(_free_port())
            for r in range(1, n):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                           MASTER_ADDR="localhost", MASTER_PORT=port, PYTHONPATH=HERE)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ml_mdm_tpu_torch.clis.train_parallel",
                     "--config_path", CLI_CONFIG, "--seed", str(SEED), "--device", "cuda", *argv],
                    env=env, cwd=HERE, stdout=open(f"{out}/rank{r}.log", "w"),
                    stderr=subprocess.STDOUT))
            os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(n),
                              MASTER_ADDR="localhost", MASTER_PORT=port)
        state = train_parallel.main(cli_args(argv, "trainer"), history)
        tails = []
        for r, p in enumerate(procs, start=1):
            code = p.wait(timeout=600)
            with open(f"{out}/rank{r}.log") as f:
                lines = f.read().splitlines()
            if code != 0:
                raise AssertionError(f"rank {r} exited {code}: " + "\n".join(lines[-30:]))
            tails.append([line.strip() for line in lines if "peak device memory" in line])
        return state, tails
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def path_fsdp(dev, tower: str, cli_history, cli_peak):
    """Phase 12: ``train_parallel`` on cc12m_64x64 (batch 32, ``--fp16 1``,
    phase 9's flan-t5-xl-shaped tower and a shard made as phase 9's) with
    ``--mesh-shape data:1,fsdp:N`` for FSDP_STEPS steps, N the cards: one
    process a card over NCCL (``run_cli_ranks``); with one card the CLI
    joins a process group of its own, so the sharded code and its
    collectives run. Every loss finite, no step skipped, K1-K3·B launched;
    the step-4 train state loaded into a plain ``TrainState`` holds rank 0's
    shards bit for bit. Step 1's loss and norm against the data-parallel
    step on the same batch and noise (the step tolerances): with one card
    the step on the batch the run took, in this process; with N the
    data-parallel CLI (``--mesh-shape data:N``) for one step on the same
    processes, both runs with one reader thread a process (a fixed order).
    Phase 9's step 1 beside. Prints each process's shard bytes and peak
    memory beside phase 9's peak."""
    import gc
    import logging

    import torch
    import torch.distributed as dist

    from ml_mdm_tpu_torch import trainer
    from ml_mdm_tpu_torch.clis import train_parallel
    from ml_mdm_tpu_torch.config import get_model, get_pipeline
    from ml_mdm_tpu_torch.presets import build_unet
    from ml_mdm_tpu_torch.utils import checkpoint as ckpt

    n = torch.cuda.device_count()
    out = os.path.abspath("chiprun_out/fsdp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  fsdp: %(message)s"))
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    root.handlers = [handler]
    root.setLevel(logging.INFO)
    result = {}
    try:
        with tempfile.TemporaryDirectory() as data:
            with phase("FSDP: a tar shard of JPEGs and its index, from the seed"):
                index = write_shard(data)
            argv = ["--file-list", index, "--text-model", tower, "--fp16", "1",
                    "--batch-size", str(CLI_BATCH), "--warmup-steps", "10"]
            if n > 1:
                argv += ["--reader_config.num_readers", "1"]
            with phase(f"FSDP: train_parallel, cc12m_64x64, batch {CLI_BATCH}, {FSDP_STEPS} "
                       f"steps, --mesh-shape data:1,fsdp:{n}, {n} process(es)"):
                first = {}
                device_batch = train_parallel._device_batch

                def keep_first(*a):
                    b = device_batch(*a)
                    if not first:
                        first.update({k: v.clone() for k, v in b.items()})
                    return b

                train_parallel._device_batch = keep_first
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                history = []
                t0 = time.perf_counter()
                try:
                    state, tails = run_cli_ranks(
                        argv + ["--mesh-shape", f"data:1,fsdp:{n}", "--num-training-steps",
                                str(FSDP_STEPS), "--save-freq", str(FSDP_STEPS), "--output-dir",
                                out], n, out, history)
                finally:
                    train_parallel._device_batch = device_batch
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts(f"the FSDP run's {FSDP_STEPS} steps", TRAINING_KERNELS)
                peak = torch.cuda.max_memory_allocated(dev)
                check_cli_run(history, "FSDP run", 1, FSDP_STEPS)
                if state.step != FSDP_STEPS:
                    raise AssertionError(f"FSDP run: {FSDP_STEPS - state.step} steps skipped")
                layout = state.layout
                if layout is None or not layout.dims:
                    raise AssertionError("FSDP run: no parameter was sharded")
                pb, gb, ob = shard_bytes(state)
                per_step = statistics.fmean(t for num, *_, t in history if num > 1)
                n_params = sum(p.numel() for p in state.params.values())
                log(f"FSDP run: {len(layout.dims)} of {len(state.params)} parameters sharded "
                    f"over {n} process(es), {n_params} elements; rank 0 holds parameters {pb}, "
                    f"gradients {gb}, optimizer {ob} bytes ({(pb + gb + ob) / 2**30:.3f} GiB), "
                    f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) against phase "
                    f"9's {cli_peak} ({cli_peak / 2**30:.3f} GiB); step time over steps "
                    f"2-{FSDP_STEPS} {per_step * 1e3:.3f} ms ({1 / per_step:.4f} steps/s); "
                    f"{wall:.3f} s wall with set-up and the save")
                for r, lines in enumerate(tails, start=1):
                    log(f"FSDP run, rank {r}: {lines}")
                result.update(fsdp_peak=peak, fsdp_bytes=(pb, gb, ob), fsdp_steps_s=1 / per_step,
                              fsdp_wall_s=wall, shards=len(layout.dims), processes=n)
            with phase(f"FSDP: train_state_{FSDP_STEPS:06d} into a plain TrainState, against "
                       "rank 0's shards bit for bit"):
                args = cli_args(argv, "trainer")
                args.unet_config.conditioning_feature_dim = FLAN_T5_XL["d_model"]
                module = build_unet(get_model(args.model), args.unet_config, dev, SEED + 1,
                                    dtype=torch.float32).train()
                fresh = trainer.TrainState.create(module, trainer.TrainerConfig(use_adamw=True))
                fresh, _ = ckpt.load_train_state(f"{out}/train_state_{FSDP_STEPS:06d}", fresh)
                local = state.local_params()
                names = ckpt.optimizer_names(state)
                opt_local = {names[i]: state.optimizer.state[t] for i, t in enumerate(
                    t for g in state.optimizer.param_groups for t in g["params"])}
                diff = []
                for k, p in fresh.params.items():
                    pairs = [("param", p.detach(), local[k]),
                             ("ema", fresh.ema_params[k], state.ema_params[k])]
                    mine = fresh.optimizer.state[p]
                    pairs += [(m, mine[m], opt_local[k][m]) for m in ("exp_avg", "exp_avg_sq")]
                    for what, full, shard in pairs:
                        if not torch.equal(layout.shard_of(k, full), shard):
                            diff.append(f"{what} {k}")
                    if int(mine["step"]) != int(opt_local[k]["step"]):
                        diff.append(f"step {k}")
                if diff or fresh.step != state.step:
                    raise AssertionError(f"FSDP train state: {len(diff)} tensors differ from the "
                                         f"shards: {diff[:6]} (step {fresh.step})")
                log(f"FSDP train state reloaded: step {fresh.step}, {4 * len(fresh.params)} "
                    "tensors (parameters, EMA, both Adam moments) hold rank 0's shards bitwise")
                del module, fresh, state, local, opt_local
                shutil.rmtree(f"{out}/train_state_{FSDP_STEPS:06d}")
                gc.collect()
                torch.cuda.empty_cache()
            with phase("FSDP: step 1 against the data-parallel step on its batch and noise"):
                nums = {num: (loss, norm) for num, loss, norm, _ in cli_history}
                log(f"phase 9's step 1 (its own batch: the reader's 8 workers fix no order): "
                    f"loss {nums[1][0]:.6f}, norm {nums[1][1]:.4f}")
                if n > 1:
                    dist.destroy_process_group()
                    dp_history = []
                    run_cli_ranks(argv + ["--mesh-shape", f"data:{n}", "--num-training-steps",
                                          "1", "--save-freq", "1000", "--output-dir",
                                          f"{out}/dp"], n, out, dp_history)
                    _, dp_loss, dp_norm, _ = dp_history[0]
                else:
                    args = cli_args(argv, "trainer")
                    args.unet_config.conditioning_feature_dim = FLAN_T5_XL["d_model"]
                    module = build_unet(get_model(args.model), args.unet_config, dev, SEED,
                                        dtype=torch.float32).train()
                    module.set_compute_dtype(torch.bfloat16)
                    pipe = get_pipeline(args.model)(module, args.diffusion_config)
                    tcfg = trainer.TrainerConfig(
                        lr=args.lr, warmup_steps=args.warmup_steps,
                        gradient_clip_norm=args.gradient_clip_norm, use_adamw=args.use_adamw,
                        num_gradient_accumulations=args.num_gradient_accumulations,
                        loss_factor=args.loss_factor)
                    dp_state = trainer.TrainState.create(module, tcfg)
                    gen = torch.Generator(device=dev).manual_seed(
                        train_parallel.step_seed(SEED, 0, 0))
                    _, m = trainer.make_train_step(pipe, tcfg)(dp_state, first, gen)
                    dp_loss, dp_norm = m["loss"], m["grad_norm"]
                    del module, pipe, dp_state
                _, loss, norm, _ = history[0]
                log(f"step 1: FSDP loss {loss:.6f} norm {norm:.4f}; data parallel loss "
                    f"{dp_loss:.6f} norm {dp_norm:.4f}")
                if not (abs(loss - dp_loss) <= 1e-2 * abs(dp_loss)
                        and abs(norm - dp_norm) <= 5e-2 * dp_norm):
                    raise AssertionError("FSDP step 1 is off the data-parallel step")
                result.update(step1=(loss, norm), dp_step1=(dp_loss, dp_norm))
        del first
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        root.handlers = handlers
        root.setLevel(level)
        shutil.rmtree(out, ignore_errors=True)  # ~11 GB a save
        gc.collect()
        torch.cuda.empty_cache()
    fsdp = {"K1": counts["K1"], "K2 64px": counts["K2"],
            **{k: counts[k] for k in ("K3", "K3·A", "K3·B")}}
    return fsdp, result


# -- phase 13: cifar10_32x32, dropout 0.1, through the CLIs -----------------------------

CIFAR_CONFIG = "configs/models/cifar10_32x32.yaml"
CIFAR_STEPS = 10
CIFAR_BATCH = 128
CIFAR_IMAGES = 1280
# the reader settings the categorical recipe needs: data/cifar10.vocab has
# no "<pad>" (the YAML's padding token), and the one-hot reads the second
# token, which is the class name's only after a BOS
CIFAR_READER = ["--reader_config.padding_token", "</s>", "--reader_config.prepad_bos", "true"]
DROPOUT_SIGMAS = 4


def write_cifar_shard(path: str):
    """One tar shard of CIFAR_IMAGES JPEGs (quality 90, sides 32-64 px from
    the seed, seeded 4 x 4 noise upsampled) captioned in turn with the class
    names of data/cifar10.vocab; its TSV and an index. Returns the index."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    with open("data/cifar10.vocab") as f:
        classes = [line.split("\t")[0] for line in f][3:]
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    with tarfile.open(f"{path}/cifar_00000.tar", "w", format=tarfile.USTAR_FORMAT) as tf, \
            open(f"{path}/cifar_00000.tsv", "w") as tsv:
        tsv.write("tar\tfile\tcaption\n")
        for i in range(CIFAR_IMAGES):
            w, h = (int(v) for v in rng.integers(32, 65, size=2))
            small = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
            buf = io.BytesIO()
            small.resize((w, h), Image.BICUBIC).save(buf, "JPEG", quality=90)
            info = tarfile.TarInfo(f"{i:08d}.jpg")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
            tsv.write(f"{path}/cifar_00000.tar\t{info.name}\t{classes[i % len(classes)]}\n")
    with open(f"{path}/index.tsv", "w") as f:
        f.write(f"filename\n{path}/cifar_00000.tsv\n")
    log(f"data: {CIFAR_IMAGES} JPEGs (sides 32-64 px), captions the classes of "
        f"data/cifar10.vocab, written in {time.perf_counter() - t0:.3f} s")
    return f"{path}/index.tsv"


def record_identity_shapes(run):
    """Run ``run()`` (a forward and backward) with ``conv3x3_vjp`` wrapped;
    its distinct launch shapes (B, H, W, C, Cout, residual, packed)."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet

    keys = set()
    vjp = fused_resnet.conv3x3_vjp

    def rec(x, w, bias, residual=None, **kw):
        keys.add((*x.shape, w.shape[-1], residual is not None, bool(kw.get("packed_struct"))))
        return vjp(x, w, bias, residual, **kw)

    fused_resnet.conv3x3_vjp = rec
    try:
        run()
        torch.cuda.synchronize()
    finally:
        fused_resnet.conv3x3_vjp = vjp
    return sorted(keys)


def check_identity_k3(keys, dev, label: str):
    """Each ``conv3x3_vjp`` launch shape (K3 without its chain): the backward
    against autograd of the plain twin (K2_TOL), then its time beside the
    plain backward's, the library's (cuDNN's dgrad and wgrad) and the
    bound: the two convolutions' tensor-core FLOPs (2 x 2 B H W 9 C Cout),
    or the bytes (x and dy read, dx written, the f32 weights read and their
    gradient written, dbias). Returns the totals."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    tot = _new_totals()
    for key in keys:
        bsz, h, w, c, cout, residual, struct = key
        if struct:
            raise AssertionError(f"{label}: a packed identity-prologue launch {key}")
        bf = torch.bfloat16
        x = torch.randn((bsz, h, w, c), generator=g, device=dev).to(bf)
        wt = torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5
        bias = torch.randn((cout,), generator=g, device=dev) * 0.1
        res = torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf) if residual else None
        dy = torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf)

        def backward_of(fn):
            leaves = [t.detach().requires_grad_(True) for t in (x, wt, bias)]
            rl = res.detach().requires_grad_(True) if res is not None else None
            y = fn(*leaves, rl)
            targets = leaves + ([rl] if rl is not None else [])
            return lambda: torch.autograd.grad(y, targets, dy, retain_graph=True)

        kernel = backward_of(lambda *a: fused_resnet.conv3x3_vjp(*a))
        plain = backward_of(lambda xx, ww, bb, rr: fused_resnet.affine_silu_conv3x3_plain(
            xx, None, None, ww, bb, rr, apply_silu=False))
        got, ref = kernel(), plain()
        errs = [rel_err(o, r) for o, r in zip(got, ref)]
        if not max(errs) <= K2_TOL:
            raise AssertionError(f"{label} identity-prologue K3 {key}: rel errs {errs}")
        ms = cuda_ms(kernel)
        pms = cuda_ms(plain, warmup=1, reps=3)
        w16 = wt.to(bf).permute(3, 2, 0, 1)
        dy_nchw, x_nchw = dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)

        def library():
            return (torch.nn.grad.conv2d_input(x_nchw.shape, w16, dy_nchw, padding=1),
                    torch.nn.grad.conv2d_weight(x_nchw, w16.shape, dy_nchw, padding=1),
                    dy.float().sum(dim=(0, 1, 2)))

        lms = cuda_ms(library)
        px = bsz * h * w
        t_ops = 4 * px * 9 * c * cout / PEAK_BF16_TENSOR
        t_bytes = (2 * px * c * 2 + 2 * px * cout + 2 * 4 * 9 * c * cout + 4 * cout) / PEAK_HBM
        bound, by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")
        log(f"{label} identity-prologue K3 B={bsz} {h}x{w} {c}->{cout}"
            f"{' residual' if residual else ''}: rel errs (dx, dw, dbias"
            f"{', dres' if residual else ''}) {', '.join(f'{e:.3e}' for e in errs)}; backward "
            f"{ms:.4f} ms plain {pms:.4f} ms library {lms:.4f} ms bound {bound:.4f} ms ({by})")
        _add(tot, max(abs_err(o, r) for o, r in zip(got, ref)), ms, pms, lms, bound, by)
    log(f"{label} identity-prologue K3 over {tot['shapes']} shapes: backward {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms")
    return tot


def path_cifar(dev):
    """Phase 13: configs/models/cifar10_32x32.yaml (dropout 0.1, categorical
    conditioning through data/cifar10.vocab) at its full width and batch
    through the port's CLIs, bf16 compute (``--fp16 1``; the YAML's 0 would
    run plain PyTorch on the card): every K1, K2, K3 and identity-prologue
    K3 launch shape of one step held against plain; one step with kernels
    against one without, the same masks (the step tolerances); then
    ``train_parallel`` on a shard of class-captioned JPEGs for CIFAR_STEPS
    steps (losses finite, each mask's kept fraction within 4 sigma of 0.9,
    K3·id launched), steps/s, and ``generate_batch`` on its checkpoint
    (CIFAR_BATCH samples, DDIM-50), samples/s. Returns (launches, shape
    totals, result)."""
    import gc
    import logging

    import numpy as np
    import torch

    from ml_mdm_tpu_torch import diffusion
    from ml_mdm_tpu_torch.clis import generate_batch, train_parallel
    from ml_mdm_tpu_torch.config import get_arguments, get_model, get_pipeline
    from ml_mdm_tpu_torch.models import layers
    from ml_mdm_tpu_torch.presets import build_unet

    out = os.path.abspath("chiprun_out/cifar")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    result = {}

    def args_of(argv, mode):
        return get_arguments(["--config_path", CIFAR_CONFIG, "--seed", str(SEED), "--device",
                              "cuda", *CIFAR_READER, *argv], mode=mode)

    args = args_of([], "trainer")
    args.unet_config.conditioning_feature_dim = 13  # the vocabulary's one-hot
    with phase(f"cifar10_32x32: every launch shape of a batch-{CIFAR_BATCH} step, held "
               "against plain; a kernel step against a plain step with the same masks"):
        module = build_unet(get_model(args.model), args.unet_config, dev, SEED,
                            dtype=torch.float32).train()
        module.set_compute_dtype(torch.bfloat16)
        n_params = sum(p.numel() for p in module.parameters())
        pipe = get_pipeline(args.model)(module, args.diffusion_config)
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        classes = torch.randint(3, 13, (CIFAR_BATCH,), generator=gen, device=dev)
        batch = {"images": (torch.rand((CIFAR_BATCH, 32, 32, 3), generator=gen, device=dev) * 2
                            - 1).to(torch.bfloat16),
                 "lm_outputs": torch.nn.functional.one_hot(classes, 13).float()[:, None, :]
                 .to(torch.bfloat16)}
        time_ = torch.randint(0, 1000, (CIFAR_BATCH,), generator=gen, device=dev)
        eps = torch.randn((CIFAR_BATCH, 32, 32, 3), generator=gen, device=dev)
        masks = layers.DropoutMasks(module, gen)

        def one_backward():
            module.zero_grad(set_to_none=True)
            loss = pipe.get_loss(batch, time=time_, eps=eps, dropout=masks)[0].mean()
            loss.backward()
            return float(loss)

        k3_box, id_box = [], []
        k2_keys, k1_keys = record_launch_shapes(lambda: k3_box.append(record_k3_shapes(
            lambda: id_box.append(record_identity_shapes(one_backward)))), grad=True)
        log(f"cifar10_32x32 ({n_params} parameters): {len(k1_keys)} K1, {len(k2_keys)} K2, "
            f"{len(k3_box[0])} K3 and {len(id_box[0])} identity-prologue K3 launch shapes in "
            f"a batch-{CIFAR_BATCH} step")
        tot = check_kernels(k2_keys, k1_keys, dev, "cifar train")
        shapes = {"K1": tot["K1"], "K2": tot["K2"], **check_k3(k3_box[0], dev, "cifar train"),
                  "K3·id": check_identity_k3(id_box[0], dev, "cifar train")}
        runs = []
        for kernels in (True, False):
            module.use_kernels(kernels)
            loss = one_backward()
            grads = torch.cat([p.grad.flatten() for p in module.parameters()
                               if p.grad is not None])
            runs.append((loss, grads))
        module.use_kernels(True)
        (lk, gk), (lp, gp) = runs
        cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
        log(f"cifar10_32x32 step, the same masks: loss kernels {lk:.6f} plain {lp:.6f}, gradient "
            f"norm {float(gk.norm()):.6f} against {float(gp.norm()):.6f}, cosine {cos:.6f}")
        if not (abs(lk - lp) <= 1e-2 * abs(lp)
                and abs(float(gk.norm()) - float(gp.norm())) <= 5e-2 * float(gp.norm())
                and cos >= 0.99):
            raise AssertionError("cifar10_32x32: kernel step off the plain step")
        del module, pipe, runs, gk, gp, batch
        gc.collect()
        torch.cuda.empty_cache()
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  cifar: %(message)s"))
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    root.handlers = [handler]
    root.setLevel(logging.INFO)
    made = []

    class Recorded(layers.DropoutMasks):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    try:
        with tempfile.TemporaryDirectory() as data:
            index = write_cifar_shard(data)
            with phase(f"cifar10_32x32: train_parallel, batch {CIFAR_BATCH}, {CIFAR_STEPS} "
                       "steps, --fp16 1, dropout 0.1"):
                diffusion.DropoutMasks = Recorded
                reset_counts()
                history = []
                t0 = time.perf_counter()
                try:
                    state = train_parallel.main(args_of(
                        ["--file-list", index, "--fp16", "1", "--batch-size", str(CIFAR_BATCH),
                         "--num-training-steps", str(CIFAR_STEPS), "--save-freq",
                         str(CIFAR_STEPS), "--output-dir", out], "trainer"), history)
                finally:
                    diffusion.DropoutMasks = layers.DropoutMasks
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts_train = read_counts("the cifar10_32x32 CLI's steps",
                                           TRAINING_KERNELS + ("K3·id",))
                check_cli_run(history, "cifar10_32x32 run", 1, CIFAR_STEPS)
                if state.step != CIFAR_STEPS:
                    raise AssertionError(f"cifar10_32x32: {CIFAR_STEPS - state.step} steps "
                                         "skipped")
                fracs = [float(kept) / n for m in made for kept, n in m.kept.values()]
                sigma = max(np.sqrt(0.1 * 0.9 / n) for m in made for _, n in m.kept.values())
                worst = max(abs(f - 0.9) for f in fracs) / sigma
                log(f"cifar10_32x32 dropout: {len(fracs)} masks in {len(made)} steps, kept "
                    f"fractions {min(fracs):.6f}-{max(fracs):.6f}, worst {worst:.3f} sigma of "
                    "0.9")
                if len(made) != CIFAR_STEPS or worst > DROPOUT_SIGMAS:
                    raise AssertionError(f"cifar10_32x32 dropout: {len(made)} mask sets, worst "
                                         f"{worst:.3f} sigma")
                per_step = statistics.fmean(t for num, *_, t in history if num > 2)
                log(f"cifar10_32x32 run: {CIFAR_STEPS} steps, step time over steps 3-"
                    f"{CIFAR_STEPS} {per_step * 1e3:.3f} ms: {1 / per_step:.4f} steps/s, "
                    f"{CIFAR_BATCH / per_step:.2f} images/s; {wall:.3f} s wall")
                result.update(cifar_steps_s=1 / per_step, cifar_wall_s=wall,
                              cifar_params=n_params, dropout_worst_sigma=worst)
                del state
            with phase(f"cifar10_32x32: generate_batch on vis_model_{CIFAR_STEPS:06d}.pth, "
                       f"{CIFAR_BATCH} samples, DDIM-50"):
                samples = f"{out}/samples"
                times = []
                reset_counts()
                n = generate_batch.main(args_of(
                    ["--model-file", f"{out}/vis_model_{CIFAR_STEPS:06d}.pth", "--test-file-list",
                     index, "--sample-dir", samples, "--min-examples", str(CIFAR_BATCH),
                     "--batch-size", str(CIFAR_BATCH)], "sampler"),
                    num_inference_steps=50, ddim_eta=0.0, times=times)
                counts_gen = read_counts("cifar10_32x32 generate_batch", SAMPLING_KERNELS)
                from PIL import Image

                pngs = sorted(f for f in os.listdir(f"{samples}/rank0") if f.startswith("s_"))
                pixels = np.stack([np.asarray(Image.open(f"{samples}/rank0/{f}")) for f in pngs])
                if n != CIFAR_BATCH or pixels.shape != (CIFAR_BATCH, 32, 32, 3) \
                        or pixels.min() == pixels.max():
                    raise AssertionError(f"cifar10_32x32 generate_batch: {n} samples, "
                                         f"{pixels.shape}")
                rate = n / sum(times)
                log(f"cifar10_32x32 generate_batch: {n} samples in {sum(times):.4f} s: "
                    f"{rate:.4f} samples/s; pixels {pixels.min()}..{pixels.max()}, mean "
                    f"{pixels.mean():.3f}")
                result.update(cifar_samples_s=rate)
    finally:
        diffusion.DropoutMasks = layers.DropoutMasks
        root.handlers = handlers
        root.setLevel(level)
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    cifar = {"K1": counts_train["K1"] + counts_gen["K1"],
             "K2": counts_train["K2"] + counts_gen["K2"],
             **{k: counts_gen[k] for k in ("K2·N", "K2·proj")},
             **{k: counts_train[k] for k in ("K3", "K3·A", "K3·B", "K3·id")}}
    return cifar, shapes, result


# -- phase 14: the one-process data-parallel sampler --------------------------------------


def _u8(x):
    """Images in [-1, 1] as the CLIs write them: uint8 levels."""
    import numpy as np

    return np.clip(x.clamp(-1, 1).float().cpu().numpy() * 128 + 127, 0, 255).astype(np.uint8)


def path_dp_sampler(dev):
    """Phase 14: ``parallel.sample_data_parallel`` on the 64px model at batch
    8, guidance 5 (16 text rows), DDIM-25, over every card, or over cuda:0
    twice with one card, K1-K2·proj launched. On the kernels and on the
    plain route (``use_kernels(False)``): bitwise equal to one device
    sampling each replica's rows from the noise drawn in full (the same call
    shapes, ``reproducible``); a call over the whole batch differs by the
    library's batch-dependent algorithms (logged). Returns (launches,
    result)."""
    import gc

    import torch

    from ml_mdm_tpu_torch import parallel
    from ml_mdm_tpu_torch.presets import flagship_64px

    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n)] if n > 1 else [dev, dev]
    batch = 8 if 8 % len(devices) == 0 else 2 * len(devices)
    pipe, lm_dim, side = flagship_64px(dev, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cond = text_conditioning(dev, 2 * batch, lm_dim, gen)
    kw = dict(num_inference_steps=25, resample_steps=True, ddim_eta=0.0, guidance_scale=5.0)
    result = {}

    def seeded():
        return torch.Generator(device=dev).manual_seed(SEED + 15)

    def replica_rows():
        """One device's calls on each replica's rows, from the noise drawn
        in full: the replicas' call shapes."""
        noise = pipe.get_noise(batch, side, seeded())
        per = batch // len(devices)
        parts = []
        for k in range(len(devices)):
            lo, hi = k * per, (k + 1) * per
            rows = {key: torch.cat([v[lo:hi], v[batch + lo:batch + hi]])
                    for key, v in cond.items()}
            parts.append(pipe.sample(per, rows, side, None, noise=noise[lo:hi], **kw))
        return torch.cat(parts)

    with phase(f"one-process sampler: batch {batch} over {[str(d) for d in devices]}, "
               "kernels, against one device replica by replica"):
        # the runner's first call copies the model and builds the copies'
        # sampling weights; the second is timed
        run = parallel.make_data_parallel_sampler(pipe, batch, side, devices, **kw)
        run(cond, seeded())
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dp = run(cond, seeded())
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        counts = read_counts("the one-process sampler", SAMPLING_KERNELS)
        check_images(dp, (batch, side, side, 3), "one-process sampler")
        t0 = time.perf_counter()
        one = pipe.sample(batch, cond, side, seeded(), **kw)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        reproducible("one-process sampler, kernel route: against one device, replica by "
                     "replica", replica_rows(), dp)
        log(f"one-process sampler, kernel route: against one call over the whole batch: "
            f"largest, count, mean of the level differences {_levels(_u8(dp), _u8(one))}")
        log(f"one-process sampler: {batch / dp_s:.4f} samples/s over {len(devices)} replicas, "
            f"{batch / one_s:.4f} on one device (host clock, one call each, after one untimed "
            "call of the runner)")
        result.update(dp_samples_s=batch / dp_s, one_samples_s=batch / one_s)
        del run
    with phase("one-process sampler, plain route: against one device, replica by replica"):
        pipe.vision_module.use_kernels(False)
        try:
            dp = parallel.sample_data_parallel(pipe, batch, cond, side, seeded(), devices, **kw)
            split = replica_rows()
            whole = pipe.sample(batch, cond, side, seeded(), **kw)
        finally:
            pipe.vision_module.use_kernels(True)
        reproducible("one-process sampler, plain route: against one device, replica by replica",
                     split, dp)
        levels = _levels(_u8(dp), _u8(whole))
        log(f"one-process sampler, plain route: bitwise equal to one device, replica by "
            f"replica; against one call over the whole batch: largest, count, mean of the "
            f"level differences {levels}")
        result["plain_vs_whole"] = levels
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return {"K1": counts["K1"], "K2 64px": counts["K2"],
            **{k: counts[k] for k in ("K2·N", "K2·proj")}}, result


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
    tot_k3, counts_train, steps_64, tot_train_64 = path_train(dev)
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
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tower:
        with phase("the text tower at flan-t5-xl's shape, written to a local directory (phases "
                   "8 and 9)"):
            n_t5 = write_text_tower(dev, tower)
        counts_demo, demo = path_demo(dev, tower)
        torch.cuda.empty_cache()
        with phase("training CLI and generate_batch"):
            cli, cli_result = path_cli(dev, tower, steps_64)
        torch.cuda.empty_cache()
        with phase("FSDP training through the CLI (phase 12)"):
            fsdp, fsdp_result = path_fsdp(dev, tower, cli_result.pop("history"),
                                          cli_result["cli_peak"])
    torch.cuda.empty_cache()
    samples = os.path.abspath("chiprun_out/cli/samples")
    try:
        with phase("evaluation: run_torchmetrics on phase 9's samples"):
            evaluation = path_eval(dev, samples)
    finally:
        shutil.rmtree(samples, ignore_errors=True)
    torch.cuda.empty_cache()
    with phase("quality gate on the card"):
        gate_routes = path_gate(dev)
    gate_result, gate_train, gate_probe, tot_gate = gate_routes["a"]
    torch.cuda.empty_cache()
    with phase("cifar10_32x32 with dropout through the CLIs (phase 13)"):
        cifar, tot_cifar, cifar_result = path_cifar(dev)
    torch.cuda.empty_cache()
    with phase("the one-process data-parallel sampler (phase 14)"):
        dp_sampler, dp_result = path_dp_sampler(dev)

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
    # the web demo's requests run the nested forward's kernels too
    server = {k: counts_demo[k] for k in ("K1", "K2", "K2·N", "K2·proj", "K2·struct", "K2·pipe")}
    for k, v in server.items():
        launches[k] += v
    # the CLIs' runs: the 64px model's training steps and generate_batch
    for k, v in cli.items():
        launches[k] += v
    # the quality gate's kernel route: its 500 steps and its four probes
    gate = {"K1": gate_train["K1"] + gate_probe["K1"], "K2": gate_train["K2"] + gate_probe["K2"],
            **{k: gate_probe[k] for k in ("K2·N", "K2·proj")},
            **{k: gate_train[k] for k in ("K3", "K3·A", "K3·B")}}
    for k, v in gate.items():
        launches[k] += v
    # phases 12-14: FSDP training, cifar10_32x32 (its K3 launches count its
    # identity-prologue backwards, K3·id, too), the one-process sampler
    for part in (fsdp, {k: v for k, v in cifar.items() if k != "K3·id"}, dp_sampler):
        for k, v in part.items():
            launches[k] += v
    log(f"launches during the nested matmul-route requests (256px and 1024px; K1-K2·proj), the "
        f"two 64px batch-64 requests from one seed (K2 64px), the nested matmul-route requests "
        f"and the train_1024 preset's timed steps (K2·struct, K2·pipe: {counts_256['K2·struct']} + "
        f"{counts_1024['K2·struct']} + {counts_t1024['K2·struct']} and {counts_256['K2·pipe']} + "
        f"{counts_1024['K2·pipe']} + {counts_t1024['K2·pipe']}), the train_256 preset's timed "
        f"steps (K3, K3·A, K3·B), the flash-route "
        f"requests (64px and 256px; K4) and the probes' tables (P1, P2), and, for K1-K2·pipe, "
        f"the web demo's four requests ({server}), and, for K1, K2 64px, K2·N, K2·proj and "
        f"K3-K3·B, the CLIs' runs ({cli}), and, for K1, K2, K2·N, K2·proj and K3-K3·B, the "
        f"quality gate's kernel route ({gate}): {launches}")
    log(f"CLIs: {cli_result}")
    log(f"FSDP (phase 12): launches {fsdp}; {fsdp_result}")
    log(f"cifar10_32x32 (phase 13): launches {cifar}; {cifar_result}")
    log(f"one-process sampler (phase 14): launches {dp_sampler}; {dp_result}")
    log(f"evaluation: {evaluation}")
    for route, (result, train_counts, probe_counts, _) in gate_routes.items():
        log(f"quality gate ({route}): {result}; launches in training {train_counts}, in the "
            f"probes {probe_counts}")
    log(f"web demo: text tower {n_t5} parameters, {demo['t5_ms']:.4f} ms for the "
        f"request's captions; streamed request {demo['wall_s']:.4f} s, first preview after "
        f"{demo['first_s']:.4f} s")
    for what, t in (("64px forward's", totals["K2 64px"]), ("nested forwards'", totals["K2"])):
        log(f"K2 over the {what} {t['shapes']} shapes: kernel {t['ms']:.4f} ms "
            f"({t['ms'] / t['library_ms']:.3f}x the library), library {t['library_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms']:.3f} of it)")
    for what, t in (("train_256 step's", tot_k3["K3"]), ("train_1024 step's", tot_k3_1024["K3"]),
                    ("64px batch-32 step's", tot_train_64["K3"])):
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
    for line in REPRODUCIBLE:
        log(f"reproducible: {line}")

    # the CLI's training steps launch K1, K2, K3 and its passes at the 64px
    # batch-32 step's shapes, held against their plain versions in phase 4:
    # their totals stand apart in each row (``cli_shapes``, the same keys),
    # and the row's error is the larger of the two
    train_64 = {"K1": "K1", "K2 64px": "K2", "K3": "K3", "K3·A": "K3·A", "K3·B": "K3·B"}
    # likewise the quality gate's launch shapes (its steps' and probes'),
    # ``gate_shapes``, on the K1, K2 and K3 rows
    gate_rows = {"K1": "K1", "K2": "K2", "K2·N": "K2·N", "K2·proj": "K2·proj", "K3": "K3",
                 "K3·A": "K3·A", "K3·B": "K3·B"}

    def shapes_row(c, library):
        return {"shapes": c["shapes"], "max_abs_err": c["err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "library_ms": c["library_ms"] if library else None}

    def entry(name, mode, route, source, replaces, library=True, **extra):
        t = totals[mode]
        row = {}
        if mode in train_64:
            row["cli_shapes"] = shapes_row(tot_train_64[train_64[mode]], library)
        if mode in gate_rows and tot_gate[gate_rows[mode]]["shapes"]:
            row["gate_shapes"] = shapes_row(tot_gate[gate_rows[mode]], library)
        # phase 13's cifar10_32x32 step's shapes (K2's row holds every K2 one)
        cifar_key = {"K2 64px": None}.get(mode, mode)
        if cifar_key in tot_cifar and tot_cifar[cifar_key]["shapes"]:
            row["cifar_shapes"] = shapes_row(tot_cifar[cifar_key], library)
        if mode == "K3":
            # the identity-prologue backward (conv3x3_vjp), counted in K3's launches
            row["identity_shapes"] = shapes_row(tot_cifar["K3·id"], library)
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[mode], "server_launches": server.get(mode, 0),
                "cli_launches": cli.get(mode, 0), "gate_launches": gate.get(mode, 0),
                "fsdp_launches": fsdp.get(mode, 0),
                "cifar_launches": cifar.get(mode, 0),
                "dp_sampler_launches": dp_sampler.get(mode, 0),
                **({"identity_launches": cifar["K3·id"]} if mode == "K3" else {}),
                "max_abs_err": max([t["err"]] + [r["max_abs_err"] for r in row.values()]),
                "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops_ms"] > t["bytes_ms"] else "bytes",
                "library_ms": t["library_ms"] if library else None,
                **{k: t[v] for k, v in extra.items()}, **row}

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
