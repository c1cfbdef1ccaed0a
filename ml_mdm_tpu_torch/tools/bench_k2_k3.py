"""Time kernels K2 and K3 alone on the card, at the shapes the model gives
them, and two forwards and two training steps around them.

    python -m ml_mdm_tpu_torch.tools.bench_k2_k3

K2 (``ops/fused_resnet.py`` ``affine_silu_conv3x3``; ``conv3x3_fast`` for
the launches without the SiLU) at the 64px model's 15 launch shapes of a
batch-64 forward and at the 49 unpacked launch shapes of the nested
forwards (256px at 8 rows, 1024px at 4), beside the library's (affine and
SiLU, ``torch.cat``, cuDNN's bf16 convolution, the residual, the stats, the
1x1 shortcut) and the bound; K2·struct (``packed_struct=True``) at the 44
packed launch shapes of the 256px forward (6), the 1024px forward (15) and
a ``train_1024`` step (23), beside the library's dense packed convolution
and the bound of the unpacked convolution, with the sum over the launches
that count as K2·pipe (``pipelines``), and the 256px forward's packed
shapes beside the unpacked K2 at the same convolutions; K3
(``affine_silu_conv3x3_vjp``'s backward) at the 29 launch shapes of a
``train_256`` step (batch 16) and the 36 of a ``train_1024`` step (batch
2; 13 packed), beside the library backward (the same chain around cuDNN's
dgrad and wgrad); then one batch-64 forward of ``cc12m_64x64`` and one
batch-4 forward of ``cc12m_1024x1024`` (CUDA events, and the host's time to
enqueue it) and a ``train_256`` and a ``train_1024`` step (mean of 3 after
one untimed, host clock). The shapes were recorded from the models as
``chip_smoke.py`` records them. Each kernel time is the median of 5 runs
from CUDA events, the 50 MB L2 overwritten and the device kept busy ~1 ms
before each, so that the events time the device's work. K2 takes its
weights in the layout the model keeps for sampling (``K2Weights``), the
data gradient's as K3 hands them over. The bound is the larger of the
bytes at 3.35 TB/s and the tensor-core FLOPs at 989 TFLOP/s (NVIDIA H100
SXM), a convolution's bytes each input read once and each output written
once. Without a card it exits 1. It runs against whichever ``ml_mdm_tpu_torch`` is first on the
path, so ``PYTHONPATH=<another checkout> python
ml_mdm_tpu_torch/tools/bench_k2_k3.py`` times that checkout's kernels (an
A/B in one call). Each K2 row ends with a digest of the kernel's y (and
shortcut), the same bits on the same inputs, so two checkouts' rows show
whether their outputs are bitwise equal; ``--k2`` times K2's rows alone.
"""
from __future__ import annotations

import hashlib
import statistics
import subprocess
import sys
import time

K2_64 = [  # (B, H, W, operand channels, Cout, residual, stats, shortcut, SiLU)
    (64, 16, 16, (512,), 768, 0, 1, 1, 1), (64, 16, 16, (768,), 768, 0, 1, 0, 1),
    (64, 16, 16, (768,), 768, 1, 0, 0, 1), (64, 16, 16, (768, 512), 768, 0, 1, 1, 1),
    (64, 16, 16, (768, 768), 768, 0, 1, 1, 1), (64, 32, 32, (256,), 512, 0, 1, 1, 1),
    (64, 32, 32, (512,), 512, 0, 1, 0, 1), (64, 32, 32, (512,), 512, 1, 0, 0, 1),
    (64, 32, 32, (512, 256), 512, 0, 1, 1, 1), (64, 32, 32, (512, 512), 512, 0, 1, 1, 1),
    (64, 32, 32, (768, 512), 512, 0, 1, 1, 1), (64, 64, 64, (256,), 256, 0, 1, 0, 1),
    (64, 64, 64, (256,), 256, 1, 0, 0, 1), (64, 64, 64, (256, 256), 256, 0, 1, 1, 1),
    (64, 64, 64, (512, 256), 256, 0, 1, 1, 1),
]
K2_NESTED = [  # the same, the nested forwards' unpacked launches
    (8, 16, 16, (512,), 768, 0, 1, 1, 1), (8, 16, 16, (768,), 768, 0, 1, 0, 1),
    (8, 16, 16, (768,), 768, 1, 0, 0, 1), (8, 16, 16, (768, 512), 768, 0, 1, 1, 1),
    (8, 16, 16, (768, 768), 768, 0, 1, 1, 1), (8, 32, 32, (256,), 512, 0, 1, 1, 1),
    (8, 32, 32, (512,), 512, 0, 1, 0, 1), (8, 32, 32, (512,), 512, 1, 0, 0, 1),
    (8, 32, 32, (512, 256), 512, 0, 1, 1, 1), (8, 32, 32, (512, 512), 512, 0, 1, 1, 1),
    (8, 32, 32, (768, 512), 512, 0, 1, 1, 1), (8, 64, 64, (128,), 256, 0, 1, 1, 1),
    (8, 64, 64, (256,), 256, 0, 1, 0, 1), (8, 64, 64, (256,), 256, 1, 0, 0, 1),
    (8, 64, 64, (256, 128), 256, 0, 1, 1, 1), (8, 64, 64, (256, 256), 256, 0, 1, 1, 1),
    (8, 64, 64, (512, 256), 256, 0, 1, 1, 1), (8, 128, 128, (64,), 128, 0, 1, 1, 1),
    (8, 128, 128, (128,), 128, 0, 1, 0, 1), (8, 128, 128, (128,), 128, 1, 0, 0, 1),
    (8, 128, 128, (128,), 512, 0, 0, 0, 0), (8, 128, 128, (128, 64), 128, 0, 1, 1, 1),
    (8, 128, 128, (128, 128), 128, 0, 1, 1, 1), (8, 128, 128, (256, 128), 128, 0, 1, 1, 1),
    (4, 16, 16, (512,), 768, 0, 1, 1, 1), (4, 16, 16, (768,), 768, 0, 1, 0, 1),
    (4, 16, 16, (768,), 768, 1, 0, 0, 1), (4, 16, 16, (768, 512), 768, 0, 1, 1, 1),
    (4, 16, 16, (768, 768), 768, 0, 1, 1, 1), (4, 32, 32, (256,), 512, 0, 1, 1, 1),
    (4, 32, 32, (512,), 512, 0, 1, 0, 1), (4, 32, 32, (512,), 512, 1, 0, 0, 1),
    (4, 32, 32, (512, 256), 512, 0, 1, 1, 1), (4, 32, 32, (512, 512), 512, 0, 1, 1, 1),
    (4, 32, 32, (768, 512), 512, 0, 1, 1, 1), (4, 64, 64, (128,), 256, 0, 1, 1, 1),
    (4, 64, 64, (256,), 256, 0, 1, 0, 1), (4, 64, 64, (256,), 256, 1, 0, 0, 1),
    (4, 64, 64, (256, 128), 256, 0, 1, 1, 1), (4, 64, 64, (256, 256), 256, 0, 1, 1, 1),
    (4, 64, 64, (512, 256), 256, 0, 1, 1, 1), (4, 128, 128, (64,), 128, 0, 1, 1, 1),
    (4, 128, 128, (128,), 128, 0, 1, 0, 1), (4, 128, 128, (128,), 128, 1, 0, 0, 1),
    (4, 128, 128, (128, 64), 128, 0, 1, 1, 1), (4, 128, 128, (128, 128), 128, 0, 1, 1, 1),
    (4, 128, 128, (256, 128), 128, 0, 1, 1, 1), (4, 256, 256, (64,), 256, 0, 0, 0, 0),
    (4, 512, 512, (32,), 128, 0, 0, 0, 0),
]
# the packed launches (packed channels; SiLU 0: ``conv3x3_fast``, whose
# input layer takes the 12-channel packed image)
K2_PACKED = {
    "256px forward": [
        (8, 128, 128, (12,), 256, 0, 0, 0, 0), (8, 128, 128, (256,), 16, 0, 0, 0, 1),
        (8, 128, 128, (256,), 256, 0, 1, 0, 1), (8, 128, 128, (256,), 256, 1, 0, 0, 1),
        (8, 128, 128, (256, 256), 256, 0, 1, 1, 1), (8, 128, 128, (512, 256), 256, 0, 1, 1, 1),
    ],
    "1024px forward": [
        (4, 128, 128, (128,), 256, 0, 1, 1, 1), (4, 128, 128, (256,), 256, 0, 1, 0, 1),
        (4, 128, 128, (256,), 256, 1, 0, 0, 1), (4, 128, 128, (256, 128), 256, 0, 1, 1, 1),
        (4, 128, 128, (256, 256), 256, 0, 1, 1, 1), (4, 128, 128, (512, 256), 256, 0, 1, 1, 1),
        (4, 256, 256, (128,), 128, 0, 1, 0, 1), (4, 256, 256, (128,), 128, 1, 0, 0, 1),
        (4, 256, 256, (128, 128), 128, 0, 1, 1, 1), (4, 256, 256, (256, 128), 128, 0, 1, 1, 1),
        (4, 512, 512, (12,), 128, 0, 0, 0, 0), (4, 512, 512, (128,), 16, 0, 0, 0, 1),
        (4, 512, 512, (128,), 128, 0, 1, 0, 1), (4, 512, 512, (128,), 128, 1, 0, 0, 1),
        (4, 512, 512, (128, 128), 128, 0, 1, 1, 1),
    ],
    "train_1024 step": [
        (2, 128, 128, (128,), 256, 0, 1, 0, 1), (2, 128, 128, (256,), 128, 0, 0, 0, 0),
        (2, 128, 128, (256,), 256, 0, 0, 0, 0), (2, 128, 128, (256,), 256, 0, 1, 0, 1),
        (2, 128, 128, (256,), 256, 1, 0, 0, 1), (2, 128, 128, (256,), 384, 0, 0, 0, 0),
        (2, 128, 128, (256,), 512, 0, 0, 0, 0), (2, 128, 128, (256,), 768, 0, 0, 0, 0),
        (2, 128, 128, (384,), 256, 0, 1, 0, 1), (2, 128, 128, (512,), 256, 0, 1, 0, 1),
        (2, 128, 128, (768,), 256, 0, 1, 0, 1), (2, 256, 256, (128,), 128, 0, 0, 0, 0),
        (2, 256, 256, (128,), 128, 0, 1, 0, 1), (2, 256, 256, (128,), 128, 1, 0, 0, 1),
        (2, 256, 256, (128,), 256, 0, 0, 0, 0), (2, 256, 256, (128,), 384, 0, 0, 0, 0),
        (2, 256, 256, (256,), 128, 0, 1, 0, 1), (2, 256, 256, (384,), 128, 0, 1, 0, 1),
        (2, 512, 512, (128,), 128, 0, 0, 0, 0), (2, 512, 512, (128,), 128, 0, 1, 0, 1),
        (2, 512, 512, (128,), 128, 1, 0, 0, 1), (2, 512, 512, (128,), 256, 0, 0, 0, 0),
        (2, 512, 512, (256,), 128, 0, 1, 0, 1),
    ],
}
K3_256 = [  # (B, H, W, C, Cout, residual, stats, packed)
    (10, 64, 64, 128, 256, 0, 1, 0), (10, 64, 64, 256, 256, 1, 0, 0),
    (10, 64, 64, 384, 256, 0, 1, 0), (10, 64, 64, 512, 256, 0, 1, 0),
    (10, 128, 128, 64, 128, 0, 1, 0), (10, 128, 128, 128, 128, 0, 1, 0),
    (10, 128, 128, 128, 128, 1, 0, 0), (10, 128, 128, 192, 128, 0, 1, 0),
    (10, 128, 128, 256, 128, 0, 1, 0), (10, 128, 128, 256, 256, 0, 1, 1),
    (10, 128, 128, 256, 256, 1, 0, 1), (10, 128, 128, 384, 128, 0, 1, 0),
    (10, 128, 128, 512, 256, 0, 1, 1), (10, 128, 128, 768, 256, 0, 1, 1),
    (16, 16, 16, 512, 768, 0, 1, 0), (16, 16, 16, 768, 768, 0, 1, 0),
    (16, 16, 16, 768, 768, 1, 0, 0), (16, 16, 16, 1280, 768, 0, 1, 0),
    (16, 16, 16, 1536, 768, 0, 1, 0), (16, 32, 32, 256, 512, 0, 1, 0),
    (16, 32, 32, 512, 512, 0, 1, 0), (16, 32, 32, 512, 512, 1, 0, 0),
    (16, 32, 32, 768, 512, 0, 1, 0), (16, 32, 32, 1024, 512, 0, 1, 0),
    (16, 32, 32, 1280, 512, 0, 1, 0), (16, 64, 64, 256, 256, 0, 1, 0),
    (16, 64, 64, 256, 256, 1, 0, 0), (16, 64, 64, 512, 256, 0, 1, 0),
    (16, 64, 64, 768, 256, 0, 1, 0),
]
K3_1024 = [  # the same, of a train_1024 step (batch 2)
    (2, 16, 16, 512, 768, 0, 1, 0), (2, 16, 16, 768, 768, 0, 1, 0),
    (2, 16, 16, 768, 768, 1, 0, 0), (2, 16, 16, 1280, 768, 0, 1, 0),
    (2, 16, 16, 1536, 768, 0, 1, 0), (2, 32, 32, 256, 512, 0, 1, 0),
    (2, 32, 32, 512, 512, 0, 1, 0), (2, 32, 32, 512, 512, 1, 0, 0),
    (2, 32, 32, 768, 512, 0, 1, 0), (2, 32, 32, 1024, 512, 0, 1, 0),
    (2, 32, 32, 1280, 512, 0, 1, 0), (2, 64, 64, 128, 256, 0, 1, 0),
    (2, 64, 64, 256, 256, 0, 1, 0), (2, 64, 64, 256, 256, 1, 0, 0),
    (2, 64, 64, 384, 256, 0, 1, 0), (2, 64, 64, 512, 256, 0, 1, 0),
    (2, 64, 64, 768, 256, 0, 1, 0), (2, 128, 128, 64, 128, 0, 1, 0),
    (2, 128, 128, 128, 128, 0, 1, 0), (2, 128, 128, 128, 128, 1, 0, 0),
    (2, 128, 128, 128, 256, 0, 1, 1), (2, 128, 128, 192, 128, 0, 1, 0),
    (2, 128, 128, 256, 128, 0, 1, 0), (2, 128, 128, 256, 256, 0, 1, 1),
    (2, 128, 128, 256, 256, 1, 0, 1), (2, 128, 128, 384, 128, 0, 1, 0),
    (2, 128, 128, 384, 256, 0, 1, 1), (2, 128, 128, 512, 256, 0, 1, 1),
    (2, 128, 128, 768, 256, 0, 1, 1), (2, 256, 256, 128, 128, 0, 1, 1),
    (2, 256, 256, 128, 128, 1, 0, 1), (2, 256, 256, 256, 128, 0, 1, 1),
    (2, 256, 256, 384, 128, 0, 1, 1), (2, 512, 512, 128, 128, 0, 1, 1),
    (2, 512, 512, 128, 128, 1, 0, 1), (2, 512, 512, 256, 128, 0, 1, 1),
]

PEAK_BF16_TENSOR, PEAK_HBM = 989e12, 3.35e12


def k2_bound(b, h, w, cs, cout, residual, stats, proj):
    """Least ms of one K2 launch (``chip_smoke.py`` ``k2_bound``)."""
    ct, px = sum(cs), b * h * w
    flops = 2 * px * ct * cout * (9 + proj)
    nbytes = (2 * px * ct + 2 * 4 * b * ct + 2 * 9 * ct * cout + 4 * cout
              + 2 * px * cout * (1 + residual + proj) + (2 * 4 * b * cout if stats else 0)
              + ((2 * ct + 4) * cout if proj else 0))
    return 1e3 * max(flops / PEAK_BF16_TENSOR, nbytes / PEAK_HBM), flops


_FLUSH = []


def _ms(fn, reps=5, warmup=2):
    """Median ms of fn() from CUDA events, the L2 overwritten and the device
    kept busy ~1 ms before each run."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH[0].zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def digest(out) -> str:
    """12 hex digits of the hash of K2's y and, with the shortcut, proj
    (the stats, f32 atomics in no fixed order, are left out)."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in (outs[0], outs[-1]) if len(outs) in (2, 4) else outs[:1]:
        h.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main() -> int:
    import torch
    import torch.nn.functional as F

    from ml_mdm_tpu_torch.ops import fused_resnet
    from ml_mdm_tpu_torch.ops import space_to_depth as s2d

    if not torch.cuda.is_available():
        print("bench_k2_k3: no CUDA device; the kernels run only on a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"ml_mdm_tpu_torch from {fused_resnet.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bf = torch.bfloat16
    keep = getattr(fused_resnet, "K2Weights", None)
    ms = _ms
    g = torch.Generator(device=dev).manual_seed(0)

    def k2_case(b, h, w, cs, cout, residual, stats, proj, silu, packed=False):
        """(kernel, library) of one launch shape; packed: the packed kernels
        of random unpacked ones (the kernel takes their combined taps, kept
        as sampling keeps them; the library the (3, 3) packed kernel), the
        block-diagonal packed shortcut."""
        ct, m = sum(cs), 4 if packed else 1
        xs = tuple(torch.randn((b, h, w, c), generator=g, device=dev).to(bf) for c in cs)
        a = tuple(torch.randn((b, c), generator=g, device=dev) * 0.2 + 1.0 for c in cs)
        bb = tuple(torch.randn((b, c), generator=g, device=dev) * 0.3 for c in cs)
        ws = tuple((torch.randn((3, 3, -(-c // m), cout // m), generator=g, device=dev)
                    / (9 * ct / m) ** 0.5) for c in cs)
        bias = torch.randn((cout,), generator=g, device=dev) * 0.1
        res = torch.randn((b, h, w, cout), generator=g, device=dev).to(bf) if residual else None
        pks = (tuple(torch.randn((c // m, cout // m), generator=g, device=dev) / (ct / m) ** 0.5
                     for c in cs) if proj else None)
        pb = torch.randn((cout,), generator=g, device=dev) * 0.1 if proj else None
        if packed:
            ws = tuple(s2d.pack_conv3x3_kernel(wk)[:, :, :c] for wk, c in zip(ws, cs))
            pks = pks and tuple(s2d.pack_conv1x1_kernel(p[None, None])[0, 0] for p in pks)
        ws = tuple(wk.to(bf) for wk in ws)
        pks = pks and tuple(p.to(bf) for p in pks)
        wq = tuple(fused_resnet.struct_weights(wk) for wk in ws) if packed else ws
        wk = keep(wq) if keep else wq
        pk = keep(pks) if keep and proj else pks
        if not silu:
            def kernel():
                return fused_resnet.conv3x3_fast(xs[0], ws[0] if packed or not keep else wk,
                                                 bias, res, packed_struct=packed)
        else:
            def kernel():
                return fused_resnet.affine_silu_conv3x3(xs, a, bb, wk, bias, res,
                                                        emit_stats=stats, proj_kernel=pk,
                                                        proj_bias=pb, packed_struct=packed)

        def library():
            v = (torch.cat(xs, dim=-1) if not silu else torch.cat(
                [F.silu(x.float() * ak[:, None, None, :] + bk[:, None, None, :]).to(bf)
                 for x, ak, bk in zip(xs, a, bb)], dim=-1)).permute(0, 3, 1, 2)
            wt = torch.cat(ws, dim=2).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            y = F.conv2d(v, wt, bias.to(bf), padding=1)
            if res is not None:
                y = y + res.permute(0, 3, 1, 2)
            out = [y]
            if stats:
                yf = y.float()
                out += [yf.sum(dim=(2, 3)), yf.square().sum(dim=(2, 3))]
            if proj:
                pw = torch.cat(pks, dim=0).t()[:, :, None, None].contiguous(
                    memory_format=torch.channels_last)
                out.append(F.conv2d(torch.cat(xs, dim=-1).permute(0, 3, 1, 2), pw, pb.to(bf)))
            return out

        return kernel, library

    def unpacked(key):
        """The same convolution unpacked, or None where K2 has no such
        launch (channels no multiple of 8)."""
        b, h, w, cs, cout = key[:5]
        if cout % 32 or any(c % 32 for c in cs):
            return None
        return (b, 2 * h, 2 * w, tuple(c // 4 for c in cs), cout // 4) + tuple(key[5:])

    for label, keys in (("the 64px forward's", K2_64),
                        ("the nested forwards' unpacked", K2_NESTED)):
        tot = dict.fromkeys(("kernel", "library", "bound", "flops"), 0.0)
        for key in keys:
            kernel, library = k2_case(*key)
            t, lib = ms(kernel), ms(library)
            bound, flops = k2_bound(*key[:8])
            for k, v in (("kernel", t), ("library", lib), ("bound", bound), ("flops", flops)):
                tot[k] += v
            print(f"K2 {key}: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, {bound / t:.3f} of the "
                  f"bound), library {lib:.4f} ms, bound {bound:.4f} ms, digest {digest(kernel())}",
                  flush=True)
        rate, share = tot["flops"] / tot["kernel"] / 1e9, tot["bound"] / tot["kernel"]
        print(f"K2 over {label} {len(keys)} shapes: {tot['kernel']:.4f} ms "
              f"({rate:.1f} TFLOP/s, {share:.3f} of the bound), library {tot['library']:.4f} ms "
              f"({tot['kernel'] / tot['library']:.3f}x), bound {tot['bound']:.4f} ms", flush=True)

    tot = {k: dict.fromkeys(("n", "kernel", "library", "bound", "unpacked", "paired"), 0.0)
           for k in ("K2·struct", "K2·pipe", "256px")}
    for where, keys in K2_PACKED.items():
        for key in keys:
            b, h, w, cs, cout = key[:5]
            kernel, library = k2_case(*key, packed=True)
            t, lib = ms(kernel), ms(library)
            bound, _ = k2_bound(b, 2 * h, 2 * w, tuple(c / 4 for c in cs), cout // 4, *key[5:8])
            pipe = fused_resnet.pipelines(cs, b, h, w, cout, None, True)
            row = dict(n=1, kernel=t, library=lib, bound=bound)
            text = ""
            if where == "256px forward" and unpacked(key):
                ut = ms(k2_case(*unpacked(key))[0])
                row.update(unpacked=ut, paired=t)
                text = f", unpacked K2 at {unpacked(key)[:5]} {ut:.4f} ms"
            for mode, on in (("K2·struct", True), ("K2·pipe", pipe),
                             ("256px", where == "256px forward")):
                for k, v in row.items():
                    tot[mode][k] += v if on else 0.0
            print(f"K2·struct {where} {key}{' pipelined' if pipe else ''}: {t:.4f} ms "
                  f"({bound / t:.3f} of the bound), library {lib:.4f} ms, bound {bound:.4f} ms"
                  + text + f", digest {digest(kernel())}", flush=True)
    for mode, label in (("K2·struct", "its"), ("K2·pipe", "its pipelined"),
                        ("256px", "the 256px forward's")):
        t = tot[mode]
        if not t["n"]:
            continue
        print(f"{mode} over {label} {int(t['n'])} packed shapes: {t['kernel']:.4f} ms "
              f"({t['bound'] / t['kernel']:.3f} of the bound), library {t['library']:.4f} ms "
              f"({t['kernel'] / t['library']:.3f}x), bound {t['bound']:.4f} ms"
              + (f"; the unpacked K2 at the same convolutions {t['unpacked']:.4f} ms against "
                 f"{t['paired']:.4f} ms packed" if t["paired"] else ""), flush=True)

    if "--k2" in sys.argv[1:]:
        return 0
    for label, keys in (("train_256's", K3_256), ("train_1024's", K3_1024)):
        k3_rows(label, keys)
    forward_and_step()
    return 0


def k3_rows(label, keys):
    """K3's backward at each launch shape beside the library backward, and
    the sums (all, and the packed shapes)."""
    import torch

    from ml_mdm_tpu_torch.ops import fused_resnet
    from ml_mdm_tpu_torch.ops import space_to_depth as s2d

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    tot = dict.fromkeys(("kernel", "library", "packed_kernel", "packed_library"), 0.0)
    for key in keys:
        b, h, w, c, cout, residual, stats, packed = key
        m = 4 if packed else 1
        ins = [torch.randn((b, h, w, c), generator=g, device=dev).to(bf),
               torch.randn((b, c), generator=g, device=dev) * 0.2 + 1.0,
               torch.randn((b, c), generator=g, device=dev) * 0.3,
               torch.randn((3, 3, c // m, cout // m), generator=g, device=dev)
               / (9 * c // m) ** 0.5,
               torch.randn((cout,), generator=g, device=dev) * 0.1,
               torch.randn((b, h, w, cout), generator=g, device=dev).to(bf) if residual else None]
        cots = [torch.randn((b, h, w, cout), generator=g, device=dev).to(bf)]
        if stats:
            cots += [torch.randn((b, cout), generator=g, device=dev) * 1e-3,
                     torch.randn((b, cout), generator=g, device=dev) * 1e-4]
        leaves = [t.detach().requires_grad_(True) if t is not None else None for t in ins]
        args = list(leaves)
        if packed:
            args[3] = s2d.pack_conv3x3_kernel(leaves[3])
        out = fused_resnet.affine_silu_conv3x3_vjp(*args, emit_stats=stats, packed_struct=packed)
        outs = out if stats else (out,)
        targets = [t for t in leaves if t is not None]
        w16 = (s2d.pack_conv3x3_kernel(ins[3]) if packed else ins[3]).to(bf)
        y = outs[0].detach()

        def library():
            dy = cots[0]
            if stats:
                dy = (dy.float() + cots[1][:, None, None, :]
                      + 2.0 * y.float() * cots[2][:, None, None, :]).to(dy.dtype)
            a_c, b_c = ins[1][:, None, None, :], ins[2][:, None, None, :]
            v = ins[0].float() * a_c + b_c
            sig = torch.sigmoid(v)
            dact = sig * (1.0 + v * (1.0 - sig))
            w_oihw, dy_nchw = w16.permute(3, 2, 0, 1), dy.permute(0, 3, 1, 2)
            ds = torch.nn.grad.conv2d_input(ins[0].permute(0, 3, 1, 2).shape, w_oihw, dy_nchw,
                                            padding=1)
            dv = ds.permute(0, 2, 3, 1).float() * dact
            return ((dv * a_c).to(bf), (dv * ins[0].float()).sum(dim=(1, 2)), dv.sum(dim=(1, 2)),
                    torch.nn.grad.conv2d_weight((v * sig).to(bf).permute(0, 3, 1, 2),
                                                w_oihw.shape, dy_nchw, padding=1),
                    dy.float().sum(dim=(0, 1, 2)))

        t = _ms(lambda: torch.autograd.grad(outs, targets, cots, retain_graph=True))
        lib = _ms(library)
        tot["kernel"] += t
        tot["library"] += lib
        if packed:
            tot["packed_kernel"] += t
            tot["packed_library"] += lib
        print(f"K3 {key}: backward {t:.4f} ms, library {lib:.4f} ms", flush=True)
        del out, outs, leaves, args, targets
    print(f"K3 over {label} {len(keys)} shapes: backward {tot['kernel']:.4f} ms, library "
          f"{tot['library']:.4f} ms ({tot['kernel'] / tot['library']:.3f}x); of it the "
          f"{sum(k[-1] for k in keys)} packed shapes {tot['packed_kernel']:.4f} ms, library "
          f"{tot['packed_library']:.4f} ms", flush=True)


def forward_and_step():
    """The 64px batch-64 forward and the 1024px batch-4 forward (packed
    shells; CUDA events and the host's enqueue time), and the rates of a
    train_256 step (batch 16) and a train_1024 step (batch 2)."""
    import torch

    from ml_mdm_tpu_torch import presets, trainer

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)

    def forward(label, pipe, rows, lm_dim, side):
        x = pipe.get_noise(rows, side, g)
        tt = torch.full((rows,), 500, device=dev)
        lm = torch.randn((rows, 32, lm_dim), generator=g, device=dev).to(bf)
        mask = torch.ones((rows, 32), device=dev, dtype=bf)
        with torch.no_grad():
            fwd_ms = _ms(lambda: pipe.model(x, tt, lm, mask, {}), reps=3, warmup=1)
            enqueue = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.model(x, tt, lm, mask, {})
                enqueue.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        print(f"{label} forward: {fwd_ms:.3f} ms (CUDA events, median of 3); the host enqueues "
              f"it in {statistics.median(enqueue):.3f} ms (median of 3)", flush=True)

    def steps(label, pipe, cfg, rows, side, lm_dim, lm_len=32):
        state = trainer.TrainState.create(pipe.vision_module)
        step = trainer.make_train_step(pipe, cfg)
        times = []
        for i in range(4):
            data = {"images": torch.rand((rows, side, side, 3), generator=g, device=dev) * 2 - 1,
                    "lm_outputs": torch.randn((rows, lm_len, lm_dim), generator=g,
                                              device=dev).to(bf),
                    "lm_mask": torch.ones((rows, lm_len), device=dev, dtype=bf)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, data, g)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
        print(f"{label} step (batch {rows}): {len(times) / sum(times):.4f} steps/s (mean of "
              f"{len(times)} after one untimed, host clock); loss {metrics['loss']:.6f}",
              flush=True)

    for label, build, rows in (("64px batch-64", presets.flagship_64px, 64),
                               ("1024px batch-4", presets.cc12m_1024x1024, 4)):
        pipe, lm_dim, side = build(dev, seed=0)
        forward(label, pipe, rows, lm_dim, side)
        del pipe
        torch.cuda.empty_cache()
    pipe, lm_dim, side = presets.nested_preset("cc12m_256x256", dev, seed=0, train=True)
    steps("train_256", pipe, trainer.TrainerConfig(lr=5e-5, warmup_steps=10,
                                                   gradient_clip_norm=2.0), 16, side, lm_dim)
    del pipe
    torch.cuda.empty_cache()
    p = presets.train_1024(dev, seed=0)
    steps("train_1024", p.pipeline, p.config, p.batch, p.side, p.lm_dim, p.lm_len)


if __name__ == "__main__":
    sys.exit(main())
