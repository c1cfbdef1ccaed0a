"""Fused affine + SiLU + 3x3 convolution (kernel K2).

``affine_silu_conv3x3`` replaces ``ml_mdm_tpu/ops/fused_resnet.py``
``affine_silu_conv3x3`` (the single-operand Pallas ``_kernel``):

    y = conv3x3(silu(x * a + b), w, padding 1) + bias [+ residual]

over NHWC, with per-(batch, channel) f32 coefficients a, b (GroupNorm with
FiLM folded in). Optionally it also returns the f32 sum and sum of squares
of the stored output per (batch, output channel), for the next GroupNorm.

The CUDA kernel is ``csrc/fused_resnet.cu`` (its header says what bounds
it on the H100 and how it is laid out). It is built with ``nvcc`` for
``sm_90a`` at first use into ``ml_mdm_tpu_torch/_build/`` and loaded with
ctypes. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# launches of the CUDA kernel since the count was last set to 0
launch_count = 0

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "fused_resnet.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def affine_silu_conv3x3_plain(x, a, b, w, bias, residual=None, *,
                              apply_silu: bool = True,
                              emit_stats: bool = False):
    """Plain PyTorch version (``reference_affine_silu_conv3x3`` of the JAX
    package, plus the stats outputs). x: (B, H, W, C); a, b: (B, C);
    w: (3, 3, C, Cout) HWIO; bias: (Cout,); residual: (B, H, W, Cout).

    The activation is rounded to x's dtype, the weights are cast to it,
    products accumulate in f32 and bias and residual are added in f32
    before one rounding to x's dtype. The stats square the stored output
    in f32."""
    v = x.float() * a.float()[:, None, None, :] + b.float()[:, None, None, :]
    if apply_silu:
        v = F.silu(v)
    v = v.to(x.dtype).float()
    wk = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(v.permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    y = y.to(x.dtype)
    if not emit_stats:
        return y
    yf = y.float()
    return y, yf.sum(dim=(1, 2)), yf.square().sum(dim=(1, 2))


def affine_silu_conv3x3(x, a, b, w, bias, residual=None, *,
                        apply_silu: bool = True, emit_stats: bool = False):
    """Same contract as ``affine_silu_conv3x3_plain``. Returns y, or
    (y, s1, s2) with ``emit_stats``."""
    if x.device.type == "cpu":
        return affine_silu_conv3x3_plain(
            x, a, b, w, bias, residual,
            apply_silu=apply_silu, emit_stats=emit_stats,
        )
    return _launch(x, a, b, w, bias, residual, apply_silu, emit_stats)


def conv3x3_fast(x, w, bias, residual=None):
    """3x3 stride-1 convolution with padding 1 (no affine, no SiLU)
    through the same kernel (``conv3x3_fast`` of the JAX package)."""
    bsz, c = x.shape[0], x.shape[-1]
    ones = torch.ones((bsz, c), device=x.device, dtype=torch.float32)
    zeros = torch.zeros_like(ones)
    if bias is None:
        bias = torch.zeros((w.shape[-1],), device=x.device, dtype=torch.float32)
    return affine_silu_conv3x3(x, ones, zeros, w, bias, residual,
                               apply_silu=False)


def _launch(x, a, b, w, bias, residual, apply_silu, emit_stats):
    global launch_count
    if not x.is_cuda:
        raise RuntimeError(f"affine_silu_conv3x3: no kernel for device {x.device}")
    lib = load_library()
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(
            f"affine_silu_conv3x3: the CUDA kernel takes (B, H, W, C) bf16, "
            f"got {tuple(x.shape)} {x.dtype}"
        )
    bsz, h, wd, c = x.shape
    if w.shape[:3] != (3, 3, c):
        raise ValueError(f"affine_silu_conv3x3: weight {tuple(w.shape)} for C={c}")
    cout = w.shape[3]
    if c % 8 or cout % 8:
        raise ValueError(
            f"affine_silu_conv3x3: C={c} and Cout={cout} must be multiples of 8"
        )
    dev = x.device
    x = x.contiguous()
    a = a.to(dev, torch.float32).reshape(bsz, c).contiguous()
    b = b.to(dev, torch.float32).reshape(bsz, c).contiguous()
    # (3, 3, C, Cout) -> (Cout, 9, C): each output channel's taps x channels
    wt = w.to(torch.bfloat16).permute(3, 0, 1, 2).reshape(cout, 9 * c).contiguous()
    bias = bias.to(dev, torch.float32).contiguous()
    if residual is not None:
        if residual.shape != (bsz, h, wd, cout) or residual.dtype != x.dtype:
            raise ValueError("affine_silu_conv3x3: residual must match y")
        residual = residual.contiguous()
    y = torch.empty((bsz, h, wd, cout), device=dev, dtype=x.dtype)
    s1 = s2 = None
    if emit_stats:
        s1 = torch.zeros((bsz, cout), device=dev, dtype=torch.float32)
        s2 = torch.zeros_like(s1)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    with torch.cuda.device(dev):  # the C side launches on the current device
        err = lib.ml_mdm_affine_silu_conv3x3(
            ptr(x), ptr(a), ptr(b), ptr(wt), ptr(bias), ptr(residual), ptr(y),
            ptr(s1), ptr(s2), bsz, h, wd, c, cout, int(apply_silu),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(
            f"affine_silu_conv3x3: CUDA error {err} at launch "
            f"(x {tuple(x.shape)}, Cout {cout})"
        )
    launch_count += 1
    return (y, s1, s2) if emit_stats else y


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build_library() -> Path:
    """Compile ``csrc/fused_resnet.cu`` for sm_90a into the build directory
    (named by the source's hash, so an edited source rebuilds). Returns the
    shared library's path; ``<path>.log`` keeps nvcc's output."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"fused_resnet_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    Path(str(out) + ".log").write_text(
        f"built in {time.perf_counter() - t0:.3f} s\n{log}"
    )
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ml_mdm_affine_silu_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
