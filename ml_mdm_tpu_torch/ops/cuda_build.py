"""Builds the port's CUDA sources with ``nvcc`` for ``sm_90a`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library in ``ml_mdm_tpu_torch/_build/``, named by the hash of its source and
the flags, so an edited source rebuilds; the kernel modules load it with
ctypes. ``<library>.log`` keeps nvcc's output (``-Xptxas -v``: registers,
shared memory and spills of every kernel).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def source_path(name: str) -> Path:
    return _PKG / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into the build directory, unless that
    source with these flags is built already. Returns the shared library's
    path."""
    source = source_path(name)
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
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
