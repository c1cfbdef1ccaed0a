"""Builds the port's CUDA sources with ``nvcc`` for ``sm_90a`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library in ``ml_mdm_tpu_torch/_build/``, named by the hash of its source,
of every header it includes with ``#include "..."`` (and those include) and
of the flags, so an edited source or header rebuilds; the kernel modules
load it with ctypes. ``<library>.log`` keeps nvcc's output (``-Xptxas -v``: registers,
shared memory and spills of every kernel).
"""
from __future__ import annotations

import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def build_tag(source: Path, flags=NVCC_FLAGS) -> str:
    """16 hex digits of the hash of ``source``, of the local headers it
    includes (``#include "..."``, found beside the file that names them,
    each once, in the order first included) and of ``flags``."""
    h = hashlib.sha256()
    seen, todo = set(), [Path(source).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(str(len(text)).encode() + b":" + text)
        todo += [(path.parent / m.decode()).resolve() for m in _INCLUDE.findall(text)
                 if (path.parent / m.decode()).is_file()]
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into the build directory, unless that
    source with its headers and these flags is built already. Returns the
    shared library's path."""
    source = source_path(name)
    out = BUILD_DIR / f"{name}_{build_tag(source)}.so"
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
