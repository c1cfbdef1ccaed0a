"""The port's native (C++) data plane, loaded with ctypes.

Counterpart of ``ml_mdm_tpu/native``: trie tokenization, JPEG decode +
smallest-side resize + crop, and tar member reads, from the port's own
``datacore.cpp``. At first use the source is compiled with

    g++ -O3 -std=c++17 -shared -fPIC datacore.cpp -o <lib> -ljpeg

into ``ml_mdm_tpu_torch/_build/libdatacore_<hash>.so`` (the hash of the
source and the flags, so an edited source rebuilds), never beside the
source and never the JAX package's ``libdatacore.so``. Where the toolchain
or libjpeg is missing the build fails, ``load()`` returns None and every
caller takes its Python route (PIL, ``tarfile``, the Python tokenizer
search), as in the JAX package; ``build_report()`` says what happened.

ctypes foreign calls release the GIL, so the reader's worker threads decode
and tokenize on several cores at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

_SRC = Path(__file__).resolve().parent / "datacore.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None  # None: not tried yet; False: unavailable
_report: Dict[str, Any] = {}
_lock = threading.Lock()
_logger = logging.getLogger(__name__)


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdatacore_{h}.so"


def _build(out: Path) -> bool:
    # a process-unique temporary name renamed into place: os.replace is
    # atomic, so a concurrent process never loads a half-written library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), "-ljpeg"]
    _report.update(command=" ".join(cmd), built=False)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:  # no g++, or it hung
        _report.update(returncode=None, output=str(exc))
        return False
    _report.update(seconds=time.perf_counter() - t0, returncode=proc.returncode,
                   output=(proc.stdout + proc.stderr).strip())
    if proc.returncode != 0:
        _logger.info("native datacore build failed: %s", _report["output"][-2000:])
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    _report["built"] = True
    return True


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None where it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        out = library_path()
        _report.update(path=str(out))
        if not out.exists() and not _build(out):
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as exc:
            _report.update(load_error=str(exc))
            _lib = False
            return None

        lib.dc_tok_new.restype = ctypes.c_void_p
        lib.dc_tok_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
        lib.dc_tok_free.argtypes = [ctypes.c_void_p]
        lib.dc_tok_free.restype = None
        lib.dc_tok_tokenize.restype = ctypes.c_int32
        lib.dc_tok_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_int32]
        lib.dc_image_decode_resize_crop.restype = ctypes.c_int32
        lib.dc_image_decode_resize_crop.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
        lib.dc_tar_open.restype = ctypes.c_void_p
        lib.dc_tar_open.argtypes = [ctypes.c_char_p]
        lib.dc_tar_member_size.restype = ctypes.c_int64
        lib.dc_tar_member_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dc_tar_read.restype = ctypes.c_int64
        lib.dc_tar_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.dc_tar_free.argtypes = [ctypes.c_void_p]
        lib.dc_tar_free.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def build_report() -> Dict[str, Any]:
    """What the last ``load()`` did: the library's ``path``; where it
    compiled, the g++ ``command``, its ``returncode``, ``seconds`` and
    ``output``, and whether it ``built``; a ``load_error``."""
    return dict(_report)
