"""ctypes wrapper of the C++ tar member index: random access reads
(``ml_mdm_tpu/native/tar.py``'s counterpart)."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ml_mdm_tpu_torch import native


class NativeTar:
    """The members of a plain (uncompressed) tar file by name, indexed once
    when opened; reads are locked inside the library."""

    def __init__(self, path: str):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native datacore unavailable")
        self._lib = lib
        self._handle = lib.dc_tar_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(path)

    def read(self, member: str) -> Optional[bytes]:
        name = member.encode()
        size = self._lib.dc_tar_member_size(self._handle, name)
        if size < 0:
            return None
        buf = np.empty(size, dtype=np.uint8)
        n = self._lib.dc_tar_read(self._handle, name,
                                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
        return buf.tobytes() if n == size else None

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.dc_tar_free(handle)
