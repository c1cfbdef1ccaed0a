"""ctypes wrapper of the C++ JPEG decode + resize + crop
(``ml_mdm_tpu/native/image.py``'s counterpart).

The reader takes it for JPEG members; other bytes (PNG, WebP), or a
library that did not build, go to PIL in the caller.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ml_mdm_tpu_torch import native

_JPEG_MAGIC = b"\xff\xd8\xff"


def is_jpeg(data: bytes) -> bool:
    return data[:3] == _JPEG_MAGIC


def decode_resize_crop(data: bytes, smaller_side: int, crop: int,
                       random_crop: bool = False, seed: int = 0) -> Optional[np.ndarray]:
    """(crop, crop, 3) uint8 RGB: the smallest side resized to
    ``smaller_side`` (PIL's antialiased bilinear), then a centre crop or,
    with ``random_crop``, one placed by ``seed``. None where the native
    route cannot take the input (the caller then uses PIL)."""
    lib = native.load()
    if lib is None or not is_jpeg(data) or crop <= 0:
        return None
    out = np.empty((crop, crop, 3), dtype=np.uint8)
    rc = lib.dc_image_decode_resize_crop(
        data, len(data), smaller_side, crop, int(random_crop), seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None
