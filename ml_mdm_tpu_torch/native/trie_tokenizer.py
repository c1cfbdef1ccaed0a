"""ctypes wrapper of the C++ trie tokenizer
(``ml_mdm_tpu/native/trie_tokenizer.py``'s counterpart).

The same shortest-path search as ``language_models.tokenizer.
tokenize_shortest``, which gives the same ids (tests/test_torch_data.py).
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from ml_mdm_tpu_torch import native


class NativeTokenizer:
    def __init__(self, trie, scores: List[float]):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native datacore unavailable")
        self._lib = lib
        tokens = [trie.key(i) for i in range(trie.num_keys())]
        blob = b"".join(tokens)
        offsets = np.zeros(len(tokens) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in tokens], out=offsets[1:])
        sc = np.asarray(scores, dtype=np.float64)
        self._handle = lib.dc_tok_new(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(tokens),
            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if not self._handle:
            raise RuntimeError("dc_tok_new failed")

    def tokenize_shortest(self, text, use_scores: bool = True) -> List[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        cap = max(64, len(data))
        while True:
            out = (ctypes.c_int32 * cap)()
            n = self._lib.dc_tok_tokenize(self._handle, data, len(data), int(use_scores),
                                          out, cap)
            if n >= 0:
                return list(out[:n])
            if n == -1:
                raise ValueError("untokenizable input")
            cap = -n  # the buffer was too small: the size needed

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.dc_tok_free(handle)
