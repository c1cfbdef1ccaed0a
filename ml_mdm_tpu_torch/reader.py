"""The text side of the input pipeline: ``ReaderConfig`` and the caption
tokenization used at inference.

Counterpart of ``ml_mdm_tpu/reader.py`` ``ReaderConfig``, ``convert`` and
``process_text``. The tar and image pipeline of that module is not ported
yet. Field names and defaults are the JAX package's, so the
``reader_config`` sections of the shipped YAMLs load unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class ReaderConfig:
    smaller_side_size: int = -1
    max_caption_length: int = -1
    max_token_length: int = -1
    image_size: int = -1
    random_crop: bool = False
    num_kept_files: int = -1
    num_readers: int = 16
    shuffle_buffer_size: int = 9600
    reader_buffer_size: int = 9600
    endpoint_url: str = ""
    bucket: str = "mlx"
    prepad_caption_with_space: bool = True
    use_tokenizer_scores: bool = True
    prepad_bos: bool = False
    append_eos: bool = True
    padding_token: str = "<pad>"
    pad_to_max_length: bool = False


def convert(arr) -> str:
    """uint8 array -> str, zeros dropped."""
    arr = np.asarray(arr).astype(np.uint8)
    return "".join(chr(x) for x in arr[arr != 0])


def process_text(text: List[str], tokenizer, config: ReaderConfig) -> List[List[int]]:
    """Token ids of each caption: cut to ``max_caption_length`` characters,
    a leading space, optional BOS, EOS, padded with ``padding_token`` to
    ``max_token_length``; every row then cut to the longest caption's
    length (or to ``max_token_length`` with ``pad_to_max_length``)."""
    padded_tokens = []
    max_len = 0
    for d in text:
        if config.max_caption_length > -1:
            d = d[: config.max_caption_length]
        if config.prepad_caption_with_space:
            d = " " + d
        tokens = tokenizer.tokenize_shortest(d, use_scores=config.use_tokenizer_scores)
        if config.prepad_bos:
            tokens = [tokenizer.bos] + tokens
        if config.append_eos:
            tokens = tokens + [tokenizer.eos]
        max_len = max(max_len, len(tokens))
        if len(tokens) < config.max_token_length:
            pad = config.max_token_length - len(tokens)
            tokens = tokens + [tokenizer.token_id(config.padding_token)] * pad
        padded_tokens.append(tokens)
    if config.pad_to_max_length:
        max_len = config.max_token_length
    else:
        max_len = min(max_len, config.max_token_length)
    return [t[:max_len] for t in padded_tokens]
