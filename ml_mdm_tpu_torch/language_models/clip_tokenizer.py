"""CLIP's tokenizer: byte-level BPE with ``</w>`` word ends.

The port's counterpart of what ``CLIPProcessor.from_pretrained`` loads for
the JAX package's ``run_torchmetrics`` (``ClipFeatures``): the fast
tokenizer (``CLIPTokenizerFast``), converted from ``vocab.json`` and
``merges.txt`` where the directory has no ``tokenizer.json``. Its steps, as
that conversion sets them up (``transformers`` ``CLIPConverter``):

1. normalize: NFC, every run of white space to one space, lower case
   character by character;
2. split into the matches of ``'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|
   [^\\s\\p{L}\\p{N}]+`` (the white space between them dropped);
3. map each piece's utf-8 bytes to GPT-2's printable characters;
4. BPE over those characters, the last one carrying ``</w>``, merging the
   pair of lowest rank in ``merges.txt`` (whose first line is a header, and
   of which at most 48,894 are read, as the slow tokenizer reads them);
5. ``<|startoftext|>`` ... ``<|endoftext|>`` around each caption;
   truncated to ``model_max_length`` of ``tokenizer_config.json`` where the
   directory gives one (77 in OpenAI's), else not at all, as the JAX call
   does; padded with the pad token (``<|endoftext|>`` unless the directory
   names another) to the longest caption, with an attention mask.

It reads only local files and needs neither ``transformers`` nor
``regex``: the split follows the pattern character by character with
``unicodedata``'s categories.
"""
from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the slow tokenizer reads merges.txt's lines [1, 49152 - 256 - 2 + 1)
MAX_MERGES = 49152 - 256 - 2
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode's White_Space property (Rust's ``\s``, which the fast tokenizer's
# regexes use)
WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
                        + "\u2028\u2029\u202f\u205f\u3000")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


BYTE_ENCODER = _bytes_to_unicode()


def normalize(text: str) -> str:
    """NFC, white-space runs to one space, lower case by character."""
    text = unicodedata.normalize("NFC", text)
    out, in_space = [], False
    for c in text:
        if c in WHITE_SPACE:
            if not in_space:
                out.append(" ")
            in_space = True
        else:
            out.append(c.lower())
            in_space = False
    return "".join(out)


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def split_words(text: str) -> List[str]:
    """The matches of CLIP's pattern, left to right, the first alternative
    that matches at each position winning: a contraction, a run of
    letters, one number character, or a run of characters that are none of
    white space, letter or number."""
    words, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        contraction = next((s for s in CONTRACTIONS if text.startswith(s, i)), None)
        if contraction:
            j = i + len(contraction)
        elif _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            j = i + 1
        elif c in WHITE_SPACE:
            i += 1
            continue
        else:
            j = i + 1
            while j < n and not (text[j] in WHITE_SPACE or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _special(value, default: str) -> str:
    """A special token as a config file gives it: a string or an
    ``AddedToken``-like dict with its ``content``."""
    if value is None:
        return default
    return value["content"] if isinstance(value, dict) else str(value)


class CLIPTokenizer:
    """``CLIPTokenizer(path)`` reads ``vocab.json``, ``merges.txt`` and,
    where present, ``tokenizer_config.json`` and ``special_tokens_map.json``
    from the local directory ``path``; ``tokenizer(texts)`` returns
    (input_ids, attention_mask), int64 arrays of (len(texts), longest)."""

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"CLIP tokenizer {path!r} is not a local directory (vocab.json + merges.txt); "
                "the port downloads nothing")
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        self.bpe_ranks: Dict[Tuple[str, ...], int] = {}
        for rank, line in enumerate(lines):
            self.bpe_ranks[tuple(line.split())] = rank
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            file = os.path.join(path, name)
            if os.path.exists(file):
                with open(file, encoding="utf-8") as f:
                    config.update(json.load(f))
        self.model_max_length: Optional[int] = config.get("model_max_length")
        self.bos_id = self.encoder[_special(config.get("bos_token"), "<|startoftext|>")]
        self.eos_id = self.encoder[_special(config.get("eos_token"), "<|endoftext|>")]
        self.pad_id = self.encoder[_special(config.get("pad_token"), "<|endoftext|>")]
        self.unk_id = self.encoder.get(_special(config.get("unk_token"), "<|endoftext|>"))
        self._cache: Dict[str, List[int]] = {}

    def bpe(self, word: str) -> List[str]:
        """The BPE symbols of one byte-mapped word, ``</w>`` on its last."""
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols, symbols[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == first and symbols[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        return symbols

    def encode(self, text: str) -> List[int]:
        """The ids of one caption without the start and end tokens."""
        ids = []
        for word in split_words(normalize(text)):
            if word not in self._cache:
                mapped = "".join(BYTE_ENCODER[b] for b in word.encode("utf-8"))
                self._cache[word] = [self.encoder.get(s, self.unk_id) for s in self.bpe(mapped)]
            ids.extend(self._cache[word])
        return ids

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        rows = []
        for text in texts:
            ids = self.encode(text)
            if self.model_max_length is not None:
                ids = ids[:max(self.model_max_length - 2, 0)]
            rows.append([self.bos_id] + ids + [self.eos_id])
        longest = max(len(r) for r in rows)
        input_ids = np.full((len(rows), longest), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(rows), longest), dtype=np.int64)
        for i, r in enumerate(rows):
            input_ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return input_ids, mask
