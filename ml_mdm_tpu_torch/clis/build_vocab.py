"""Build the trie tokenizer's vocabulary files (``token<TAB>score`` rows).

The port's own copy of ``ml_mdm_tpu/clis/build_vocab.py``, without
``transformers`` and ``sentencepiece``:

- from a local tokenizer directory: with ``spiece.model``, the pieces and
  their scores read from the sentencepiece model proto itself (what the JAX
  tool's slow-tokenizer path, ``sp_model``, gives); else from
  ``tokenizer.json``, the vocabulary (added tokens included) in id order
  with flat 0.0 scores (the JAX tool's fast-tokenizer path). Either way
  ``<pad> </s> <unk>`` are pinned to the first rows, the layout
  ``language_models/tokenizer.py``'s mode "t5" expects. A Hugging Face hub
  name is not fetched: a name that is not a local directory raises. (Given
  a directory that holds both files, the JAX tool loads the fast tokenizer
  and writes flat scores; the port reads the proto's.)
- from a plain word list (one token per line): scores ``-log(rank + 2)``.

    python -m ml_mdm_tpu_torch.clis.build_vocab --tokenizer <local dir> --output t5.vocab
    python -m ml_mdm_tpu_torch.clis.build_vocab --wordlist words.txt --output out.vocab
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import struct
import sys
from typing import Iterator, List, Tuple

SPECIALS = ["<pad>", "</s>", "<unk>"]


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one protobuf
    message: an int for varints, bytes for length-delimited fields, the raw
    little-endian bytes for the fixed 32- and 64-bit types."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"sentencepiece model: unsupported wire type {wire}")
        yield field, wire, value


def read_sentencepiece(path: str) -> List[Tuple[str, float]]:
    """(piece, score) of every piece of a sentencepiece ``ModelProto``, in
    id order: field 1 is the repeated ``SentencePiece``, whose field 1 is the
    piece and field 2 the float score (0.0 where absent)."""
    with open(path, "rb") as f:
        data = f.read()
    rows = []
    for field, wire, value in _fields(data):
        if field != 1 or wire != 2:
            continue
        piece, score = "", 0.0
        for sub, sub_wire, sub_value in _fields(value):
            if sub == 1 and sub_wire == 2:
                piece = sub_value.decode("utf-8")
            elif sub == 2 and sub_wire == 5:
                score = struct.unpack("<f", sub_value)[0]
        rows.append((piece, score))
    return rows


def read_tokenizer_json(path: str) -> List[Tuple[str, float]]:
    """The vocabulary of a ``tokenizers`` ``tokenizer.json`` (the model's,
    then the added tokens), sorted by id, each with score 0.0."""
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    vocab = spec["model"]["vocab"]
    ids = ({row[0]: i for i, row in enumerate(vocab)} if isinstance(vocab, list)
           else dict(vocab))
    ids.update({t["content"]: t["id"] for t in spec.get("added_tokens", [])})
    return [(t, 0.0) for t, _ in sorted(ids.items(), key=lambda kv: kv[1])]


def vocab_from_sentencepiece(name_or_path: str):
    """(token, score) rows of the tokenizer in the local directory
    ``name_or_path``, the T5 dialect's three special rows first."""
    spiece = os.path.join(name_or_path, "spiece.model")
    tok_json = os.path.join(name_or_path, "tokenizer.json")
    if os.path.isfile(spiece):
        rows = read_sentencepiece(spiece)
    elif os.path.isfile(tok_json):
        rows = read_tokenizer_json(tok_json)
    else:
        raise FileNotFoundError(
            f"--tokenizer {name_or_path!r}: neither {spiece!r} nor {tok_json!r} exists; the port "
            "reads a local tokenizer directory (spiece.model or tokenizer.json) and downloads "
            "nothing")
    head = [(s, 0.0) for s in SPECIALS]
    body = [(t, s) for t, s in rows if t not in SPECIALS]
    return head + body


def vocab_from_wordlist(path: str):
    rows = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0)]
    with open(path) as f:
        words = [w.strip() for w in f if w.strip()]
    for rank, w in enumerate(words):
        rows.append(("▁" + w, -math.log(rank + 2)))
    return rows


def write_vocab(rows, output: str):
    with open(output, "w") as f:
        for token, score in rows:
            f.write(f"{token}\t{score:.5f}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tokenizer", default=None,
                        help="local tokenizer directory (spiece.model or tokenizer.json)")
    parser.add_argument("--wordlist", default=None, help="plain word list, one token per line")
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    if bool(args.tokenizer) == bool(args.wordlist):
        parser.error("exactly one of --tokenizer / --wordlist is required")

    if args.tokenizer:
        rows = vocab_from_sentencepiece(args.tokenizer)
    else:
        rows = vocab_from_wordlist(args.wordlist)
    write_vocab(rows, args.output)
    logging.info("wrote %d tokens to %s", len(rows), args.output)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
