"""Trie tokenizer: a vocabulary file read into a byte-level ``CharTrie``,
captions split by the shortest path (the least total score) through the
token lattice.

Counterpart of ``ml_mdm_tpu/language_models/tokenizer.py``. Three
vocabulary dialects, each with the JAX package's conventions:

- t5: sentencepiece TSV (token \\t logprob); '▁' is a space; specials
  </s> <unk> <pad>; a token's score is -logprob;
- bert: wordpiece TSV; [SEP] [CLS] [PAD]; every other token scores 0;
- spm (the default): the specials <pad> <s> </s> first, the <0xNN> byte
  tokens inserted as bytes, specials scored max + 1.

``Tokenizer.tokenize_shortest`` answers through the port's C++ trie
(``ml_mdm_tpu_torch/native``, built at first use), as the JAX one does
through its own; where that library is unavailable it runs the Python
search, which gives the same ids.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple


class _TrieNode:
    __slots__ = ("children", "id")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.id: Optional[int] = None


class CharTrie:
    """Byte-level trie; a key's id is its insertion order."""

    def __init__(self):
        self.root = _TrieNode()
        self._keys: List[bytes] = []

    def insert(self, token) -> int:
        if isinstance(token, str):
            token = token.encode("utf-8")
        node = self.root
        for b in token:
            node = node.children.setdefault(b, _TrieNode())
        if node.id is None:
            node.id = len(self._keys)
            self._keys.append(token)
        return node.id

    def search(self, token) -> Optional[_TrieNode]:
        if isinstance(token, str):
            token = token.encode("utf-8")
        node = self.root
        for b in token:
            node = node.children.get(b)
            if node is None:
                return None
        return node if node.id is not None else None

    def num_keys(self) -> int:
        return len(self._keys)

    def key(self, i: int) -> bytes:
        return self._keys[i]

    def key_string(self, i: int) -> str:
        return self._keys[i].decode("utf-8", errors="replace")


def tokenize_shortest(trie: CharTrie, text, scores: Optional[List[float]] = None,
                      ignore_unk: bool = True) -> List[int]:
    """The segmentation of ``text`` with the least total score (Viterbi over
    the token lattice). Without scores every token costs 1, so the fewest
    tokens win. A byte no token starts at is skipped when ``ignore_unk``,
    else it raises."""
    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    n = len(data)
    inf = float("inf")
    dist = [inf] * (n + 1)  # least cost to reach each position
    back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
    dist[0] = 0.0
    unk_cost = 1e9  # any real segmentation beats skipping a byte

    for i in range(n):
        di = dist[i]
        if di == inf:
            continue
        node = trie.root
        j = i
        matched = False
        while j < n:
            node = node.children.get(data[j])
            if node is None:
                break
            j += 1
            if node.id is not None:
                matched = True
                cost = di + (scores[node.id] if scores is not None else 1.0)
                if cost < dist[j]:
                    dist[j] = cost
                    back[j] = (i, node.id)
        if not matched or dist[i + 1] == inf:
            if ignore_unk:
                cost = di + unk_cost
                if cost < dist[i + 1]:
                    dist[i + 1] = cost
                    back[i + 1] = (i, None)
            elif not matched:
                raise ValueError(f"untokenizable byte {data[i]!r} at position {i}")

    tokens: List[int] = []
    pos = n
    while pos > 0:
        prev, tok = back[pos]
        if tok is not None:
            tokens.append(tok)
        pos = prev
    tokens.reverse()
    return tokens


_SEP = "▁".encode()


def _read_tsv(vocab_file: str):
    """(token with '▁' as a space, score) per non-empty line."""
    with open(vocab_file, "rb") as f:
        for line in f:
            line = line.rstrip()
            if line:
                token, score = line.split(b"\t")
                yield token, float(score)


def _insert_new(trie: CharTrie, token: bytes):
    if trie.search(token):
        raise RuntimeError(f"token {token!r} already exists")
    trie.insert(token)


def read_dictionary_t5(vocab_file: str):
    trie, scores = CharTrie(), []
    for token, score in _read_tsv(vocab_file):
        _insert_new(trie, token.replace(_SEP, b" "))
        scores.append(-score)
    return trie, scores, _find(trie, "</s>"), _find(trie, "<unk>"), _find(trie, "<pad>")


def read_dictionary_bert(vocab_file: str):
    trie, scores = CharTrie(), []
    specials = (b"[PAD]", b"[SEP]", b"[CLS]")
    for token, score in _read_tsv(vocab_file):
        token = token.replace(_SEP, b" ")
        _insert_new(trie, token)
        scores.append(-score if token in specials else 0.0)
    return trie, scores, _find(trie, "[SEP]"), _find(trie, "[CLS]"), _find(trie, "[PAD]")


def read_dictionary(vocab_file: str):
    trie, scores = CharTrie(), []
    specials = [b"<pad>", b"<s>", b"</s>"]
    for token in specials:
        trie.insert(token)
        scores.append(0.0)
    max_score = 0.0
    for token, score in _read_tsv(vocab_file):
        s = -score
        if re.match(b"^<.*>$", token):
            if token not in specials:
                specials.append(token)
        else:
            _insert_new(trie, token.replace(_SEP, b" "))
            scores.append(s)
        max_score = max(max_score, s)
    for token in specials:
        hex_byte = re.match(b"^<0x(..)>$", token)
        if hex_byte:
            token = bytes.fromhex(hex_byte.groups()[0].decode())
        if not trie.search(token):
            trie.insert(token)
            scores.append(max_score + 1.0)
    return trie, scores, _find(trie, "</s>"), _find(trie, "<s>"), _find(trie, "<pad>")


def _find(trie: CharTrie, token: str) -> int:
    node = trie.search(token)
    return node.id if node is not None else -1


class Tokenizer:
    """A vocabulary file (``mode`` "t5", "bert" or None for spm) with
    ``tokenize_shortest`` and the ids of eos, bos and pad."""

    def __init__(self, vocab_file: str, mode: Optional[str] = None):
        read = {"t5": read_dictionary_t5, "bert": read_dictionary_bert}.get(mode, read_dictionary)
        self._trie, self._trie_key_scores, self.eos, self.bos, self.pad = read(vocab_file)
        self.vocab_size = self._trie.num_keys()
        self._native = None  # the C++ trie, attached at first use (False: unavailable)

    @property
    def trie(self):
        return self._trie

    @property
    def trie_key_scores(self):
        return self._trie_key_scores

    def tokens2text(self, tokens) -> str:
        return "".join(self._trie.key_string(int(t)) for t in tokens)

    def token_id(self, token) -> int:
        node = self._trie.search(token)
        if node is None:
            raise ValueError(f"token: {token} not found in vocab.")
        return node.id

    def tokenize_shortest(self, text, use_scores: bool = True) -> List[int]:
        if self._native is None:
            from ml_mdm_tpu_torch.native import trie_tokenizer

            try:
                self._native = trie_tokenizer.NativeTokenizer(self._trie, self._trie_key_scores)
            except RuntimeError:  # the library did not build or load
                self._native = False
        if self._native:
            return self._native.tokenize_shortest(text, use_scores)
        return tokenize_shortest(self._trie, text,
                                 self._trie_key_scores if use_scores else None,
                                 ignore_unk=True)
