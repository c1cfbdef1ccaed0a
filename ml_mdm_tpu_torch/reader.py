"""The input pipeline: TSV index -> tar shards -> JPEG decode -> resize and
crop -> trie tokenization -> batches -> prefetch queue; and the caption
tokenization used at inference.

Counterpart of ``ml_mdm_tpu/reader.py``, whole: ``ReaderConfig``,
``convert``, ``process_text``, the image operations, ``_TarCache``,
``_sample_rows``, ``_Pipeline``, ``_collate``, ``get_dataset`` and
``get_dataset_partition``. Field names and defaults are the JAX package's,
so the ``reader_config`` sections of the shipped YAMLs load unchanged, and
the rows, their order, shuffles, partitions and crops are the JAX reader's
for the same seed: with one worker the batches are equal key by key
(tests/test_torch_data.py).

Worker threads (``num_readers``, at most 8) read members from the tar
shards, decode, resize and crop, and tokenize; a bounded queue holds their
samples and the iterator assembles batches. JPEG members go through the
port's C++ data plane (``ml_mdm_tpu_torch/native``: libjpeg, then PIL's
antialiased bilinear resize, with the GIL released); any other image, or
every image where that library is unavailable, through PIL with the same
geometry. Each pipeline counts its decodes by route (``decodes``). Plain
tar shards are read through the C++ member index, others with ``tarfile``.
"""
from __future__ import annotations

import io
import logging
import os
import queue
import tarfile
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

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


# -- image operations (PIL, on the host) ------------------------------------


def _load_image(data: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(data)).convert("RGB")


def _resize_smallest_side(img, size: int):
    """The smallest side to ``size``, the other in proportion (rounded, at
    least ``size``), with PIL's antialiased bilinear filter."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nw, nh = max(size, int(round(w * size / h))), size
    return img.resize((nw, nh), Image.BILINEAR)


def _crop(img, size: int, random_crop: bool, rng: np.random.Generator):
    w, h = img.size
    if random_crop:
        x0 = rng.integers(0, max(w - size, 0) + 1)
        y0 = rng.integers(0, max(h - size, 0) + 1)
    else:
        x0, y0 = (w - size) // 2, (h - size) // 2
    return img.crop((x0, y0, x0 + size, y0 + size))


# -- the streaming dataset ---------------------------------------------------


def _read_tsv(path: str) -> Iterator[Dict[str, str]]:
    """The rows of a TSV with a header line, as dicts; short rows are
    skipped."""
    with open(path, newline="") as f:
        header = None
        for line in f:
            row = line.rstrip("\n").split("\t")
            if header is None:
                header = row
                continue
            if len(row) < len(header):
                continue
            yield dict(zip(header, row))


class _TarCache:
    """The recently used tar shards, kept open (a shard is read many times
    over). A plain ustar shard is opened through the C++ member index
    (lookups by name, reads with the GIL released); a compressed or other
    one with ``tarfile``."""

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _open(self, tar_path: str):
        with open(tar_path, "rb") as f:
            magic = f.read(512)
        if magic[257:262] == b"ustar":
            from ml_mdm_tpu_torch.native.tar import NativeTar

            try:
                return NativeTar(tar_path)
            except RuntimeError:  # the library did not build or load
                pass
        return tarfile.open(tar_path, "r")

    def read_member(self, tar_path: str, member: str) -> Optional[bytes]:
        for attempt in range(2):
            tf = None
            try:
                with self._lock:
                    tf = self._cache.get(tar_path)
                    if tf is None:
                        if len(self._cache) >= self.capacity:
                            # evicted without closing: another worker may
                            # hold it outside this lock; it closes when the
                            # last reference goes
                            self._cache.popitem()
                        tf = self._open(tar_path)
                        self._cache[tar_path] = tf
                if isinstance(tf, tarfile.TarFile):
                    with self._lock:
                        f = tf.extractfile(member)
                        return f.read() if f is not None else None
                return tf.read(member)  # NativeTar locks inside the library
            except KeyError:
                return None
            except (OSError, ValueError, tarfile.TarError):
                # a missing or damaged shard, or a handle that raced with
                # a close: drop it and try once more
                with self._lock:
                    if self._cache.get(tar_path) is tf:
                        del self._cache[tar_path]
                if attempt == 1:
                    return None
        return None


def _sample_rows(file_list: str, is_index_file: bool, num_epochs: int,
                 partition_num: int = 0, num_partitions: int = 1,
                 shuffle_buffer_size: int = 0, num_kept_files: int = -1, seed: int = 0):
    """The raw {tar, file, caption, ...} rows of partition ``partition_num``
    of ``num_partitions`` (round robin), epoch after epoch. Each epoch's
    generator is seeded by (seed, epoch): it permutes the shards (of an
    index file, the first ``num_kept_files`` kept) and draws from a bounded
    shuffle buffer."""
    epoch = 0
    while num_epochs == -1 or epoch < num_epochs:
        rng = np.random.default_rng((seed, epoch))
        idx = 0

        def raw_rows():
            if is_index_file:
                shards = []
                for index_row in _read_tsv(file_list):
                    shard = index_row.get("filename") or list(index_row.values())[0]
                    if not os.path.exists(shard):
                        alt = os.path.join(os.path.dirname(os.path.abspath(file_list)), shard)
                        shard = alt if os.path.exists(alt) else shard
                    shards.append(shard)
                if num_kept_files > 0:
                    shards = shards[:num_kept_files]
                if shuffle_buffer_size > 0:
                    rng.shuffle(shards)
                for shard in shards:
                    yield from _read_tsv(shard)
            else:
                yield from _read_tsv(file_list)

        buf: List[Dict[str, str]] = []
        for row in raw_rows():
            mine = idx % num_partitions == partition_num
            idx += 1
            if not mine:
                continue
            if shuffle_buffer_size > 1:
                if len(buf) < shuffle_buffer_size:
                    buf.append(row)
                    continue
                j = int(rng.integers(0, len(buf)))
                buf[j], row = row, buf[j]
            yield row
        if buf:
            rng.shuffle(buf)
            yield from buf
        epoch += 1
        if idx == 0:
            return  # an empty dataset: no endless loop


class _Pipeline:
    """Worker threads that decode and tokenize rows, a bounded queue of
    samples, and the iterator that assembles batches from it. Each worker
    posts an end-of-stream sentinel when it stops; the iterator ends with
    the last batch (possibly short) after every worker's. ``close()`` stops
    the workers. ``decodes`` counts the images decoded by each route
    ("native", "pil")."""

    def __init__(self, row_iter, tokenizer, batch_size: int, config: ReaderConfig,
                 skip_images: bool = False, load_numpy: bool = False, file_list: str = "",
                 seed: int = 0):
        self.row_iter = row_iter
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.config = config
        self.skip_images = skip_images
        self.load_numpy = load_numpy
        self.file_list = file_list
        self.tar_cache = _TarCache()
        self.text_tar_cache = _TarCache()
        self.rng = np.random.default_rng(seed)
        self.decodes = {"native": 0, "pil": 0}
        self._count_lock = threading.Lock()
        self._row_lock = threading.Lock()
        self._out: "queue.Queue" = queue.Queue(maxsize=max(2, min(config.reader_buffer_size, 64)))
        self._stop = threading.Event()
        n_workers = max(1, min(config.num_readers, 8))
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(n_workers)]
        self._started = False

    # -- one sample

    def _resolve(self, row, key):
        path = row.get(key, "")
        if path and not os.path.exists(path):
            alt = os.path.join(os.path.dirname(os.path.abspath(self.file_list)), path)
            if os.path.exists(alt):
                return alt
        return path

    def _count(self, route: str):
        with self._count_lock:
            self.decodes[route] += 1

    def _image(self, data: bytes) -> Optional[np.ndarray]:
        cfg = self.config
        smaller_side = cfg.smaller_side_size if cfg.smaller_side_size != -1 else cfg.image_size
        if cfg.image_size != -1:
            from ml_mdm_tpu_torch.native import image as native_image

            arr = native_image.decode_resize_crop(
                data, smaller_side, cfg.image_size, cfg.random_crop,
                seed=int(self.rng.integers(1, 2**63)))
            if arr is not None:
                self._count("native")
                return arr
        try:  # not a JPEG, or the native route unavailable: PIL
            img = _load_image(data)
        except Exception:  # PIL raises many types for bytes that are no image
            return None
        if cfg.image_size != -1:
            # the native route's geometry: the smallest side to
            # smaller_side, then an image_size crop
            img = _resize_smallest_side(img, smaller_side)
            img = _crop(img, cfg.image_size, cfg.random_crop, self.rng)
        self._count("pil")
        return np.asarray(img, dtype=np.uint8)

    def _process(self, row) -> Optional[Dict[str, Any]]:
        cfg = self.config
        out: Dict[str, Any] = {}
        caption = row.get("caption", "")
        if not self.skip_images:
            data = self.tar_cache.read_member(self._resolve(row, "tar"), row.get("file", ""))
            if data is None:
                return None
            arr = self._image(data)
            if arr is None:
                return None
            out["image"] = arr

        if self.load_numpy:
            data = self.text_tar_cache.read_member(self._resolve(row, "text_tar"),
                                                   row.get("text_file", ""))
            if data is None:
                return None
            out["text_embedding"] = np.load(io.BytesIO(data))

        if self.tokenizer is not None:
            cap = " " + caption + " "  # the reference pipeline pads captions with spaces
            tokens = self.tokenizer.tokenize_shortest(cap, use_scores=cfg.use_tokenizer_scores)
            if cfg.prepad_bos:
                tokens = [self.tokenizer.bos] + tokens
            if cfg.append_eos:
                tokens = tokens + [self.tokenizer.eos]
            if cfg.max_caption_length != -1 and len(caption) > cfg.max_caption_length:
                return None
            if cfg.max_token_length != -1:
                if len(tokens) > cfg.max_token_length:
                    return None
                if cfg.pad_to_max_length:
                    pad_id = self.tokenizer.token_id(cfg.padding_token)
                    tokens = tokens + [pad_id] * (cfg.max_token_length - len(tokens))
            out["tokens"] = np.asarray(tokens, dtype=np.int64)

        # the other columns (watermark_score, state, ...) as utf-8 bytes
        for key, value in row.items():
            if key not in ("tar", "file", "caption") and key not in out:
                out[key] = np.frombuffer(value.encode("utf-8"), dtype=np.uint8).copy()
        out["caption"] = np.frombuffer(caption.encode("utf-8"), dtype=np.uint8).copy()
        return out

    # -- workers and batches

    def _next_row(self):
        with self._row_lock:
            return next(self.row_iter, None)

    def _put(self, item) -> bool:
        """A put that gives up when close() is called."""
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            while not self._stop.is_set():
                row = self._next_row()
                if row is None:
                    return
                try:
                    sample = self._process(row)
                except Exception:  # one bad row must not stop the stream
                    logging.exception("reader worker: sample dropped")
                    continue
                if sample is not None and not self._put(sample):
                    return
        finally:
            # always the sentinel: the iterator waits for one from each worker
            self._put(None)

    def __iter__(self):
        if not self._started:
            for t in self._threads:
                t.start()
            self._started = True
        n_live = len(self._threads)
        pad_id = (self.tokenizer.token_id(self.config.padding_token)
                  if self.tokenizer is not None else 0)
        batch: List[Dict[str, Any]] = []
        while True:
            item = self._out.get()
            if item is None:
                n_live -= 1
                if n_live == 0:
                    if batch:
                        yield _collate(batch, pad_id)
                    return
                continue
            batch.append(item)
            if len(batch) == self.batch_size:
                yield _collate(batch, pad_id)
                batch = []

    def close(self):
        self._stop.set()


def _collate(batch: List[Dict[str, Any]], pad_id: int) -> Dict[str, np.ndarray]:
    """One array a key that every sample has: scalars stacked, arrays
    padded to the largest shape (``tokens`` with ``pad_id``, others with 0)."""
    out = {}
    keys = set().union(*(b.keys() for b in batch))
    for key in keys:
        vals = [b[key] for b in batch if key in b]
        if len(vals) < len(batch):
            continue
        first = np.asarray(vals[0])
        if first.ndim == 0:
            out[key] = np.stack([np.asarray(v) for v in vals])
            continue
        max_shape = np.max([np.asarray(v).shape for v in vals], axis=0)
        stacked = np.full((len(vals), *max_shape), pad_id if key == "tokens" else 0,
                          dtype=first.dtype)
        for i, v in enumerate(vals):
            v = np.asarray(v)
            stacked[(i, *(slice(0, n) for n in v.shape))] = v
        out[key] = stacked
    return out


def get_dataset(tokenizer, batch_size, file_list: str, config: ReaderConfig,
                num_epochs: int = -1, skip_images: bool = False, load_numpy: bool = False,
                is_index_file: bool = False) -> _Pipeline:
    rows = _sample_rows(file_list, is_index_file, num_epochs,
                        shuffle_buffer_size=config.shuffle_buffer_size,
                        num_kept_files=config.num_kept_files)
    return _Pipeline(rows, tokenizer, batch_size, config, skip_images, load_numpy,
                     file_list=file_list)


def get_dataset_partition(partition_num, num_partitions, tokenizer, batch_size,
                          file_list: str, config: ReaderConfig, num_epochs: int = -1,
                          skip_images: bool = False, load_numpy: bool = False,
                          is_index_file: bool = False) -> _Pipeline:
    """The pipeline over partition ``partition_num`` of ``num_partitions``
    (one a process), its shuffles and crops seeded by the partition."""
    rows = _sample_rows(file_list, is_index_file, num_epochs, partition_num, num_partitions,
                        shuffle_buffer_size=config.shuffle_buffer_size,
                        num_kept_files=config.num_kept_files, seed=partition_num)
    return _Pipeline(rows, tokenizer, batch_size, config, skip_images, load_numpy,
                     file_list=file_list, seed=partition_num)
