"""Dataset tar fetcher: reads a TSV index, fetches the tar shards its ``tar``
column names (this node's share, on a thread pool, under an optional byte
rate cap) and writes the index again with that column pointing at the
local copies. ``s3://`` sources go through ``s3_helpers`` (``boto3``);
local or NFS paths are copied, so the tool also runs without a network.

The port's own copy of ``ml_mdm_tpu/clis/download_tar_from_index.py``.

    python -m ml_mdm_tpu_torch.clis.download_tar_from_index --index-file index.tsv \\
        --dest-dir dataset_tars [--node-id 0 --num-nodes 1 --max-bytes-per-sec 0]
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from ml_mdm_tpu_torch import s3_helpers


def read_index(path: str):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    return header, rows


def write_index(path: str, header, rows):
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        for row in rows:
            f.write("\t".join(row) + "\n")


class RateLimiter:
    """A byte rate cap shared by the download threads (0: no cap): each
    ``consume`` books its bytes after the ones booked before it and sleeps
    until its turn."""

    def __init__(self, bytes_per_sec: float = 0):
        self.rate = bytes_per_sec
        self._allow_at = time.monotonic()
        self._lock = threading.Lock()

    def consume(self, nbytes: int):
        if self.rate <= 0:
            return
        with self._lock:
            now = time.monotonic()
            start = max(self._allow_at, now)
            self._allow_at = start + nbytes / self.rate
            sleep = start - now
        if sleep > 0:
            time.sleep(sleep)


def fetch_one(src: str, dest_dir: str, limiter: RateLimiter, endpoint_url=None) -> str:
    """``src`` copied (or downloaded, for ``s3://``) into ``dest_dir`` under
    its base name, unless it is there already; returns the local path."""
    local = os.path.join(dest_dir, os.path.basename(src))
    if os.path.exists(local):
        return local
    if src.startswith("s3://"):
        s3_helpers.download_object_from_full_path(src, local, endpoint_url=endpoint_url)
    else:
        shutil.copyfile(src, local)
    limiter.consume(os.path.getsize(local))
    return local


def main(argv=None):
    p = argparse.ArgumentParser(description="download dataset tar shards")
    p.add_argument("--index-file", type=str, required=True)
    p.add_argument("--output-index", type=str, default=None)
    p.add_argument("--dest-dir", type=str, default="dataset_tars")
    p.add_argument("--node-id", type=int, default=int(os.environ.get("RANK", 0)))
    p.add_argument("--num-nodes", type=int, default=int(os.environ.get("WORLD_SIZE", 1)))
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--max-bytes-per-sec", type=float, default=0)
    p.add_argument("--endpoint-url", type=str, default=None)
    args = p.parse_args(argv)

    header, rows = read_index(args.index_file)
    tar_col = header.index("tar")
    tars = sorted({row[tar_col] for row in rows})
    my_tars = s3_helpers.shard_for_node(tars, args.node_id, args.num_nodes)
    logging.info(f"node {args.node_id}/{args.num_nodes}: fetching "
                 f"{len(my_tars)}/{len(tars)} shards")

    limiter = RateLimiter(args.max_bytes_per_sec)
    os.makedirs(args.dest_dir, exist_ok=True)
    mapping: Dict[str, str] = {}
    with ThreadPoolExecutor(max_workers=args.num_workers) as pool:
        locals_ = pool.map(lambda s: fetch_one(s, args.dest_dir, limiter, args.endpoint_url),
                           my_tars)
        for src, local in zip(my_tars, locals_):
            mapping[src] = local

    kept = []
    for row in rows:
        if row[tar_col] in mapping:
            row = list(row)
            row[tar_col] = mapping[row[tar_col]]
            kept.append(row)
    out = args.output_index or (args.index_file + f".node{args.node_id}")
    write_index(out, header, kept)
    logging.info(f"wrote {out} with {len(kept)} rows")
    return out


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
