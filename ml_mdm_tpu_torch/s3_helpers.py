"""S3 helpers of the data tools: ``s3://bucket/key`` parsing, regex patterns
expanded to object lists, downloads (one, or many on a thread pool) and
node sharding of a download list.

The port's own copy of ``ml_mdm_tpu/s3_helpers.py``. ``boto3`` is optional
and imported at each call that needs it: without it those calls raise
``_require_boto3``'s ``RuntimeError``, while the string helpers
(``parse_s3_path``, ``shard_for_node``) keep working.
"""
from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple


def _require_boto3():
    try:
        import boto3

        return boto3
    except ImportError as e:
        raise RuntimeError(
            "boto3 is not installed; S3 downloads are unavailable in this "
            "environment. Use local file paths instead."
        ) from e


def parse_s3_path(path: str) -> Tuple[str, str]:
    m = re.match(r"^s3://([^/]+)/(.*)$", path)
    if not m:
        raise ValueError(f"not an s3 path: {path}")
    return m.group(1), m.group(2)


def expand_s3_pattern(pattern: str, endpoint_url: Optional[str] = None) -> List[str]:
    """The ``s3://`` paths of the objects whose keys match the regex in
    ``pattern`` (``*`` as ``.*``), listed under the key's literal prefix,
    sorted."""
    boto3 = _require_boto3()
    bucket, key_pattern = parse_s3_path(pattern)
    prefix = key_pattern.split("[")[0].split("(")[0].split("*")[0]
    prefix = prefix.rsplit("/", 1)[0] + "/" if "/" in prefix else ""
    client = boto3.client("s3", endpoint_url=endpoint_url or None)
    keys = []
    paginator = client.get_paginator("list_objects_v2")
    rx = re.compile(key_pattern.replace("*", ".*") + "$")
    for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
        for obj in page.get("Contents", []):
            if rx.match(obj["Key"]):
                keys.append(f"s3://{bucket}/{obj['Key']}")
    return sorted(keys)


def download_object(bucket: str, key: str, download_path: str,
                    endpoint_url: Optional[str] = None):
    boto3 = _require_boto3()
    client = boto3.client("s3", endpoint_url=endpoint_url or None)
    os.makedirs(os.path.dirname(download_path) or ".", exist_ok=True)
    client.download_file(bucket, key, download_path)
    return download_path


def download_object_from_full_path(path: str, download_path: str,
                                   endpoint_url: Optional[str] = None):
    bucket, key = parse_s3_path(path)
    return download_object(bucket, key, download_path, endpoint_url)


def download_many(paths: List[str], dest_dir: str, num_workers: int = 8,
                  endpoint_url: Optional[str] = None) -> List[str]:
    """Each path downloaded into ``dest_dir`` under its base name, on a pool
    of ``num_workers`` threads; a file already there is kept."""
    os.makedirs(dest_dir, exist_ok=True)

    def one(path):
        local = os.path.join(dest_dir, os.path.basename(path))
        if os.path.exists(local):
            return local
        return download_object_from_full_path(path, local, endpoint_url)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(one, paths))


def shard_for_node(paths: List[str], node_id: int, num_nodes: int) -> List[str]:
    """Node ``node_id``'s share of a download list: every ``num_nodes``-th."""
    return [p for i, p in enumerate(paths) if i % num_nodes == node_id]
