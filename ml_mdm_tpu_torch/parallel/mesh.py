"""Data parallelism across processes, one card (or CPU) each.

Counterpart of the data axis of ``ml_mdm_tpu/parallel/mesh.py``. The JAX
package runs one compiled step over a device mesh whose ``data`` axis
shards the global batch, and XLA all-reduces the gradients. Here each
process (``distributed.init_distributed_singlenode``) reads its own reader
partition, ``batch_size`` rows (per process, as in the JAX CLI), and the
train step averages the loss and the gradients over the processes with one
bucketed ``all_reduce`` (``all_reduce_mean``) before the norm, so every
process clips alike and takes the same NaN-skip decision. Parameters start
equal on every process: ``broadcast_module`` sends rank 0's after init and
load. The mesh's other axis, ``fsdp`` (parameters sharded), is not ported:
``data_axis_size`` raises for it.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

# the bytes of one all_reduce bucket
BUCKET_BYTES = 256 * 2**20


def data_axis_size(spec: Optional[str], world_size: int) -> int:
    """The data axis of a ``--mesh-shape`` spec ("data:4"; None: every
    process), which must span the processes. Any other axis raises
    ``NotImplementedError``."""
    if not spec:
        return world_size
    sizes = {}
    for part in spec.split(","):
        name, _, size = part.partition(":")
        sizes[name.strip()] = int(size) if size else -1
    other = sorted(set(sizes) - {"data"})
    if other:
        raise NotImplementedError(f"--mesh-shape {spec!r}: only the data axis is ported "
                                  f"(axes {other} are not)")
    n = sizes["data"] if sizes["data"] > 0 else world_size
    if n != world_size:
        raise ValueError(f"--mesh-shape {spec!r}: the data axis must span the "
                         f"{world_size} processes")
    return n


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Average ``tensors`` over the processes in place, packed into flat
    buckets of one dtype and at most ``BUCKET_BYTES`` each."""
    world = dist.get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group + [None]:
            if t is not None:
                bucket.append(t)
                size += t.numel() * t.element_size()
            if bucket and (t is None or size >= BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat)
                flat.div_(world)
                offset = 0
                for b in bucket:
                    b.copy_(flat[offset:offset + b.numel()].view_as(b))
                    offset += b.numel()
                bucket, size = [], 0


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every process."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t, src=0)
