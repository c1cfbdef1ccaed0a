"""Process coordination of a data-parallel run on one node.

Counterpart of ``ml_mdm_tpu/distributed.py``, on ``torch.distributed``
(the JAX package wires hosts with ``jax.distributed``; the reference
initialises NCCL from torchrun's environment, as here).
``init_distributed_singlenode`` reads ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (torchrun sets them)
and joins the process group over ``tcp://MASTER_ADDR:MASTER_PORT``: NCCL
when the run's device is CUDA, gloo on the CPU. A world size of 1
initialises nothing.
"""
from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist


def init_distributed_singlenode(timeout: int = 0, device="cpu"):
    """Join the process group of a torchrun-style launch on ``device``'s
    type. Returns (local_rank, global_rank, world_size)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = get_local_rank()
    if world > 1 and not dist.is_initialized():
        rank = int(os.environ.get("RANK", "0"))
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.set_device(local_rank)
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        kw = {"timeout": datetime.timedelta(seconds=timeout)} if timeout else {}
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank, **kw)
        logging.info(f"torch.distributed initialised: process {rank}/{world}, "
                     f"{dist.get_backend()}")
    return local_rank, get_rank(), get_world_size()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str = "barrier"):
    """All processes meet here (``name`` is for the reader of the code, as
    the JAX package's sync names)."""
    if get_world_size() > 1:
        dist.barrier()


def print0(*args, **kwargs):
    if get_rank() == 0:
        print(*args, **kwargs)
