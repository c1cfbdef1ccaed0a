"""Data parallelism and FSDP across processes (one card or CPU each), and the
one-process data-parallel sampler over several devices.

Counterpart of ``ml_mdm_tpu/parallel/mesh.py``. The JAX package runs one
compiled step over a device mesh whose ``data`` axis shards the global
batch and whose optional ``fsdp`` axis shards the large parameters, and XLA
inserts the collectives. Here each process (``distributed.
init_distributed_singlenode``) reads its own reader partition,
``batch_size`` rows (per process, as in the JAX CLI), and:

- ``--mesh-shape data:N`` (or none): every process holds the whole state,
  and the train step averages the loss and the gradients over the
  processes with one bucketed ``all_reduce`` (``all_reduce_mean``) before
  the norm, so every process clips alike and takes the same NaN-skip
  decision. Parameters start equal on every process: ``broadcast_module``
  sends rank 0's after init and load;
- ``--mesh-shape data:D,fsdp:F`` (``mesh_shape``, ``make_mesh``): a 2-D
  ``DeviceMesh`` (D, F), process r at (r // F, r % F). ``shard_module``
  applies PyTorch's FSDP2 ``fully_shard`` to every U-Net stage and to the
  top module: each parameter that ``infer_param_sharding`` (the JAX rule)
  splits is a ``DTensor`` sharded over ``fsdp`` along the same logical
  axis as in JAX and replicated over ``data``; the others (``ignored_params``)
  stay whole on every process, their gradients averaged by
  ``all_reduce_mean``. FSDP2 gathers a stage's parameters before its
  forward and again before its backward (a recomputed stage reads them
  then), frees them after, and reduce-scatters the gradients (averaged
  over all D F processes). ``FsdpLayout`` holds the placement: the train
  step hands the optimizer and the EMA the local shards (``local``), takes
  the global gradient norm (``grad_norm``), and checkpoints gather and
  split full tensors (``full`` / ``full_local`` / ``shard_of``). The step's
  arithmetic is the data-parallel step's on the same global batch.

``make_data_parallel_sampler`` / ``sample_data_parallel``: one process,
several devices, one replica of the vision module on each; the batch's rows
split over them (``DataParallelSampler``).
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import math
import re
import socket
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the bytes of one all_reduce bucket
BUCKET_BYTES = 256 * 2**20
# the mesh's axes, in the order of its dimensions
AXES = ("data", "fsdp")
# parameters below this many elements stay whole (the JAX rule's default)
FSDP_MIN_SIZE = 2**16


def mesh_shape(spec: Optional[str], world_size: int) -> Tuple[int, int]:
    """(D, F) of a ``--mesh-shape`` spec over ``world_size`` processes, as
    ``create_mesh`` of the JAX package reads it: comma-separated
    ``axis:size``, one size may be left out (inferred), and the product must
    be the number of processes. No spec: every process on ``data``. An axis
    other than ``data`` and ``fsdp`` raises ``ValueError``."""
    if not spec:
        return world_size, 1
    sizes = {}
    for part in spec.split(","):
        name, _, size = part.partition(":")
        name = name.strip()
        if name not in AXES:
            raise ValueError(f"--mesh-shape {spec!r}: unknown axis {name!r} (the port's mesh "
                             f"has the axes {AXES})")
        if name in sizes:
            raise ValueError(f"--mesh-shape {spec!r}: axis {name!r} given twice")
        sizes[name] = int(size) if size.strip() else -1
    if sum(v <= 0 for v in sizes.values()) > 1:
        raise ValueError(f"--mesh-shape {spec!r}: at most one size may be inferred")
    known = math.prod(v for v in sizes.values() if v > 0)
    sizes = {k: v if v > 0 else world_size // known for k, v in sizes.items()}
    d, f = sizes.get("data", 1), sizes.get("fsdp", 1)
    if d * f != world_size or d < 1 or f < 1:
        raise ValueError(f"--mesh-shape {spec!r}: data x fsdp = {d} x {f} must be the "
                         f"{world_size} processes")
    return d, f


def uses_fsdp(spec: Optional[str]) -> bool:
    """Whether a ``--mesh-shape`` spec names the ``fsdp`` axis (``fsdp:1``
    too: the sharded route over one process)."""
    return bool(spec) and any(part.partition(":")[0].strip() == "fsdp"
                              for part in spec.split(","))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(shape: Tuple[int, int], device: torch.device):
    """The (data, fsdp) ``DeviceMesh`` of ``shape`` on ``device``'s type. A
    run of one process (an ``fsdp:1`` mesh) joins a process group of its own
    first (NCCL on CUDA, gloo on the CPU, over a free localhost port), so
    the sharded code and its collectives run there too."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(f"a {shape} mesh needs the process group of a "
                               f"{math.prod(shape)}-process launch")
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=600))
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=AXES)


# -- the JAX placement rule ---------------------------------------------------------

# dense layers that are 1x1 Conv2d in the torch 2-D attention block (Dense
# kernels (in, out) in JAX): ``utils/convert.py``'s rule, on torch names
_ATTN2D_DENSE = re.compile(r"(^|\.)attn\.\d+\.(qkv|proj_out|ffn\.1|ffn\.3)\.weight$")


def jax_axes(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The torch axes of a port parameter in the order of its JAX layout
    (``utils/convert.py``'s transposes undone): conv kernels OIHW <- HWIO
    (2, 3, 1, 0), 1-D conv kernels OIK <- KIO (2, 1, 0), dense kernels
    (out, in) <- (in, out) (1, 0), and the 2-D attention's dense layers,
    (out, in, 1, 1) in torch, (in, out) in JAX: (1, 0). Everything else
    (norm scales, biases) keeps its axes."""
    if not name.endswith(".weight") or len(shape) < 2:
        return tuple(range(len(shape)))
    if len(shape) == 4:
        return (1, 0) if _ATTN2D_DENSE.search(name) else (2, 3, 1, 0)
    if len(shape) == 3:
        return (2, 1, 0)
    return (1, 0)


def infer_param_sharding(named_shapes: Dict[str, Sequence[int]], fsdp_size: int,
                         min_size: int = FSDP_MIN_SIZE) -> Dict[str, Optional[int]]:
    """The JAX ``infer_param_sharding``: for each parameter (its shape in
    the JAX layout), the axis split over ``fsdp_size`` processes, or None
    (replicated): a parameter of at least ``min_size`` elements is split
    along its largest dimension that ``fsdp_size`` divides (ties to the
    lower axis); a smaller one, or one with no such dimension, stays
    whole."""
    out = {}
    for name, shape in named_shapes.items():
        out[name] = None
        if math.prod(shape) < min_size:
            continue
        for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
            if shape[d] % fsdp_size == 0:
                out[name] = d
                break
    return out


def torch_shard_dims(module: torch.nn.Module, fsdp_size: int,
                     min_size: int = FSDP_MIN_SIZE) -> Dict[str, Optional[int]]:
    """``infer_param_sharding`` on ``module``'s parameters in the JAX layout,
    mapped back to the torch axis each one splits (None: whole)."""
    axes = {n: jax_axes(n, p.shape) for n, p in module.named_parameters()}
    shapes = {n: tuple(p.shape[a] for a in axes[n]) for n, p in module.named_parameters()}
    return {n: None if d is None else axes[n][d]
            for n, d in infer_param_sharding(shapes, fsdp_size, min_size).items()}


class FsdpLayout:
    """The placement of a module that ``shard_module`` sharded: its mesh,
    the torch axis of each sharded parameter (``dims``), and the
    conversions between a process's shards and full tensors."""

    def __init__(self, mesh, dims: Dict[str, int]):
        self.mesh = mesh
        self.dims = dims
        self.fsdp_group = mesh.get_group("fsdp")
        self.fsdp_size = mesh["fsdp"].size()
        self.fsdp_rank = mesh["fsdp"].get_local_rank()

    @staticmethod
    def local(t: torch.Tensor) -> torch.Tensor:
        """A ``DTensor``'s local shard (the storage FSDP gathers from), or
        ``t`` itself."""
        from torch.distributed.tensor import DTensor

        return t._local_tensor if isinstance(t, DTensor) else t

    @staticmethod
    def full(t: torch.Tensor) -> torch.Tensor:
        """The full tensor of a parameter (a collective over ``fsdp`` when
        it is sharded)."""
        from torch.distributed.tensor import DTensor

        t = t.detach()
        return t.full_tensor() if isinstance(t, DTensor) else t

    def full_local(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor of which ``local`` is this process's shard of
        parameter ``name`` (its EMA, an Adam moment; a collective)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if name not in self.dims:
            return local
        return DTensor.from_local(local, self.mesh, (Replicate(), Shard(self.dims[name])),
                                  run_check=False).full_tensor()

    def shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This process's shard of the full tensor ``full`` of parameter
        ``name``."""
        if name not in self.dims:
            return full
        return full.chunk(self.fsdp_size, dim=self.dims[name])[self.fsdp_rank]

    def grad_norm(self, names: Sequence[str], grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global 2-norm of the gradients whose local parts are
        ``grads``: the shards' squares summed over ``fsdp`` (equal over
        ``data``), the whole gradients' counted once."""
        sharded = [g for n, g in zip(names, grads) if n in self.dims]
        whole = [g for n, g in zip(names, grads) if n not in self.dims]
        dev = grads[0].device

        def sq(ts):
            if not ts:
                return torch.zeros((), device=dev)
            return torch.stack(torch._foreach_norm(ts)).float().square().sum()

        s = sq(sharded)
        dist.all_reduce(s, group=self.fsdp_group)
        return torch.sqrt(s + sq(whole))


def shard_module(module: torch.nn.Module, mesh,
                 min_size: Optional[int] = None) -> FsdpLayout:
    """Shard ``module`` over ``mesh``'s ``fsdp`` axis with FSDP2: every
    ``ResNetBlockStage`` (the U-Net's stages, those of inner U-Nets too) is
    a unit of its own, the top module takes the rest. A parameter that the
    JAX rule splits (``torch_shard_dims``) becomes a ``DTensor`` sharded
    along that axis; the others are ``ignored_params``, whole. Parameters
    stay f32 (the modules cast to their compute dtype at use). ``min_size``
    None is ``FSDP_MIN_SIZE`` (2**16, the JAX rule's default), read at the
    call. Returns the layout."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ml_mdm_tpu_torch.models.layers import ResNetBlockStage

    if min_size is None:
        min_size = FSDP_MIN_SIZE
    dims = {n: d for n, d in torch_shard_dims(module, mesh["fsdp"].size(), min_size).items()
            if d is not None}
    by_param = {p: Shard(dims[n]) for n, p in module.named_parameters() if n in dims}
    ignored = {p for n, p in module.named_parameters() if n not in dims}
    kw = dict(mesh=mesh, shard_placement_fn=by_param.get, ignored_params=ignored)
    for m in [m for m in module.modules() if isinstance(m, ResNetBlockStage)]:
        fully_shard(m, **kw)
    fully_shard(module, **kw)
    return FsdpLayout(mesh, dims)


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


# -- the one-process data-parallel sampler ------------------------------------------


def _rows(t, lo: int, hi: int, batch: int):
    """Rows [lo, hi) of a tensor of ``batch`` rows, or of both halves of
    one of 2 ``batch`` rows (classifier-free guidance's unconditional rows
    then its conditional ones, kept paired with their samples); anything
    else as it is."""
    if not torch.is_tensor(t) or t.dim() == 0:
        return t
    if t.shape[0] == batch:
        return t[lo:hi]
    if t.shape[0] == 2 * batch:
        return torch.cat([t[lo:hi], t[batch + lo:batch + hi]])
    return t


def _to(t, device):
    if isinstance(t, (list, tuple)):
        return type(t)(_to(v, device) for v in t)
    return t.to(device) if torch.is_tensor(t) else t


class DataParallelSampler:
    """``run(sample, generator)``: ``pipeline.sample`` of ``batch`` images
    with the rows split over ``devices``, one replica of the vision module
    on each (the first device's is the pipeline's own module when it lives
    there). The initial noise is drawn in full on the first device from
    ``generator``, as ``pipeline.sample`` draws it; the step noise of a step
    that adds some (eta not 0) comes from generators seeded by one draw
    after it and by (step, level), in full, so neither depends on the
    split. Replica k takes rows [k B / n, (k + 1) B / n) of the noise and of
    the conditioning (of both halves of its 2 B guided rows), runs the
    whole loop in a thread of its own, and the images are concatenated in
    order on the first device. The sampler has no reduction across rows, so
    the same noise gives the same images as one device. The replicas' weights
    are copied once, and again when the pipeline's parameters change
    (storage or version counter)."""

    def __init__(self, pipeline, batch: int, image_side: int,
                 devices: Optional[Sequence] = None, **kwargs):
        devices = [_indexed(torch.device(d)) for d in (devices or _all_devices(pipeline))]
        if batch % len(devices):
            raise ValueError(f"data-parallel sampler: batch {batch} does not split over "
                             f"{len(devices)} devices")
        self.pipeline, self.batch, self.side, self.kwargs = pipeline, batch, image_side, kwargs
        self.devices = devices
        self._replicas: List = []
        self._key = None

    @torch.no_grad()
    def _sync(self):
        src = self.pipeline.vision_module
        key = tuple((p.data_ptr(), p._version) for p in src.parameters())
        if self._replicas and key == self._key:
            return
        own = next(src.parameters()).device
        if not self._replicas:
            for i, dev in enumerate(self.devices):
                if i == 0 and dev == own:
                    self._replicas.append(self.pipeline)
                    continue
                module = copy.deepcopy(src).to(dev)
                for m in module.modules():  # sampling weights built from the source's
                    m.__dict__.pop("_weights_cache", None)
                self._replicas.append(type(self.pipeline)(module, self.pipeline.config))
        else:
            for pipe in self._replicas:
                if pipe is self.pipeline:
                    continue
                for dst, p in zip(pipe.vision_module.parameters(), src.parameters()):
                    dst.copy_(p)
                for dst, b in zip(pipe.vision_module.buffers(), src.buffers()):
                    dst.copy_(b)
        self._key = key

    @torch.no_grad()
    def __call__(self, sample, generator: Optional[torch.Generator] = None):
        self._sync()
        first = self._replicas[0]
        noise = first.get_noise(self.batch, self.side, generator)
        kwargs = dict(self.kwargs)
        full_step_noise = kwargs.pop("step_noise", None)
        if full_step_noise is None:
            base = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device if generator is not None
                                     else "cpu"))
            dev0 = self.devices[0]
            shapes = [tuple(t.shape) for t in (noise if isinstance(noise, list) else [noise])]

            def full_step_noise(i, level, x):
                g = torch.Generator(device=dev0).manual_seed(base + 64 * i + level)
                return torch.randn(shapes[level], generator=g, device=dev0, dtype=x.dtype)
        n = len(self.devices)
        per = self.batch // n
        outs: List = [None] * n
        errors: List = []
        # a new thread starts with the default intra-op thread count: give it
        # the caller's, so that a CPU replica computes as the caller would
        threads_now = torch.get_num_threads()

        def work(k):
            try:
                if torch.get_num_threads() != threads_now:
                    torch.set_num_threads(threads_now)
                dev, pipe = self.devices[k], self._replicas[k]
                lo, hi = k * per, (k + 1) * per
                rows = {key: _to(_rows(v, lo, hi, self.batch), dev) for key, v in sample.items()}
                x_t = _to([t[lo:hi] for t in noise] if isinstance(noise, list)
                          else noise[lo:hi], dev)

                def step_noise(i, level, x):
                    return full_step_noise(i, level, x)[lo:hi].to(x.device)

                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    outs[k] = pipe.sample(per, rows, self.side, None, noise=x_t,
                                          step_noise=step_noise, **kwargs)
            except BaseException as e:  # re-raised in the caller's thread
                errors.append(e)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(1, n)]
        for t in threads:
            t.start()
        work(0)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return torch.cat([o.to(self.devices[0]) for o in outs])


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, so that devices compare."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _all_devices(pipeline) -> List[torch.device]:
    own = next(pipeline.vision_module.parameters()).device
    if own.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [own]


def make_data_parallel_sampler(pipeline, batch: int, image_side: int,
                               devices: Optional[Sequence] = None, **kwargs):
    """Returns ``run(sample, generator) -> images``: ``pipeline.sample`` of
    ``batch`` images with the rows split over ``devices`` (default: every
    card, when the module lives on one), one replica of the vision module
    on each (``DataParallelSampler``). ``kwargs`` go to ``pipeline.sample``
    (guidance_scale, num_inference_steps, ddim_eta, ...). ``sample``'s rows
    may be 2 ``batch`` for classifier-free guidance."""
    return DataParallelSampler(pipeline, batch, image_side, devices, **kwargs)


def sample_data_parallel(pipeline, batch: int, sample, image_side: int,
                         generator: Optional[torch.Generator] = None,
                         devices: Optional[Sequence] = None, **kwargs):
    """One call of ``make_data_parallel_sampler``'s runner."""
    return make_data_parallel_sampler(pipeline, batch, image_side, devices, **kwargs)(
        sample, generator)
