"""One process of tests/test_torch_fsdp.py: a rank of a gloo run of the
port's FSDP route on the CPU.

    python tests/torch_fsdp_child.py cli <outdir> <argv of train_parallel...>
    python tests/torch_fsdp_child.py step <workdir>

The parent sets torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT). Parameters of 2**10 elements and up are
sharded, as ``dryrun_multichip`` places the JAX state: at the JAX rule's
default of 2**16 the tiny U-Net would shard few.

``cli``: ``clis/train_parallel.main`` with the given arguments; the child
records each step's (loss, norm), the gathered parameters' digest and,
for every sharded parameter, its local and full element counts, in
``<outdir>/record_<rank>.json``; rank 0 also writes the gathered state it
returned to ``<outdir>/final_state.pt``.

``step``: one train step of the tiny flagship-structured U-Net over a
``data:2,fsdp:2`` mesh from the weights in ``<workdir>/init.pth``, on this
process's rows of the batch and noise in ``<workdir>/batch.pt``
(``trainer.make_train_step`` with ``all_reduce_mean``); rank 0 writes the
loss, the norm and the gathered parameters to ``<workdir>/step.pt``.
"""
import hashlib
import json
import logging
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from ml_mdm_tpu_torch import parallel, trainer  # noqa: E402
from ml_mdm_tpu_torch.clis import train_parallel  # noqa: E402
from ml_mdm_tpu_torch.config import get_arguments  # noqa: E402
from ml_mdm_tpu_torch.distributed import init_distributed_singlenode  # noqa: E402
from ml_mdm_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

torch.set_num_threads(1)
logging.basicConfig(level=logging.INFO)
parallel.mesh.FSDP_MIN_SIZE = 2**10

STEP_CFG = dict(lr=1e-4, warmup_steps=10)


def gathered(state):
    """The state's parameters, EMA and Adam moments, whole (a collective)."""
    layout = state.layout
    out = {f"param {k}": layout.full(p) for k, p in state.params.items()}
    out.update({f"ema {k}": v for k, v in ckpt.ema_state_dict(state).items()})
    names = ckpt.optimizer_names(state)
    for i, t in enumerate(p for g in state.optimizer.param_groups for p in g["params"]):
        for key, v in state.optimizer.state.get(t, {}).items():
            if torch.is_tensor(v) and v.dim() > 0:
                out[f"{key} {names[i]}"] = layout.full_local(names[i], v)
            else:
                out[f"{key} {names[i]}"] = torch.as_tensor(v)
    return out


def run_cli(outdir, argv):
    rank = int(os.environ["RANK"])
    history = []
    state = train_parallel.main(get_arguments(argv, mode="trainer"), history)
    full = gathered(state)
    h = hashlib.sha256()
    for k in sorted(full):
        h.update(k.encode() + full[k].detach().float().numpy().tobytes())
    layout = state.layout
    shards = {k: [layout.local(p).numel(), p.numel()] for k, p in state.params.items()
              if k in layout.dims}
    record = {"rank": rank, "history": [list(e[:3]) for e in history], "step": state.step,
              "sha256": h.hexdigest(), "shards": shards, "dims": layout.dims}
    if rank == 0:
        torch.save({"step": state.step, "tensors": {k: v.detach() for k, v in full.items()}},
                   os.path.join(outdir, "final_state.pt"))
    with open(os.path.join(outdir, f"record_{rank}.json"), "w") as f:
        json.dump(record, f)


def run_step(workdir):
    from ml_mdm_tpu_torch.diffusion import Diffusion
    from ml_mdm_tpu_torch.models.unet import UNet
    from ml_mdm_tpu_torch.presets import flagship_configs

    _, rank, world = init_distributed_singlenode()
    ucfg, dcfg, _, _ = flagship_configs(scaled=True)
    unet = UNet(3, 3, ucfg)
    ckpt.load_vision_model(os.path.join(workdir, "init.pth"), unet)
    unet.train()
    layout = parallel.shard_module(unet, parallel.make_mesh((2, 2), "cpu"))
    pipe = Diffusion(unet, dcfg)
    cfg = trainer.TrainerConfig(**STEP_CFG)
    state = trainer.TrainState.create(unet, cfg, layout=layout)
    step = trainer.make_train_step(pipe, cfg, parallel.all_reduce_mean)
    data = torch.load(os.path.join(workdir, "batch.pt"))
    rows = data["batch"]["images"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    state, m = step(state, {k: v[part] for k, v in data["batch"].items()},
                    noise={k: v[part] for k, v in data["noise"].items()})
    params = {k: layout.full(p) for k, p in state.params.items()}
    if rank == 0:
        torch.save({"metrics": m, "params": params, "dims": layout.dims},
                   os.path.join(workdir, "step.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        run_cli(sys.argv[2], sys.argv[3:])
    else:
        run_step(sys.argv[2])
    print(f"torch_fsdp_child rank {os.environ['RANK']} done", flush=True)
