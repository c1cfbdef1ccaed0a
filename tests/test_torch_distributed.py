"""The port's data parallelism: two gloo processes on the CPU run the
training CLI (``clis/train_parallel.py`` with torchrun's environment), as
tests/test_multiprocess.py runs the JAX one.

- each process reads its own reader partition (0 and 1 of 2), and the
  captions they consumed differ;
- only rank 0 writes the checkpoints;
- after the steps the parameters are bitwise identical on both processes
  (the averaged gradients are the same on each);
- the per-step losses equal a one-process run of the same global batches
  (partition 0's rows then partition 1's, each with the noise its process
  drew) within 1e-6 relative: the mean of two per-process means against one
  mean over the global batch, f32;
- ``all_reduce_mean`` averages over several buckets of two dtypes.
A world size of 1 initialises nothing.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ml_mdm_tpu_torch import distributed, reader, trainer
from ml_mdm_tpu_torch.clis.train_parallel import _device_batch, load_batch, step_seed
from ml_mdm_tpu_torch.config import get_arguments, get_model, get_pipeline
from ml_mdm_tpu_torch.language_models import factory
from ml_mdm_tpu_torch.presets import build_unet

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
YAML = os.path.join(HERE, "test_files", "tiny_train.yaml")
INDEX = os.path.join(HERE, "test_files", "sample_training_0.tsv")
VOCAB = os.path.join(HERE, "test_files", "tiny_t5.vocab")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_out")
    port = str(_free_port())
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for rank in range(2):
        env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mp_child.py"), str(out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    records = []
    for rank in range(2):
        with open(out / f"record_{rank}.json") as f:
            records.append(json.load(f))
    return out, logs, records


def test_both_processes_took_the_steps(mp_run):
    _, logs, records = mp_run
    assert [r["final_step"] for r in records] == [2, 2]
    assert "gloo" in logs[0] and "process 1/2" in logs[1]


def test_reader_partitions_differ(mp_run):
    _, _, records = mp_run
    assert [(r["partition_num"], r["num_partitions"]) for r in records] == [(0, 2), (1, 2)]
    flat0 = [c for b in records[0]["digests"] for c in b]
    flat1 = [c for b in records[1]["digests"] for c in b]
    assert len(flat0) == len(flat1) == 8
    assert not set(flat0) & set(flat1)  # partitions of distinct rows


def test_only_rank0_saves(mp_run):
    out, logs, _ = mp_run
    files = set(os.listdir(out))
    assert {"vis_model_000001.pth", "vis_model_noema_000002.pth", "train_state_000002"} <= files
    assert "Saving model" in logs[0] and "Saving model" not in logs[1]


def test_parameters_identical_across_ranks(mp_run):
    _, _, records = mp_run
    assert records[0]["params_sha256"] == records[1]["params_sha256"]


def test_all_reduce_mean_buckets(mp_run):
    _, _, records = mp_run
    for r in records:
        a, b, c = r["reduced"]
        assert a == [1.5] * 7 and c == [1.5] * 3
        np.testing.assert_allclose(b, np.arange(40.0) * 1.5, rtol=0, atol=0)


def test_losses_match_one_process(mp_run):
    """The two processes' global batches and noise replayed in one process."""
    _, _, records = mp_run
    args = get_arguments(["--config_path", YAML, "--file-list", INDEX, "--vocab_file", VOCAB,
                          "--batch-size", "4", "--device", "cpu",
                          "--reader_config.num_readers", "1"], mode="trainer")
    args.reader_config.pad_to_max_length = True  # as main() forces for two processes
    tok, lm = factory.create_lm(args, "cpu", seed=args.seed)
    args.unet_config.conditioning_feature_dim = lm.embed_dim
    unet = build_unet(get_model(args.model), args.unet_config, "cpu", args.seed,
                      dtype=torch.float32).train()
    pipe = get_pipeline(args.model)(unet, args.diffusion_config)
    tcfg = trainer.TrainerConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                                 gradient_clip_norm=args.gradient_clip_norm)
    state = trainer.TrainState.create(unet, tcfg)
    step = trainer.make_train_step(pipe, tcfg)
    loaders = [reader.get_dataset_partition(p, 2, tok, 4, INDEX, args.reader_config,
                                            args.num_epochs, is_index_file=True)
               for p in range(2)]
    iters = [iter(ld) for ld in loaders]
    losses = []
    n_steps = pipe.sampler.n_steps
    try:
        for i in range(2):
            parts = [_device_batch(load_batch(next(it), lm, tok), pipe, "cpu") for it in iters]
            times, eps = [], []
            for rank, part in enumerate(parts):
                g = torch.Generator().manual_seed(step_seed(args.seed, rank, i))
                times.append(torch.randint(0, n_steps, (4,), generator=g))
                eps.append(torch.randn(part["images"].shape, generator=g))
            batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            state, m = step(state, batch, noise={"time": torch.cat(times), "eps": torch.cat(eps)})
            losses.append(m["loss"])
    finally:
        for ld in loaders:
            ld.close()
    np.testing.assert_allclose(records[0]["losses"], losses, rtol=1e-6)
    l2 = float(sum(float((p.detach() ** 2).sum()) for p in state.params.values()))
    np.testing.assert_allclose(records[0]["params_l2"], l2, rtol=1e-6)


def test_world_of_one_initialises_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed_singlenode() == (0, 0, 1)
    assert not torch.distributed.is_initialized()
    assert distributed.get_rank() == 0 and distributed.get_world_size() == 1
    distributed.barrier("nothing to wait for")
