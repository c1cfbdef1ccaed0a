"""The port's FSDP route (``--mesh-shape data:D,fsdp:F``) on the CPU, gloo
processes running ``clis/train_parallel.py`` (tests/torch_fsdp_child.py):

- the placement: ``parallel.mesh.infer_param_sharding`` and
  ``torch_shard_dims`` against the JAX ``infer_param_sharding`` on the tiny
  U-Net, at F = 2 and ``min_size`` 2**16 and 2**10: the same parameters
  sharded, along the same logical axis (the JAX layout's);
- four processes on ``data:2,fsdp:2`` for 2 steps: the per-step losses
  equal a one-process run of the same global batches (the four reader
  partitions' rows, each with the noise its process drew) within 1e-6
  relative, as the data-parallel run's do (tests/test_torch_distributed.py);
  the gathered state is identical on every process; each holds half of
  each sharded parameter; the ``.pth`` loads strict into a one-process
  module, and a one-process data-parallel run resumes the train state
  bitwise;
- ``fsdp:2`` alone resumes a one-process data-parallel save and steps on
  as a one-process replay of its two partitions does; ``data:2,fsdp:1``
  (FSDP over one process a shard) steps as the replay does;
- one sharded step (four processes, ``data:2,fsdp:2``, ``min_size`` 2**10,
  explicit noise) against the JAX step on a four-device CPU mesh with the
  placement ``dryrun_multichip`` builds: loss and gradient norm within
  1e-5 relative, the updated parameters within the trainer parity's
  tolerances (tests/test_torch_trainer.py).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu import trainer as jtrainer
from ml_mdm_tpu.parallel import batch_sharding, create_mesh, replicated
from ml_mdm_tpu.parallel import infer_param_sharding as jax_infer_param_sharding
from ml_mdm_tpu_torch import reader, trainer
from ml_mdm_tpu_torch.clis import train_parallel
from ml_mdm_tpu_torch.clis.train_parallel import _device_batch, load_batch, step_seed
from ml_mdm_tpu_torch.config import get_arguments, get_model, get_pipeline
from ml_mdm_tpu_torch.language_models import factory
from ml_mdm_tpu_torch.parallel import infer_param_sharding, mesh_shape
from ml_mdm_tpu_torch.parallel.mesh import jax_axes, torch_shard_dims, uses_fsdp
from ml_mdm_tpu_torch.presets import build_unet
from ml_mdm_tpu_torch.utils import checkpoint as ckpt
from ml_mdm_tpu_torch.utils.convert import _flatten, _torch_name, params_from_jax
from torch_parity import LM_LEN, jax_flat_noise, tiny_pair, to_np

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
YAML = os.path.join(HERE, "test_files", "tiny_train.yaml")
INDEX = os.path.join(HERE, "test_files", "sample_training_0.tsv")
VOCAB = os.path.join(HERE, "test_files", "tiny_t5.vocab")
MIN_SIZE = 2**10  # the children's (tests/torch_fsdp_child.py)
BATCH = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli(*extra):
    return ["--config_path", YAML, "--file-list", INDEX, "--vocab_file", VOCAB,
            "--batch-size", str(BATCH), "--device", "cpu", "--reader_config.num_readers", "1",
            *extra]


def _launch(world: int, argv):
    """Start ``world`` gloo processes of tests/torch_fsdp_child.py."""
    port = str(_free_port())
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_fsdp_child.py"), *argv],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                 MASTER_ADDR="localhost", MASTER_PORT=port, OMP_NUM_THREADS="1",
                 PYTHONPATH=REPO),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs, what):
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} rank {rank} failed:\n{log[-4000:]}"
    return logs


def _records(out, world):
    recs = []
    for rank in range(world):
        with open(os.path.join(out, f"record_{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A one-process data-parallel save (2 steps), then three gloo runs at
    once: ``data:2,fsdp:2`` (4 processes, 2 steps, saved at 2), ``fsdp:2``
    resuming the data-parallel save for one step, ``data:2,fsdp:1``."""
    root = tmp_path_factory.mktemp("fsdp")
    dp = root / "dp"
    train_parallel.main(get_arguments(_cli("--output-dir", str(dp), "--save-freq", "2",
                                           "--num-training-steps", "2"), mode="trainer"))
    specs = {
        "data:2,fsdp:2": (4, ["--num-training-steps", "2", "--save-freq", "2"]),
        "fsdp:2": (2, ["--num-training-steps", "3", "--save-freq", "10",
                       "--resume-from-train-state", str(dp / "train_state_000002")]),
        "data:2,fsdp:1": (2, ["--num-training-steps", "2", "--save-freq", "10"]),
    }
    procs, outs = {}, {}
    for spec, (world, extra) in specs.items():
        out = root / spec.replace(":", "").replace(",", "_")
        out.mkdir()
        outs[spec] = out
        procs[spec] = _launch(world, ["cli", str(out), *_cli(
            "--output-dir", str(out), "--multinode", "1", "--mesh-shape", spec, *extra)])
    result = {"dp": dp}
    for spec, (world, _) in specs.items():
        logs = _wait(procs[spec], spec)
        result[spec] = (outs[spec], logs, _records(outs[spec], world))
    return result


def _replay(n_parts: int, steps, start=None):
    """One process training on the global batches of ``n_parts`` reader
    partitions (partition p's rows with the noise process p draws at each
    step), from the CLI's init or the train state ``start``; the losses of
    ``steps`` (step numbers, from 0)."""
    args = get_arguments(_cli(), mode="trainer")
    args.reader_config.pad_to_max_length = True  # as main() forces for several processes
    tok, lm = factory.create_lm(args, "cpu", seed=args.seed)
    args.unet_config.conditioning_feature_dim = lm.embed_dim
    unet = build_unet(get_model(args.model), args.unet_config, "cpu", args.seed,
                      dtype=torch.float32).train()
    pipe = get_pipeline(args.model)(unet, args.diffusion_config)
    tcfg = trainer.TrainerConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                                 gradient_clip_norm=args.gradient_clip_norm,
                                 use_adamw=args.use_adamw, loss_factor=args.loss_factor)
    state = trainer.TrainState.create(unet, tcfg)
    if start is not None:
        ckpt.load_train_state(start, state)
    step = trainer.make_train_step(pipe, tcfg)
    loaders = [reader.get_dataset_partition(p, n_parts, tok, BATCH, INDEX, args.reader_config,
                                            args.num_epochs, is_index_file=True)
               for p in range(n_parts)]
    iters = [iter(ld) for ld in loaders]
    losses = []
    try:
        for i in steps:
            parts = [_device_batch(load_batch(next(it), lm, tok), pipe, "cpu") for it in iters]
            times, eps = [], []
            for rank, part in enumerate(parts):
                g = torch.Generator().manual_seed(step_seed(args.seed, rank, i))
                times.append(torch.randint(0, pipe.sampler.n_steps, (BATCH,), generator=g))
                eps.append(torch.randn(part["images"].shape, generator=g))
            batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            state, m = step(state, batch, noise={"time": torch.cat(times), "eps": torch.cat(eps)})
            losses.append(m["loss"])
    finally:
        for ld in loaders:
            ld.close()
    return losses


def _jax_axes_of(sharding_tree) -> dict:
    """{torch name: the JAX axis split over "fsdp", or None} of a tree of
    ``NamedSharding``."""
    out = {}
    for path, sh in _flatten(sharding_tree).items():
        leaf = path[-1]
        name = "weight" if leaf in ("kernel", "scale") else leaf
        spec = tuple(sh.spec)
        out[".".join(_torch_name(path[:-1]) + [name])] = (
            spec.index("fsdp") if "fsdp" in spec else None)
    return out


@pytest.mark.parametrize("min_size", [2**16, 2**10])
def test_placement_matches_jax(min_size):
    jpipe, params, pipe, _, _ = tiny_pair(seed=1, fast_init=True)
    mesh = create_mesh("data:2,fsdp:2", devices=jax.devices()[:4])
    ref = _jax_axes_of(jax_infer_param_sharding(params, mesh, min_size=min_size))
    shapes = {".".join(_torch_name(p[:-1]) + ["weight" if p[-1] in ("kernel", "scale")
                                               else p[-1]]): np.shape(v)
              for p, v in _flatten(params).items()}
    assert infer_param_sharding(shapes, 2, min_size) == ref
    unet = pipe.vision_module
    want = {n: None if ref[n] is None else jax_axes(n, p.shape)[ref[n]]
            for n, p in unet.named_parameters()}
    assert torch_shard_dims(unet, 2, min_size) == want
    # at 2**16 only the largest few (the 96-channel convs), at 2**10 most
    n_sharded = sum(d is not None for d in want.values())
    assert 0 < n_sharded <= 20 if min_size == 2**16 else n_sharded >= 60


def test_mesh_shape_specs():
    assert mesh_shape(None, 4) == (4, 1) and mesh_shape("data:4", 4) == (4, 1)
    assert mesh_shape("data:2,fsdp:2", 4) == (2, 2) and mesh_shape("fsdp:2", 2) == (1, 2)
    assert mesh_shape("data,fsdp:2", 8) == (4, 2) and mesh_shape("data:1,fsdp", 4) == (1, 4)
    assert uses_fsdp("data:1,fsdp:1") and not uses_fsdp("data:2") and not uses_fsdp(None)
    for spec, world in (("data:3,fsdp:2", 4), ("data,fsdp", 4), ("data:2,data:2", 4),
                        ("data:2,model:2", 4)):
        with pytest.raises(ValueError):
            mesh_shape(spec, world)


def test_fsdp_losses_match_one_process(runs):
    _, _, recs = runs["data:2,fsdp:2"]
    assert [r["step"] for r in recs] == [2] * 4
    losses = [loss for _, loss, _ in recs[0]["history"]]
    np.testing.assert_allclose(losses, _replay(4, range(2)), rtol=1e-6)
    for r in recs[1:]:  # every process logs the same (averaged) loss and norm
        assert r["history"] == recs[0]["history"]


def test_gathered_state_identical_on_every_process(runs):
    for spec in ("data:2,fsdp:2", "fsdp:2", "data:2,fsdp:1"):
        _, _, recs = runs[spec]
        assert len({r["sha256"] for r in recs}) == 1, spec


def test_each_process_holds_its_share(runs):
    _, _, recs = runs["data:2,fsdp:2"]
    module = build_unet(*_tiny_module_args())
    want = {n: d for n, d in torch_shard_dims(module, 2, MIN_SIZE).items() if d is not None}
    for r in recs:
        assert r["dims"] == want
        assert r["shards"].keys() == want.keys()
        assert all(2 * local == full for local, full in r["shards"].values())
    sharded = sum(full for _, full in recs[0]["shards"].values())
    total = sum(p.numel() for p in module.parameters())
    assert sharded > 0.9 * total


def _tiny_module_args():
    args = get_arguments(_cli(), mode="trainer")
    _, lm = factory.create_lm(args, "cpu", seed=args.seed)
    args.unet_config.conditioning_feature_dim = lm.embed_dim
    return get_model(args.model), args.unet_config, "cpu", args.seed, torch.float32


def test_fsdp_checkpoint_loads_strict_and_resumes_data_parallel(runs, tmp_path):
    out, logs, _ = runs["data:2,fsdp:2"]
    assert "Saving model" in logs[0] and not any("Saving model" in log for log in logs[1:])
    module = build_unet(*_tiny_module_args())
    for name in ("vis_model_000002.pth", "vis_model_noema_000002.pth"):
        sd = torch.load(out / name, weights_only=False)["state_dict"]
        module.load_state_dict(sd, strict=True)
    final = torch.load(out / "final_state.pt")
    # the .pth holds the parameters and the EMA that the processes held
    sd = torch.load(out / "vis_model_noema_000002.pth", weights_only=False)["state_dict"]
    ema = torch.load(out / "vis_model_000002.pth", weights_only=False)["state_dict"]
    for k, v in sd.items():
        assert torch.equal(v, final["tensors"][f"param {k}"]), k
        assert torch.equal(ema[k], final["tensors"][f"ema {k}"]), k
    # a one-process data-parallel run resumes the FSDP train state bitwise
    # (no step left to take)
    state = train_parallel.main(get_arguments(_cli(
        "--output-dir", str(tmp_path), "--num-training-steps", "2",
        "--resume-from-train-state", str(out / "train_state_000002")), mode="trainer"))
    assert state.step == final["step"] == 2
    got = {f"param {k}": p.detach() for k, p in state.params.items()}
    got.update({f"ema {k}": v for k, v in state.ema_params.items()})
    for k, p in state.params.items():
        for key, v in state.optimizer.state[p].items():
            got[f"{key} {k}"] = torch.as_tensor(v)
    assert got.keys() == final["tensors"].keys()
    for k, v in final["tensors"].items():
        assert torch.equal(got[k], v), k


def test_fsdp_resumes_a_data_parallel_save(runs):
    _, _, recs = runs["fsdp:2"]
    assert [r["step"] for r in recs] == [3, 3]
    (num, loss, _), = recs[0]["history"]
    assert num == 3
    np.testing.assert_allclose(
        [loss], _replay(2, [2], start=str(runs["dp"] / "train_state_000002")), rtol=1e-6)


def test_fsdp_of_one_process_a_shard(runs):
    _, _, recs = runs["data:2,fsdp:1"]
    assert all(all(local == full for local, full in r["shards"].values()) for r in recs)
    losses = [loss for _, loss, _ in recs[0]["history"]]
    np.testing.assert_allclose(losses, _replay(2, range(2)), rtol=1e-6)


def test_sharded_step_matches_jax(tmp_path):
    """One step of the tiny flagship-structured U-Net on a data:2,fsdp:2
    mesh: JAX (four CPU devices, ``infer_param_sharding(min_size=2**10)``
    as ``dryrun_multichip`` places the state) against the port's FSDP
    (four gloo processes, the same noise)."""
    jpipe, params, pipe, lm_dim, side = tiny_pair(seed=2, fast_init=True)
    rng = np.random.default_rng(3)
    b = 8
    batch = {"images": np.clip(rng.standard_normal((b, side, side, 3)) * 0.5, -1, 1
                               ).astype(np.float32),
             "lm_outputs": rng.standard_normal((b, LM_LEN, lm_dim)).astype(np.float32),
             "lm_mask": np.ones((b, LM_LEN), np.float32)}
    batch["lm_mask"][1, 5:] = 0
    key = jax.random.PRNGKey(4)
    ckpt.save_vision_model(str(tmp_path / "init.pth"), params_from_jax(params))
    noise = jax_flat_noise(jpipe, key, batch["images"])
    torch.save({"batch": {k: torch.from_numpy(v) for k, v in batch.items()}, "noise": noise},
               tmp_path / "batch.pt")
    procs = _launch(4, ["step", str(tmp_path)])

    mesh = create_mesh("data:2,fsdp:2", devices=jax.devices()[:4])
    tcfg = jtrainer.TrainerConfig(lr=1e-4, warmup_steps=10)
    optimizer, _ = jtrainer.make_optimizer(tcfg)
    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), optimizer)
    psharding = jax_infer_param_sharding(params, mesh, min_size=2**10)
    state = state.replace(params=jax.device_put(state.params, psharding),
                          ema_params=jax.device_put(state.ema_params, psharding),
                          opt_state=jax.device_put(state.opt_state, replicated(mesh)),
                          step=jax.device_put(state.step, replicated(mesh)))
    jbatch = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh)) for k, v in batch.items()}
    with mesh:
        new, metrics = jax.jit(jtrainer.make_train_step(jpipe, optimizer, tcfg))(
            state, jbatch, key)
    ref = {k: v.numpy() for k, v in params_from_jax(jax.device_get(new.params)).items()}
    start = {k: v.numpy() for k, v in params_from_jax(params).items()}

    _wait(procs, "sharded step")
    got = torch.load(tmp_path / "step.pt")
    assert got["dims"] == {n: d for n, d in torch_shard_dims(pipe.vision_module, 2, 2**10).items()
                           if d is not None}
    m = got["metrics"]
    assert m["skipped"] == 0
    assert abs(m["loss"] - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert abs(m["grad_norm"] - float(metrics["grad_norm"])) <= 1e-5 * float(metrics["grad_norm"])
    # Adam's first step moves each element by lr times about the sign of
    # its gradient (lr 1e-5 in warmup): each element within 1e-2 of the
    # tensor's largest move plus 4 f32 ULPs of itself, but those whose
    # gradient is 0 up to rounding, whose sign may flip (held to twice the
    # move, and to 1e-3 of the elements)
    moved, loose, total = 0, 0, 0
    for k, r in ref.items():
        diff = np.abs(to_np(got["params"][k]) - r)
        top = np.abs(r - start[k]).max()
        tight = diff <= 1e-2 * top + 4 * np.spacing(np.abs(r))
        assert (diff <= 2.01 * top + 4 * np.spacing(np.abs(r))).all(), k
        loose += int((~tight).sum())
        total += r.size
        moved += top > 0
    assert loose <= 1e-3 * total
    assert moved >= 0.9 * len(ref)


def test_remat_and_frozen_parameters_on_shards():
    """FSDP over a one-process gloo mesh (every parameter of 2**10 elements
    and up a ``DTensor``), the tiny nested model in f32: the loss and the
    shards' gradients with every stage recomputed in the backward (remat,
    save side 0; FSDP gathers the stage's parameters again for the
    recompute) equal those without; then a step with the inner U-Net
    frozen (``freeze_mask``): its shards keep their values and take no
    moments, the shell's move."""
    import torch.distributed as dist

    from ml_mdm_tpu_torch import parallel
    from ml_mdm_tpu_torch.presets import nested_preset

    pipe, lm_dim, side = nested_preset("cc12m_256x256", "cpu", seed=3, scaled=True)
    unet = pipe.vision_module.float().train()
    g = torch.Generator().manual_seed(5)
    batch = {"images": torch.rand((2, side, side, 3), generator=g) * 2 - 1,
             "lm_outputs": torch.randn((2, 8, lm_dim), generator=g),
             "lm_mask": torch.ones((2, 8))}
    try:
        layout = parallel.shard_module(unet, parallel.make_mesh((1, 1), "cpu"), min_size=2**10)
        assert len(layout.dims) >= 20
        runs = []
        for remat in (None, 0):
            trainer.set_remat(unet, remat)
            unet.zero_grad(set_to_none=True)
            loss = pipe.get_loss(batch, torch.Generator().manual_seed(6))[0].mean()
            loss.backward()
            runs.append((float(loss), {k: layout.local(p.grad).clone()
                                       for k, p in unet.named_parameters() if p.grad is not None}))
        trainer.set_remat(unet, None)
        (l0, g0), (l1, g1) = runs
        assert l0 == l1 and g0.keys() == g1.keys() and len(g0) > 100
        for k in g0:
            torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9)
        freeze = {k: "freeze" if "inner_unet" in k.split(".") else "train"
                  for k, _ in unet.named_parameters()}
        cfg = trainer.TrainerConfig(lr=1e-3, warmup_steps=1)
        state = trainer.TrainState.create(unet, cfg, freeze, layout)
        local = state.local_params()
        before = {k: t.detach().clone() for k, t in local.items()}
        step = trainer.make_train_step(pipe, cfg)
        for i in range(2):
            state, m = step(state, batch, torch.Generator().manual_seed(7 + i))
            assert m["skipped"] == 0
        frozen = [k for k in local if freeze[k] == "freeze"]
        assert frozen and any(k in layout.dims for k in frozen)
        for k in frozen:
            assert torch.equal(local[k], before[k]), k
            assert local[k] not in state.optimizer.state
        assert any(not torch.equal(local[k], before[k]) for k in local if freeze[k] == "train")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
