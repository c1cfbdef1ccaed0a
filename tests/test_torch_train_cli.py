"""The port's training CLI (``clis/train_parallel.py``), its trainer options
and its checkpoints, on the CPU, against the JAX package where both compute
the same thing.

- Trainer options against optax over 5 steps of identical gradients (f32):
  ``adam_mu_dtype="bfloat16"`` against ``optax.adam(mu_dtype=bf16)`` (the
  JAX ``make_optimizer``): the bf16 first moment bitwise, the second moment
  and the parameters within 1e-6 relative (the f32 power in the bias
  corrections may round differently); Adam and ``use_adamw`` (AdamW, weight
  decay 0) against ``optax.adam`` and ``optax.adamw(weight_decay=0)``: the
  parameters within 2 f32 ULPs of their value plus 1e-5 of their move
  (torch orders the update's rounding otherwise), the moments within 1e-6;
  ``freeze_mask`` against ``optax.multi_transform`` with ``set_to_zero``:
  frozen parameters bitwise unchanged and without moments, the others as
  Adam's above, and the clip's norm counting the frozen
  gradients (the JAX step's norm, 1e-5 relative).
- ``load_batch`` against the JAX ``load_batch`` on the same reader batch:
  images, watermark scores and ``scale`` equal; ``lm_outputs`` within 1e-5
  of max|JAX| (the JAX tower's weights carried over), ``lm_mask`` equal.
- Mirrors of tests/test_train.py, test_precomputed_and_resume.py and
  test_warm_start.py on tests/test_files/tiny_train.yaml and
  tiny_nested_train.yaml: two steps, both ``.pth`` files and the train
  state written and reloaded; the ``.pth`` resume of ``batch_num``; the
  train-state resume: 2 + 2 steps equal 4 straight steps bitwise (the step's
  noise generator is seeded by (seed, rank, step), and on a dataset of
  exactly two batches, unshuffled, one reader, the restarted data of the
  resumed run are the straight run's steps 3 and 4; the port, as the JAX
  CLI, does not save the reader's position); ``--resume-from-ema``;
  ``select_resume_checkpoint``'s cases; the inner warm start (from a
  ``.pth``, and raising for a missing file, an Orbax directory or, without
  ``boto3``, s3);
  ``freeze_inner_unet`` through the CLI; ``--mesh-shape``; the
  ``python -m`` entry point.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ml_mdm_tpu import trainer as jtrainer
from ml_mdm_tpu_torch import trainer
from ml_mdm_tpu_torch.clis import train_parallel
from ml_mdm_tpu_torch.config import get_arguments
from ml_mdm_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
YAML = os.path.join(HERE, "test_files", "tiny_train.yaml")
NESTED_YAML = os.path.join(HERE, "test_files", "tiny_nested_train.yaml")
INDEX = os.path.join(HERE, "test_files", "sample_training_0.tsv")
IMG_TSV = os.path.join(HERE, "test_files", "images_00000.tsv")
VOCAB = os.path.join(HERE, "test_files", "tiny_t5.vocab")


def cli_args(*extra, yaml=YAML, index=INDEX):
    return get_arguments(["--config_path", yaml, "--file-list", index, "--vocab_file", VOCAB,
                          "--device", "cpu", *extra], mode="trainer")


def state_tensors(state):
    """Parameters, EMA, Adam moments and count of a port train state."""
    out = {f"p.{k}": p.detach().clone() for k, p in state.params.items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema_params.items()})
    for k, p in state.params.items():
        st = state.optimizer.state.get(p, {})
        for name in ("exp_avg", "exp_avg_sq", "step"):
            if name in st:
                out[f"{name}.{k}"] = st[name].clone()
    return out


def assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# -- trainer options against optax ------------------------------------------------


def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal((9,)).astype(np.float32) * 1e-3,
            "inner_unet.c": rng.standard_normal((3, 4)).astype(np.float32)}


def _grads(step, seed=1):
    rng = np.random.default_rng((seed, step))
    return {k: (rng.standard_normal(v.shape) * (0.1 + step)).astype(np.float32)
            for k, v in _toy_params().items()}


def _run_both(cfg_kw, freeze=None, steps=5):
    """5 optimizer steps on the same gradients through the JAX
    make_optimizer and the port's (learning rate from the schedule, as the
    train steps set it)."""
    jcfg, pcfg = jtrainer.TrainerConfig(**cfg_kw), trainer.TrainerConfig(**cfg_kw)
    jparams = {k: jnp.asarray(v) for k, v in _toy_params().items()}
    mask = None if freeze is None else {k: ("freeze" if k in freeze else "train") for k in jparams}
    jopt, _ = jtrainer.make_optimizer(jcfg, mask)
    jstate = jopt.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in _toy_params().items()}
    opt = trainer.make_optimizer(params, pcfg, mask)
    schedule = trainer.make_schedule(pcfg)
    for i in range(steps):
        g = _grads(i)
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(trainer.adam_count(opt))
        opt.step()
    return jparams, jstate, params, opt


def _adam_state(jstate):
    if isinstance(jstate, optax.MultiTransformState):
        jstate = jstate.inner_states["train"].inner_state
    for s in jax.tree_util.tree_leaves(jstate, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no Adam state")


CFG = dict(lr=1e-3, warmup_steps=3, gradient_clip_norm=2.0)


def test_bf16_first_moment_matches_optax():
    jparams, jstate, params, opt = _run_both(dict(CFG, adam_mu_dtype="bfloat16"))
    assert isinstance(opt, trainer.BF16MomentAdam)
    adam = _adam_state(jstate)
    assert int(adam.count) == trainer.adam_count(opt) == 5
    for k, p in params.items():
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        mu = np.asarray(adam.mu[k].astype(jnp.float32))
        assert adam.mu[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), mu, err_msg=k)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), rtol=1e-6)
        start = _toy_params()[k]
        moved = np.abs(np.asarray(jparams[k]) - start).max()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                   atol=1e-6 * moved, err_msg=k)


@pytest.mark.parametrize("adamw", [False, True])
def test_adam_and_adamw_match_optax(adamw):
    jparams, jstate, params, opt = _run_both(dict(CFG, use_adamw=adamw))
    assert type(opt) is (torch.optim.AdamW if adamw else torch.optim.Adam)
    if adamw:
        assert opt.param_groups[0]["weight_decay"] == 0.0
    adam = _adam_state(jstate)
    for k, p in params.items():
        start = _toy_params()[k]
        moved = np.abs(np.asarray(jparams[k]) - start).max()
        # torch's update rounds p + lr * m / (sqrt(v) + eps) in another
        # order: 2 f32 ULPs of the value, plus 1e-5 of the total move
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=2.4e-7,
                                   atol=1e-5 * moved, err_msg=k)
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-6, atol=1e-9)


def test_freeze_mask_matches_multi_transform():
    frozen = {"inner_unet.c"}
    jparams, jstate, params, opt = _run_both(CFG, freeze=frozen)
    start = _toy_params()
    for k, p in params.items():
        if k in frozen:
            assert torch.equal(p.detach(), torch.from_numpy(start[k]))
            np.testing.assert_array_equal(np.asarray(jparams[k]), start[k])
            assert p not in opt.state  # no moments
        else:
            moved = np.abs(np.asarray(jparams[k]) - start[k]).max()
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=2.4e-7,
                                       atol=1e-5 * moved, err_msg=k)
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == 35 + 9


class _ToyPipeline:
    """loss = mean over the batch of sum_k mean((w_k * x)^2) for three
    parameter tensors, one of them frozen."""

    def __init__(self):
        self.vision_module = torch.nn.Module()
        for k, v in _toy_params().items():
            self.vision_module.register_parameter(k.replace(".", "_"),
                                                  torch.nn.Parameter(torch.from_numpy(v.copy())))
        self.vision_module.dtype = torch.float32

    def get_loss(self, batch, generator=None, **kw):
        x = batch["images"].reshape(-1)
        losses = sum(((p.reshape(-1)[None, :] * x[:, None]) ** 2).mean(dim=1)
                     for p in self.vision_module.parameters())
        return losses, None, None, None, None, None


class _JaxToyPipeline:
    def get_loss(self, params, batch, key, train=True):
        x = batch["images"].reshape(-1)
        losses = sum(((p.reshape(-1)[None, :] * x[:, None]) ** 2).mean(axis=1)
                     for p in params.values())
        return losses, None, None, None, None, None


def test_frozen_gradients_count_in_the_clip():
    """Through the train steps: the norm (and so the clip) counts the
    frozen tensor's gradient, as ``optax.global_norm(grads)`` does."""
    cfg = dict(lr=1e-2, warmup_steps=1, gradient_clip_norm=0.05)
    pipe = _ToyPipeline()
    names = dict(zip((k.replace(".", "_") for k in _toy_params()), _toy_params()))
    mask = {k: "freeze" if names[k].startswith("inner_unet") else "train"
            for k, _ in pipe.vision_module.named_parameters()}
    state = trainer.TrainState.create(pipe.vision_module, trainer.TrainerConfig(**cfg), mask)
    step = trainer.make_train_step(pipe, trainer.TrainerConfig(**cfg))
    jcfg = jtrainer.TrainerConfig(**cfg)
    jparams = {k.replace(".", "_"): jnp.asarray(v) for k, v in _toy_params().items()}
    jopt, _ = jtrainer.make_optimizer(jcfg, {k: mask[k] for k in jparams})
    jstate = jtrainer.TrainState.create(jparams, jopt)
    jstep = jax.jit(jtrainer.make_train_step(_JaxToyPipeline(), jopt, jcfg))
    frozen = pipe.vision_module.inner_unet_c.detach().clone()
    for i in range(3):
        x = np.linspace(0.5, 1.5, 4, dtype=np.float32) * (i + 1)
        jstate, jm = jstep(jstate, {"images": jnp.asarray(x)}, jax.random.PRNGKey(i))
        state, m = step(state, {"images": torch.from_numpy(x)})
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
        assert m["grad_norm"] > cfg["gradient_clip_norm"]  # the clip engages
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert torch.equal(pipe.vision_module.inner_unet_c.detach(), frozen)


# -- load_batch -------------------------------------------------------------------


def _extra_columns_tsv(tmp_path):
    path = tmp_path / "extra.tsv"
    with open(IMG_TSV) as f, open(path, "w") as g:
        g.write(f.readline().rstrip("\n") + "\tstate\twatermark_score\n")
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            parts[0] = os.path.join(REPO, parts[0])
            g.write("\t".join(parts) + f"\t{50 + i}\t0.{i}5\n")
    return str(path)


def test_load_batch_matches_jax(tmp_path):
    from ml_mdm_tpu.clis import train_parallel as jtp
    from ml_mdm_tpu.config import get_arguments as jget_arguments
    from ml_mdm_tpu.language_models import factory as jfactory
    from ml_mdm_tpu_torch import reader
    from ml_mdm_tpu_torch.language_models import factory
    from ml_mdm_tpu_torch.utils.convert import t5_params_from_jax

    args = cli_args()
    jargs = jget_arguments(["--config_path", YAML, "--vocab_file", VOCAB], mode="trainer")
    tok, lm = factory.create_lm(args, "cpu")
    jtok, jlm = jfactory.create_lm(jargs)
    lm.encoder.load_state_dict(t5_params_from_jax(jax.device_get(jlm.params)), strict=True)
    ds = reader.get_dataset(tok, 4, _extra_columns_tsv(tmp_path), args.reader_config,
                            num_epochs=1)
    raw = next(iter(ds))
    ds.close()
    got = train_parallel.load_batch(raw, lm, tok)
    ref = jtp.load_batch(raw, jlm, jtok)
    assert set(got) == set(ref)
    for k in ref:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        r = np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k == "lm_outputs":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())
        else:
            assert g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=k)
    assert {"images", "scale", "watermark_score", "lm_mask"} <= set(got)
    dev = train_parallel._device_batch(got, _FakePipe(("scale",)), "cpu")
    assert set(dev) == {"images", "lm_outputs", "lm_mask", "scale"}
    assert dev["scale"].dtype == torch.float32


class _FakePipe:
    def __init__(self, conditions):
        self.vision_module = type("M", (), {"conditions": {c: 1 for c in conditions}})()


# -- the CLI: two steps, checkpoints, resumes -----------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_out")
    args = cli_args("--output-dir", str(out), "--save-freq", "2")
    return args, train_parallel.main(args), out


def test_train_two_steps(trained):
    args, state, out = trained
    assert state.step == 2 == trainer.adam_count(state.optimizer)
    assert type(state.optimizer) is torch.optim.Adam  # tiny_train.yaml has no use_adamw


def test_checkpoints_written_and_reload(trained):
    from ml_mdm_tpu_torch.config import get_model
    from ml_mdm_tpu_torch.presets import build_unet

    args, state, out = trained
    files = os.listdir(out)
    assert {"vis_model_000002.pth", "vis_model_noema_000002.pth", "train_state_000002"} <= set(files)
    assert set(os.listdir(out / "train_state_000002")) == {"state.pt", "train_meta.json"}
    with open(out / "train_state_000002" / "train_meta.json") as f:
        meta = json.load(f)
    assert meta["batch_num"] == 2 and np.isfinite(meta["exp_avg_loss"])
    module = build_unet(get_model(args.model), args.unet_config, "cpu", 99, dtype=torch.float32)
    for name, ref in (("vis_model_000002.pth", state.ema_params),
                      ("vis_model_noema_000002.pth",
                       {k: p.detach() for k, p in state.params.items()})):
        _, other = ckpt.load_vision_model(str(out / name), module)
        assert other["batch_num"] == 2
        for k, p in module.named_parameters():
            assert torch.equal(p.detach(), ref[k]), (name, k)


def test_train_state_round_trip(trained):
    """load_train_state restores parameters, EMA, moments and step bit for
    bit into a fresh state."""
    from ml_mdm_tpu_torch.config import get_model
    from ml_mdm_tpu_torch.presets import build_unet

    args, state, out = trained
    module = build_unet(get_model(args.model), args.unet_config, "cpu", 5, dtype=torch.float32)
    fresh = trainer.TrainState.create(module)
    fresh, other = ckpt.load_train_state(str(out / "train_state_000002"), fresh)
    assert fresh.step == 2 and other["batch_num"] == 2
    assert_bitwise(state_tensors(fresh), state_tensors(state))


def test_sample_after_training(trained):
    from ml_mdm_tpu_torch.config import get_model, get_pipeline
    from ml_mdm_tpu_torch.language_models import factory
    from ml_mdm_tpu_torch.presets import build_unet

    args, state, out = trained
    tok, lm = factory.create_lm(args, "cpu", seed=args.seed)
    tokens = np.asarray([[4, 5, tok.eos] + [tok.pad] * 5], dtype=np.int64)
    lm_outputs, lm_mask = lm({"tokens": tokens}, tok)
    module = build_unet(get_model(args.model), args.unet_config, "cpu", 0, dtype=torch.float32)
    ckpt.load_vision_model(str(out / "vis_model_000002.pth"), module)
    pipe = get_pipeline(args.model)(module, args.diffusion_config)
    img = pipe.sample(1, {"lm_outputs": lm_outputs, "lm_mask": lm_mask}, 16,
                      torch.Generator().manual_seed(0), num_inference_steps=4,
                      resample_steps=True, ddim_eta=0.0)
    assert img.shape == (1, 16, 16, 3) and bool(torch.isfinite(img).all())
    assert float(img.abs().max()) <= 1.0


def test_resume_from_pth_checkpoint(trained, tmp_path):
    """A second run picks up batch_num and the loss stats from the .pth."""
    _, _, out = trained
    args = cli_args("--output-dir", str(tmp_path), "--save-freq", "10",
                    "--num-training-steps", "4", "--pretrained-vision-file",
                    str(out / "vis_model_noema_000002.pth"))
    state = train_parallel.main(args)
    assert state.step == 4 and trainer.adam_count(state.optimizer) == 2


def _two_batch_index(tmp_path):
    """A shard of exactly 4 rows (two batches of 2) and its index."""
    shard = tmp_path / "four.tsv"
    with open(IMG_TSV) as f, open(shard, "w") as g:
        lines = f.readlines()
        g.write(lines[0])
        for line in lines[1:5]:
            parts = line.split("\t")
            g.write("\t".join([os.path.join(REPO, parts[0])] + parts[1:]))
    index = tmp_path / "index.tsv"
    index.write_text(f"filename\n{shard}\n")
    return str(index)


def test_train_state_resume_is_exact(tmp_path):
    """2 steps, then a resume from the train state for 2 more, equal 4
    straight steps bit for bit (see the module docstring for why the data
    agree)."""
    index = _two_batch_index(tmp_path)
    common = ("--reader_config.shuffle_buffer_size", "0", "--reader_config.num_readers", "1")
    history_a, history_c = [], []
    straight = train_parallel.main(cli_args(
        "--output-dir", str(tmp_path / "a"), "--save-freq", "2", "--num-training-steps", "4",
        *common, index=index), history_a)
    train_parallel.main(cli_args("--output-dir", str(tmp_path / "b"), "--save-freq", "2",
                                 "--num-training-steps", "2", *common, index=index))
    resumed = train_parallel.main(cli_args(
        "--output-dir", str(tmp_path / "c"), "--save-freq", "2", "--num-training-steps", "4",
        "--resume-from-train-state", str(tmp_path / "b" / "train_state_000002"), *common,
        index=index), history_c)
    assert straight.step == resumed.step == 4
    assert_bitwise(state_tensors(resumed), state_tensors(straight))
    # main's history: each consumed step's (batch_num, loss, grad_norm, seconds)
    assert [h[0] for h in history_a] == [1, 2, 3, 4] and [h[0] for h in history_c] == [3, 4]
    assert [h[1:3] for h in history_c] == [h[1:3] for h in history_a[2:]]
    assert all(np.isfinite(h[1]) and h[3] > 0 for h in history_a + history_c)
    with open(tmp_path / "a" / "train_state_000004" / "train_meta.json") as f:
        a = json.load(f)
    with open(tmp_path / "c" / "train_state_000004" / "train_meta.json") as f:
        c = json.load(f)
    assert a == c  # the loss, its tracker's stats and batch_num


def test_resume_from_ema_train_state(trained, tmp_path):
    _, state1, out = trained

    def resume(*extra):
        return train_parallel.main(cli_args(
            "--output-dir", str(tmp_path), "--num-training-steps", "2",  # no training
            "--resume-from-train-state", str(out / "train_state_000002"), *extra))

    with_flag = resume("--resume-from-ema")
    for k, p in with_flag.params.items():
        assert torch.equal(p.detach(), state1.ema_params[k]), k
    without_flag = resume()
    for k, p in without_flag.params.items():
        assert torch.equal(p.detach(), state1.params[k].detach()), k
    assert any(not torch.equal(state1.params[k].detach(), state1.ema_params[k])
               for k in state1.params)


def test_select_resume_checkpoint(tmp_path):
    ema = tmp_path / "vis_model_000010.pth"
    raw = tmp_path / "vis_model_noema_000010.pth"
    ema.write_bytes(b"x")
    raw.write_bytes(b"x")
    assert ckpt.select_resume_checkpoint(str(raw), False) == str(raw)
    assert ckpt.select_resume_checkpoint(str(raw), True) == str(ema)
    assert ckpt.select_resume_checkpoint(str(ema), True) == str(ema)
    os.remove(ema)
    assert ckpt.select_resume_checkpoint(str(raw), True) == str(raw)


# -- the nested model: warm start, freeze --------------------------------------------


def _nested_module(args, seed):
    from ml_mdm_tpu_torch.config import get_model
    from ml_mdm_tpu_torch.presets import build_unet

    args.unet_config.conditioning_feature_dim = 16
    return build_unet(get_model(args.model), args.unet_config, "cpu", seed, dtype=torch.float32)


def test_inner_warm_start_from_pth(tmp_path):
    args = cli_args(yaml=NESTED_YAML)
    donor = _nested_module(args, 0)
    pth = str(tmp_path / "inner_donor.pth")
    ckpt.save_vision_model(pth, donor.inner_unet)
    args.unet_config.initialize_inner_with_pretrained = pth
    fresh = _nested_module(args, 7)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    ckpt.apply_inner_warm_start(fresh, args.unet_config)
    donor_sd = donor.state_dict()
    for k, v in fresh.state_dict().items():
        if k.startswith("inner_unet."):
            assert torch.equal(v, donor_sd[k]), k
        else:
            assert torch.equal(v, before[k]), k  # the outer shell untouched
    assert any(not torch.equal(before[k], donor_sd[k]) for k in before
               if k.startswith("inner_unet."))


@pytest.mark.parametrize("where", ["missing", "orbax", "s3"])
def test_inner_warm_start_refuses(tmp_path, monkeypatch, where):
    # boto3 absent whatever another test file of this process put into
    # sys.modules (tests/ref_loader.py stubs it)
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.chdir(tmp_path)
    args = cli_args(yaml=NESTED_YAML)
    module = _nested_module(args, 3)
    path = {"missing": str(tmp_path / "nope.pth"), "s3": "s3://bucket/inner.pth",
            "orbax": str(tmp_path)}[where]
    args.unet_config.initialize_inner_with_pretrained = path
    # s3: the JAX route, a download through s3_helpers, whose RuntimeError
    # says that boto3 is absent
    error = {"missing": FileNotFoundError, "orbax": ValueError, "s3": RuntimeError}[where]
    with pytest.raises(error, match="boto3" if where == "s3" else None):
        ckpt.apply_inner_warm_start(module, args.unet_config)


def test_freeze_inner_unet_through_the_cli(trained, tmp_path):
    """tiny_nested_train.yaml with its inner U-Net warm-started from the
    tiny_train checkpoint and frozen: after two steps the inner U-Net is
    the checkpoint's, bit for bit, and the shell moved."""
    _, state1, out = trained
    args = cli_args("--output-dir", str(tmp_path), "--save-freq", "10",
                    "--unet_config.freeze_inner_unet", "true", yaml=NESTED_YAML)
    args.unet_config.initialize_inner_with_pretrained = str(out / "vis_model_000002.pth")
    state = train_parallel.main(args)
    assert state.step == 2
    inner = [k for k in state.params if k.startswith("inner_unet.")]
    assert inner
    for k in inner:
        assert torch.equal(state.params[k].detach(), state1.ema_params[k[len("inner_unet."):]]), k
        assert state.params[k] not in state.optimizer.state
    assert any(state.optimizer.state.get(p) for k, p in state.params.items() if k not in inner)


def test_mesh_shape_takes_the_data_axis_only(tmp_path):
    """A spec of the data axis alone keeps the data-parallel step; an axis
    the port's mesh does not have (``model``) raises, here and in the CLI
    (the ``fsdp`` axis is tests/test_torch_fsdp.py's)."""
    from ml_mdm_tpu_torch.parallel import mesh_shape
    from ml_mdm_tpu_torch.parallel.mesh import uses_fsdp

    assert mesh_shape(None, 1) == (1, 1) and mesh_shape("data:1", 1) == (1, 1)
    assert mesh_shape(None, 3) == (3, 1) and mesh_shape("data", 2) == (2, 1)
    assert mesh_shape("data:2", 2) == (2, 1) and not uses_fsdp("data:2")
    with pytest.raises(ValueError):
        mesh_shape("data:2", 1)
    with pytest.raises(ValueError, match="model"):
        mesh_shape("data:1,model:2", 2)
    with pytest.raises(ValueError, match="model"):
        train_parallel.main(cli_args("--output-dir", str(tmp_path), "--mesh-shape", "model:1"))


def test_python_m_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ml_mdm_tpu_torch.clis.train_parallel", "--config_path", YAML,
         "--file-list", INDEX, "--vocab_file", VOCAB, "--device", "cpu", "--output-dir",
         str(tmp_path), "--num-training-steps", "1", "--save-freq", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Using seed: 7" in proc.stderr and "Saving model. Batch = 1" in proc.stderr
    assert "compute dtype torch.float32" in proc.stderr
    assert {"vis_model_000001.pth", "train_state_000001"} <= set(os.listdir(tmp_path))
