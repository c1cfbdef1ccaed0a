"""The port's trainer against the JAX package's: three training steps of
the tiny nested model against ``trainer.make_train_step`` (fed the same
timesteps and noise), a JAX train state carried over by
``train_state_from_jax`` and stepped on in both, and the step's semantics
on a toy quadratic pipeline (NaN skip, accumulation, the LR schedule,
EMA warmup, ``RobustLossTracker``). f32.

Tolerances:
- losses and gradient norms: 1e-4 relative (the loss parity of
  tests/test_torch_train.py, through two updates);
- Adam moments after the steps: max abs difference <= 1e-3 of the
  tensor's max |JAX|; parameters and EMA copies: <= 1e-2 of the
  parameter tensor's largest change from the start (Adam divides each element's gradient by
  that element's own running size, so the gradient's 1e-4 error on a
  small element becomes a larger share of its update). A tensor whose
  gradient is 0 up to rounding is held apart (see ``_assert_state``);
- the toy pipeline: 1e-5 relative (a few f32 operations in another
  order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu import trainer as jtrainer
from ml_mdm_tpu.lr_scaler import LRScaler as JaxLRScaler
from ml_mdm_tpu_torch import trainer
from ml_mdm_tpu_torch.lr_scaler import LRScaler
from ml_mdm_tpu_torch.utils.convert import params_from_jax, train_state_from_jax
from torch_parity import LM_LEN, jax_nested_noise, tiny_nested_pair, to_np

torch.set_num_threads(1)

CFG = dict(lr=1e-3, warmup_steps=2, gradient_clip_norm=2.0, ema_decay=0.9, ema_warmup_steps=1)
N_STEPS = 3


def _batch(seed, b=2, side=32):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, LM_LEN), np.float32)
    mask[1, 4:] = 0
    return {"images": np.clip(rng.standard_normal((b, side, side, 3)) * 0.5, -1, 1).astype(np.float32),
            "lm_outputs": rng.standard_normal((b, LM_LEN, 16)).astype(np.float32),
            "lm_mask": mask}


def _tensors(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(tree)).items()}


@pytest.fixture(scope="module")
def steps():
    """JAX and the port, N_STEPS steps each from the same weights, with the
    JAX state kept after every step."""
    jpipe, params, pipe, _, _ = tiny_nested_pair(1, seed=11, fast_init=True)
    jcfg, tcfg = jtrainer.TrainerConfig(**CFG), trainer.TrainerConfig(**CFG)
    jopt, _ = jtrainer.make_optimizer(jcfg)
    jstep = jax.jit(jtrainer.make_train_step(jpipe, jopt, jcfg))
    jstates = [jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jopt)]
    jmetrics = []
    unet = pipe.vision_module.train()
    state = trainer.TrainState.create(unet)
    step = trainer.make_train_step(pipe, tcfg)
    metrics = []
    batches, keys = [_batch(20 + i) for i in range(N_STEPS)], jax.random.split(jax.random.PRNGKey(3), N_STEPS)
    for batch, key in zip(batches, keys):
        s, m = jstep(jstates[-1], {k: jnp.asarray(v) for k, v in batch.items()}, key)
        jstates.append(s)
        jmetrics.append({k: float(v) for k, v in m.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, m = step(state, tb, noise=jax_nested_noise(jpipe, key, batch["images"]))
        metrics.append(m)
    start = _tensors(jstates[0].params)
    return dict(jpipe=jpipe, pipe=pipe, jstates=jstates, jmetrics=jmetrics, state=state,
                metrics=metrics, batches=batches, keys=keys, jstep=jstep, start=start,
                tcfg=tcfg)


def _moments(state: "trainer.TrainState"):
    """The port's Adam moments by parameter name: (mu, nu)."""
    st = [state.optimizer.state[p] for p in state.params.values()]
    return ({k: s["exp_avg"] for k, s in zip(state.params, st)},
            {k: s["exp_avg_sq"] for k, s in zip(state.params, st)})


def _assert_state(got: "trainer.TrainState", ref, start):
    """Parameters, EMA and Adam moments of the port's state against a JAX
    state, with the tolerances above. An element whose gradient is 0 up to
    rounding (its Adam second moment below (1e-5 of the largest)^2: the
    key half of ``kv_cond``'s bias, which the softmax cancels, or conv1's
    bias in a shell whose GroupNorm has one-channel groups) takes Adam
    steps that are rounding too; it is held to moving at most 2 lr a
    step."""
    assert got.step == int(ref.step)
    adam = ref.opt_state[0]
    assert trainer.adam_count(got.optimizer) == int(adam.count)
    mu, nu_got = _moments(got)
    nu = _tensors(adam.nu)
    top_nu = max(v.max() for v in nu.values())
    noise = {k: v < 1e-10 * top_nu for k, v in nu.items()}
    update = {k: np.abs(v - start[k]).max() for k, v in _tensors(ref.params).items()}
    assert sum(m.sum() for m in noise.values()) < 0.01 * sum(m.size for m in noise.values())
    for what, mine, theirs in [("params", {k: p.detach() for k, p in got.params.items()}, ref.params),
                               ("ema", got.ema_params, ref.ema_params),
                               ("mu", mu, adam.mu), ("nu", nu_got, adam.nu)]:
        theirs = _tensors(theirs)
        assert set(theirs) == set(mine)
        top = max(np.abs(r).max() for r in theirs.values())
        for k, r in theirs.items():
            diff = np.abs(to_np(mine[k]) - r)
            if what in ("params", "ema"):
                bound = np.where(noise[k], 2 * CFG["lr"] * int(ref.step), 1e-2 * update[k])
            else:
                bound = np.where(noise[k], 1e-5 * top, 1e-3 * np.abs(r).max())
            assert (diff <= bound).all(), (what, k, diff.max())


def test_three_steps_losses_match_jax(steps):
    for m, r in zip(steps["metrics"], steps["jmetrics"]):
        assert m["skipped"] == r["skipped"] == 0
        assert abs(m["loss"] - r["loss"]) <= 1e-4 * abs(r["loss"])
        assert abs(m["grad_norm"] - r["grad_norm"]) <= 1e-4 * abs(r["grad_norm"])
    assert len({m["loss"] for m in steps["metrics"]}) == N_STEPS


def test_three_steps_state_matches_jax(steps):
    state = steps["state"]
    _assert_state(state, steps["jstates"][-1], steps["start"])
    changed = sum(not np.array_equal(to_np(p), steps["start"][k]) for k, p in state.params.items())
    assert changed >= 0.9 * len(state.params)


def test_train_state_from_jax_then_one_step(steps):
    """A JAX state after two steps, carried into a fresh port model, takes
    the third step as JAX does."""
    jpipe, jstates = steps["jpipe"], steps["jstates"]
    _, _, pipe, _, _ = tiny_nested_pair(1, seed=99, fast_init=True)  # other weights, overwritten
    unet = pipe.vision_module.train()
    state = train_state_from_jax(jax.device_get(jstates[N_STEPS - 1]), unet)
    _assert_state(state, jstates[N_STEPS - 1], steps["start"])
    step = trainer.make_train_step(pipe, steps["tcfg"])
    batch, key = steps["batches"][-1], steps["keys"][-1]
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                    noise=jax_nested_noise(jpipe, key, batch["images"]))
    r = steps["jmetrics"][-1]
    assert abs(m["loss"] - r["loss"]) <= 1e-4 * abs(r["loss"])
    _assert_state(state, jstates[-1], steps["start"])


# -- the step's semantics on a toy pipeline ----------------------------------------


class _Toy(torch.nn.Module):
    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1))


class ToyPipeline:
    """losses = mean((images * w - target)^2) per image (+ poison)."""

    def __init__(self):
        self.vision_module = _Toy()

    def get_loss(self, batch, generator=None):
        pred = batch["images"] * self.vision_module.w
        losses = ((pred - batch["target"]) ** 2).mean(dim=(1, 2, 3)) + batch.get("poison", 0.0)
        return losses, None, None, None, None, None


class JaxToyPipeline:
    def get_loss(self, params, batch, key, train=True):
        losses = jnp.mean((batch["images"] * params["w"] - batch["target"]) ** 2,
                          axis=(1, 2, 3)) + batch.get("poison", 0.0)
        return losses, None, None, None, None, None


def _toy(accum=1, **kw):
    cfg = dict(lr=0.1, warmup_steps=3, gradient_clip_norm=1.0,
               num_gradient_accumulations=accum, ema_decay=0.5, ema_warmup_steps=2, **kw)
    pipe = ToyPipeline()
    tcfg = trainer.TrainerConfig(**cfg)
    state = trainer.TrainState.create(pipe.vision_module)
    step = trainer.make_train_step(pipe, tcfg)
    jcfg = jtrainer.TrainerConfig(**cfg)
    jopt, _ = jtrainer.make_optimizer(jcfg)
    jstate = jtrainer.TrainState.create({"w": jnp.ones((1,))}, jopt)
    jstep = jax.jit(jtrainer.make_train_step(JaxToyPipeline(), jopt, jcfg))
    return state, step, jstate, jstep


def _toy_batch(b=8, poison=None):
    batch = {"images": np.arange(1.0, b + 1, dtype=np.float32).reshape(b, 1, 1, 1) / b + 0.5,
             "target": np.zeros((b, 1, 1, 1), np.float32)}
    if poison is not None:
        batch["poison"] = np.float32(poison)
    return batch


def _toy_state(state):
    mu, nu = _moments(state)
    return [float(state.params["w"].detach()), float(state.ema_params["w"]),
            float(mu["w"]), float(nu["w"]), trainer.adam_count(state.optimizer), state.step]


def _jax_toy_state(s):
    adam = s.opt_state[0]
    return [float(s.params["w"][0]), float(s.ema_params["w"][0]), float(adam.mu["w"][0]),
            float(adam.nu["w"][0]), int(adam.count), int(s.step)]


@pytest.mark.parametrize("accum", [1, 4])
def test_toy_steps_match_jax(accum):
    """Warmup LR, clip, EMA warmup and accumulation, step by step; a
    poisoned step in the middle is skipped by both."""
    state, step, jstate, jstep = _toy(accum)
    for i in range(6):
        batch = _toy_batch(poison=np.nan if i == 3 else None)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert m["skipped"] == int(jm["skipped"]) == (i == 3)
        if i != 3:
            np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(_toy_state(state), _jax_toy_state(jstate), rtol=1e-5)


def test_nan_step_changes_nothing():
    state, step, _, _ = _toy()
    state, _ = step(state, {k: torch.as_tensor(v) for k, v in _toy_batch().items()})
    before = _toy_state(state)
    state, m = step(state, {k: torch.as_tensor(v) for k, v in _toy_batch(poison=np.inf).items()})
    assert m["skipped"] == 1 and not np.isfinite(m["loss"])
    assert _toy_state(state) == before
    assert state.params["w"].grad is None


def test_accumulation_matches_one_batch():
    results = []
    for accum in (1, 4):
        state, step, _, _ = _toy(accum)
        for _ in range(3):
            state, m = step(state, {k: torch.as_tensor(v) for k, v in _toy_batch().items()})
        results.append(_toy_state(state) + [m["loss"]])
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5)


def test_lr_schedule_matches_jax():
    for warmup in (0, 1, 10):
        ours = LRScaler(0.5).get_lr_schedule(warmup, 2e-4)
        theirs = JaxLRScaler(0.5).get_lr_schedule(warmup, 2e-4)
        for step in range(0, 15):
            np.testing.assert_allclose(ours(step), float(theirs(jnp.asarray(step))), rtol=1e-5)
    assert LRScaler().get_lr_schedule(10, 1.0)(0) == pytest.approx(0.1)  # step 0 counts as 1


def test_weighted_loss():
    losses = torch.tensor([1.0, 3.0])
    assert float(trainer.weighted_loss(losses, torch.tensor([1.0, 0.0]))) == 1.0
    assert float(trainer.weighted_loss(losses, None)) == 2.0
    assert float(trainer.weighted_loss(losses, None, loss_factor=2.0)) == 4.0


def test_robust_loss_tracker_matches_jax():
    ours, theirs = trainer.RobustLossTracker(), jtrainer.RobustLossTracker()
    for v in [1.0, 1.2, 0.9, 1000.0, 1.1, 0.8, 50.0, 0.7]:
        ours.update(v)
        theirs.update(v)
        assert dataclasses.astuple(_tracker(ours)) == pytest.approx(dataclasses.astuple(_tracker(theirs)))
    assert ours.exp_avg_loss < 20.0  # the outliers were clipped


@dataclasses.dataclass
class _TrackerView:
    avg: float
    var: float
    best: float


def _tracker(t):
    return _TrackerView(t.exp_avg_loss, t.exp_avg_loss_var, t.best_avg_loss)


# -- the training presets ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["flagship", "cc12m_256x256"])
def test_scaled_train_preset_takes_steps_in_bf16(name):
    """``train=True``: f32 parameters from the same seeded init, bf16
    compute, training mode; two finite steps move the parameters. The
    default stays a bf16 model in eval mode."""
    from ml_mdm_tpu_torch.presets import flagship_64px, nested_preset

    def build(train):
        if name == "flagship":
            return flagship_64px("cpu", seed=1, scaled=True, train=train)
        return nested_preset(name, "cpu", seed=1, scaled=True, train=train)

    sampling, _, _ = build(False)
    pipe, lm_dim, side = build(True)
    unet = pipe.vision_module
    assert not sampling.vision_module.training and sampling.vision_module.dtype == torch.bfloat16
    assert unet.training and unet.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    for (k, p), q in zip(unet.named_parameters(), sampling.vision_module.parameters()):
        assert torch.equal(p.to(torch.bfloat16), q), k
    cfg = trainer.TrainerConfig(lr=1e-4, warmup_steps=2)
    state = trainer.TrainState.create(unet)
    start = {k: p.detach().clone() for k, p in state.params.items()}
    step = trainer.make_train_step(pipe, cfg)
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        batch = {"images": torch.rand((3, side, side, 3), generator=gen) * 2 - 1,
                 "lm_outputs": torch.randn((3, LM_LEN, lm_dim), generator=gen),
                 "lm_mask": torch.ones((3, LM_LEN))}
        state, m = step(state, batch, gen)
        assert m["skipped"] == 0 and np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert state.step == trainer.adam_count(state.optimizer) == 2
    moved = sum(not torch.equal(p.detach(), start[k]) for k, p in state.params.items())
    assert moved >= 0.95 * len(start)
    out = pipe.get_loss({k: v.to(torch.bfloat16) for k, v in batch.items()}, gen)
    assert out[3].dtype in (torch.bfloat16, torch.float32) and out[2].dtype == torch.bfloat16


def test_training_resnet_with_dropout_raises():
    """A training ResNet with dropout raises without its masks (it never
    draws from the global RNG); given them, it runs; eval mode needs none
    (tests/test_torch_dropout.py holds the masks and the numerics)."""
    from ml_mdm_tpu_torch.config import ResNetConfig
    from ml_mdm_tpu_torch.models.layers import ResNet

    block = ResNet(ResNetConfig(num_channels=8, output_channels=8, num_groups_norm=4,
                                dropout=0.1), temporal_dim=16).train()
    with pytest.raises(RuntimeError, match="masks"):
        block(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 16)))
    block.dropout_masks = lambda resnet, shape, device: torch.ones(shape, dtype=torch.bool)
    assert block(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 16))).shape == (1, 4, 4, 8)
    assert block.eval()(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 16))).shape == (1, 4, 4, 8)
