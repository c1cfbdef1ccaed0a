"""The check fails what it should fail: a whole run of each kind (the look
for a card skipped: the tiny configurations on the CPU) with the timed path
broken underneath in each way the cell can be, and the control, the
reference put in the program's place in fp8. At this size the bf16 program
reads other numbers than at the cells' own (the tiny training step's loss
gap 0.016 against 0.001-0.002 on the card), so each run is held to limits
three times the sound run's readings, on the numbers the cell's own file
compares."""
import pytest
import torch

import tiny
import common
from drivers import sample, train
from ml_mdm_tpu_torch import samplers
from ml_mdm_tpu_torch.diffusion import Diffusion, NestedDiffusion

torch.set_num_threads(2)
CELLS = {c: common.load_json(common.BENCH / "cells" / f"{c}.json")
         for c in ("sample64_b32_cfg", "sample1024_b8_cfg", "train1024_b8")}
_SOUND = {}


def _limits(kind, run_sound):
    """Three times the sound run's readings, computed once a kind."""
    if kind not in _SOUND:
        out = run_sound()
        _SOUND[kind] = {k: 3 * v for k, (v, _) in out["compared"].items()}
    return _SOUND[kind]


def _sample_ctx(nested, limits=None):
    cell = CELLS["sample1024_b8_cfg" if nested else "sample64_b32_cfg"]
    limits = limits or _limits(("sample", nested), lambda: sample.run(
        _sample_ctx(nested, cell["limits"])))
    return tiny.context(tiny.config(nested), tiny.sample_traffic(batch=2, steps=3),
                        {"check_samples": 4, "limits": limits})


def _unchanged(self, model_fn, x_t, *args, **kwargs):
    return x_t, x_t  # the denoise step returns its state unchanged


def _half_batch(orig):
    def forward_model(self, model_fn, x_t, t, lm_outputs, lm_mask, micros, guidance_scale=1.0):
        xs = x_t if isinstance(x_t, list) else [x_t]
        b = xs[0].shape[0]
        h = b // 2
        text = torch.cat([lm_outputs[:h], lm_outputs[b:b + h]])
        mask = torch.cat([lm_mask[:h], lm_mask[b:b + h]])
        half = [x[:h] for x in xs]
        p = orig(self, model_fn, half if isinstance(x_t, list) else half[0], t[:h], text, mask,
                 micros, guidance_scale)
        return [torch.cat([q, q]) for q in p] if isinstance(p, list) else torch.cat([p, p])
    return forward_model


def _rolled(orig):
    def sample_(self, *args, **kwargs):
        return orig(self, *args, **kwargs).roll(1, dims=0)  # each prompt gets another's image
    return sample_


SAMPLE_FAULTS = {
    "state_unchanged": lambda mp: (mp.setattr(samplers.Sampler, "step", _unchanged),
                                   mp.setattr(samplers.NestedSampler, "step", _unchanged)),
    "half_batch": lambda mp: (
        mp.setattr(samplers.Sampler, "forward_model", _half_batch(samplers.Sampler.forward_model)),
        mp.setattr(samplers.NestedSampler, "forward_model",
                   _half_batch(samplers.NestedSampler.forward_model))),
    "answer_altered": lambda mp: (
        mp.setattr(Diffusion, "sample", _rolled(Diffusion.sample)),
        mp.setattr(NestedDiffusion, "sample", _rolled(NestedDiffusion.sample))),
}


@pytest.mark.parametrize("nested", [False, True])
def test_sample_sound_run_is_correct(nested):
    out = sample.run(_sample_ctx(nested))
    assert out["correct"]
    # at this size too, the sound run is inside the cell's own limit
    assert all(v <= lim for v, lim in sample.run(_sample_ctx(
        nested, CELLS["sample1024_b8_cfg" if nested else "sample64_b32_cfg"]["limits"])
    )["compared"].values())


@pytest.mark.parametrize("fault", sorted(SAMPLE_FAULTS))
@pytest.mark.parametrize("nested", [False, True])
def test_sample_fault_is_caught(nested, fault, monkeypatch):
    SAMPLE_FAULTS[fault](monkeypatch)
    out = sample.run(_sample_ctx(nested))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("nested", [False, True])
def test_sample_control_fails(nested):
    ctx = _sample_ctx(nested)
    chosen = sample.picks(ctx, 2)
    want = sample.reference_images(ctx, chosen)
    got = sample.reference_images(ctx, chosen, quant="fp8")
    assert max(sample.relative_errors(got, want)) > ctx.cell["limits"]["image_rel_err"]


def _train_ctx(limits=None):
    limits = limits or _limits("train", lambda: train.run(
        _train_ctx(CELLS["train1024_b8"]["limits"])))
    return tiny.context(tiny.config(True), tiny.train_traffic(batch=2),
                        {"reference_steps": 3, "check_rows": 1, "limits": limits})


def _no_update(self, *args, **kwargs):
    return None


def _zero_one_grad(orig):
    def step(self, *args, **kwargs):
        # the leaf with the largest gradient gets none
        p = max(self.param_groups[0]["params"], key=lambda q: float(q.grad.norm()))
        p.grad.zero_()
        return orig(self, *args, **kwargs)
    return step


def _half_loss(orig):
    def get_loss(self, sample_, generator=None, *, time=None, eps=None, dropout=None):
        h = sample_["images"].shape[0] // 2
        sample_ = {k: v[:h] for k, v in sample_.items()}
        eps = [e[:h] for e in eps] if isinstance(eps, list) else eps[:h]
        return orig(self, sample_, generator, time=time[:h], eps=eps, dropout=dropout)
    return get_loss


TRAIN_FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(torch.optim.Adam, "step", _no_update),
    "half_batch": lambda mp: mp.setattr(NestedDiffusion, "get_loss",
                                        _half_loss(NestedDiffusion.get_loss)),
    "answer_altered": lambda mp: mp.setattr(torch.optim.Adam, "step",
                                            _zero_one_grad(torch.optim.Adam.step)),
}


def test_train_sound_run_is_correct():
    assert train.run(_train_ctx())["correct"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    out = train.run(_train_ctx())
    assert not out["correct"], out["compared"]


def test_train_control_fails():
    ctx = _train_ctx()
    nums = train.compare(train.reference_run(ctx, quant="fp8"), train.reference_run(ctx),
                         train.clip_norm(ctx))
    assert any(nums[k] > lim for k, lim in ctx.cell["limits"].items()), nums
