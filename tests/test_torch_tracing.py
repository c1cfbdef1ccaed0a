"""The port's spans (``ml_mdm_tpu_torch/tracing.py``) on the CPU: the null
context with no profiler, the spans a tiny U-Net forward and a tiny
training step open under a profiler of the host, the ranges the
benchmark's readers name (``benchmark/metrics/*.json``), and the nesting
rules that keep those readings apart (a kernel sits under the innermost
range open when it was launched)."""
import collections
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ml_mdm_tpu_torch import presets, trainer, tracing
from ml_mdm_tpu_torch.diffusion import Diffusion
from ml_mdm_tpu_torch.models.layers import ResNetBlockStage
from ml_mdm_tpu_torch.models.unet import UNet

torch.set_num_threads(1)

METRICS = Path(__file__).resolve().parent.parent / "benchmark" / "metrics"
PREFIXES = ("unet:", "K2", "K3 ", "remat:", "trainer:", "text tower")
K3 = ("K3 backward", "K3 backward (identity prologue)")
LEAVES = ("unet: attention", "K2", "remat: recompute")
TEXT_LEN = 8


def _program(e) -> bool:
    return e.name.startswith(PREFIXES)


def _traced(fn):
    """The host events of ``fn`` under a profiler of the host."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.events())


def _names(events):
    """How often each program range opens."""
    return collections.Counter(e.name for e in events if _program(e))


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        if _program(p):
            yield p
        p = p.cpu_parent


def _forward(pipe, lm_dim, side, batch=2):
    u = pipe.vision_module
    g = torch.Generator().manual_seed(0)
    x = torch.randn(batch, side, side, 3, generator=g).to(u.dtype)
    if hasattr(u, "inner_unet"):
        x = [x] + [x[:, ::r, ::r] for r in u.nest_ratio]
    text = torch.randn(batch, TEXT_LEN, lm_dim, generator=g).to(u.dtype)
    with torch.no_grad():
        return u(x, torch.tensor([10, 500][:batch]), text, torch.ones(batch, TEXT_LEN))


def _batch(side, lm_dim, batch=2):
    g = torch.Generator().manual_seed(1)
    return {"images": torch.rand(batch, side, side, 3, generator=g) * 2 - 1,
            "lm_outputs": torch.randn(batch, TEXT_LEN, lm_dim, generator=g),
            "lm_mask": torch.ones(batch, TEXT_LEN)}


def _step_events(pipe, lm_dim, side, cfg):
    state = trainer.TrainState.create(pipe.vision_module, cfg)
    step = trainer.make_train_step(pipe, cfg)
    batch, g = _batch(side, lm_dim), torch.Generator().manual_seed(2)
    _, m = step(state, batch, g)  # Adam builds its state outside the trace
    assert not m["skipped"]
    return _traced(lambda: step(state, batch, g))


def _stages(module):
    return [m for m in module.modules() if isinstance(m, ResNetBlockStage)]


@pytest.fixture(scope="module")
def nested_step():
    """One traced step of the tiny nested 256px model (its shells packed)
    with remat above physical side 16, and the pipeline."""
    pipe, lm_dim, side = presets.nested_preset("cc12m_256x256", "cpu", 0, scaled=True,
                                               train=True, pack_min_side=8)
    cfg = trainer.TrainerConfig(lr=1e-3, warmup_steps=2, remat=True, remat_save_conv_max_side=16)
    return _step_events(pipe, lm_dim, side, cfg), pipe


def test_no_profiler_gives_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("unet: forward") is tracing.span("K3 backward", backward=True)
    assert tracing.span(lambda: pytest.fail("a name built with no profiler")) is tracing._OFF
    with tracing.span("unet: forward"):
        pass


def test_a_span_opens_in_its_pass_only():
    """A forward span opens outside a backward pass, a backward one only
    inside it; the name of a callable is built only when the span opens."""
    seen = {}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            seen["fwd"] = (tracing.span("f") is tracing._OFF,
                           tracing.span("b", backward=True) is tracing._OFF)
            return x * 2

        @staticmethod
        def backward(ctx, dy):
            seen["bwd"] = (tracing.span("f") is tracing._OFF,
                           tracing.span("b", backward=True) is tracing._OFF)
            return dy * 2

    x = torch.ones(2, requires_grad=True)
    _traced(lambda: Probe.apply(x).sum().backward())
    assert seen == {"fwd": (False, True), "bwd": (True, False)}

    def opened():
        with tracing.span(lambda: "trainer: built"):
            pass

    assert _names(_traced(opened)) == {"trainer: built": 1}


def test_flagship_forward_opens_its_spans_once_a_call():
    pipe, lm_dim, side = presets.flagship_64px("cpu", 0, scaled=True)
    events = _traced(lambda: _forward(pipe, lm_dim, side))
    names = _names(events)
    u = pipe.vision_module
    assert names["unet: forward"] == 1
    # the scaled flagship: levels at 16, 8 and 4 px, two mid blocks, one
    # attention layer after each ResNet at 8 and 4 px and in the first mid block
    for path in ("down", "up"):
        for s in (16, 8, 4):
            assert names[f"unet: {path} {s}"] == 1
    assert names["unet: mid"] == 2
    assert names["unet: attention"] == sum(len(getattr(s, "attn", ())) for s in _stages(u))
    k2 = sum(n for k, n in names.items() if k.startswith("K2"))
    assert k2 == 2 * sum(len(s.resnets) for s in _stages(u))  # conv1 and conv2 of each ResNet
    assert names["K2·N·proj"] > 0 and names["K2"] > 0


def test_nested_forward_opens_one_forward_span_a_call():
    pipe, lm_dim, side = presets.nested_preset("cc12m_256x256", "cpu", 0, scaled=True,
                                               pack_min_side=8)
    names = _names(_traced(lambda: (_forward(pipe, lm_dim, side),
                                    _forward(pipe, lm_dim, side))))
    assert names["unet: forward"] == 2
    assert names["unet: down 64"] == names["unet: up 64"] == 2
    assert names["unet: mid"] == 4  # the core's two, twice
    # the packed shell's launches are K2·struct
    assert any(k.startswith("K2·struct") for k in names)


def test_training_step_opens_the_step_readback_and_one_recompute_a_remat_stage(nested_step):
    events, pipe = nested_step
    names = _names(events)
    assert names["trainer: step"] == names["trainer: readback"] == 1
    assert names["unet: forward"] == 1
    # remat above physical side 16: the shell's 64 px stages (packed, 32 px),
    # down and up; the 32 px stages pack to 16 and keep their activations
    recomputed = {k: n for k, n in names.items() if k.startswith("remat: recompute")}
    assert recomputed == {"remat: recompute 64": 2}
    stages = sum(n for k, n in names.items() if k.startswith(("unet: down", "unet: up",
                                                                 "unet: mid")))
    assert stages == len(_stages(pipe.vision_module)) == 14


def test_every_stage_recomputed_at_save_side_0():
    pipe, lm_dim, side = presets.flagship_64px("cpu", 0, scaled=True, train=True)
    cfg = trainer.TrainerConfig(lr=1e-3, warmup_steps=2, remat=True, remat_save_conv_max_side=0)
    names = _names(_step_events(pipe, lm_dim, side, cfg))
    recomputed = sum(n for k, n in names.items() if k.startswith("remat: recompute"))
    assert recomputed == len(_stages(pipe.vision_module)) == 8


def _metric_ranges():
    out = set()
    for f in ("conv_bwd_roofline.json", "optimizer_ms_per_step.json"):
        out |= set(json.loads((METRICS / f).read_text())["ranges"])
    return out


def test_the_benchmarks_ranges_still_open(nested_step):
    """Every range the benchmark's K3 and optimizer metrics read opens in a
    step that exercises it: the nested step (K3 with its stats, Adam), and a
    flagship step with dropout ResNets (K3's identity-prologue backward)
    and AdamW."""
    ucfg, dcfg, lm_dim, side = presets.flagship_configs(scaled=True)
    ucfg.resnet_config.dropout = 0.1
    pipe = Diffusion(presets.build_unet(UNet, ucfg, "cpu", 0, train=True), dcfg)
    cfg = trainer.TrainerConfig(lr=1e-3, warmup_steps=2, use_adamw=True)
    opened = {e.name for e in nested_step[0] + _step_events(pipe, lm_dim, side, cfg)}
    assert _metric_ranges() - opened == set()


def test_nesting_rules(nested_step):
    """No program range opens inside a K3 range but K3's own and remat's
    recompute; none inside "trainer: Adam" or "trainer: EMA"; the leaves
    (attention, K2, the recompute) hold no program range; no forward span
    opens inside a backward pass."""
    events = [e for e in nested_step[0] if _program(e)]
    assert events
    for e in events:
        above = [p.name for p in _ancestors(e)]
        if any(a.startswith(K3) for a in above):
            assert e.name.startswith("K3 ") or e.name.startswith("remat: recompute"), (e.name,
                                                                                       above)
        assert not any(a in ("trainer: Adam", "trainer: EMA") for a in above), e.name
        assert not any(a.startswith(LEAVES) for a in above), (e.name, above)
    k3_inside = [e for e in events
                 if e.name.startswith("K2") and any(p.name.startswith("K3 ") for p in _ancestors(e))]
    assert not k3_inside
