"""The one-process data-parallel sampler (``parallel.make_data_parallel_
sampler`` / ``sample_data_parallel``, the counterpart of the JAX package's
``make_data_parallel_sampler``), on the CPU with ``devices=[cpu, cpu]``:

- the tiny flagship-structured U-Net, unguided and with classifier-free
  guidance (2 B text rows, each half split with its samples), and the tiny
  nested model (one noise tensor a resolution): bitwise equal to
  ``pipeline.sample`` on one device of each replica's rows from the noise
  drawn in full with the same generator, and within 1e-5 of one call over
  the whole batch;
- with eta 1 (step noise drawn in full from seeded generators) the two
  replicas give one device's images (within 1e-5; run to run bitwise), and
  a change of the parameters reaches the replicas;
- ``generate_batch`` takes the route when the process sees more than one
  device (``local_devices`` patched), and writes the images of the
  one-device run.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ml_mdm_tpu_torch import parallel
from ml_mdm_tpu_torch.clis import generate_batch
from ml_mdm_tpu_torch.config import get_arguments
from ml_mdm_tpu_torch.presets import flagship_64px, nested_preset

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CPUS = [torch.device("cpu"), torch.device("cpu")]
KW = dict(num_inference_steps=3, resample_steps=True, ddim_eta=0.0)


def _cond(rows, lm_dim, seed):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(rows, 8)
    mask[0, 5:] = 0
    return {"lm_outputs": torch.randn(rows, 8, lm_dim, generator=g), "lm_mask": mask}


def _halves(cond, batch):
    """Each replica's conditioning rows of a 2-way split (both halves of
    2 B guided rows)."""
    out = []
    for lo, hi in ((0, batch // 2), (batch // 2, batch)):
        out.append({k: v[lo:hi] if v.shape[0] == batch else torch.cat([v[lo:hi],
                                                                        v[batch + lo:batch + hi]])
                    for k, v in cond.items()})
    return out


@pytest.mark.parametrize("model,guidance", [("flat", 1.0), ("flat", 3.0), ("nested", 2.0)])
def test_two_replicas_equal_one_device(model, guidance):
    """Each replica's images are bitwise one device's sampling of its rows
    (the same call shape); against one call over the whole batch they
    differ only by the library's batch-dependent blocking (a 2-row and a
    4-row forward of the same rows differ by ~6e-7 here)."""
    if model == "flat":
        pipe, lm_dim, side = flagship_64px("cpu", seed=1, scaled=True)
    else:
        pipe, lm_dim, side = nested_preset("cc12m_256x256", "cpu", seed=1, scaled=True)
    pipe.vision_module.float()
    batch = 4
    cond = _cond(batch * (2 if guidance != 1.0 else 1), lm_dim, seed=2)
    kw = dict(KW, guidance_scale=guidance)
    two = parallel.sample_data_parallel(pipe, batch, cond, side,
                                        torch.Generator().manual_seed(3), devices=CPUS, **kw)
    noise = pipe.get_noise(batch, side, torch.Generator().manual_seed(3))
    rows = [[n[lo:lo + 2] for n in noise] if isinstance(noise, list) else noise[lo:lo + 2]
            for lo in (0, 2)]
    split = torch.cat([pipe.sample(2, c, side, None, noise=x, **kw)
                       for c, x in zip(_halves(cond, batch), rows)])
    whole = pipe.sample(batch, cond, side, torch.Generator().manual_seed(3), **kw)
    assert two.shape == whole.shape == (batch, side, side, 3)
    assert torch.equal(two, split)
    torch.testing.assert_close(two, whole, rtol=0, atol=1e-5)


def test_step_noise_and_a_weight_change_reach_the_replicas():
    pipe, lm_dim, side = flagship_64px("cpu", seed=4, scaled=True)
    pipe.vision_module.float()
    cond = _cond(4, lm_dim, seed=5)
    kw = dict(KW, ddim_eta=1.0)
    one = parallel.make_data_parallel_sampler(pipe, 4, side, [torch.device("cpu")], **kw)
    two = parallel.make_data_parallel_sampler(pipe, 4, side, CPUS, **kw)
    a = one(cond, torch.Generator().manual_seed(6))
    b = two(cond, torch.Generator().manual_seed(6))
    # the same step noise in full on both: one device within the blocking's
    # rounding, and the replicas run to run bitwise
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert torch.equal(b, two(cond, torch.Generator().manual_seed(6)))
    c = two(cond, torch.Generator().manual_seed(7))
    assert (b - c).abs().max() > 0.1
    with torch.no_grad():
        pipe.vision_module.conv_out.bias.add_(0.5)
    d = two(cond, torch.Generator().manual_seed(6))
    e = one(cond, torch.Generator().manual_seed(6))
    torch.testing.assert_close(d, e, rtol=0, atol=1e-5)
    assert (d - b).abs().max() > 0.1
    with pytest.raises(ValueError, match="split"):
        parallel.make_data_parallel_sampler(pipe, 3, side, CPUS)


def _gen_args(out):
    return get_arguments(["--config_path", os.path.join(HERE, "test_files", "tiny_train.yaml"),
                          "--test-file-list",
                          os.path.join(HERE, "test_files", "sample_training_0.tsv"),
                          "--vocab_file", os.path.join(HERE, "test_files", "tiny_t5.vocab"),
                          "--sample-dir", str(out), "--min-examples", "4", "--batch-size", "4",
                          "--seed", "11", "--reader_config.num_readers", "1", "--device", "cpu"],
                         mode="sampler")


def test_generate_batch_takes_the_route(tmp_path, monkeypatch):
    kw = dict(negative_prompt="low quality", guidance_scale=2.0, num_inference_steps=2,
              ddim_eta=0.0)
    assert generate_batch.main(_gen_args(tmp_path / "one"), **kw) == 4
    calls = []
    real = parallel.make_data_parallel_sampler

    def spy(*a, **k):
        calls.append(a[1:3])
        return real(*a, **k)

    monkeypatch.setattr(generate_batch, "local_devices", lambda device, world: CPUS)
    monkeypatch.setattr(parallel, "make_data_parallel_sampler", spy)
    assert generate_batch.main(_gen_args(tmp_path / "two"), **kw) == 4
    assert calls == [(4, 16)]
    for i in range(4):
        a, b = (np.asarray(Image.open(tmp_path / d / "rank0" / f"s_{i:06d}.png"))
                for d in ("one", "two"))
        assert np.array_equal(a, b)
