"""The offline sample-quality gate on the port (``ml_mdm_tpu_torch/tools/
quality_gate.py``), the counterpart of tests/test_quality_gate.py: the tiny
pipeline of tests/test_files/tiny_train.yaml overfit on the ten fixture
images for 500 steps (lr 5e-4, warmup 20, clip 2.0, EMA 0.99), then two
seed-disjoint DDIM-20 sample sets (eta 0, ``resample_steps``) from the EMA
parameters for the same captions. As in the JAX gate: the untrained
model's per-caption MSE above 0.3 (the broken anchor: the probe itself is
calibrated), the trained one below 0.05, and the pixel FID lower after
training. Nothing else in the suite would catch a numerics fault that
keeps shapes and finiteness and stays inside the per-step tolerances.

On one CPU thread, f32, the whole gate takes about 22 s (anchor 0.516,
trained 0.0088: the JAX gate's calibration is ~0.50 and ~0.013), so it
runs in tier-1, unmarked. It runs from another working directory: the
fixture is read relative to the checkout. The probe's arithmetic is also
held against the JAX gate's (its inline ``probe``) on the same arrays.
"""
import numpy as np
import pytest
import torch

from ml_mdm_tpu_torch.tools import quality_gate as qg

torch.set_num_threads(1)


def test_trained_samples_match_references(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = qg.QualityGate("cpu").run()
    # broken-anchor sanity: an untrained model's samples are far from the
    # references; if this fails the probe itself is miscalibrated
    assert result["mse_untrained"] > 0.3, result
    assert np.isfinite(result["loss"]) and not result["skipped"], result
    assert result["mse_trained"] < 0.05, result
    assert result["fid_trained"] < result["fid_untrained"], result
    qg.check(result)


def test_fixture_is_the_jax_gates():
    """The ten 16 px references and captions as the JAX gate reads them."""
    import io
    import os
    import tarfile

    from PIL import Image

    refs, texts = qg.load_fixture()
    assert refs.shape == (10, 16, 16, 3) and refs.dtype == np.uint8 and len(texts) == 10
    caps = {}
    with open(os.path.join(qg.FIXTURES, "images_00000.tsv")) as f:
        next(f)
        for line in f:
            _tar, fn, cap = line.strip().split("\t")
            caps[fn] = cap
    with tarfile.open(os.path.join(qg.FIXTURES, "images_00000.tar")) as t:
        for i, m in enumerate(t.getmembers()):
            img = Image.open(io.BytesIO(t.extractfile(m).read()))
            np.testing.assert_array_equal(
                refs[i], np.asarray(img.convert("RGB").resize((16, 16), Image.BILINEAR)))
            assert texts[i] == caps[m.name]


def test_probe_arithmetic_matches_jax():
    """``probe_metrics`` against the JAX gate's probe arithmetic (its MSE
    and the JAX ``PixelFeatures`` / ``fid_from_features``) on the same
    sample sets."""
    from ml_mdm_tpu.clis.run_torchmetrics import PixelFeatures, fid_from_features

    rng = np.random.default_rng(5)
    refs = rng.integers(0, 256, (10, 16, 16, 3), dtype=np.uint8)
    images = refs.astype(np.float32) / 127.5 - 1.0
    samples = np.clip(images + rng.normal(0, 0.3, (2,) + images.shape), -1, 1).astype(np.float32)
    mses, u8s = [], []
    for img in samples:
        mses.append(((img - images) ** 2).mean(axis=(1, 2, 3)))
        u8s.append(np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8))
    px = PixelFeatures()
    want = (float(np.mean(mses)), fid_from_features(px(np.concatenate(u8s)), px(refs)))
    got = qg.probe_metrics(samples, images, refs)
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-10)


@pytest.mark.parametrize("bad", ["anchor", "mse", "fid", "loss"])
def test_check_rejects(bad):
    good = {"mse_untrained": 0.5, "fid_untrained": 3.0, "mse_trained": 0.01, "fid_trained": 0.1,
            "loss": 0.02, "skipped": False}
    qg.check(good)
    broken = dict(good, **{"anchor": {"mse_untrained": 0.2}, "mse": {"mse_trained": 0.06},
                           "fid": {"fid_trained": 3.5}, "loss": {"loss": float("nan")}}[bad])
    with pytest.raises(AssertionError, match="quality gate"):
        qg.check(broken)
