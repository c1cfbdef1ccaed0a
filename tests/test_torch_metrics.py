"""The port's ``clis/run_torchmetrics.py`` against the JAX one, on the CPU.

- ``frechet_distance`` (full-rank covariances, and rank-deficient ones,
  whose square root is complex), ``fid_from_features`` and
  ``PixelFeatures`` equal the JAX ones to 1e-10 on features and images
  made from a seed with numpy;
- ``main`` with the pixel extractor on ``tests/test_metrics.py``'s
  fabricated manifests (two ranks of 12 with a +40 shift; one rank whose
  samples are its references): the same keys and ``fid`` to 1e-10, and 0
  for identical sets; the sanity FID too where the reference halves have
  more images than the 198 pixel features (two ranks of 200 at 8 px);
- the JAX ``main`` reads the port's ``generate_batch`` output, and the
  port's ``main`` the JAX one's (tests/test_files/tiny_train.yaml, 4
  samples): equal ``fid`` on each;
- with a tiny local CLIP directory (``torch_clip_dir.py``): ``--feature-
  extractor clip --metrics fid,clip`` gives ``fid_extractor`` "clip", a
  ``fid`` within 1e-5 relative of the JAX CLI's (its features through
  ``transformers``; they agree to ~2e-7, the FID of 24 images in 24
  dimensions to ~4e-7) and a ``clip_score`` within 1e-5 relative or, where
  it is near 0, 1e-5 absolute on its 0-100 scale;
- the JAX CLI's fallbacks: an extractor that cannot be built (``inception``
  without torchvision) falls back to pixel features, as in the JAX CLI, and
  a CLIP model that cannot be loaded skips CLIPScore;
- ``--device cuda`` without a card raises.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ml_mdm_tpu.clis import run_torchmetrics as jrt
from ml_mdm_tpu_torch.clis import run_torchmetrics as prt
from torch_clip_dir import write_tiny_clip

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(HERE, "test_files", "tiny_train.yaml")
INDEX = os.path.join(HERE, "test_files", "sample_training_0.tsv")
VOCAB = os.path.join(HERE, "test_files", "tiny_t5.vocab")


def _make_rank(sample_dir, rank, n, rng, shift=0, side=32):
    """tests/test_metrics.py's fixture: n random references and their
    samples shifted by ``shift`` levels, with a manifest."""
    d = os.path.join(sample_dir, f"rank{rank}")
    os.makedirs(d)
    manifest = {}
    for i in range(n):
        base = rng.integers(0, 200, size=(side, side, 3), dtype=np.uint8)
        Image.fromarray(base).save(os.path.join(d, f"ref_{i:04d}.png"))
        sample = np.clip(base.astype(int) + shift, 0, 255).astype(np.uint8)
        Image.fromarray(sample).save(os.path.join(d, f"s_{i:04d}.png"))
        manifest[f"s_{i:04d}.png"] = f"a photo of a cat {i}"
    with open(os.path.join(d, "lst.json"), "w") as f:
        json.dump(manifest, f)


def _samples(tmp_path, ranks, n, shift, seed=0, side=32):
    rng = np.random.default_rng(seed)
    sample_dir = str(tmp_path / "samples")
    os.makedirs(sample_dir)
    for r in range(ranks):
        _make_rank(sample_dir, r, n, rng, shift=shift, side=side)
    return sample_dir


def _both(argv):
    return prt.main(argv + ["--device", "cpu"]), jrt.main(argv)


@pytest.mark.parametrize("n,d", [(40, 8), (10, 30), (64, 64)])
def test_frechet_distance_matches_jax(n, d):
    rng = np.random.default_rng(n * d)
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((n, d)) * 1.3 + 0.2
    pa, pb = prt.compute_statistics(a), prt.compute_statistics(b)
    ja, jb = jrt.compute_statistics(a), jrt.compute_statistics(b)
    for p, j in zip(pa + pb, ja + jb):
        np.testing.assert_array_equal(p, j)
    got, want = prt.frechet_distance(*pa, *pb), jrt.frechet_distance(*ja, *jb)
    assert got == pytest.approx(want, rel=1e-10, abs=1e-10)
    assert prt.fid_from_features(a, b) == pytest.approx(jrt.fid_from_features(a, b), rel=1e-10,
                                                        abs=1e-10)
    assert isinstance(got, float)


def test_frechet_distance_known_value():
    mu1, mu2 = np.zeros(3), np.ones(3)
    s = np.eye(3)
    assert abs(prt.frechet_distance(mu1, s, mu2, s) - 3.0) < 1e-6


def test_pixel_features_match_jax():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(7, 20, 28, 3), dtype=np.uint8)
    got, want = prt.PixelFeatures()(images), jrt.PixelFeatures()(images)
    assert got.shape == want.shape == (7, 198)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("ranks,n,shift,side", [(2, 12, 40, 32), (1, 16, 0, 32), (2, 200, 40, 8)])
def test_main_matches_jax(tmp_path, ranks, n, shift, side):
    sample_dir = _samples(tmp_path, ranks, n, shift, side=side)
    out = str(tmp_path / "out.json")
    got, want = _both(["--sample-dir", sample_dir, "--min-examples", str(ranks * n),
                       "--metrics", "fid", "--feature-extractor", "pixel",
                       "--output-json", out])
    assert set(got) == set(want)
    assert got["fid_extractor"] == "pixel"
    for key in ("fid", "fid_sanity"):
        if key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-10, abs=1e-10), key
    assert ("fid_sanity" in got) == (ranks * n // 2 > 198)
    if shift:
        assert got["fid"] > 0 and np.isfinite(got["fid"])
    else:
        assert abs(got["fid"]) < 1e-4
    with open(out) as f:
        assert json.load(f) == got


def test_load_images_order_matches_jax(tmp_path):
    """Rank by rank, each manifest's entries sorted, stopping at the limit."""
    sample_dir = _samples(tmp_path, 2, 5, 40)
    for prefix in ("s_", "ref_"):
        got, got_caps = prt.load_images(sample_dir, prefix, 7)
        want, want_caps = jrt.load_images(sample_dir, prefix, 7)
        np.testing.assert_array_equal(got, want)
        assert got_caps == want_caps and len(got_caps) == 7


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """tests/test_files/tiny_train.yaml sampled by both ``generate_batch``
    CLIs (4 samples, DDIM-2)."""
    from ml_mdm_tpu.clis import generate_batch as jgenerate_batch
    from ml_mdm_tpu.config import get_arguments as jget_arguments
    from ml_mdm_tpu_torch.clis import generate_batch
    from ml_mdm_tpu_torch.config import get_arguments

    argv = ["--config_path", YAML, "--test-file-list", INDEX, "--vocab_file", VOCAB,
            "--min-examples", "4", "--seed", "3", "--reader_config.num_readers", "1"]
    out, jout = tmp_path_factory.mktemp("port_gen"), tmp_path_factory.mktemp("jax_gen")
    run = dict(num_inference_steps=2, ddim_eta=0.0)
    generate_batch.main(get_arguments(argv + ["--sample-dir", str(out), "--device", "cpu"],
                                      mode="sampler"), **run)
    jgenerate_batch.main(jget_arguments(argv + ["--sample-dir", str(jout)], mode="sampler"), **run)
    return out, jout


@pytest.mark.parametrize("which", ["port", "jax"])
def test_each_cli_reads_the_others_generate_batch(generated, which):
    sample_dir = str(generated[0] if which == "port" else generated[1])
    got, want = _both(["--sample-dir", sample_dir, "--min-examples", "4", "--metrics", "fid",
                       "--feature-extractor", "pixel"])
    assert got["fid_extractor"] == want["fid_extractor"] == "pixel"
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-10, abs=1e-10)
    assert np.isfinite(got["fid"]) and got["fid"] > 0


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_clip"))
    write_tiny_clip(path)
    return path


def test_main_with_clip_matches_jax(tmp_path, clip_dir):
    sample_dir = _samples(tmp_path, 2, 12, 40)
    got, want = _both(["--sample-dir", sample_dir, "--min-examples", "24",
                       "--metrics", "fid,clip", "--feature-extractor", "clip",
                       "--clip-model", clip_dir])
    assert set(got) == set(want) == {"fid", "fid_extractor", "clip_score"}
    assert got["fid_extractor"] == want["fid_extractor"] == "clip"
    # near 0 (most pairs of the random towers have a negative cosine, which
    # the score clamps) 1e-5 absolute on its 0-100 scale
    assert got["clip_score"] == pytest.approx(want["clip_score"], rel=1e-5, abs=1e-5)
    assert 0 <= got["clip_score"] <= 100
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-5)


def test_fallbacks_as_in_jax(tmp_path, clip_dir):
    """inception without torchvision falls back to pixel features in both
    CLIs; a CLIP directory that cannot be loaded skips CLIPScore."""
    sample_dir = _samples(tmp_path, 1, 12, 40)
    got, want = _both(["--sample-dir", sample_dir, "--min-examples", "12", "--metrics", "fid",
                       "--feature-extractor", "inception"])
    assert got["fid_extractor"] == want["fid_extractor"] == "pixel"
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-10, abs=1e-10)
    got = prt.main(["--sample-dir", sample_dir, "--min-examples", "12", "--metrics", "clip",
                    "--clip-model", str(tmp_path / "no_such_clip"), "--device", "cpu"])
    assert got == {}


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sample_dir = _samples(tmp_path, 1, 4, 40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prt.main(["--sample-dir", sample_dir, "--min-examples", "4", "--metrics", "fid",
                  "--feature-extractor", "pixel", "--device", "cuda"])
