"""The port's ``generate_batch`` CLI against the JAX one, on the CPU, on
tests/test_files/tiny_train.yaml with one reader (with several the eval
partition's order depends on the reader's threads).

With the negative-prompt splice (guidance 2): the cached tokens (the
negative prompt's rows, then the captions', padded to one length) and text
masks equal the JAX ``generate_data``'s; the reference images
``ref_*.png``, the manifest of the references and ``index.html`` are
bitwise the JAX CLI's; every manifest entry's ``s_*.png`` exists, is a
16 x 16 RGB image and not one flat colour. The samples themselves are not
compared: the port's random vision weights are its own. Without guidance, a
last batch shorter than the others (10 captions at batch 4) is sampled
too, and a ``--model-file`` loads.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ml_mdm_tpu_torch.clis import generate_batch
from ml_mdm_tpu_torch.config import get_arguments

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(HERE, "test_files", "tiny_train.yaml")
INDEX = os.path.join(HERE, "test_files", "sample_training_0.tsv")
VOCAB = os.path.join(HERE, "test_files", "tiny_t5.vocab")
CFG_RUN = dict(negative_prompt="low quality", guidance_scale=2.0, num_inference_steps=2,
               ddim_eta=0.0)


def _cli(sample_dir, *extra, port=True):
    argv = ["--config_path", YAML, "--test-file-list", INDEX, "--vocab_file", VOCAB,
            "--sample-dir", str(sample_dir), "--min-examples", "4", "--seed", "11",
            "--reader_config.num_readers", "1", *extra]
    if port:
        return get_arguments(argv + ["--device", "cpu"], mode="sampler")
    from ml_mdm_tpu.config import get_arguments as jget_arguments

    return jget_arguments(argv, mode="sampler")


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    from ml_mdm_tpu.clis import generate_batch as jgenerate_batch

    out, jout = tmp_path_factory.mktemp("gen"), tmp_path_factory.mktemp("jgen")
    n = generate_batch.main(_cli(out), **CFG_RUN)
    jn = jgenerate_batch.main(_cli(jout, port=False), **CFG_RUN)
    return out, jout, n, jn


def test_writes_samples_and_manifest(generated):
    out, _, n, jn = generated
    assert n == jn == 4
    rank_dir = out / "rank0"
    with open(rank_dir / "lst.json") as f:
        manifest = json.load(f)
    assert len(manifest) == n
    for fname in manifest:
        img = np.asarray(Image.open(rank_dir / fname))
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        assert img.min() < img.max()
    assert sorted(p.name for p in rank_dir.glob("ref_*.png")) == [
        f"ref_{i:06d}.png" for i in range(4)]
    assert (out / "index.html").exists()


def test_references_and_gallery_are_the_jax_clis(generated):
    out, jout, _, _ = generated
    refs = sorted(p.name for p in (jout / "rank0").glob("ref_*.png"))
    assert refs
    for name in refs:
        assert filecmp.cmp(out / "rank0" / name, jout / "rank0" / name, shallow=False), name
    assert filecmp.cmp(out / "index.html", jout / "index.html", shallow=False)
    with open(out / "rank0" / "lst.json") as f, open(jout / "rank0" / "lst.json") as g:
        assert json.load(f) == json.load(g)  # the same captions in the same order


def test_cfg_splice_matches_jax():
    """The cached tokens: negative prompt rows first, then the captions',
    padded to one length; and the masks the tower derives from them."""
    from ml_mdm_tpu.clis import generate_batch as jgenerate_batch
    from ml_mdm_tpu.language_models import factory as jfactory
    from ml_mdm_tpu_torch.language_models import factory

    args, jargs = _cli("unused"), _cli("unused", port=False)
    tok, lm = factory.create_lm(args, "cpu")
    jtok, jlm = jfactory.create_lm(jargs)
    got = generate_batch.generate_data(args, tok, lm, 4, "low quality")
    ref = jgenerate_batch.generate_data(jargs, jtok, jlm, 4, "low quality")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["captions"] == r["captions"]
        np.testing.assert_array_equal(g["tokens"], r["tokens"])
        assert g["tokens"].shape[0] == 2 * len(g["captions"])
        np.testing.assert_array_equal(g["lm_mask"].numpy(), np.asarray(r["lm_mask"]))
        np.testing.assert_array_equal(g["image"], r["image"])
        neg = g["tokens"][: len(g["captions"])]
        assert (neg == neg[0]).all()  # one negative prompt for every row


def test_ragged_last_batch_and_model_file(tmp_path):
    from ml_mdm_tpu_torch.config import get_model
    from ml_mdm_tpu_torch.presets import build_unet
    from ml_mdm_tpu_torch.utils import checkpoint as ckpt

    args = _cli(tmp_path / "a", "--batch-size", "4", "--min-examples", "10")
    args.unet_config.conditioning_feature_dim = 16
    pth = str(tmp_path / "vis.pth")
    ckpt.save_vision_model(pth, build_unet(get_model(args.model), args.unet_config, "cpu", 3,
                                           dtype=torch.float32))
    times = []
    n = generate_batch.main(args, num_inference_steps=2, ddim_eta=0.0, times=times)
    assert n == 10
    assert len(times) == 3 and all(t > 0 for t in times)  # batches of 4, 4 and 2
    args = _cli(tmp_path / "b", "--batch-size", "4", "--min-examples", "10", "--model-file", pth)
    assert generate_batch.main(args, num_inference_steps=2, ddim_eta=0.0) == 10
    a = np.asarray(Image.open(tmp_path / "a" / "rank0" / "s_000009.png"))
    b = np.asarray(Image.open(tmp_path / "b" / "rank0" / "s_000009.png"))
    assert a.shape == b.shape == (16, 16, 3) and not np.array_equal(a, b)
