"""The port's CLIP towers (``language_models/clip.py``), tokenizer
(``language_models/clip_tokenizer.py``) and image preprocessing against
what the JAX package's ``run_torchmetrics.ClipFeatures`` gets from
``transformers``, on the CPU, in f32.

The directories are tiny random ``transformers.CLIPModel`` checkpoints
(``torch_clip_dir.py``: 2 layers a tower, widths 32-64, patch 8 at 32 px,
a hand-written byte-level BPE vocabulary), written with
``model.safetensors`` or ``pytorch_model.bin``, with the end token's id or
2 as ``eos_token_id``, with ``model_max_length`` 16 or none:

- token ids and attention masks exactly equal to the fast tokenizer's
  (``CLIPTokenizerFast``, converted from ``vocab.json`` + ``merges.txt``)
  on captions with capitals, digits, punctuation, accents, runs of white
  space, tabs and newlines, and one longer than ``model_max_length``:
  truncated where the directory gives it, not where it does not;
- pixel values exactly equal to the slow ``CLIPImageProcessor``'s, at sides
  above, at and below the crop, square and not;
- image features and CLIPScore within 1e-5 relative of ``ClipFeatures``';
- the text tower's pooled output on hand-made ids under both pooling
  rules (the first end token; the largest id where ``eos_token_id`` is 2)
  within 1e-5 of Hugging Face's, and the two rules told apart;
- the safetensors reader and writer against the ``safetensors`` package;
- the tower directory ``chip_smoke.py`` writes (``write_clip_tower``, here
  at a tiny size) loads in ``transformers`` and gives the same features
  and ids there as in the port.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from ml_mdm_tpu.clis import run_torchmetrics as jrt
from ml_mdm_tpu_torch.clis import run_torchmetrics as prt
from ml_mdm_tpu_torch.language_models import clip
from ml_mdm_tpu_torch.language_models.clip_tokenizer import CLIPTokenizer
from torch_clip_dir import write_tiny_clip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTIONS = [
    "A photo of a CAT",
    "the  red   fox in the snow at dawn!!",
    "It's 2024, café au lait; Ünïcode ÀÉÎ straße",
    "tabs\tand\nnewlines here... (and) [brackets] #42",
    "x",
    "painting of blue sky over hills " * 3,
]
DIRS = {"safetensors, first end token, max 16": dict(eos_rule="first", max_length=16, safe=True),
        "bin, argmax, no max length": dict(eos_rule="argmax", max_length=None, safe=False)}


@pytest.fixture(scope="module", params=list(DIRS))
def clip_pair(request, tmp_path_factory):
    """(directory, JAX ClipFeatures, the port's ClipFeatures)."""
    path = str(tmp_path_factory.mktemp("clip"))
    write_tiny_clip(path, **DIRS[request.param])
    return path, jrt.ClipFeatures(path), prt.ClipFeatures(path, "cpu")


def _images(seed, sides):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sides]


def test_token_ids_match_fast_tokenizer(clip_pair):
    path, jax_feats, port = clip_pair
    tok = jax_feats.processor.tokenizer
    assert type(tok).__name__ == "CLIPTokenizerFast"
    want = jax_feats.processor(text=CAPTIONS, padding=True, truncation=True, return_tensors="np")
    ids, mask = port.tokenizer(CAPTIONS)
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])
    longest = int(mask.sum(1).max())
    if port.tokenizer.model_max_length is None:
        assert longest > 16  # the long caption is not truncated
    else:
        assert longest == port.tokenizer.model_max_length == 16


def test_pixel_values_match_processor(clip_pair):
    _, jax_feats, port = clip_pair
    images = _images(1, [(48, 40), (40, 48), (32, 32), (16, 16), (64, 64), (33, 57), (20, 31)])
    want = jax_feats.processor(images=images, return_tensors="np")["pixel_values"]
    got = clip.preprocess_images(images, port.preprocessor)
    assert got.dtype == np.float32 and got.shape == (7, 3, 32, 32)
    np.testing.assert_array_equal(got, want)


def test_crop_above_the_shortest_edge_raises(clip_pair):
    _, _, port = clip_pair
    cfg = dict(port.preprocessor, crop_size={"height": 40, "width": 40})
    with pytest.raises(ValueError, match="smaller than the 40x40 crop"):
        clip.preprocess_images(_images(0, [(32, 32)]), cfg)


def test_features_and_clip_score_match_jax(clip_pair):
    _, jax_feats, port = clip_pair
    images = np.stack(_images(2, [(40, 48)] * len(CAPTIONS)))
    want, got = jax_feats(images), port(images)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(CAPTIONS), 24)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    score = port.clip_score(images, CAPTIONS)
    assert score == pytest.approx(jax_feats.clip_score(images, CAPTIONS), rel=1e-5)


def test_clip_score_batches(clip_pair, monkeypatch):
    """Batched (3 images a batch) the same score and features as whole."""
    _, _, port = clip_pair
    images = np.stack(_images(3, [(32, 32)] * len(CAPTIONS)))
    whole, score = port(images), port.clip_score(images, CAPTIONS)
    monkeypatch.setattr(prt, "CLIP_BATCH", 3)
    assert np.abs(port(images) - whole).max() <= 1e-6 * np.abs(whole).max()
    assert port.clip_score(images, CAPTIONS) == pytest.approx(score, rel=1e-6)


@pytest.mark.parametrize("rule", ["first", "argmax"])
def test_text_pooling_rules(tmp_path, rule):
    from transformers import CLIPModel

    path = str(tmp_path)
    write_tiny_clip(path, eos_rule=rule)
    eos = CLIPTokenizer(path).eos_id
    # row 0: the largest id (eos + 3) before the first end token
    ids = torch.tensor([[eos - 1, eos + 3, eos, 7, eos], [5, 200, 9, eos, eos]])
    mask = torch.ones_like(ids)
    ref = CLIPModel.from_pretrained(path).eval()
    port = clip.load_clip_from_torch(path, "cpu")
    with torch.no_grad():
        want = ref.get_text_features(input_ids=ids, attention_mask=mask)
        got = port.get_text_features(ids, mask)
        other = port.text_model.config.eos_token_id
        port.text_model.config.eos_token_id = eos if rule == "argmax" else 2
        swapped = port.get_text_features(ids, mask)
        port.text_model.config.eos_token_id = other
    assert port.text_model.config.eos_token_id == (2 if rule == "argmax" else eos)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (swapped - want).abs().max() > 1e-2 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64,
                                   torch.float64])
def test_safetensors_match_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    state = {"a.weight": (torch.randn(3, 5, generator=g) * 100).to(dtype),
             "b": (torch.randn(7, generator=g) * 100).to(dtype),
             "scalar": torch.ones((), dtype=dtype)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    clip.write_safetensors(state, ours)
    save_file(state, theirs)
    for loaded in (load_file(ours), clip.read_safetensors(theirs), clip.read_safetensors(ours)):
        assert set(loaded) == set(state)
        for k, v in state.items():
            assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k


def test_local_directories_only(tmp_path):
    for call in (lambda p: clip.load_clip_from_torch(p, "cpu"), CLIPTokenizer):
        with pytest.raises(FileNotFoundError, match="downloads nothing"):
            call("openai/clip-vit-base-patch16")


def test_init_clip_is_seeded():
    cfg = clip.CLIPConfig(text=clip._tower(dict(hidden_size=16, intermediate_size=32,
                                                num_hidden_layers=1, num_attention_heads=2), {}),
                          vision=clip._tower(dict(hidden_size=16, intermediate_size=32,
                                                  num_hidden_layers=1, num_attention_heads=2,
                                                  image_size=16, patch_size=8), {}),
                          projection_dim=8)
    a, b, c = (clip.init_clip_(clip.CLIPModel(cfg), torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    for (k, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), k
        if k.endswith("weight") and "norm" not in k:
            assert not torch.equal(pa, pc), k
    assert a.logit_scale.item() == pytest.approx(2.6592)


def test_chip_smoke_clip_tower_loads_in_transformers(tmp_path):
    """The directory ``chip_smoke.write_clip_tower`` writes, at a tiny size
    of the same layout, is a Hugging Face CLIP checkpoint: the JAX
    package's ``ClipFeatures`` reads it, with the same features, ids and
    score as the port."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    tiny = json.loads(json.dumps(chip_smoke.CLIP_B16))
    tiny["text_config"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4)
    tiny["vision_config"].update(hidden_size=48, intermediate_size=64, num_hidden_layers=2,
                                 num_attention_heads=4, image_size=32, patch_size=8)
    tiny["projection_dim"] = 24
    path = str(tmp_path)
    n = chip_smoke.write_clip_tower("cpu", path, tiny, image_side=32)
    assert n == sum(p.numel() for p in clip.load_clip_from_torch(path, "cpu").parameters())
    jax_feats, port = jrt.ClipFeatures(path), prt.ClipFeatures(path, "cpu")
    assert port.model.text_model.config.eos_token_id == 2  # the published config's rule
    images = np.stack(_images(4, [(64, 64)] * 4))
    caps = ["a red fox in the snow at dawn", "Photo of 3 CATS!", "x", "an oil painting"]
    want = jax_feats.processor(text=caps, padding=True, truncation=True, return_tensors="np")
    ids, mask = port.tokenizer(caps)
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])
    got, ref = port(images), jax_feats(images)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert port.clip_score(images, caps) == pytest.approx(jax_feats.clip_score(images, caps),
                                                         rel=1e-5)
