"""The port's text side against the JAX package: the tokenizer, the caption
tokenization of ``reader.process_text``, the T5 encoder (gated and ReLU)
with the JAX weights carried over by ``t5_params_from_jax``, the local
checkpoint loader on a tiny Hugging Face T5 written by ``transformers``
(one file and sharded), and every ``create_lm`` mode.

Tolerances: tokens, masks, relative-position buckets and one-hot
conditioning exact; the T5 encoder f32 max-abs <= 1e-5 * max|ref| (the same
f32 operations in another summation order); precomputed embeddings exact.
"""
import dataclasses
import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.language_models import factory as jfactory
from ml_mdm_tpu.language_models import t5 as jt5
from ml_mdm_tpu.language_models.tokenizer import Tokenizer as JaxTokenizer
from ml_mdm_tpu.reader import ReaderConfig as JaxReaderConfig
from ml_mdm_tpu.reader import process_text as jax_process_text
from ml_mdm_tpu_torch.language_models import factory, t5
from ml_mdm_tpu_torch.language_models.tokenizer import Tokenizer
from ml_mdm_tpu_torch.reader import ReaderConfig, convert, process_text
from ml_mdm_tpu_torch.utils.convert import t5_params_from_jax
from torch_parity import rel_err, seeded_tree, to_np

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T5_VOCAB = os.path.join(REPO, "data/t5.vocab")
PROMPT_FILES = sorted(glob.glob(os.path.join(REPO, "data/prompts_*.tsv")))
T5_TOL = 1e-5

_TOKENIZERS = {}


def _tokenizers(vocab: str, mode):
    if (vocab, mode) not in _TOKENIZERS:
        path = os.path.join(REPO, "data", vocab)
        _TOKENIZERS[(vocab, mode)] = (JaxTokenizer(path, mode=mode), Tokenizer(path, mode=mode))
    return _TOKENIZERS[(vocab, mode)]


def _prompts(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f][1:]


@pytest.mark.parametrize("use_scores", [True, False])
@pytest.mark.parametrize("path", PROMPT_FILES, ids=os.path.basename)
def test_tokenizer_matches_jax_on_every_prompt(path, use_scores):
    jtok, tok = _tokenizers("t5.vocab", "t5")
    assert (tok.vocab_size, tok.eos, tok.bos, tok.pad) == (jtok.vocab_size, jtok.eos,
                                                           jtok.bos, jtok.pad)
    prompts = _prompts(path)
    assert prompts
    for p in prompts:
        assert tok.tokenize_shortest(" " + p, use_scores) == \
            jtok.tokenize_shortest(" " + p, use_scores), p


@pytest.mark.parametrize("vocab,mode", [("bert.vocab", "bert"), ("c4_wpm.vocab", None),
                                        ("tokenizer_spm_32000_50m.vocab", None),
                                        ("cifar10.vocab", "t5")])
def test_vocab_dialects_match_jax(vocab, mode):
    jtok, tok = _tokenizers(vocab, mode)
    assert (tok.vocab_size, tok.eos, tok.bos, tok.pad) == (jtok.vocab_size, jtok.eos,
                                                           jtok.bos, jtok.pad)
    assert tok.trie_key_scores == jtok.trie_key_scores
    for p in _prompts(os.path.join(REPO, "data/prompts_demo.tsv"))[:40] + ["ünïcödé ☃ x"]:
        for use_scores in (True, False):
            assert tok.tokenize_shortest(p, use_scores) == jtok.tokenize_shortest(p, use_scores)
    ids = tok.tokenize_shortest(" a photo of a dog")
    assert tok.tokens2text(ids) == jtok.tokens2text(ids)


@pytest.mark.parametrize("over", [
    dict(max_token_length=16),
    dict(max_token_length=8, prepad_bos=True, append_eos=False),
    dict(max_token_length=12, pad_to_max_length=True, max_caption_length=20),
    dict(max_token_length=128, prepad_caption_with_space=False, use_tokenizer_scores=False),
])
def test_process_text_matches_jax(over):
    jtok, tok = _tokenizers("t5.vocab", "t5")
    texts = _prompts(os.path.join(REPO, "data/prompts_demo.tsv"))[:6] + ["", "a cat"]
    assert process_text(texts, tok, ReaderConfig(**over)) == \
        jax_process_text(texts, jtok, JaxReaderConfig(**over))
    assert [f.name for f in dataclasses.fields(ReaderConfig)] == \
        [f.name for f in dataclasses.fields(JaxReaderConfig)]
    arr = np.array([104, 105, 0, 33, 0], np.uint8)
    assert convert(arr) == "hi!"


@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 16), (12, 40)])
def test_relative_position_buckets_match_jax(buckets, distance):
    rel = np.arange(-5000, 5001, dtype=np.int32)
    ref = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), buckets, distance))
    got = t5._relative_position_bucket(torch.from_numpy(rel).long(), buckets, distance)
    np.testing.assert_array_equal(got.numpy(), ref)


def _tiny_t5_config(gated: bool, vocab: int = 64):
    return dict(vocab_size=vocab, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
                relative_attention_num_buckets=8, relative_attention_max_distance=16,
                is_gated_act=gated, dense_act_fn="gelu_new" if gated else "relu")


def _tokens(vocab: int, b: int = 3, length: int = 40, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, length))
    mask = np.ones((b, length), np.float32)
    mask[1, 25:] = 0
    mask[2, 4:] = 0
    return ids, mask


@pytest.mark.parametrize("gated", [True, False])
def test_t5_encoder_matches_jax(gated):
    kw = _tiny_t5_config(gated)
    jenc = jt5.T5Encoder(jt5.T5Config(**kw))
    ids, mask = _tokens(kw["vocab_size"])
    params = seeded_tree(lambda k: jenc.init(k, jnp.asarray(ids), jnp.asarray(mask))["params"], 3)
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    enc = t5.T5Encoder(t5.T5Config(**kw))
    enc.load_state_dict(t5_params_from_jax(params), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_err(to_np(got), ref) <= T5_TOL


def _hf_t5_dir(tmp_path, gated: bool, shard: bool) -> str:
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration

    cfg = HFT5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                     num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
                     relative_attention_max_distance=16,
                     feed_forward_proj="gated-gelu" if gated else "relu", dropout_rate=0.0,
                     is_encoder_decoder=True, tie_word_embeddings=not gated)
    torch.manual_seed(0)
    model = T5ForConditionalGeneration(cfg).eval()
    path = str(tmp_path / f"t5_{gated}_{shard}")
    model.save_pretrained(path, safe_serialization=False,
                          **({"max_shard_size": "40KB"} if shard else {}))
    return path


@pytest.mark.parametrize("gated,shard", [(True, False), (False, True)])
def test_local_checkpoint_matches_jax_loader(tmp_path, gated, shard):
    path = _hf_t5_dir(tmp_path, gated, shard)
    assert os.path.exists(os.path.join(path, "pytorch_model.bin.index.json")) == shard
    jenc, params = jt5.load_t5_from_torch(path)
    enc = t5.load_t5_from_torch(path, "cpu")
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config)
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    ids, mask = _tokens(64, length=24, seed=1)
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert rel_err(to_np(got), ref) <= T5_TOL


def test_flan_style_directory_loads(tmp_path):
    """A directory as ``chip_smoke.py`` writes it: flan-t5's ``config.json``
    keys (``feed_forward_proj`` "gated-gelu" and no ``dense_act_fn``) and
    a bf16 ``pytorch_model.bin`` of the encoder alone; the loader gives f32
    weights equal to the bf16 values."""
    import json

    cfg = t5.T5Config(**_tiny_t5_config(True))
    src = t5.init_t5_(t5.T5Encoder(cfg), torch.Generator().manual_seed(2))
    hf = {"d_ff": cfg.d_ff, "d_kv": cfg.d_kv, "d_model": cfg.d_model,
          "feed_forward_proj": "gated-gelu", "layer_norm_epsilon": 1e-6, "model_type": "t5",
          "num_heads": cfg.num_heads, "num_layers": cfg.num_layers,
          "relative_attention_max_distance": 16, "relative_attention_num_buckets": 8,
          "vocab_size": cfg.vocab_size}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    torch.save({k: v.to(torch.bfloat16) for k, v in src.state_dict().items()},
               tmp_path / "pytorch_model.bin")
    enc = t5.load_t5_from_torch(str(tmp_path), "cpu")
    assert enc.config == cfg
    for k, v in enc.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, src.state_dict()[k].to(torch.bfloat16).float()), k


def test_loader_takes_only_a_local_directory():
    with pytest.raises(FileNotFoundError, match="local directory"):
        t5.load_t5_from_torch("google/flan-t5-xl", "cpu")


def _args(reader_cls, **kw):
    base = dict(vocab_file=T5_VOCAB, text_model="random:16", categorical_conditioning=0,
                use_precomputed_text_embeddings=0, reader_config=reader_cls(max_token_length=16))
    return SimpleNamespace(**dict(base, **kw))


def _lm_pair(mode: str, tmp_path):
    if mode == "categorical":
        kw = dict(vocab_file=os.path.join(REPO, "data/cifar10.vocab"), categorical_conditioning=1)
    elif mode == "precomputed":
        kw = dict(use_precomputed_text_embeddings=1)
    elif mode == "local":
        kw = dict(text_model=_hf_t5_dir(tmp_path, True, False), vocab_file=T5_VOCAB)
    else:
        kw = {}
    (jtok, jlm), (tok, lm) = (jfactory.create_lm(_args(JaxReaderConfig, **kw)),
                              factory.create_lm(_args(ReaderConfig, **kw), "cpu"))
    if mode == "random":  # the JAX weights, carried over
        lm.encoder.load_state_dict(t5_params_from_jax(jax.device_get(jlm.params)), strict=True)
    return jtok, jlm, tok, lm


@pytest.mark.parametrize("mode", ["categorical", "precomputed", "random", "local"])
def test_create_lm_modes_match_jax(mode, tmp_path):
    jtok, jlm, tok, lm = _lm_pair(mode, tmp_path)
    assert lm.embed_dim == jlm.embed_dim
    if mode == "categorical":  # its vocabulary has no padding token
        tokens = np.random.default_rng(1).integers(0, tok.vocab_size, (3, 4))
    else:
        texts = ["a cat", "a red colored car on a street", "truck"]
        tokens = np.asarray(process_text(texts, tok, ReaderConfig(max_token_length=16)))
        if mode == "local":  # the tiny checkpoint's vocabulary; <pad> is 0
            tokens = tokens % 64
    sample = {"tokens": tokens}
    if mode == "precomputed":
        sample["text_embedding"] = np.random.default_rng(2).standard_normal(
            tokens.shape + (8,)).astype(np.float32)
    ref_out, ref_mask = jlm(sample, jtok)
    got_out, got_mask = lm(sample, tok)
    if ref_mask is None:
        assert got_mask is None
    else:
        np.testing.assert_array_equal(to_np(got_mask), np.asarray(ref_mask))
        assert float(got_mask.min()) == 0.0  # the captions were padded
    assert got_out.shape == ref_out.shape and got_out.dtype == torch.float32
    if mode in ("categorical", "precomputed"):
        np.testing.assert_array_equal(to_np(got_out), np.asarray(ref_out))
    else:
        assert rel_err(to_np(got_out), np.asarray(ref_out)) <= T5_TOL
        # padded positions are zeroed
        assert float(got_out[got_mask == 0].abs().max()) == 0.0
