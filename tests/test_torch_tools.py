"""The port's data tools against the JAX package's, on the CPU, on the same
inputs: ``s3_helpers``, ``clis/download_tar_from_index.py``,
``clis/scrape_cc12m.py``, ``clis/build_vocab.py`` and ``core.py``
(counterparts of tests/test_aux.py's s3, downloader, scraper and CLI-builder
tests and tests/test_tokenizer.py's ``build_vocab`` round trip).

- the outputs of ``download_tar_from_index`` (the rewritten index and the
  fetched shards, local and through ``s3://``), ``scrape_cc12m`` (parquet
  -> TSV -> split) and ``build_vocab --wordlist`` are byte-equal to the JAX
  tools' on the same inputs;
- ``build_vocab``'s ``tokenizer.json`` route equals the JAX tool's fast
  path (``AutoTokenizer`` without ``sp_model``: the vocabulary in id order,
  flat scores), for a Unigram and a WordPiece tokenizer; its
  ``spiece.model`` route reads a ``ModelProto`` built with protobuf's own
  classes (the pieces and scores a sentencepiece processor gives, the JAX
  slow path) exactly, and the parser reads a hand-encoded proto with
  multi-byte varints, every wire type and fields it skips;
- ``core.CLIBuilder`` and ``_parse_value`` equal the JAX ones;
- ``s3_helpers`` raise alike without ``boto3``, and list and download alike
  through one fake ``boto3`` module put into ``sys.modules`` for both
  packages; the inner warm start's ``s3://`` path is downloaded through it,
  once, into the JAX route's local file name, and a bare ``bucket/key``
  path takes the JAX route too, where ``parse_s3_path`` refuses it.
"""
import dataclasses
import filecmp
import json
import os
import struct
import sys
import types

import pytest
import torch

from ml_mdm_tpu import core as jcore
from ml_mdm_tpu import s3_helpers as js3
from ml_mdm_tpu.clis import build_vocab as jbuild_vocab
from ml_mdm_tpu.clis import download_tar_from_index as jdl
from ml_mdm_tpu.clis import scrape_cc12m as jscrape
from ml_mdm_tpu_torch import core, s3_helpers
from ml_mdm_tpu_torch.clis import build_vocab, download_tar_from_index, scrape_cc12m

torch.set_num_threads(1)


# -- s3_helpers --------------------------------------------------------------------


def test_parse_s3_path_and_shard_for_node():
    path = "s3://mlx/datasets/cc12m-64x64/images_001.tsv"
    assert s3_helpers.parse_s3_path(path) == js3.parse_s3_path(path) == (
        "mlx", "datasets/cc12m-64x64/images_001.tsv")
    for mod in (s3_helpers, js3):
        with pytest.raises(ValueError):
            mod.parse_s3_path("/local/path.tsv")
    paths = [f"p{i}" for i in range(10)]
    for n in range(3):
        assert s3_helpers.shard_for_node(paths, n, 3) == js3.shard_for_node(paths, n, 3)
    shards = [s3_helpers.shard_for_node(paths, n, 3) for n in range(3)]
    assert sorted(p for s in shards for p in s) == sorted(paths)
    assert not set(shards[0]) & set(shards[1])


def _raise(call):
    try:
        call()
    except RuntimeError as e:
        return str(e)
    raise AssertionError("no RuntimeError")


@pytest.mark.parametrize("call", ["expand", "download", "full_path", "many"])
def test_without_boto3_both_raise_alike(monkeypatch, tmp_path, call):
    monkeypatch.setitem(sys.modules, "boto3", None)  # import boto3 -> ImportError
    calls = {
        "expand": lambda m: m.expand_s3_pattern("s3://b/data/images_[0-9]+.tar"),
        "download": lambda m: m.download_object("b", "k", str(tmp_path / "x")),
        "full_path": lambda m: m.download_object_from_full_path("s3://b/k", str(tmp_path / "x")),
        "many": lambda m: m.download_many(["s3://b/k1"], str(tmp_path / "many")),
    }
    got, want = (_raise(lambda: calls[call](m)) for m in (s3_helpers, js3))
    assert got == want and "boto3 is not installed" in got


class _FakeS3:
    """A bucket of objects in memory, behind boto3's client calls."""

    def __init__(self, objects, log):
        self.objects, self.log = objects, log

    def client(self, name, endpoint_url=None):
        assert name == "s3"
        fake = self

        class Client:
            def download_file(self, bucket, key, path):
                fake.log.append((bucket, key, endpoint_url))
                with open(path, "wb") as f:
                    f.write(fake.objects[(bucket, key)])

            def get_paginator(self, op):
                assert op == "list_objects_v2"

                class Pages:
                    def paginate(self, Bucket, Prefix):
                        keys = sorted(k for b, k in fake.objects if b == Bucket
                                      and k.startswith(Prefix))
                        return [{"Contents": [{"Key": k} for k in keys[:2]]},
                                {"Contents": [{"Key": k} for k in keys[2:]]}]

                return Pages()

        return Client()


@pytest.fixture
def fake_boto3(monkeypatch):
    objects = {("bkt", f"data/shard_{i}.tar"): bytes([i]) * (100 + i) for i in range(4)}
    objects[("bkt", "data/readme.txt")] = b"not a shard"
    objects[("bkt", "ckpt/inner.pth")] = b"a checkpoint"
    log = []
    fake = _FakeS3(objects, log)
    module = types.ModuleType("boto3")
    module.client = fake.client
    monkeypatch.setitem(sys.modules, "boto3", module)
    return objects, log


def test_s3_through_a_fake_boto3_alike(fake_boto3, tmp_path):
    _, log = fake_boto3
    pattern = "s3://bkt/data/shard_[0-9]+.tar"
    assert s3_helpers.expand_s3_pattern(pattern) == js3.expand_s3_pattern(pattern) == [
        f"s3://bkt/data/shard_{i}.tar" for i in range(4)]
    for name, mod in (("port", s3_helpers), ("jax", js3)):
        one = mod.download_object_from_full_path("s3://bkt/data/shard_1.tar",
                                                 str(tmp_path / name / "sub" / "one.tar"),
                                                 endpoint_url="http://localhost:9000")
        many = mod.download_many([f"s3://bkt/data/shard_{i}.tar" for i in range(3)],
                                 str(tmp_path / name / "many"), num_workers=2)
        assert one == str(tmp_path / name / "sub" / "one.tar")
        assert many == [str(tmp_path / name / "many" / f"shard_{i}.tar") for i in range(3)]
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    for sub in ("sub", "many"):
        assert not filecmp.dircmp(tmp_path / "port" / sub, tmp_path / "jax" / sub).diff_files
    assert log.count(("bkt", "data/shard_1.tar", "http://localhost:9000")) == 2


def test_warm_start_s3_path_downloads_through_s3_helpers(fake_boto3, tmp_path, monkeypatch):
    """The JAX route: process 0 fetches the object once into the path with
    its slashes as underscores; the second call finds the file."""
    from ml_mdm_tpu_torch.utils import checkpoint as ckpt

    _, log = fake_boto3
    monkeypatch.chdir(tmp_path)
    local = ckpt._resolve_pretrained_path("s3://bkt/ckpt/inner.pth")
    assert local == "bkt_ckpt_inner.pth"
    with open(tmp_path / local, "rb") as f:
        assert f.read() == b"a checkpoint"
    assert ckpt._resolve_pretrained_path("s3://bkt/ckpt/inner.pth") == local
    assert log == [("bkt", "ckpt/inner.pth", None)]


def test_warm_start_bare_bucket_key_takes_the_jax_route(fake_boto3, tmp_path, monkeypatch):
    """A ``bucket/key`` path that is no local file goes to ``s3_helpers``
    as in the JAX package, whose ``parse_s3_path`` refuses it: the same
    ValueError from both, and nothing downloaded."""
    from ml_mdm_tpu.utils import checkpoint as jckpt
    from ml_mdm_tpu_torch.utils import checkpoint as ckpt

    _, log = fake_boto3
    monkeypatch.chdir(tmp_path)
    errors = []
    for mod in (ckpt, jckpt):
        with pytest.raises(ValueError, match="not an s3 path") as e:
            mod._resolve_pretrained_path("bkt/ckpt/inner.pth")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and log == []


# -- download_tar_from_index ---------------------------------------------------------


def _index(tmp_path, tars):
    index = tmp_path / "index.tsv"
    with open(index, "w") as f:
        f.write("tar\tfile\tcaption\n")
        for i, tar in enumerate(tars):
            f.write(f"{tar}\timg_{i}.jpg\tcap {i}\n")
            f.write(f"{tar}\timg_{i}b.jpg\tcap {i} again\n")
    return str(index)


@pytest.mark.parametrize("node", [0, 1])
def test_download_tar_from_index_local_matches_jax(tmp_path, node):
    src = tmp_path / "src"
    os.makedirs(src)
    for i in range(4):
        (src / f"shard_{i}.tar").write_bytes(bytes([i]) * (100 + i))
    index = _index(tmp_path, [f"{src}/shard_{i}.tar" for i in range(4)])
    outs = {}
    for name, mod in (("port", download_tar_from_index), ("jax", jdl)):
        outs[name] = mod.main(["--index-file", index, "--dest-dir", str(tmp_path / "dest"),
                               "--output-index", str(tmp_path / f"{name}.tsv"),
                               "--node-id", str(node), "--num-nodes", "2", "--num-workers", "2"])
    assert filecmp.cmp(outs["port"], outs["jax"], shallow=False)
    header, rows = download_tar_from_index.read_index(outs["port"])
    assert header == ["tar", "file", "caption"] and len(rows) == 4  # half the shards, 2 rows each
    for row in rows:
        assert row[0].startswith(str(tmp_path / "dest")) and os.path.exists(row[0])
        assert filecmp.cmp(row[0], src / os.path.basename(row[0]), shallow=False)


def test_download_tar_from_index_s3_matches_jax(fake_boto3, tmp_path):
    index = _index(tmp_path, [f"s3://bkt/data/shard_{i}.tar" for i in range(4)])
    for name, mod in (("port", download_tar_from_index), ("jax", jdl)):
        mod.main(["--index-file", index, "--dest-dir", str(tmp_path / name),
                  "--output-index", str(tmp_path / f"{name}.tsv"), "--num-workers", "3"])
    port = open(tmp_path / "port.tsv").read()
    assert port == open(tmp_path / "jax.tsv").read().replace(str(tmp_path / "jax"),
                                                             str(tmp_path / "port"))
    assert not filecmp.dircmp(tmp_path / "port", tmp_path / "jax").diff_files
    assert sorted(os.listdir(tmp_path / "port")) == [f"shard_{i}.tar" for i in range(4)]


def test_rate_limiter_caps_throughput():
    import time

    rl = download_tar_from_index.RateLimiter(bytes_per_sec=10000)
    t0 = time.monotonic()
    for _ in range(5):
        rl.consume(1000)  # 5 kB at 10 kB/s: >= ~0.4 s
    assert time.monotonic() - t0 >= 0.3
    t0 = time.monotonic()
    download_tar_from_index.RateLimiter(0).consume(10**9)  # no cap
    assert time.monotonic() - t0 < 0.1


# -- scrape_cc12m --------------------------------------------------------------------


def test_scraper_parquet_to_tsv_and_split_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    for name in ("port", "jax"):
        out = tmp_path / name
        os.makedirs(out)
        for shard in ("00000", "00001", "00002"):
            df = pd.DataFrame({"key": [f"{shard}{i}" for i in range(3)],
                               "caption": ["a cat", "tab\there", "new\nline"],
                               "status": ["success", "success", "failed"]})
            df.to_parquet(out / f"{shard}.parquet")
            (out / f"{shard}.tar").write_bytes(b"")
        df.to_parquet(out / "00003.parquet")  # no tar beside it: skipped
    port_tsvs = scrape_cc12m.convert_parquets(str(tmp_path / "port"))
    jax_tsvs = jscrape.convert_parquets(str(tmp_path / "jax"))
    assert len(port_tsvs) == len(jax_tsvs) == 3
    scrape_cc12m.split_index(str(tmp_path / "port"), validation_shards=1)
    jscrape.split_index(str(tmp_path / "jax"), validation_shards=1)
    for fname in [os.path.basename(t) for t in port_tsvs] + ["training.tsv", "validation.tsv"]:
        port = (tmp_path / "port" / fname).read_text()
        assert port == (tmp_path / "jax" / fname).read_text().replace(
            str(tmp_path / "jax"), str(tmp_path / "port")), fname
    lines = (tmp_path / "port" / "00000.tsv").read_text().splitlines()
    assert lines[0] == "tar\tfile\tcaption" and len(lines) == 3 and "tab here" in lines[2]
    assert (tmp_path / "port" / "training.tsv").read_text().count("\n") == 3


def test_scraper_main_split_stage_and_download_refusal(tmp_path):
    for name, mod in (("port", scrape_cc12m), ("jax", jscrape)):
        out = tmp_path / name
        os.makedirs(out)
        for shard in ("00000", "00001"):
            (out / f"{shard}.tsv").write_text("tar\tfile\tcaption\n")
        mod.main(["--output-dir", str(out), "--stage", "split", "--validation-shards", "1"])
    for fname in ("training.tsv", "validation.tsv"):
        assert (tmp_path / "port" / fname).read_text() == (tmp_path / "jax" / fname).read_text(
            ).replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    msgs = [_raise(lambda: mod.download("urls.tsv", str(tmp_path))) for mod in
            (scrape_cc12m, jscrape)]
    assert msgs[0] == msgs[1] and "img2dataset is not installed" in msgs[0]


# -- build_vocab ---------------------------------------------------------------------


def test_build_vocab_wordlist_matches_jax_and_loads(tmp_path):
    from ml_mdm_tpu_torch.language_models.tokenizer import Tokenizer

    words = tmp_path / "words.txt"
    words.write_text("cat\ndog\n\nbird\n  fish  \n")
    build_vocab.main(["--wordlist", str(words), "--output", str(tmp_path / "port.vocab")])
    jbuild_vocab.main(["--wordlist", str(words), "--output", str(tmp_path / "jax.vocab")])
    assert filecmp.cmp(tmp_path / "port.vocab", tmp_path / "jax.vocab", shallow=False)
    tok = Tokenizer(str(tmp_path / "port.vocab"), mode="t5")
    ids = tok.tokenize_shortest("cat dog")
    assert ids and all(isinstance(i, int) for i in ids)


def test_build_vocab_needs_exactly_one_source(tmp_path):
    for argv in ([], ["--wordlist", "w", "--tokenizer", "t"]):
        with pytest.raises(SystemExit):
            build_vocab.main(argv + ["--output", str(tmp_path / "x")])


def _fast_tokenizer_dir(path, kind):
    """A tokenizers ``tokenizer.json`` (Unigram with T5's specials first, or
    WordPiece) with added tokens, and a ``tokenizer_config.json`` naming the
    fast class, as AutoTokenizer loads it without a network."""
    from tokenizers import Tokenizer, models

    if kind == "unigram":
        pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0), ("▁a", -3.5),
                  ("▁cat", -4.25), ("s", -5.0), ("▁dog", -6.125)]
        tok = Tokenizer(models.Unigram(pieces, unk_id=2))
    else:
        vocab = {"[PAD]": 0, "[UNK]": 1, "cat": 2, "dog": 3, "##s": 4, "<unk>": 5, "a": 6}
        tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.add_special_tokens(["<extra_id_1>", "<extra_id_0>"])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)


@pytest.mark.parametrize("kind", ["unigram", "wordpiece"])
def test_build_vocab_tokenizer_json_matches_jax_fast_path(tmp_path, kind):
    path = str(tmp_path / kind)
    _fast_tokenizer_dir(path, kind)
    got, want = build_vocab.vocab_from_sentencepiece(path), jbuild_vocab.vocab_from_sentencepiece(
        path)
    assert got == want
    assert got[:3] == [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    build_vocab.main(["--tokenizer", path, "--output", str(tmp_path / "port.vocab")])
    jbuild_vocab.main(["--tokenizer", path, "--output", str(tmp_path / "jax.vocab")])
    assert filecmp.cmp(tmp_path / "port.vocab", tmp_path / "jax.vocab", shallow=False)


def test_spiece_model_parsed_as_sentencepiece_reads_it(tmp_path):
    """A ModelProto built with protobuf's classes (transformers' copy of
    sentencepiece_model.proto): the pieces and their f32 scores, in id
    order, what the JAX slow path reads through ``sp_model``."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.1),
              ("▁the", -3.3333333), ("é" * 70, -10.5), ("▁chat", -1e-7), ("x", 0.0)]
    for piece, score, *typ in pieces:
        p = m.pieces.add()
        p.piece = piece
        if score:
            p.score = score
        if typ:
            p.type = typ[0]
    m.trainer_spec.model_type = 1
    m.trainer_spec.vocab_size = len(pieces)
    m.normalizer_spec.name = "nmt_nfkc"
    m.normalizer_spec.add_dummy_prefix = True
    path = tmp_path / "t5"
    os.makedirs(path)
    (path / "spiece.model").write_bytes(m.SerializeToString())
    want = [(p.piece, p.score) for p in m.pieces]
    assert build_vocab.read_sentencepiece(str(path / "spiece.model")) == want
    rows = build_vocab.vocab_from_sentencepiece(str(path))
    assert rows == [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + want[3:]
    assert rows[4][1] == struct.unpack("<f", struct.pack("<f", -3.3333333))[0]


def _varint(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    key = _varint(num << 3 | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def test_spiece_parser_on_a_hand_encoded_proto(tmp_path):
    long_piece = "▁" + "ab" * 100  # a length of more than one varint byte
    piece_msgs = [
        _field(1, 2, "<pad>".encode()) + _field(3, 0, _varint(3)),
        _field(1, 2, long_piece.encode()) + _field(2, 5, struct.pack("<f", -7.25)),
        _field(2, 5, struct.pack("<f", 1.5)) + _field(1, 2, "▁x".encode())  # fields reordered
        + _field(9, 1, struct.pack("<d", 2.0)),  # an unknown fixed64 field, skipped
    ]
    data = (_field(2, 2, _field(3, 0, _varint(300)))  # trainer_spec, skipped
            + b"".join(_field(1, 2, p) for p in piece_msgs)
            + _field(3, 2, _field(1, 2, b"nmt_nfkc")))
    path = tmp_path / "spiece.model"
    path.write_bytes(data)
    assert build_vocab.read_sentencepiece(str(path)) == [("<pad>", 0.0), (long_piece, -7.25),
                                                         ("▁x", 1.5)]


def test_build_vocab_refuses_a_hub_name():
    with pytest.raises(FileNotFoundError, match="spiece.model"):
        build_vocab.vocab_from_sentencepiece("google/flan-t5-xl")


# -- core ----------------------------------------------------------------------------


@dataclasses.dataclass
class _Cfg:
    lr: float = 0.1
    name: str = "x"
    steps: int = 1
    flag: bool = False


@pytest.mark.parametrize("argv,default", [
    (["--steps", "7"], None),
    (["--config-file", "CFG", "--steps", "7", "--flag", "yes"], None),
    (["--config-file", "CFG"], _Cfg(lr=0.2, name="d", steps=3)),
    ([], _Cfg(lr=0.2, name="d", steps=3)),
])
def test_cli_builder_matches_jax(tmp_path, argv, default):
    cfgfile = tmp_path / "c.yaml"
    cfgfile.write_text("lr: 0.5\nname: from_yaml\nunknown: 1\n")
    argv = [str(cfgfile) if a == "CFG" else a for a in argv]
    captured = {}

    class Runner:
        def __init__(self, config):
            captured.setdefault("cfgs", []).append(config)

    core.CLIBuilder(class_to_call=Runner, config_class=_Cfg, default_config=default).run(argv)
    jcore.CLIBuilder(class_to_call=Runner, config_class=_Cfg, default_config=default).run(argv)
    port, jax = captured["cfgs"]
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    if "--steps" in argv:
        assert port.steps == 7
    if "CFG" in argv or str(cfgfile) in argv:
        assert port.lr == 0.5 and port.name == "from_yaml"


@pytest.mark.parametrize("ftype,raw", [("int", "7"), ("float", "0.5"), ("bool", "true"),
                                       ("bool", "No"), (int, "3"), (bool, "1"),
                                       ("SomethingElse", "x"), (str, "y")])
def test_parse_value_matches_jax(ftype, raw):
    got, want = core._parse_value(ftype, raw), jcore._parse_value(ftype, raw)
    assert got == want and type(got) is type(want)


def test_config_printer_prints(capsys):
    core.CLIBuilder().run([])
    assert capsys.readouterr().out.strip() == str(core.MDMConfig())
