"""The port's data plane and reader against the JAX package's, on the CPU.

- The C++ data plane (``ml_mdm_tpu_torch/native``, the port's own copy of
  ``datacore.cpp``, built into ``ml_mdm_tpu_torch/_build/``): token ids of
  every caption of the prompt files under ``data/`` with ``data/t5.vocab``,
  equal to the JAX library's and (on every 7th caption) to the Python
  search, with and without scores; tar members byte for byte, with PAX and
  GNU long names; ``decode_resize_crop`` bitwise equal to the JAX library's
  on the fixture JPEGs, centre and random crops per seed; a corrupt JPEG
  gives None.
- The reader (``get_dataset_partition``): with one worker the batches equal
  the JAX reader's key by key (uint8 images bitwise, tokens, captions, the
  other columns, ``state`` among them, and ``load_numpy``'s embeddings
  bitwise), over partitions 0 and 1 of 2 of an index of three shards with
  ``num_kept_files`` 2, the shuffle buffer, random crops, the long-token
  filter and a PNG member (PIL's route); on the PIL route alone (the native
  decode off in both packages) too, and with neither library loaded (tar
  members through ``tarfile``, tokens through the Python search, every
  image through PIL). These and the 4-reader and ``close`` tests run where
  the libraries do not build. With one worker the JAX pipeline's order
  is fixed; with several it depends on its threads, so with 4 readers the
  batches hold the same multiset of captions as with one.
"""
import glob
import io
import os
import tarfile

import numpy as np
import pytest
import torch

from ml_mdm_tpu import reader as jreader
from ml_mdm_tpu.language_models import tokenizer as jtok
from ml_mdm_tpu.native import image as jimage
from ml_mdm_tpu.native import tar as jtar
from ml_mdm_tpu.native import trie_tokenizer as jtrie
from ml_mdm_tpu_torch import native
from ml_mdm_tpu_torch import reader
from ml_mdm_tpu_torch.language_models import tokenizer as ptok
from ml_mdm_tpu_torch.native import image as pimage
from ml_mdm_tpu_torch.native import tar as ptar
from ml_mdm_tpu_torch.native import trie_tokenizer as ptrie

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TAR = os.path.join(HERE, "test_files", "images_00000.tar")
TSV = os.path.join(HERE, "test_files", "images_00000.tsv")
VOCAB = os.path.join(HERE, "test_files", "tiny_t5.vocab")


@pytest.fixture(scope="module")
def lib():
    """The port's library, built from its own source into its build
    directory (the JAX one is built beside its source)."""
    if not native.available():
        pytest.skip(f"the native data plane did not build here: {native.build_report()}")
    from ml_mdm_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's native data plane did not build here")
    return native.load()


def test_library_is_the_ports_own(lib):
    path = os.path.realpath(lib._name)
    assert path.startswith(str(native.BUILD_DIR) + os.sep), path
    assert os.path.basename(path).startswith("libdatacore_")
    assert "ml_mdm_tpu" + os.sep + "native" not in path
    report = native.build_report()
    assert report["path"] == str(native.library_path())


def _captions():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "data", "prompts_*.tsv"))):
        with open(path, encoding="utf-8") as f:
            next(f)
            out += [" " + line.rstrip("\n") + " " for line in f if line.strip()]
    return out


@pytest.fixture(scope="module")
def t5_vocab():
    vocab = os.path.join(REPO, "data", "t5.vocab")
    return ptok.Tokenizer(vocab, mode="t5"), jtok.Tokenizer(vocab, mode="t5")


def test_token_ids_match_jax_on_the_prompt_files(lib, t5_vocab):
    pt, jt = t5_vocab
    nat = ptrie.NativeTokenizer(pt.trie, pt.trie_key_scores)
    jnat = jtrie.NativeTokenizer(jt.trie, jt.trie_key_scores)
    captions = _captions()
    assert len(captions) > 6000
    for i, text in enumerate(captions):
        for scores in (True, False):
            ids = nat.tokenize_shortest(text, use_scores=scores)
            assert ids == jnat.tokenize_shortest(text, use_scores=scores), text
            if i % 7 == 0:
                py = ptok.tokenize_shortest(pt.trie, text,
                                            pt.trie_key_scores if scores else None)
                assert ids == py, text
        assert pt.tokenize_shortest(text) == jt.tokenize_shortest(text)
    assert pt._native  # the Tokenizer answered through the C++ trie


def test_tokenizer_falls_back_to_the_python_search(monkeypatch):
    """Where the library is unavailable the Tokenizer runs the Python
    search, with the same ids."""
    monkeypatch.setattr(native, "load", lambda: None)
    tok = ptok.Tokenizer(VOCAB, mode="t5")
    ref = jtok.Tokenizer(VOCAB, mode="t5")
    for text in (" a red circle on blue background ", " unknown€ bytes ", ""):
        assert tok.tokenize_shortest(text) == ref.tokenize_shortest(text)
    assert tok._native is False


def _tar_cases(tmp_path):
    long_pax = "dir/" + "x" * 150 + "/image_é.jpg"
    long_gnu = "g/" + "y" * 140 + ".jpg"
    paths = []
    for fmt, names in ((tarfile.PAX_FORMAT, [long_pax, "short.jpg"]),
                       (tarfile.GNU_FORMAT, [long_gnu, "s2.bin"])):
        path = tmp_path / f"{fmt}.tar"
        with tarfile.open(path, "w", format=fmt) as tf:
            for i, name in enumerate(names):
                payload = bytes(range(256)) * (i + 3) + name.encode()
                info = tarfile.TarInfo(name=name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
        paths.append(str(path))
    return [TAR] + paths


def test_tar_members_byte_for_byte(lib, tmp_path):
    for path in _tar_cases(tmp_path):
        nt, jt = ptar.NativeTar(path), jtar.NativeTar(path)
        with tarfile.open(path) as tf:
            members = [m for m in tf.getmembers() if m.isfile()]
            assert members
            for m in members:
                expected = tf.extractfile(m).read()
                assert nt.read(m.name) == expected, m.name
                assert jt.read(m.name) == expected, m.name
        assert nt.read("no/such/member.jpg") is None
    with pytest.raises(FileNotFoundError):
        ptar.NativeTar(str(tmp_path / "missing.tar"))


def _jpegs():
    with tarfile.open(TAR) as tf:
        return [tf.extractfile(m).read() for m in tf.getmembers() if m.isfile()]


@pytest.mark.parametrize("side,crop", [(40, 40), (16, 16), (48, 32), (64, 64), (20, 12)])
def test_decode_resize_crop_bitwise(lib, side, crop):
    for data in _jpegs():
        got = pimage.decode_resize_crop(data, side, crop)
        assert got is not None and got.shape == (crop, crop, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jimage.decode_resize_crop(data, side, crop))
        for seed in (1, 7, 2**40 + 3):
            got = pimage.decode_resize_crop(data, side, crop, random_crop=True, seed=seed)
            np.testing.assert_array_equal(
                got, jimage.decode_resize_crop(data, side, crop, random_crop=True, seed=seed))
            again = pimage.decode_resize_crop(data, side, crop, random_crop=True, seed=seed)
            np.testing.assert_array_equal(got, again)


def test_decode_is_close_to_pil(lib):
    """The native route's geometry is PIL's: the same libjpeg decode and the
    same antialiased triangle filter, so only rounding differs (the JAX
    test's bound)."""
    for data in _jpegs():
        out = pimage.decode_resize_crop(data, smaller_side=40, crop=40)
        img = reader._crop(reader._resize_smallest_side(reader._load_image(data), 40), 40,
                           False, np.random.default_rng(0))
        diff = np.abs(out.astype(int) - np.asarray(img, dtype=np.uint8).astype(int))
        assert diff.max() <= 2 and diff.mean() < 1.0, (diff.max(), diff.mean())


def test_corrupt_jpeg_gives_none(lib):
    data = _jpegs()[0]
    assert pimage.decode_resize_crop(b"\xff\xd8\xff" + b"\x00" * 100, 40, 40) is None
    truncated = pimage.decode_resize_crop(data[: len(data) // 2], 40, 40)
    ref = jimage.decode_resize_crop(data[: len(data) // 2], 40, 40)
    assert (truncated is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(truncated, ref)
    assert pimage.decode_resize_crop(b"\x89PNG\r\n", 40, 40) is None  # not a JPEG


# -- the reader ----------------------------------------------------------------


def _rows():
    with open(TSV) as f:
        header = f.readline().rstrip("\n").split("\t")
        return [dict(zip(header, line.rstrip("\n").split("\t"))) for line in f]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three shard TSVs (extra columns ``state`` and ``watermark_score``,
    an embedding tar for ``load_numpy``, one PNG member) and an index of
    them, in a temporary directory; shard paths relative to the index."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("reader")
    rows = _rows()
    rng = np.random.default_rng(0)
    png = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)).save(png, "PNG")
    img_tar = tmp / "extra.tar"
    with tarfile.open(img_tar, "w", format=tarfile.USTAR_FORMAT) as tf:
        info = tarfile.TarInfo("picture.png")
        info.size = len(png.getvalue())
        tf.addfile(info, io.BytesIO(png.getvalue()))
    text_tar = tmp / "text.tar"
    with tarfile.open(text_tar, "w") as tf:
        for i in range(len(rows) + 1):
            buf = io.BytesIO()
            np.save(buf, rng.normal(size=(3 + i % 4, 16)).astype(np.float32))
            info = tarfile.TarInfo(f"emb_{i:04d}.npy")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
    rows = rows + [dict(tar=str(img_tar), file="picture.png",
                        caption="a png of noise in a long caption with many words here")]
    shards = []
    for s in range(3):
        path = tmp / f"shard_{s}.tsv"
        with open(path, "w") as f:
            f.write("tar\tfile\tcaption\tstate\twatermark_score\ttext_tar\ttext_file\n")
            for i, row in enumerate(rows):
                if i % 3 == s:
                    tar = row["tar"] if os.path.isabs(row["tar"]) else os.path.join(REPO, row["tar"])
                    f.write(f"{tar}\t{row['file']}\t{row['caption']}\t{40 + i}\t0.{i}"
                            f"\t{text_tar}\temb_{i:04d}.npy\n")
        shards.append(path.name)
    index = tmp / "index.tsv"
    with open(index, "w") as f:
        f.write("filename\n" + "".join(s + "\n" for s in shards))
    return str(index)


def _configs(pkg, **kw):
    base = dict(image_size=16, smaller_side_size=20, max_token_length=9, num_readers=1,
                reader_buffer_size=4, shuffle_buffer_size=3, num_kept_files=2,
                random_crop=True)
    base.update(kw)
    return pkg.ReaderConfig(**base)


def _batches(pkg, tok, index, partition, n, cfg, load_numpy=True, batch_size=2):
    ds = pkg.get_dataset_partition(partition, n, tok, batch_size, index, cfg, num_epochs=2,
                                   load_numpy=load_numpy, is_index_file=True)
    try:
        return list(ds), ds
    finally:
        ds.close()


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) and got
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("partition", [0, 1])
def test_reader_batches_equal_jax(lib, dataset, partition):
    tok, jt = ptok.Tokenizer(VOCAB, mode="t5"), jtok.Tokenizer(VOCAB, mode="t5")
    got, ds = _batches(reader, tok, dataset, partition, 2, _configs(reader))
    ref, _ = _batches(jreader, jt, dataset, partition, 2, _configs(jreader))
    _assert_batches_equal(got, ref)
    keys = set(got[0])
    assert {"image", "tokens", "caption", "state", "watermark_score", "text_embedding"} <= keys
    assert got[0]["image"].shape == (2, 16, 16, 3)
    # the long caption's tokens pass max_token_length 9 nowhere
    captions = {reader.convert(c) for b in got for c in b["caption"]}
    assert not any(c.startswith("a png") for c in captions)
    # the PNG member, decoded by PIL before the token filter drops it
    assert ds.decodes["native"] > 0 and ds.decodes["pil"] in (0, 2)


def test_reader_pil_route_equals_jax(dataset, monkeypatch):
    """The native decode off in both packages (as where it does not
    build): PIL with the same geometry and the same random crops."""
    monkeypatch.setattr(pimage, "decode_resize_crop", lambda *a, **k: None)
    monkeypatch.setattr(jimage, "decode_resize_crop", lambda *a, **k: None)
    tok, jt = ptok.Tokenizer(VOCAB, mode="t5"), jtok.Tokenizer(VOCAB, mode="t5")
    kw = dict(max_token_length=16, num_kept_files=-1, shuffle_buffer_size=0)
    got, ds = _batches(reader, tok, dataset, 0, 1, _configs(reader, **kw), load_numpy=False)
    ref, _ = _batches(jreader, jt, dataset, 0, 1, _configs(jreader, **kw), load_numpy=False)
    _assert_batches_equal(got, ref)
    assert ds.decodes["native"] == 0 and ds.decodes["pil"] == 2 * 11  # two epochs


def test_reader_without_the_library_equals_jax(dataset, monkeypatch):
    """Neither package's library loads (as on a machine without
    ``jpeglib.h``): the tar members through ``tarfile``, the tokens through
    the Python search and every image through PIL, equal to the JAX
    reader's batches."""
    from ml_mdm_tpu import native as jnative

    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(jnative, "load", lambda: None)
    tok, jt = ptok.Tokenizer(VOCAB, mode="t5"), jtok.Tokenizer(VOCAB, mode="t5")
    kw = dict(max_token_length=16, num_kept_files=-1)
    got, ds = _batches(reader, tok, dataset, 1, 2, _configs(reader, **kw))
    ref, _ = _batches(jreader, jt, dataset, 1, 2, _configs(jreader, **kw))
    _assert_batches_equal(got, ref)
    assert ds.decodes["native"] == 0 and ds.decodes["pil"] > 0
    assert tok._native is False


def test_reader_png_member_takes_pil(lib, dataset):
    tok = ptok.Tokenizer(VOCAB, mode="t5")
    kw = dict(max_token_length=16, num_kept_files=-1, shuffle_buffer_size=0)
    got, ds = _batches(reader, tok, dataset, 0, 1, _configs(reader, **kw), load_numpy=False)
    jt = jtok.Tokenizer(VOCAB, mode="t5")
    ref, _ = _batches(jreader, jt, dataset, 0, 1, _configs(jreader, **kw), load_numpy=False)
    _assert_batches_equal(got, ref)
    assert ds.decodes == {"native": 2 * 10, "pil": 2 * 1}


def test_reader_four_workers_same_captions(dataset):
    tok = ptok.Tokenizer(VOCAB, mode="t5")
    kw = dict(random_crop=False, max_token_length=16)
    one, _ = _batches(reader, tok, dataset, 0, 1, _configs(reader, **kw))
    four, _ = _batches(reader, tok, dataset, 0, 1, _configs(reader, num_readers=4, **kw))

    def captions(batches):
        return sorted(reader.convert(c) for b in batches for c in b["caption"])

    assert captions(four) == captions(one)
    assert sum(len(b["caption"]) for b in one) > 8


def test_get_dataset_matches_jax(lib):
    tok, jt = ptok.Tokenizer(VOCAB, mode="t5"), jtok.Tokenizer(VOCAB, mode="t5")
    kw = dict(image_size=24, smaller_side_size=24, max_token_length=32, num_readers=1,
              reader_buffer_size=4, shuffle_buffer_size=4)
    ds = reader.get_dataset(tok, 3, TSV, reader.ReaderConfig(**kw), num_epochs=1)
    got = list(ds)
    ref = list(jreader.get_dataset(jt, 3, TSV, jreader.ReaderConfig(**kw), num_epochs=1))
    _assert_batches_equal(got, ref)
    assert [len(b["caption"]) for b in got] == [3, 3, 3, 1]  # the ragged last batch


def test_reader_close_stops_workers():
    tok = ptok.Tokenizer(VOCAB, mode="t5")
    cfg = reader.ReaderConfig(image_size=16, smaller_side_size=16, max_token_length=32,
                              num_readers=4, reader_buffer_size=2, shuffle_buffer_size=0)
    ds = reader.get_dataset(tok, 2, TSV, cfg, num_epochs=-1)
    it = iter(ds)
    next(it)
    ds.close()
    for t in ds._threads:
        t.join(timeout=10)
        assert not t.is_alive()
