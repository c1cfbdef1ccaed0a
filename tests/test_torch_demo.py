"""The port's web demo path on the CPU: ``config.get_arguments`` against the
JAX package's for every shipped YAML and mode, field by field; ``.pth``
vision checkpoints written by either package and loaded by the other;
``helpers.select_platform``; ``generate`` streamed and final, ``run_demo``
and the built-in HTTP server's ``/choices``, its server-sent events and its
JSON answer on tests/test_files/tiny_train.yaml with ``--device cpu``
(mirroring tests/test_generate_sample.py).

Tolerances: namespaces equal field by field (``--device`` defaults to cuda
in the port, tpu in the JAX package); a checkpoint loaded across packages
gives outputs within 1e-6 max-abs (the same f32 weights; the U-Nets agree
to 5e-4 * max|ref| as tests/test_torch_unet.py holds, so each side is
compared with its own forward before the save); images of the stream and
of the plain call bitwise equal (the same loop at eta 0).
"""
import dataclasses
import enum
import glob
import io
import json
import os
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.config import get_arguments as jax_get_arguments
from ml_mdm_tpu.utils import checkpoint as jckpt
from ml_mdm_tpu_torch import helpers
from ml_mdm_tpu_torch.clis import generate_sample as gs
from ml_mdm_tpu_torch.config import get_arguments
from ml_mdm_tpu_torch.utils import checkpoint
from ml_mdm_tpu_torch.utils.convert import params_from_jax
from torch_parity import LM_LEN, tiny_pair, to_np

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "tests", "test_files", "tiny_train.yaml")
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs/models/*.yaml"))
               + glob.glob(os.path.join(REPO, "tests/test_files/*.yaml")))
MODES = ["trainer", "sampler", "evaluator", "demo"]


def _plain(v):
    """Config dataclasses as nested dicts, enums as their names."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return str(v) if isinstance(v, enum.Enum) else v


def _assert_same_namespace(got, ref):
    g, r = vars(got), vars(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        if k == "device":
            assert (g[k], r[k]) == ("cuda", "tpu")
        else:
            assert _plain(g[k]) == _plain(r[k]), k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_get_arguments_matches_jax(path, mode):
    cli = ["--config_path", path]
    _assert_same_namespace(get_arguments(cli, mode=mode), jax_get_arguments(cli, mode=mode))


@pytest.mark.parametrize("extra", [
    ["--reader_config.max_token_length", "64", "--batch-size", "7", "--seed=3"],
    ["--unet_config.resnet_config.num_groups_norm=16", "--diffusion_config.sampler_config."
     "num_diffusion_steps", "40", "--diffusion_config.use_vdm_loss_weights", "true",
     "--unet_config.resolution_channels", "[8, 16]", "--model", "unet"],
])
def test_get_arguments_overrides_match_jax(extra):
    cli = ["--config_path", os.path.join(REPO, "configs/models/cc12m_256x256.yaml"),
           "--device", "cpu"] + extra
    got, ref = get_arguments(cli, mode="trainer"), jax_get_arguments(cli, mode="trainer")
    assert sorted(vars(got)) == sorted(vars(ref))
    for k in vars(ref):
        assert _plain(getattr(got, k)) == _plain(getattr(ref, k)), k


def test_select_platform():
    assert helpers.select_platform(SimpleNamespace(device="cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert helpers.select_platform(SimpleNamespace(device="cuda")).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            helpers.select_platform(SimpleNamespace(device="cuda"))


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=6, fast_init=True)


def _forward_inputs(lm_dim, side):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
    lm = rng.standard_normal((2, LM_LEN, lm_dim)).astype(np.float32)
    return x, np.array([3, 700], np.int32), lm, np.ones((2, LM_LEN), np.float32)


def _port_forward(unet, inputs):
    x, t, lm, mask = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        return to_np(unet(x, t.long(), lm, mask, {}))


def _fresh(unet):
    return type(unet)(3, 3, unet.config).eval()


def test_pth_from_jax_loads_into_the_port(pair, tmp_path):
    """A ``.pth`` of other weights written by the JAX ``save_vision_model``
    gives the port the tensors of ``params_from_jax``: outputs equal to the
    strictly loaded module's, and to JAX's own within the U-Net's 5e-4."""
    jpipe, params, pipe, lm_dim, side = pair
    inputs = _forward_inputs(lm_dim, side)
    other = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5, params)
    path = str(tmp_path / "vis_model.pth")
    jckpt.save_vision_model(path, other, {"batch_num": 7})
    unet = _fresh(pipe.vision_module)
    unet.load_state_dict(pipe.vision_module.state_dict())
    before = _port_forward(unet, inputs)
    _, items = checkpoint.load_vision_model(path, unet)
    assert items["batch_num"] == 7
    strict = _fresh(unet)
    strict.load_state_dict(params_from_jax(other), strict=True)
    for k, v in strict.state_dict().items():
        assert torch.equal(unet.state_dict()[k], v), k
    got = _port_forward(unet, inputs)
    assert np.abs(got - before).max() > 1e-3
    np.testing.assert_allclose(got, _port_forward(strict, inputs), rtol=0, atol=1e-6)
    ref = np.asarray(jpipe.vision_module.apply({"params": other}, *map(jnp.asarray, inputs), {}))
    assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max()


def test_pth_from_the_port_loads_into_jax(pair, tmp_path):
    jpipe, params, pipe, lm_dim, side = pair
    inputs = _forward_inputs(lm_dim, side)
    unet = pipe.vision_module
    path = str(tmp_path / "port.pth")
    checkpoint.save_vision_model(path, unet, {"loss": 0.5})
    template = jax.tree_util.tree_map(np.zeros_like, params)
    loaded, items = jckpt.load_vision_model(path, template)
    assert items["loss"] == 0.5
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-6)
    ref = np.asarray(jpipe.vision_module.apply({"params": loaded}, *map(jnp.asarray, inputs), {}))
    want = np.asarray(jpipe.vision_module.apply({"params": params}, *map(jnp.asarray, inputs), {}))
    np.testing.assert_allclose(ref, want, rtol=0, atol=1e-6)


def test_pth_load_is_non_strict(pair, tmp_path, caplog):
    _, params, pipe, _, _ = pair
    unet = pipe.vision_module
    sd = {k: v.clone() for k, v in unet.state_dict().items()}
    dropped = "conv_in.weight"
    kept = "conv_out.weight"
    want = sd[kept] + 1.0
    sd[kept] = want
    del sd[dropped]
    sd["not.a.key"] = torch.zeros(3)
    path = str(tmp_path / "partial.pth")
    torch.save({"state_dict": sd}, path)
    before = unet.state_dict()[dropped].clone()
    checkpoint.load_vision_model(path, unet)
    assert torch.equal(unet.state_dict()[kept], want)
    assert torch.equal(unet.state_dict()[dropped], before)
    assert "not.a.key" in caplog.text and dropped in caplog.text
    with pytest.raises(ValueError, match="directory"):
        checkpoint.load_vision_model(str(tmp_path), unet)
    with pytest.raises(ValueError, match=".pth"):
        checkpoint.save_vision_model(str(tmp_path / "ckpt"), unet)


def _demo_args(**kw):
    args = get_arguments(["--config_path", YAML, "--device", "cpu"], mode="demo")
    args.model_file = ""
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def models():
    return gs.setup_models(_demo_args())


def test_setup_models(models):
    pipe = models["pipeline"]
    assert models["device"] == torch.device("cpu") and models["image_side"] == 16
    assert models["language_model"].embed_dim == 16
    assert pipe.vision_module.config.conditioning_feature_dim == 16
    assert all(p.dtype == torch.float32 for p in pipe.vision_module.parameters())


def test_generate_final_and_stream(models):
    kw = dict(negative_prompt="low quality", batch_size=2, guidance_scale=2.0,
              num_inference_steps=4, seed=3)
    grid, info = gs.generate(models, "a bird on a branch", **kw)
    assert grid.ndim == 3 and grid.shape[-1] == 3 and np.isfinite(grid).all()
    assert grid.min() >= -1.0 and grid.max() <= 1.0 and grid.std() > 0
    assert info["steps"] == 4 and len(info["gammas"]) > 0
    steps = list(gs.generate(models, "a bird on a branch", stream=True, show_xt=True, **kw))
    assert len(steps) == 4
    snrs = [info["logsnr"] for _, info in steps]
    assert snrs[-1] > snrs[0]
    np.testing.assert_array_equal(steps[-1][0], grid)
    other, _ = gs.generate(models, "a bird on a branch", **dict(kw, seed=4))
    assert not np.array_equal(other, grid)


def test_threshold_is_read_at_each_call(models):
    kw = dict(batch_size=1, guidance_scale=1.0, num_inference_steps=2, seed=1)
    a, _ = gs.generate(models, "a cat", threshold_function="NONE", **kw)
    assert models["pipeline"].sampler.config.threshold_function.name == "NONE"
    b, _ = gs.generate(models, "a cat", threshold_function="CLIP", **kw)
    assert models["pipeline"].sampler.config.threshold_function.name == "CLIP"
    assert a.shape == b.shape


def test_run_demo_events(models, tmp_path):
    events = list(gs.run_demo(models, "a cat", batch_size=1, guidance_scale=1.0,
                              num_inference_steps=3, show_diffusion_path=True,
                              save_diffusion_path=True, seed=1, anim_dir=str(tmp_path)))
    assert [e["kind"] for e in events] == ["preview"] * 3 + ["final"]
    fin = events[-1]
    assert fin["image"].dtype == np.uint8
    assert fin["video_path"] and os.path.exists(fin["video_path"])
    fast = list(gs.run_demo(models, "a dog", batch_size=1, guidance_scale=1.0,
                            num_inference_steps=2))
    assert [e["kind"] for e in fast] == ["final"] and fast[0]["video_path"] is None
    assert gs.STYLE_TEMPLATES["photo"].format(prompt="x").startswith("a photograph of x")


def _sse(resp):
    events, buf = [], b""
    while True:
        chunk = resp.read(4096)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            if frame.startswith(b"data: "):
                events.append(json.loads(frame[6:]))
    return events


def _png(b64):
    import base64

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_builtin_server_choices_stream_and_json():
    server = gs.make_builtin_server(_demo_args(), port=0)
    url = f"http://127.0.0.1:{server.server_port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        page = urllib.request.urlopen(url + "/", timeout=60).read()
        assert b"<form" in page
        ch = json.loads(urllib.request.urlopen(url + "/choices", timeout=60).read())
        assert any(c.endswith(".yaml") for c in ch["configs"])
        q = ("prompt=a+cat&negative_prompt=blurry&batch_size=2&guidance_scale=2.0"
             "&num_inference_steps=3&seed=0")
        resp = urllib.request.urlopen(f"{url}/generate?{q}&stream=1&save_path=1", timeout=600)
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        events = _sse(resp)
        kinds = [e["kind"] for e in events]
        assert kinds.count("preview") >= 2 and kinds[-1] == "final", kinds
        fin = events[-1]
        assert fin.get("video_mime") in ("image/gif", "video/mp4")
        plain = json.loads(urllib.request.urlopen(f"{url}/generate?{q}", timeout=600).read())
        img = _png(plain["image"])
        assert img.dtype == np.uint8 and img.ndim == 3 and img.std() > 0
        np.testing.assert_array_equal(img, _png(fin["image"]))
        other = json.loads(urllib.request.urlopen(f"{url}/generate?{q[:-1]}5",
                                                  timeout=600).read())
        assert not np.array_equal(_png(other["image"]), img)
        missing = urllib.request.Request(url + "/nothing")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(missing, timeout=60)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
