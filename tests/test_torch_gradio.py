"""The port's Gradio app (``clis/generate_sample.py`` ``build_gradio_app``,
``serve_gradio`` and ``main``'s choice) on the CPU, without Gradio: a stub
``gradio`` module in ``sys.modules`` (context-manager ``Blocks`` and
``Row``, components that record their arguments, ``click`` that records
``fn``, ``inputs`` and ``outputs``, ``queue``/``launch`` that record their
call). Through it: the component surface of the JAX package's app, its Run
button wired to ``run``, and ``run`` driven as a generator as
tests/test_generate_sample.py drives the JAX one (a preview a step, then the
final image with its logSNR pane); ``main`` serves Gradio with the module
and the built-in page without it.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

from ml_mdm_tpu_torch.clis import generate_sample as gs
from ml_mdm_tpu_torch.config import get_arguments

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(HERE, "test_files", "tiny_train.yaml")


class _Component:
    def __init__(self, kind, log, *args, **kwargs):
        self.kind, self.args, self.kwargs = kind, args, kwargs
        log.append(self)

    def click(self, fn=None, inputs=None, outputs=None, **kwargs):
        self.clicked = dict(fn=fn, inputs=inputs, outputs=outputs, **kwargs)
        return ("event", self)


class _Context(_Component):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def queue(self, **kwargs):
        self.queued = kwargs
        return self

    def launch(self, **kwargs):
        self.launched = kwargs


def _stub_gradio():
    mod = types.ModuleType("gradio")
    mod.log = []
    for name in ("Markdown", "Dropdown", "Textbox", "Slider", "Number", "Checkbox", "Button",
                 "Image", "Video"):
        setattr(mod, name, lambda *a, _n=name, **k: _Component(_n, mod.log, *a, **k))
    for name in ("Blocks", "Row"):
        setattr(mod, name, lambda *a, _n=name, **k: _Context(_n, mod.log, *a, **k))
    return mod


@pytest.fixture
def gradio(monkeypatch):
    mod = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", mod)
    return mod


def _args():
    args = get_arguments(["--config_path", YAML, "--device", "cpu"], mode="demo")
    args.model_file = ""
    return args


def test_components_and_run_generator(gradio):
    demo, run = gs.build_gradio_app(_args())
    kinds = [c.kind for c in gradio.log]
    assert demo.kind == "Blocks" and kinds.count("Row") == 7
    labels = {c.kwargs.get("label") for c in gradio.log}
    assert {"Config", "Checkpoint", "Prompt", "Negative prompt", "Style", "Batch", "Guidance",
            "Threshold", "Steps", "DDIM eta", "Seed", "Output image", "Diffusion path",
            "System output", "Noise schedule (logSNR)"} <= labels
    buttons = {c.kwargs["value"]: c for c in gradio.log if c.kind == "Button"}
    assert set(buttons) == {"Run", "Stop"}
    wired = buttons["Run"].clicked
    assert wired["fn"] is run and len(wired["inputs"]) == 15 and len(wired["outputs"]) == 4
    assert buttons["Stop"].clicked["cancels"] == [("event", buttons["Run"])]
    outs = list(run(YAML, "", "a cat", "", "none", 1, 1.0, "CLIP", 3, 0.0, 7, True, False,
                    False, False))
    assert len(outs) == 4  # 3 previews and the final image
    for img, snr, text, video in outs[:-1]:
        assert img.dtype == np.uint8 and snr is None and video is None and "Step" in text
    img, snr, text, video = outs[-1]
    assert img.dtype == np.uint8 and img.std() > 0
    assert snr is not None and snr.dtype == np.uint8
    assert "Done" in text and video is None
    np.testing.assert_array_equal(img, outs[-2][0])  # the last preview is the final grid


def test_main_serves_gradio_with_the_module(gradio, monkeypatch):
    served = []
    monkeypatch.setattr(gs, "serve_builtin", lambda args: served.append("builtin"))
    args = _args()
    args.port = 7861
    gs.main(args)
    blocks = next(c for c in gradio.log if c.kind == "Blocks")
    assert served == [] and blocks.launched == {"server_name": "0.0.0.0", "server_port": 7861}
    assert blocks.queued == {"default_concurrency_limit": 1}


def test_main_serves_the_builtin_page_without_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    served = []
    monkeypatch.setattr(gs, "serve_builtin", lambda args: served.append("builtin"))
    monkeypatch.setattr(gs, "serve_gradio", lambda args: served.append("gradio"))
    gs.main(_args())
    assert served == ["builtin"]
