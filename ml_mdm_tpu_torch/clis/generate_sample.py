"""The web demo of the port: caption to image, with streamed previews.

Counterpart of ``ml_mdm_tpu/clis/generate_sample.py``:

    python -m ml_mdm_tpu_torch.clis.generate_sample \\
        --config_path configs/models/cc12m_256x256.yaml --text-model <T5 dir>

serves a page on ``--port`` where a caption (with a negative prompt, a
style, guidance, threshold, steps, eta, seed and batch) becomes an image
grid: the port's tokenizer and T5 encoder turn the captions into text
features, and the pipeline of the config samples, previews streamed as
server-sent events while it runs, then the final grid with its logSNR
curve and, on request, an animation of the diffusion path. The vision
model is loaded from ``--model-file`` (a ``.pth``) or has seeded random
weights; ``--text-model`` is a local Hugging Face T5 directory or
``random:<width>``. It runs on ``--device`` (default cuda, which raises
without a card); the vision model computes in bf16 on the card (the hand
kernels' type), in f32 on the CPU unless ``--fp16``.

The server is the JAX package's built-in stdlib server, a
``ThreadingHTTPServer``. The loaded models and the module globals under
them (``models/layers.py`` ``cached_weights``, the kernels' launch
counters, the flash switch) are shared, so one lock serialises their use,
and each request samples under ``torch.no_grad()`` in its own thread
(grad mode is per thread). ``build_gradio_app`` is the JAX package's Gradio
app (the same components and the same ``run`` generator over ``run_demo``:
a preview a step, then the final image, the logSNR pane and the video);
``main`` serves it where ``import gradio`` succeeds, else the built-in
page, as the JAX ``main`` does. ``gradio`` is imported only there.
"""
from __future__ import annotations

import base64
import io
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ml_mdm_tpu_torch import helpers
from ml_mdm_tpu_torch.config import ThresholdType, get_arguments, get_model, get_pipeline
from ml_mdm_tpu_torch.diffusion import NestedDiffusion
from ml_mdm_tpu_torch.language_models import factory
from ml_mdm_tpu_torch.presets import build_unet
from ml_mdm_tpu_torch.reader import process_text
from ml_mdm_tpu_torch.utils.checkpoint import load_vision_model

_CACHE: Dict[str, Any] = {}
# serialises the use of the loaded models and of the module globals under
# them; re-entrant, since a request holding it may load a model
_LOCK = threading.RLock()

STYLE_TEMPLATES = {
    "none": "{prompt}",
    "photo": "a photograph of {prompt}, 4k, highly detailed",
    "painting": "an oil painting of {prompt}, masterpiece",
    "sketch": "a pencil sketch of {prompt}",
    "anime": "an anime drawing of {prompt}",
}


def setup_models(args) -> Dict[str, Any]:
    """Tokenizer, text tower, pipeline and image side for ``args`` on the
    device ``args.device`` names. The vision model's text width is the
    tower's; its weights come from ``args.model_file`` or from seed 0."""
    device = helpers.select_platform(args)
    tokenizer, language_model = factory.create_lm(args, device)
    args.unet_config.conditioning_feature_dim = language_model.embed_dim
    dtype = torch.bfloat16 if (device.type == "cuda" or args.fp16) else torch.float32
    vision_module = build_unet(get_model(args.model), args.unet_config, device, 0, dtype=dtype)
    if getattr(args, "model_file", None):
        load_vision_model(args.model_file, vision_module)
    pipeline = get_pipeline(args.model)(vision_module, args.diffusion_config)
    image_side = (args.sample_image_size if args.sample_image_size > 0
                  else (args.reader_config.image_size or 64))
    return dict(tokenizer=tokenizer, language_model=language_model, pipeline=pipeline,
                image_side=image_side, args=args, device=device)


def get_cached_models(config_path: str, model_file: Optional[str], device: str,
                      text_model: Optional[str] = None) -> Dict[str, Any]:
    """The models of a (config, checkpoint) pair on ``device``, one pair
    resident at a time; ``text_model`` replaces the config's."""
    key = f"{config_path}::{model_file}"
    with _LOCK:
        if key not in _CACHE:
            cli = ["--config_path", config_path, "--device", device]
            if model_file:
                cli += ["--model-file", model_file]
            if text_model:
                cli += ["--text-model", text_model]
            args = get_arguments(args=cli, mode="demo")
            args.model_file = model_file
            _CACHE.clear()
            _CACHE[key] = setup_models(args)
        return _CACHE[key]


def _grid(images: np.ndarray, pad: int = 2) -> np.ndarray:
    """Batch (B, H, W, C) in [-1, 1] -> one square-ish grid image."""
    b, h, w, c = images.shape
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    canvas = np.ones((rows * (h + pad) - pad, cols * (w + pad) - pad, c), np.float32)
    for i in range(b):
        r, cc = divmod(i, cols)
        canvas[r * (h + pad): r * (h + pad) + h, cc * (w + pad): cc * (w + pad) + w] = images[i]
    return canvas


def _to_uint8(arr_m1_1: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(arr_m1_1, np.float32) * 128.0 + 127.0, 0, 255).astype(np.uint8)


def plot_logsnr(logsnrs, total_steps: int):
    """The per-step logSNR curve as a uint8 RGB image, or None without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    x = 1 - np.arange(len(logsnrs)) / max(total_steps - 1, 1)
    fig, ax = plt.subplots(figsize=(5, 3.2), dpi=100)
    ax.plot(x[: len(logsnrs)], np.asarray(logsnrs))
    ax.set_xlabel("timesteps")
    ax.set_ylabel("LogSNR")
    ax.grid(True)
    ax.set_xlim(0, 1)
    ax.set_ylim(-20, 10)
    ax.invert_xaxis()
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def write_animation(frames, path_base: str, fps: int = 16):
    """The diffusion path as an mp4 (imageio with ffmpeg) or a GIF (PIL);
    returns the written path, or None."""
    if not frames:
        return None
    try:
        import imageio

        path = path_base + ".mp4"
        w = imageio.get_writer(path, fps=fps)
        for f in frames:
            w.append_data(f)
        w.close()
        return path
    except Exception:  # no imageio, or no ffmpeg backend: a GIF
        pass
    try:
        from PIL import Image
    except ImportError:
        return None
    path = path_base + ".gif"
    pil = [Image.fromarray(f) for f in frames]
    pil[0].save(path, save_all=True, append_images=pil[1:],
                duration=max(1000 // fps, 20), loop=0)
    return path


def _logsnr(g: float) -> float:
    return float(np.log(max(g, 1e-8) / max(1 - g, 1e-8)))


def generate(models: Dict[str, Any], prompt: str, negative_prompt: str = "",
             style: str = "none", batch_size: int = 4, guidance_scale: float = 7.5,
             threshold_function: str = "CLIP", num_inference_steps: int = 50,
             ddim_eta: float = 0.0, seed: int = 0, stream: bool = False,
             output_inner: bool = False, show_xt: bool = False):
    """Sample ``batch_size`` images of ``prompt``: returns (grid in [-1, 1],
    info), or with ``stream`` a generator of (grid, info) per step. With
    guidance the text rows are [negative x B; prompt x B]. The initial
    noise, then any step noise, come from a generator seeded with
    ``seed`` on the models' device, so at eta 0 the stream's last grid is
    computed as the plain call's is."""
    args = models["args"]
    pipeline = models["pipeline"]
    tokenizer = models["tokenizer"]
    device = models["device"]
    pipeline.sampler.config.threshold_function = ThresholdType.parse(threshold_function)
    prompt = STYLE_TEMPLATES.get(style, "{prompt}").format(prompt=prompt)
    use_cfg = guidance_scale != 1.0
    texts = [negative_prompt, prompt] if use_cfg else [prompt]
    if args.reader_config.max_token_length <= 0:
        args.reader_config.max_token_length = 128
    tokens = process_text(texts, tokenizer, args.reader_config)
    lm_outputs, lm_mask = models["language_model"]({"tokens": np.asarray(tokens)}, tokenizer)
    rows = [0, 1] if use_cfg else [0]
    sample = {
        "lm_outputs": torch.cat([lm_outputs[r:r + 1].repeat(batch_size, 1, 1) for r in rows]),
        "lm_mask": torch.cat([lm_mask[r:r + 1].repeat(batch_size, 1) for r in rows]),
    }
    generator = torch.Generator(device=device).manual_seed(seed)
    kwargs = dict(num_inference_steps=num_inference_steps, resample_steps=True,
                  ddim_eta=ddim_eta if ddim_eta >= 0 else None, guidance_scale=guidance_scale)
    if isinstance(pipeline, NestedDiffusion) and output_inner:
        kwargs["output_inner"] = True
    image_side = models["image_side"]

    def grid(x):
        return _grid(np.clip(x.float().cpu().numpy(), -1, 1))

    if stream:
        def it():
            t0 = time.time()
            frames = pipeline.sample_stream(batch_size, sample, image_side, generator, **kwargs)
            for step_i, (x0, x_t, (g, _)) in enumerate(frames):
                info = {"step": step_i, "logsnr": _logsnr(float(g)), "elapsed": time.time() - t0}
                yield grid(x_t if show_xt else x0), info
        return it()
    out = pipeline.sample(batch_size, sample, image_side, generator, **kwargs)
    gammas = pipeline.sampler.gammas.numpy()
    return grid(out), {"steps": num_inference_steps,
                       "gammas": gammas[:: max(len(gammas) // 50, 1)].tolist()}


def run_demo(models: Dict[str, Any], prompt: str, negative_prompt: str = "",
             style: str = "none", batch_size: int = 4, guidance_scale: float = 7.5,
             threshold_function: str = "CLIP", num_inference_steps: int = 50,
             ddim_eta: float = 0.0, seed: int = 0, save_diffusion_path: bool = False,
             show_diffusion_path: bool = False, show_xt: bool = False,
             output_inner: bool = False, anim_dir: Optional[str] = None):
    """One demo run as events: {"kind": "preview", "image": uint8 HWC,
    "step", "total", "text"} per step when ``show_diffusion_path``, then
    {"kind": "final", "image", "logsnr_plot": uint8 or None, "video_path":
    str or None, "text", "info"}. The stream runs only when a per-step
    artifact is asked for; otherwise one ``sample`` call runs."""
    common = dict(negative_prompt=negative_prompt, style=style, batch_size=batch_size,
                  guidance_scale=guidance_scale, threshold_function=threshold_function,
                  num_inference_steps=num_inference_steps, ddim_eta=ddim_eta, seed=seed,
                  output_inner=output_inner)
    t0 = time.time()
    logsnrs = []
    video_path = None
    if save_diffusion_path or show_diffusion_path or show_xt:
        frames, final_grid = [], None
        for step_i, (final_grid, info) in enumerate(
                generate(models, prompt, stream=True, show_xt=show_xt, **common)):
            logsnrs.append(info["logsnr"])
            if save_diffusion_path:
                frames.append(_to_uint8(final_grid))
            if show_diffusion_path:
                yield {"kind": "preview", "image": _to_uint8(final_grid), "step": step_i,
                       "total": num_inference_steps,
                       "text": f"Step ({step_i + 1} / {num_inference_steps}) "
                               f"Time ({time.time() - t0:.4}s)"}
        if save_diffusion_path and frames:
            import tempfile

            base = os.path.join(anim_dir or tempfile.gettempdir(), f"diffusion_path_{os.getpid()}")
            video_path = write_animation(frames, base)
        info = {"steps": num_inference_steps}
    else:
        final_grid, info = generate(models, prompt, stream=False, **common)
        sampler = models["pipeline"].sampler
        gammas = sampler.gammas.numpy()
        logsnrs = [_logsnr(float(gammas[int(t)]))
                   for t in sampler._timestep_table(num_inference_steps, True, -1)[:-1]]
    yield {"kind": "final", "image": _to_uint8(final_grid),
           "logsnr_plot": plot_logsnr(logsnrs, num_inference_steps), "video_path": video_path,
           "text": f"Done ({num_inference_steps} steps, {time.time() - t0:.4}s)", "info": info}


def list_demo_choices(args):
    """The page's dropdowns: the YAMLs under ``--config-dir`` and the
    checkpoints under ``--model-dir``, the current ones first."""
    import glob

    cfg_dir = getattr(args, "config_dir", "configs/models") or "configs/models"
    mdl_dir = getattr(args, "model_dir", ".") or "."
    configs = sorted(glob.glob(os.path.join(cfg_dir, "*.yaml")))
    ckpts = sorted(glob.glob(os.path.join(mdl_dir, "*.pth"))
                   + glob.glob(os.path.join(mdl_dir, "vis_model*")))
    cur_cfg = getattr(args, "config_path", None)
    if cur_cfg and cur_cfg not in configs:
        configs.insert(0, cur_cfg)
    cur_ckpt = getattr(args, "model_file", None)
    if cur_ckpt and cur_ckpt not in ckpts:
        ckpts.insert(0, cur_ckpt)
    return configs, [c for c in dict.fromkeys(ckpts) if c]


_PAGE = """<!DOCTYPE html><html><head><title>ml_mdm_tpu_torch demo</title>
<style>body{font-family:sans-serif;max-width:960px;margin:2em auto}
label{display:block;margin-top:.6em}img{image-rendering:pixelated;
max-width:512px;border:1px solid #ccc;margin-top:1em}
.row{display:flex;gap:1em;flex-wrap:wrap}</style></head><body>
<h2>Matryoshka Diffusion — GPU demo</h2>
<form id=f>
<label>Config <select name=config id=cfgsel></select>
Checkpoint <select name=model_file id=ckptsel><option value="">(random init)
</option></select></label>
<label>Prompt <input name=prompt size=60 value="a photo of a dog"></label>
<label>Negative prompt <input name=negative_prompt size=60></label>
<label>Guidance <input name=guidance_scale value=7.5 size=6>
Steps <input name=num_inference_steps value=50 size=6>
Eta <input name=ddim_eta value=0 size=6>
Seed <input name=seed value=0 size=6>
Batch <input name=batch_size value=4 size=4></label>
<label>Threshold <select name=threshold_function>
<option>CLIP</option><option>DYNAMIC</option><option>DYNAMIC_IF</option>
<option>NONE</option></select>
Style <select name=style><option>none</option><option>photo</option>
<option>painting</option><option>sketch</option><option>anime</option>
</select></label>
<label><input type=checkbox name=stream value=1 checked>
Show diffusion progress (streamed previews)
<input type=checkbox name=show_xt value=1> Show predicted x_t
<input type=checkbox name=output_inner value=1> Output inner UNet
<input type=checkbox name=save_path value=1> Diffusion-path animation</label>
<button type=submit>Generate</button></form>
<div id=status></div>
<div class=row><div><h4>Output</h4><img id=out></div>
<div><h4>Noise schedule (logSNR)</h4><img id=snr style=width:400px></div>
<div><h4>Diffusion path</h4><img id=vid></div></div>
<script>
async function loadChoices(){
  const j = await (await fetch('/choices')).json();
  for (const [id, xs] of [['cfgsel', j.configs], ['ckptsel', j.checkpoints]]){
    const s = document.getElementById(id);
    for (const x of xs){const o=document.createElement('option');
      o.value=x;o.innerText=x;s.appendChild(o);}
  }
}
loadChoices();
document.getElementById('f').onsubmit = async (e) => {
  e.preventDefault();
  const q = new URLSearchParams(new FormData(e.target));
  const st = document.getElementById('status');
  st.innerText = 'sampling...';
  const r = await fetch('/generate?' + q);
  if (r.headers.get('Content-Type').startsWith('text/event-stream')) {
    const rd = r.body.getReader(); const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {done, value} = await rd.read(); if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf('\\n\\n')) >= 0) {
        const chunk = buf.slice(0, i); buf = buf.slice(i + 2);
        if (!chunk.startsWith('data: ')) continue;
        const j = JSON.parse(chunk.slice(6));
        if (j.image) document.getElementById('out').src =
            'data:image/png;base64,' + j.image;
        if (j.logsnr_plot) document.getElementById('snr').src =
            'data:image/png;base64,' + j.logsnr_plot;
        if (j.video) document.getElementById('vid').src =
            'data:' + j.video_mime + ';base64,' + j.video;
        st.innerText = j.text || JSON.stringify(j.info || {});
      }
    }
  } else {
    const j = await r.json();
    document.getElementById('out').src = 'data:image/png;base64,' + j.image;
    if (j.logsnr_plot) document.getElementById('snr').src =
        'data:image/png;base64,' + j.logsnr_plot;
    st.innerText = JSON.stringify(j.info);
  }
};
</script></body></html>"""


def _png_b64_u8(img_u8: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _request_kwargs(q: Dict[str, str]) -> Dict[str, Any]:
    """run_demo's keyword arguments from a /generate query."""
    return dict(
        negative_prompt=q.get("negative_prompt", ""), style=q.get("style", "none"),
        batch_size=int(q.get("batch_size", 4)),
        guidance_scale=float(q.get("guidance_scale", 7.5)),
        threshold_function=q.get("threshold_function", "CLIP"),
        num_inference_steps=int(q.get("num_inference_steps", 50)),
        ddim_eta=float(q.get("ddim_eta", 0)), seed=int(q.get("seed", 0)),
        show_xt=bool(q.get("show_xt")), output_inner=bool(q.get("output_inner")),
        save_diffusion_path=bool(q.get("save_path")),
    )


def _final_body(ev: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON fields of a final event: the PNG, the info, the logSNR
    plot and the animation, where there are."""
    out = {"image": _png_b64_u8(ev["image"]), "info": ev.get("info", {})}
    if ev.get("logsnr_plot") is not None:
        out["logsnr_plot"] = _png_b64_u8(ev["logsnr_plot"])
    vp = ev.get("video_path")
    if vp and os.path.exists(vp):
        with open(vp, "rb") as f:
            out["video"] = base64.b64encode(f.read()).decode()
        out["video_mime"] = "video/mp4" if vp.endswith(".mp4") else "image/gif"
    return out


def make_builtin_server(args, port: Optional[int] = None):
    """The demo's HTTP server on ``port`` (default ``args.port``; 0 picks a
    free one), built and not started: ``GET /`` the page, ``/choices`` the
    dropdowns (JSON), ``/generate?...`` one request, as JSON or, with
    ``stream=1``, as server-sent events (a ``preview`` frame per step, then
    the ``final`` one)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    default_models = setup_models(args)
    _CACHE[f"{args.config_path}::{getattr(args, 'model_file', '')}"] = default_models

    def models_for(q):
        cfg = q.get("config", "") or args.config_path
        ckpt = q.get("model_file", "") or None
        if cfg == args.config_path and not ckpt:
            return default_models
        return get_cached_models(cfg, ckpt, args.device, args.text_model)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, content_type: str, body: Optional[bytes] = None, **headers):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            for k, v in headers.items():
                self.send_header(k.replace("_", "-"), v)
            self.end_headers()
            if body is not None:
                self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send("text/html", _PAGE.encode())
            elif url.path == "/choices":
                configs, ckpts = list_demo_choices(args)
                self._send("application/json",
                           json.dumps({"configs": configs, "checkpoints": ckpts}).encode())
            elif url.path == "/generate":
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    with _LOCK, torch.no_grad():
                        self._generate(q)
                except BrokenPipeError:
                    pass
            else:
                self.send_response(404)
                self.end_headers()

        def _generate(self, q):
            models = models_for(q)
            kw = _request_kwargs(q)
            prompt = q.get("prompt", "")
            if not q.get("stream"):
                fin = list(run_demo(models, prompt, **kw))[-1]
                body = _final_body(fin)
                body.pop("video", None)
                body.pop("video_mime", None)
                self._send("application/json", json.dumps(body).encode())
                return
            self._send("text/event-stream", Cache_Control="no-cache")
            for ev in run_demo(models, prompt, show_diffusion_path=True, **kw):
                out = {"kind": ev["kind"], "text": ev.get("text", "")}
                if ev["kind"] == "preview":
                    out.update(image=_png_b64_u8(ev["image"]), step=ev["step"],
                               total=ev["total"])
                else:
                    out.update(_final_body(ev))
                self.wfile.write(b"data: " + json.dumps(out).encode() + b"\n\n")
                self.wfile.flush()

    return ThreadingHTTPServer(("0.0.0.0", args.port if port is None else port), Handler)


def serve_builtin(args):
    server = make_builtin_server(args)
    logging.info(f"builtin demo UI on http://0.0.0.0:{server.server_port}")
    server.serve_forever()


def build_gradio_app(args):
    """The Gradio Blocks app (not launched) with the JAX package's surface:
    config and checkpoint dropdowns, prompt, negative prompt, style, batch,
    guidance, threshold, steps, eta, seed, the diffusion-path toggles, Run
    and Stop, the output image, the path's video, the system output and
    the logSNR pane. Returns (demo, run): the app and the generator wired
    to Run, which yields (image, None, text, None) a preview, then (image,
    logSNR plot, text, video path)."""
    import gradio as gr

    # load the default models now, so that the first request does not
    get_cached_models(args.config_path, getattr(args, "model_file", None), args.device,
                      getattr(args, "text_model", None))
    configs, ckpts = list_demo_choices(args)

    def run(config, ckpt, prompt, negative, style, batch, guidance, thresh,
            steps, eta, seed, show_path, save_path, show_xt, output_inner):
        with _LOCK, torch.no_grad():
            models = get_cached_models(config, ckpt or None, args.device,
                                       getattr(args, "text_model", None))
            for ev in run_demo(models, prompt, negative_prompt=negative, style=style,
                               batch_size=int(batch), guidance_scale=float(guidance),
                               threshold_function=thresh, num_inference_steps=int(steps),
                               ddim_eta=float(eta), seed=int(seed),
                               save_diffusion_path=bool(save_path),
                               show_diffusion_path=bool(show_path), show_xt=bool(show_xt),
                               output_inner=bool(output_inner)):
                if ev["kind"] == "preview":
                    yield ev["image"], None, ev["text"], None
                else:
                    yield ev["image"], ev.get("logsnr_plot"), ev["text"], ev.get("video_path")

    with gr.Blocks(title="Matryoshka Diffusion — PyTorch demo") as demo:
        gr.Markdown("# Matryoshka Diffusion — PyTorch demo")
        with gr.Row():
            config_dd = gr.Dropdown(configs, value=args.config_path, label="Config",
                                    allow_custom_value=True)
            ckpt_dd = gr.Dropdown([""] + ckpts, value=getattr(args, "model_file", "") or "",
                                  label="Checkpoint", allow_custom_value=True)
        with gr.Row():
            prompt_tb = gr.Textbox(label="Prompt")
            negative_tb = gr.Textbox(label="Negative prompt")
        with gr.Row():
            style_dd = gr.Dropdown(list(STYLE_TEMPLATES), value="none", label="Style")
            batch_sl = gr.Slider(1, 128, value=4, step=1, label="Batch")
            guidance_sl = gr.Slider(0, 50, value=7.5, label="Guidance")
            thresh_dd = gr.Dropdown(["CLIP", "DYNAMIC", "DYNAMIC_IF", "NONE"], value="CLIP",
                                    label="Threshold")
        with gr.Row():
            steps_sl = gr.Slider(1, 1000, value=50, step=1, label="Steps")
            eta_sl = gr.Slider(0, 1, value=0.0, step=0.05, label="DDIM eta")
            seed_nb = gr.Number(value=137, label="Seed", precision=0)
        with gr.Row():
            show_path_cb = gr.Checkbox(value=False, label="Show diffusion progress")
            save_path_cb = gr.Checkbox(value=True, label="Show diffusion path as a video")
            show_xt_cb = gr.Checkbox(value=False, label="Show predicted x_t")
            inner_cb = gr.Checkbox(value=False,
                                   label="Output inner UNet (high-res models only)")
        run_btn = gr.Button(value="Run", variant="primary")
        stop_btn = gr.Button(value="Stop", variant="stop")
        with gr.Row():
            out_img = gr.Image(label="Output image")
            out_video = gr.Video(label="Diffusion path")
        with gr.Row():
            out_text = gr.Textbox(label="System output")
            snr_img = gr.Image(label="Noise schedule (logSNR)")
        run_event = run_btn.click(
            fn=run,
            inputs=[config_dd, ckpt_dd, prompt_tb, negative_tb, style_dd, batch_sl, guidance_sl,
                    thresh_dd, steps_sl, eta_sl, seed_nb, show_path_cb, save_path_cb,
                    show_xt_cb, inner_cb],
            outputs=[out_img, snr_img, out_text, out_video],
        )
        stop_btn.click(fn=None, cancels=[run_event], queue=False)
    return demo, run


def serve_gradio(args):
    demo, _ = build_gradio_app(args)
    demo.queue(default_concurrency_limit=1).launch(server_name="0.0.0.0",
                                                   server_port=args.port)


def main(args):
    """Serve the Gradio app where ``gradio`` imports, else the built-in
    page."""
    try:
        import gradio  # noqa: F401
    except ImportError:
        logging.info("gradio not installed; using the built-in HTTP page")
        serve_builtin(args)
        return
    serve_gradio(args)


if __name__ == "__main__":
    args = get_arguments(mode="demo")
    logging.basicConfig(level=getattr(logging, args.loglevel.upper(), None))
    if not hasattr(args, "model_file"):
        args.model_file = None
    helpers.print_args(args)
    main(args)
