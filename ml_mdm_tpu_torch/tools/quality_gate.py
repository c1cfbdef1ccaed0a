"""The offline sample-quality gate: overfit the tiny U-Net on the ten fixture
images for 500 steps, then require its samples to land near their own
references.

    python -m ml_mdm_tpu_torch.tools.quality_gate --device cpu
    python -m ml_mdm_tpu_torch.tools.quality_gate --device cuda --compute-dtype bfloat16

The port's counterpart of the JAX package's ``tests/test_quality_gate.py``,
on the port's own calls and the same recipe: ``tests/test_files/
tiny_train.yaml`` (16 and 32 channels) with its ``random:16`` text tower;
the ten images of ``tests/test_files/images_00000.tar`` resized to 16 px
(PIL bilinear) with their captions from ``images_00000.tsv``, read relative
to this checkout, not the working directory; ``TrainerConfig(lr=5e-4,
warmup_steps=20, gradient_clip_norm=2.0, ema_decay=0.99)``, one batch of
all ten a step, each step's noise from a generator seeded by 100 + step.
The probe samples two seed-disjoint sets (seeds 0 and 1) for the ten
captions with DDIM-20 (eta 0, ``resample_steps``) from the given
parameters, and returns the mean per-caption MSE against the references
and the pixel FID (``run_torchmetrics.PixelFeatures``) of the 20 samples
against the ten references. ``check`` applies the JAX gate's three
conditions: the untrained anchor above 0.3, the trained MSE below 0.05, the
pixel FID lower after training than before.

Nothing else would catch a fault in the training numerics that keeps
shapes and finiteness and stays inside the per-step tolerances: on the
card, where the kernels run, the route (``compute_dtype``, ``kernels``)
says whether K1, K2 and K3 carry the steps and K1 and K2 the probes.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import tarfile
import time
from typing import Dict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, "tests", "test_files")
SEED = 0
SIDE = 16
STEPS = 500
ANCHOR_MIN, MSE_MAX = 0.3, 0.05


def load_fixture():
    """(uint8 references (10, 16, 16, 3), their captions) in the tar's order."""
    from PIL import Image

    caps = {}
    with open(os.path.join(FIXTURES, "images_00000.tsv")) as f:
        next(f)
        for line in f:
            _tar, fn, cap = line.strip().split("\t")
            caps[fn] = cap
    refs, texts = [], []
    with tarfile.open(os.path.join(FIXTURES, "images_00000.tar")) as t:
        for m in t.getmembers():
            img = Image.open(io.BytesIO(t.extractfile(m).read()))
            refs.append(np.asarray(img.convert("RGB").resize((SIDE, SIDE), Image.BILINEAR)))
            texts.append(caps[m.name])
    return np.asarray(refs), texts


def probe_metrics(samples: np.ndarray, images: np.ndarray, refs: np.ndarray):
    """The JAX gate's probe arithmetic: ``samples`` (S, N, H, W, 3) in
    [-1, 1] for the N ``images`` (in [-1, 1]) whose uint8 form is ``refs``;
    (mean per-caption MSE, pixel FID of all S·N samples against ``refs``)."""
    from ml_mdm_tpu_torch.clis.run_torchmetrics import PixelFeatures, fid_from_features

    mses = [((s - images) ** 2).mean(axis=(1, 2, 3)) for s in samples]
    u8s = [np.clip((s + 1) * 127.5, 0, 255).astype(np.uint8) for s in samples]
    px = PixelFeatures()
    return float(np.mean(mses)), fid_from_features(px(np.concatenate(u8s)), px(refs))


class QualityGate:
    """The gate's model, data and train state on ``device``: f32
    parameters computing in ``compute_dtype`` for training, a copy in
    ``compute_dtype`` for the probes; ``kernels`` False takes the plain
    versions (on the CPU they run whatever it says)."""

    def __init__(self, device, compute_dtype: torch.dtype = torch.float32, kernels: bool = True):
        from ml_mdm_tpu_torch import reader, trainer
        from ml_mdm_tpu_torch.config import get_arguments, get_model, get_pipeline
        from ml_mdm_tpu_torch.language_models import factory
        from ml_mdm_tpu_torch.presets import build_unet

        self.device = torch.device(device)
        args = get_arguments(["--config_path", os.path.join(FIXTURES, "tiny_train.yaml"),
                              "--vocab_file", os.path.join(FIXTURES, "tiny_t5.vocab"),
                              "--device", self.device.type], mode="trainer")
        tokenizer, lm = factory.create_lm(args, self.device, seed=SEED)
        self.refs, self.texts = load_fixture()
        self.images = self.refs.astype(np.float32) / 127.5 - 1.0
        tokens = reader.process_text(self.texts, tokenizer, args.reader_config)
        lm_outputs, lm_mask = lm({"tokens": np.asarray(tokens)}, tokenizer)
        self.cond = {"lm_outputs": lm_outputs, "lm_mask": lm_mask}
        args.unet_config.conditioning_feature_dim = lm.embed_dim

        def pipeline(train: bool):
            unet = build_unet(get_model(args.model), args.unet_config, self.device, SEED,
                              train=False, dtype=torch.float32 if train else compute_dtype)
            if train:
                unet.set_compute_dtype(compute_dtype).train()
            return get_pipeline(args.model)(unet.use_kernels(kernels), args.diffusion_config)

        self.pipeline = pipeline(train=True)
        # the probes sample from a second module with weights of the compute
        # dtype (as generate_batch samples on the card), in eval mode, into
        # which the parameters to probe are loaded
        self.probe_pipeline = pipeline(train=False)
        self.initial = {k: v.detach().clone()
                        for k, v in self.pipeline.vision_module.state_dict().items()}
        self.config = trainer.TrainerConfig(lr=5e-4, warmup_steps=20, gradient_clip_norm=2.0,
                                            ema_decay=0.99)
        self.state = trainer.TrainState.create(self.pipeline.vision_module, self.config)
        self.step = trainer.make_train_step(self.pipeline, self.config)
        self.batch = {"images": torch.from_numpy(self.images).to(self.device),
                      "lm_outputs": lm_outputs, "lm_mask": lm_mask}

    def sample(self, params: Dict[str, torch.Tensor], seed: int) -> np.ndarray:
        """DDIM-20 samples (eta 0, ``resample_steps``) of the ten captions
        from ``params``, f32 on the host."""
        module = self.probe_pipeline.vision_module
        module.load_state_dict({**module.state_dict(), **params}, strict=True)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = self.probe_pipeline.sample(len(self.texts), self.cond, SIDE, gen,
                                         num_inference_steps=20, resample_steps=True,
                                         ddim_eta=0.0)
        return out.float().cpu().numpy()

    def probe(self, params: Dict[str, torch.Tensor]):
        """(mean per-caption MSE, pixel FID) of two seed-disjoint sets."""
        return probe_metrics(np.stack([self.sample(params, s) for s in (0, 1)]), self.images,
                             self.refs)

    def train(self, steps: int = STEPS) -> Dict[str, float]:
        """``steps`` steps on the one batch; returns the last step's metrics."""
        m = {}
        for _ in range(steps):
            gen = torch.Generator(device=self.device).manual_seed(100 + self.state.step)
            self.state, m = self.step(self.state, self.batch, gen)
        return m

    def run(self) -> Dict[str, float]:
        """The anchor, STEPS timed steps, the trained probe; with the steps'
        time and rate."""
        steps = STEPS
        mse0, fid0 = self.probe(self.initial)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        last = self.train(steps)
        sync()
        seconds = time.perf_counter() - t0
        mse1, fid1 = self.probe(self.state.ema_params)
        return {"mse_untrained": mse0, "fid_untrained": fid0, "mse_trained": mse1,
                "fid_trained": fid1, "loss": last["loss"], "skipped": self.state.step != steps,
                "train_seconds": seconds, "steps_s": steps / seconds}


def check(r: Dict[str, float]) -> None:
    """The JAX gate's conditions; raises AssertionError naming the one
    that fails."""
    # a miscalibrated probe: an untrained model's samples must be far off
    if not r["mse_untrained"] > ANCHOR_MIN:
        raise AssertionError(f"quality gate: untrained anchor {r['mse_untrained']} <= {ANCHOR_MIN}")
    if not np.isfinite(r["loss"]) or r["skipped"]:
        raise AssertionError(f"quality gate: last loss {r['loss']}, steps skipped {r['skipped']}")
    if not r["mse_trained"] < MSE_MAX:
        raise AssertionError(f"quality gate: trained MSE {r['mse_trained']} >= {MSE_MAX} "
                             f"(untrained {r['mse_untrained']})")
    if not r["fid_trained"] < r["fid_untrained"]:
        raise AssertionError(f"quality gate: pixel FID {r['fid_trained']} did not improve on "
                             f"{r['fid_untrained']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--plain", action="store_true", help="the kernels' plain versions")
    args = p.parse_args(argv)
    from ml_mdm_tpu_torch import helpers

    device = helpers.select_platform(args)
    gate = QualityGate(device, getattr(torch, args.compute_dtype), kernels=not args.plain)
    result = gate.run()
    print(json.dumps(result))
    check(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
