"""FID and CLIPScore of what ``generate_batch`` wrote.

The port's counterpart of ``ml_mdm_tpu/clis/run_torchmetrics.py``, with the
same flags, the same protocol and the same result keys (``fid``,
``fid_sanity``, ``fid_extractor``, ``clip_score``), and ``--device``
(default ``cuda``; CUDA without a card raises, as every CLI of the port):

- it reads every ``{sample_dir}/rank*/lst.json`` (waiting for one to
  appear), and from each, in sorted order, the ``s_*`` samples or their
  ``ref_*`` references with their captions, up to ``--min-examples``;
- ``fid``: a reference-against-reference sanity FID of the two halves where
  each half has more images than the features have dimensions, then the
  samples against the references, on the Frechet distance of the features'
  Gaussians (numpy and scipy on the host, as in the JAX CLI);
- ``clip``: CLIPScore, ``mean(100 * max(0, cos(image, text)))`` of the
  samples and their captions.

Extractors: ``pixel`` (an 8x8 downsample and the channel moments; no
weights), ``clip`` (the projected image features of the port's own CLIP
towers, ``language_models/clip.py``, from a local Hugging Face CLIP
directory, on ``--device``) and ``inception`` (torchvision's InceptionV3
with its default weights, imported when built; neither torchvision nor
its weights are assumed to be present). As in the JAX CLI, an extractor
that cannot be built falls back to ``pixel`` with a warning, and CLIPScore
is skipped with a warning where the CLIP model cannot be loaded:
``fid_extractor`` says what ran.

    python -m ml_mdm_tpu_torch.clis.run_torchmetrics --sample-dir S --metrics fid,clip \\
        --feature-extractor clip --clip-model <local CLIP directory> --device cuda
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ml_mdm_tpu_torch import helpers
from ml_mdm_tpu_torch.language_models import clip as clip_towers
from ml_mdm_tpu_torch.language_models.clip_tokenizer import CLIPTokenizer

# images a batch through the CLIP towers (10,000 samples fit on the card)
CLIP_BATCH = 64


# -- Frechet distance -----------------------------------------------------------------


def compute_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """FID between two Gaussians (Heusel et al. 2017). A rank-deficient
    product's square root may come out non-finite: then it is taken again
    with ``eps`` on the diagonals; an imaginary part is dropped."""
    from scipy import linalg

    def _sqrtm(m):  # scipy >= 1.14 drops the disp kwarg/tuple return
        out = linalg.sqrtm(m)
        return out[0] if isinstance(out, tuple) else out

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu1, s1 = compute_statistics(feats_a)
    mu2, s2 = compute_statistics(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


# -- feature extractors ---------------------------------------------------------------


class PixelFeatures:
    """Weight-free features: an 8x8x3 bilinear downsample and the channel
    means and deviations. Not a perceptual metric: a deterministic
    extractor that is always there."""

    name = "pixel"

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        from PIL import Image

        feats = []
        for img in images_u8:
            small = np.asarray(Image.fromarray(img).resize((8, 8), Image.BILINEAR),
                               dtype=np.float32) / 255.0
            moments = np.concatenate([img.reshape(-1, 3).mean(0) / 255.0,
                                      img.reshape(-1, 3).std(0) / 255.0])
            feats.append(np.concatenate([small.ravel(), moments]))
        return np.asarray(feats)


class InceptionFeatures:
    """torchvision's InceptionV3 (default weights) without its last layer,
    on 299 px bilinear resizes in [-1, 1]; on the CPU, as in the JAX CLI."""

    name = "inception"

    def __init__(self, feature_layer: int = 2048):
        from torchvision.models import inception_v3  # may be absent

        self.model = inception_v3(weights="DEFAULT", aux_logits=True)
        self.model.fc = torch.nn.Identity()
        self.model.eval()
        self.feature_layer = feature_layer

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        from PIL import Image

        batch = []
        for img in images_u8:
            im = Image.fromarray(img).resize((299, 299), Image.BILINEAR)
            batch.append(np.asarray(im, dtype=np.float32) / 255.0)
        x = torch.from_numpy(np.stack(batch).transpose(0, 3, 1, 2))
        x = (x - 0.5) / 0.5
        with torch.no_grad():
            return self.model(x).numpy()


class ClipFeatures:
    """The port's CLIP towers from the local directory ``path`` on
    ``device``: ``__call__`` gives the projected image features, f32 on the
    host; ``clip_score`` the CLIPScore of images against captions. Both
    run CLIP_BATCH images a batch."""

    name = "clip"

    def __init__(self, path: str, device):
        self.path = path
        self.device = torch.device(device)
        self.model = clip_towers.load_clip_from_torch(path, self.device)
        self.tokenizer = CLIPTokenizer(path)
        self.preprocessor = clip_towers.read_preprocessor_config(path)

    def _pixels(self, images_u8) -> torch.Tensor:
        pixels = clip_towers.preprocess_images(images_u8, self.preprocessor)
        return torch.from_numpy(pixels).to(self.device)

    @torch.no_grad()
    def image_embeds(self, images_u8: np.ndarray) -> torch.Tensor:
        return torch.cat([self.model.get_image_features(self._pixels(images_u8[i:i + CLIP_BATCH]))
                          for i in range(0, len(images_u8), CLIP_BATCH)])

    @torch.no_grad()
    def text_embeds(self, texts: List[str]) -> torch.Tensor:
        out = []
        for i in range(0, len(texts), CLIP_BATCH):
            ids, mask = self.tokenizer(texts[i:i + CLIP_BATCH])
            out.append(self.model.get_text_features(torch.from_numpy(ids).to(self.device),
                                                    torch.from_numpy(mask).to(self.device)))
        return torch.cat(out)

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        return self.image_embeds(images_u8).float().cpu().numpy()

    def clip_score(self, images_u8: np.ndarray, texts: List[str]) -> float:
        """mean(100 * max(0, cos(image, text))) in f32: the torchmetrics
        CLIPScore the reference uses."""
        img = self.image_embeds(images_u8).float()
        txt = self.text_embeds(texts).float()
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        cos = (img * txt).sum(-1)
        return float((100 * cos.clamp(min=0)).mean())


def build_extractor(kind: str, clip_model: str, feature_layer: int, device):
    if kind == "pixel":
        return PixelFeatures()
    if kind == "inception":
        return InceptionFeatures(feature_layer)
    if kind == "clip":
        return ClipFeatures(clip_model, device)
    raise ValueError(f"unknown feature extractor {kind}")


# -- manifests and images -------------------------------------------------------------


def wait_for_manifests(sample_dir: str, timeout: float = 36000.0, poll: float = 10.0) -> List[str]:
    """The ``rank*/lst.json`` files under ``sample_dir``, polled for until
    one exists or ``timeout`` seconds have passed."""
    deadline = time.time() + timeout
    while True:
        manifests = sorted(glob.glob(os.path.join(sample_dir, "rank*", "lst.json")))
        if manifests:
            return manifests
        if time.time() > deadline:
            raise TimeoutError(f"no manifests under {sample_dir}")
        time.sleep(poll)


def load_images(sample_dir: str, prefix: str, limit: int):
    """(images, captions) from the rank manifests, rank by rank and each
    manifest's entries sorted, up to ``limit``. ``prefix`` picks the samples
    (``s_``) or the references (``ref_``)."""
    from PIL import Image

    images, captions = [], []
    for manifest in wait_for_manifests(sample_dir, timeout=0.1, poll=0.1):
        rank_dir = os.path.dirname(manifest)
        with open(manifest) as f:
            entries = json.load(f)
        for fname, caption in sorted(entries.items()):
            path = os.path.join(rank_dir, fname if prefix == "s_" else fname.replace("s_", prefix))
            if not os.path.exists(path):
                continue
            images.append(np.asarray(Image.open(path).convert("RGB")))
            captions.append(caption)
            if len(images) >= limit:
                return np.stack(images), captions
    if not images:
        raise FileNotFoundError(f"no {prefix}* images under {sample_dir}")
    return np.stack(images), captions


def main(argv=None):
    p = argparse.ArgumentParser(description="FID / CLIP evaluation")
    p.add_argument("--sample-dir", type=str, default="samples")
    p.add_argument("--min-examples", type=int, default=10000)
    p.add_argument("--metrics", type=str, default="fid,clip")
    p.add_argument("--feature-extractor", type=str, default="inception",
                   choices=["inception", "clip", "pixel"])
    p.add_argument("--feature-layer", type=int, default=2048, choices=[64, 192, 768, 2048])
    p.add_argument("--clip-model", type=str, default="openai/clip-vit-base-patch16",
                   help="a local Hugging Face CLIP directory (nothing is downloaded)")
    p.add_argument("--output-json", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device of the CLIP towers (cuda raises without a card)")
    args = p.parse_args(argv)
    device = helpers.select_platform(args)

    metrics = args.metrics.split(",")
    results: Dict[str, float] = {}

    refs, _ = load_images(args.sample_dir, "ref_", args.min_examples)
    samples, caps = load_images(args.sample_dir, "s_", args.min_examples)
    logging.info(f"{len(refs)} reference / {len(samples)} sample images")

    if "fid" in metrics:
        try:
            extractor = build_extractor(args.feature_extractor, args.clip_model,
                                        args.feature_layer, device)
        except Exception as e:
            logging.warning(f"{args.feature_extractor} extractor unavailable ({e}); "
                            "falling back to weight-free pixel features")
            extractor = PixelFeatures()
        ref_feats = extractor(refs)
        # sanity: two halves of the reference set should be near 0
        half = len(ref_feats) // 2
        if half > ref_feats.shape[1]:
            sanity = fid_from_features(ref_feats[:half], ref_feats[half:])
            logging.info(f"reference-vs-reference FID: {sanity:.4f}")
            results["fid_sanity"] = sanity
        results["fid"] = fid_from_features(extractor(samples), ref_feats)
        results["fid_extractor"] = extractor.name
        logging.info(f"FID: {results['fid']:.4f}")

    if "clip" in metrics:
        try:
            # the FID's CLIP towers where they are the same model (the JAX
            # CLI loads them again)
            clip = extractor if "fid" in metrics and isinstance(extractor, ClipFeatures) \
                and extractor.path == args.clip_model else ClipFeatures(args.clip_model, device)
            results["clip_score"] = clip.clip_score(samples, caps)
            logging.info(f"CLIPScore: {results['clip_score']:.4f}")
        except Exception as e:
            logging.warning(f"CLIP unavailable: {e}")

    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
