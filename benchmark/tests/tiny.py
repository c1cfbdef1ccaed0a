"""Tiny configurations of the benchmark's two models (the structure of the
port's ``scaled=True`` presets: the 64px U-Net at 16 px with 32/64/96
channels, and the 1024px model's two shells at 8/8/16 and 16/16/32
channels around it), with traffic and cell files to match, and a context
as ``run.py`` makes one, on the CPU."""
from __future__ import annotations

import copy
import os
import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import common  # noqa: E402

CORE = {
    "resolution_channels": [32, 64, 96], "num_resnets_per_resolution": [1, 1, 1],
    "attention_levels": [1, 2], "num_attention_layers": [0, 1, 1],
    "conditioning_feature_dim": -1, "conditioning_feature_proj_dim": 24,
    "num_lm_head_layers": 0, "masked_cross_attention": 0, "micro_conditioning": "scale:16",
    "skip_mid_blocks": False, "skip_cond_emb": False, "nesting": False,
    "resnet_config": {"num_groups_norm": 8, "dropout": 0.0, "use_attention_ffn": True},
}
SAMPLER = {"num_diffusion_steps": 1000, "schedule_type": "DEEPFLOYD",
           "prediction_type": "V_PREDICTION", "loss_target_type": "DDPM"}


def _shell(chans, micro, inner, **kw):
    return dict({
        "resolution_channels": chans, "num_resnets_per_resolution": [2, 2, 1],
        "attention_levels": [], "num_attention_layers": [0, 0, 0],
        "conditioning_feature_dim": -1, "conditioning_feature_proj_dim": 24,
        "num_lm_head_layers": 0, "masked_cross_attention": 1, "micro_conditioning": micro,
        "nesting": False, "skip_mid_blocks": True, "skip_cond_emb": True,
        "skip_inner_unet_input": False, "skip_normalization": True, "temporal_dim": 128,
        "freeze_inner_unet": False, "initialize_inner_with_pretrained": None,
        "interp_conditioning": False, "pack_min_side": 8,
        "resnet_config": {"num_groups_norm": 8, "dropout": 0.0, "use_attention_ffn": False},
        "inner_config": inner}, **kw)


def config(nested: bool) -> dict:
    """A configuration file's content (``configs/<config>.json``)."""
    if not nested:
        yaml = {"model": "unet", "unet_config": copy.deepcopy(CORE),
                "diffusion_config": {"sampler_config": dict(SAMPLER, threshold_function="CLIP"),
                                     "model_output_scale": 0.0,
                                     "use_vdm_loss_weights": False},
                "lr": 5e-5, "warmup_steps": 10, "gradient_clip_norm": 2, "use_adamw": True}
        return {"yaml": yaml, "image_side": 16, "text_width": 32, "gates": {}}
    core = dict(copy.deepcopy(CORE), nesting=True)
    middle = _shell([16, 16, 32], "scale:64", core, nesting=True, skip_normalization=False)
    yaml = {"model": "nested2_unet", "unet_config": _shell([8, 8, 16], "scale:256", middle),
            "diffusion_config": {
                "sampler_config": dict(SAMPLER, rescale_signal=1, schedule_shifted=True,
                                       schedule_shifted_power=2),
                "model_output_scale": 0, "use_vdm_loss_weights": False,
                "use_double_loss": True, "no_use_residual": True},
            "multi_res_weights": "16:4:1", "lr": 5e-5, "warmup_steps": 10,
            "gradient_clip_norm": 2, "batch_size": 2}
    return {"yaml": yaml, "image_side": 256, "text_width": 32,
            "gates": {"ML_MDM_TPU_PACK64_MIN_SIDE": "16"}}


def sample_traffic(batch=2, guidance=5.0, steps=3) -> dict:
    return {"kind": "sample", "batch": batch, "guidance_scale": guidance,
            "num_inference_steps": steps, "ddim_eta": 0.0, "text_tokens": 8,
            "cond_tokens": [2, 8], "uncond_tokens": [1, 1], "warmup_steps": 2,
            "traced_forwards": [1, 1], "labelled_forwards": 1}


def train_traffic(batch=2) -> dict:
    return {"kind": "train", "batch": batch, "text_tokens": 8, "cond_tokens": [2, 8],
            "ema_decay": 0.9999, "remat": True, "remat_save_conv_max_side": 8,
            "traced_steps": 2}


def context(config_, traffic, cell, seed=123, seconds=0.01, log=None) -> SimpleNamespace:
    """``run.py``'s context on the CPU, the configuration's gates set."""
    import torch

    os.environ.update(config_["gates"])
    sides = common.sides(config_, config_["image_side"])
    w = config_["yaml"].get("multi_res_weights")
    return SimpleNamespace(
        seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
        workload={"name": "tiny"}, config=config_, traffic=traffic, cell=cell,
        t_start=0.0, log=log or (lambda m: None), nested=len(sides) > 1,
        scales=[s // sides[-1] for s in sides],
        loss_weights=[float(v) for v in str(w).split(":")] if w else [1.0] * len(sides))
