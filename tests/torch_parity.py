"""Shared fixtures of the port's parity tests (tests/test_torch_*.py): the
tiny flagship-structured U-Net in both packages, with the same weights.

Weights are initialised by JAX, every all-zero leaf (biases and the
zero-init output projections, which would make the U-Net output exactly 0)
is filled with seeded normals, and the tree is carried into the port by
``params_from_jax`` and ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.diffusion import Diffusion as JaxDiffusion
from ml_mdm_tpu.models.unet import UNet as JaxUNet
from ml_mdm_tpu_torch.diffusion import Diffusion
from ml_mdm_tpu_torch.models.unet import UNet
from ml_mdm_tpu_torch.presets import flagship_configs
from ml_mdm_tpu_torch.utils.convert import params_from_jax

LM_LEN = 8


def fill_zero_leaves(params, seed: int = 0, scale: float = 0.02):
    """numpy copy of a JAX params tree with every all-zero leaf replaced by
    seeded normals times ``scale``."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        leaf = np.asarray(leaf)
        if not leaf.any():
            return (rng.standard_normal(leaf.shape) * scale).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map(fill, jax.device_get(params))


def jax_config_of(cfg):
    """The JAX package's dataclass with the same field values as the
    port's ``cfg`` (UNetConfig with its ResNetConfig, or DiffusionConfig)."""
    from dataclasses import asdict

    from ml_mdm_tpu.diffusion import DiffusionConfig as JDC
    from ml_mdm_tpu.models.layers import ResNetConfig as JRC
    from ml_mdm_tpu.models.unet import UNetConfig as JUC
    from ml_mdm_tpu.samplers import SamplerConfig as JSC

    d = asdict(cfg)
    if "resnet_config" in d:
        d["resnet_config"] = JRC(**d["resnet_config"])
        return JUC(**d)
    sc = {k: (str(v) if hasattr(v, "name") else v)
          for k, v in d["sampler_config"].items()}
    d["sampler_config"] = JSC(**sc)
    return JDC(**d)


def tiny_pair(seed: int = 0):
    """(jax pipeline, jax params as numpy, port pipeline, lm_dim, side) for
    the scaled flagship structure in f32."""
    ucfg, dcfg, lm_dim, side = flagship_configs(scaled=True)
    jmod = JaxUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32)
    jpipe = JaxDiffusion(jmod, jax_config_of(dcfg))
    params = jpipe.init_params(jax.random.PRNGKey(seed), image_side=side,
                               lm_dim=lm_dim, seq_len=LM_LEN)
    params = fill_zero_leaves(params, seed)
    unet = UNet(3, 3, ucfg)
    unet.load_state_dict(params_from_jax(params), strict=True)
    return jpipe, params, Diffusion(unet.eval(), dcfg), lm_dim, side


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in f32."""
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
