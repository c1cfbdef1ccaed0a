"""Shared fixtures of the port's parity tests (tests/test_torch_*.py): the
tiny flagship-structured U-Net, tiny nested U-Nets (the structure of
tests/test_files/tiny_nested_train.yaml, one or two shells deep), and tiny
U-Nets with the learned lm-head or in temporal mode, in both packages,
with the same weights.

Weights are initialised by JAX, every all-zero leaf (biases and the
zero-init output projections, which would make the U-Net output exactly 0)
is filled with seeded normals, and the tree is carried into the port by
``params_from_jax`` and ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.diffusion import Diffusion as JaxDiffusion
from ml_mdm_tpu.diffusion import NestedDiffusion as JaxNestedDiffusion
from ml_mdm_tpu.models.nested_unet import NestedUNet as JaxNestedUNet
from ml_mdm_tpu.models.unet import UNet as JaxUNet
from ml_mdm_tpu_torch.config import (
    NestedDiffusionConfig,
    NestedUNetConfig,
    ResNetConfig,
    UNetConfig,
    load_model_config,
)
from ml_mdm_tpu_torch.diffusion import Diffusion, NestedDiffusion
from ml_mdm_tpu_torch.models.nested_unet import NestedUNet
from ml_mdm_tpu_torch.models.unet import UNet
from ml_mdm_tpu_torch.presets import flagship_configs
from ml_mdm_tpu_torch.utils.convert import params_from_jax

LM_LEN = 8
NESTED_LM_DIM = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def seeded_params(jpipe, seed: int, **init_kw):
    """A params tree for ``jpipe``'s module without compiling its init
    (``seeded_tree`` over ``jpipe.init_params``)."""
    return seeded_tree(lambda k: jpipe.init_params(k, **init_kw), seed)


def seeded_tree(init_fn, seed: int):
    """A params tree shaped as ``init_fn(key)`` returns it, without
    compiling the init: the shapes from ``jax.eval_shape``, every leaf
    seeded normals (kernels scaled by 1/sqrt(fan-in), norm scales
    1 + 0.1 N, biases 0.02 N)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        v = rng.standard_normal(s.shape)
        if name == "kernel":
            v = v / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * v
        else:
            v = 0.02 * v
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(jpipe, seed: int, fast_init: bool, **init_kw):
    if fast_init:
        return seeded_params(jpipe, seed, **init_kw)
    return fill_zero_leaves(jpipe.init_params(jax.random.PRNGKey(seed), **init_kw), seed)


def jax_config_of(cfg):
    """The JAX package's dataclass with the same field values as the
    port's ``cfg`` (a U-Net config, nested or not, or a diffusion config)."""
    from ml_mdm_tpu.diffusion import DiffusionConfig as JDC
    from ml_mdm_tpu.diffusion import NestedDiffusionConfig as JNDC
    from ml_mdm_tpu.models.nested_unet import NestedUNetConfig as JNUC
    from ml_mdm_tpu.models.unet import UNetConfig as JUC
    from ml_mdm_tpu.samplers import SamplerConfig as JSC

    d = dataclasses.asdict(cfg)
    if "resnet_config" in d:
        # the JAX __post_init__ builds the nested dataclasses from the dicts
        return (JNUC if "inner_config" in d else JUC)(**d)
    sc = {k: (str(v) if hasattr(v, "name") else v)
          for k, v in d["sampler_config"].items()}
    d["sampler_config"] = JSC(**sc)
    return (JNDC if isinstance(cfg, NestedDiffusionConfig) else JDC)(**d)


def tiny_pair(seed: int = 0, fast_init: bool = False):
    """(jax pipeline, jax params as numpy, port pipeline, lm_dim, side) for
    the scaled flagship structure in f32 (``fast_init``: ``seeded_params``
    in place of the JAX init)."""
    ucfg, dcfg, lm_dim, side = flagship_configs(scaled=True)
    jmod = JaxUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32)
    jpipe = JaxDiffusion(jmod, jax_config_of(dcfg))
    params = _params(jpipe, seed, fast_init, image_side=side, lm_dim=lm_dim, seq_len=LM_LEN)
    unet = UNet(3, 3, ucfg)
    unet.load_state_dict(params_from_jax(params), strict=True)
    return jpipe, params, Diffusion(unet.eval(), dcfg), lm_dim, side


def unet_pair(ucfg, x_shape, n_videos: int, lm_dim: int, seed: int = 0):
    """(jax U-Net, its params as numpy, the port's U-Net in eval mode) for
    the port's U-Net config ``ucfg`` in f32, seeded weights
    (``seeded_tree``): the input has ``x_shape`` (rows, side, side, 3), the
    times and the text features (``lm_dim`` wide; 0: none) have
    ``n_videos`` rows, fewer than the input for a temporal U-Net."""
    jmod = JaxUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32)
    lm = jnp.zeros((n_videos, LM_LEN, lm_dim)) if lm_dim else None
    mask = jnp.ones((n_videos, LM_LEN)) if lm_dim else None
    params = seeded_tree(
        lambda k: jmod.init(k, jnp.zeros(x_shape), jnp.zeros((n_videos,), jnp.int32),
                            lm, mask, {})["params"], seed)
    unet = UNet(3, 3, ucfg)
    unet.load_state_dict(params_from_jax(params), strict=True)
    return jmod, params, unet.eval()


def lm_head_config(masked_cross_attention: int):
    """The scaled flagship structure with a learned lm-head of two layers."""
    ucfg = flagship_configs(scaled=True)[0]
    return dataclasses.replace(ucfg, num_lm_head_layers=2,
                               masked_cross_attention=masked_cross_attention)


def temporal_config(spatial_ds: bool, pos_emb: bool):
    """A tiny temporal U-Net: two levels of 32 and 64 channels, one ResNet
    each, one temporal attention layer per ResNet, no text."""
    return UNetConfig(
        resolution_channels=[32, 64], num_resnets_per_resolution=[1, 1],
        attention_levels=[1], num_attention_layers=[0, 1],
        num_temporal_attention_layers=[1, 1], temporal_mode=True,
        temporal_spatial_ds=spatial_ds, temporal_positional_encoding=pos_emb,
        conditioning_feature_dim=-1, masked_cross_attention=0,
        resnet_config=ResNetConfig(num_groups_norm=8, use_attention_ffn=False),
    )


def tiny_nested_configs(depth: int):
    """(U-Net config, diffusion config, image side) of the tiny nested
    model of tests/test_files/tiny_nested_train.yaml (depth 1: an 8/16
    shell around a 16/32 core, sides 32 and 16), with text features of
    width NESTED_LM_DIM; depth 2 wraps it in one more 8/16 shell (sides
    32, 16, 8). The diffusion config keeps the YAML's defaults, so the
    low-resolution residual is on."""
    ucfg, dcfg = load_model_config(os.path.join(REPO, "tests/test_files/tiny_nested_train.yaml"))
    ucfg.conditioning_feature_dim = NESTED_LM_DIM
    if depth == 2:
        middle = dataclasses.replace(ucfg, nesting=True, conditioning_feature_dim=-1)
        ucfg = NestedUNetConfig(
            resolution_channels=[8, 16], num_resnets_per_resolution=[1, 1],
            attention_levels=[], num_attention_layers=[0, 0],
            conditioning_feature_dim=NESTED_LM_DIM, masked_cross_attention=0,
            temporal_dim=64, micro_conditioning="scale:64",
            resnet_config=ResNetConfig(num_groups_norm=8), inner_config=middle,
        )
    return ucfg, dcfg, 32


def tiny_nested_pair(depth: int, seed: int = 0, fast_init: bool = False):
    """(jax pipeline, jax params as numpy, port pipeline, lm_dim, side) for
    the tiny nested model of ``tiny_nested_configs(depth)`` in f32: JAX
    init, all-zero leaves filled (``fast_init``: ``seeded_params``),
    ``params_from_jax``, strict load."""
    ucfg, dcfg, side = tiny_nested_configs(depth)
    jmod = JaxNestedUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32)
    jpipe = JaxNestedDiffusion(jmod, jax_config_of(dcfg))
    params = _params(jpipe, seed, fast_init, image_side=side, lm_dim=NESTED_LM_DIM,
                     seq_len=LM_LEN)
    unet = NestedUNet(3, 3, ucfg)
    unet.load_state_dict(params_from_jax(params), strict=True)
    return jpipe, params, NestedDiffusion(unet.eval(), dcfg), NESTED_LM_DIM, side


def with_diffusion_config(pair, **overrides):
    """A nested pair with the same modules and weights and pipelines built
    on a diffusion config with ``overrides`` (``mixed_ratio``,
    ``use_double_loss``, ...)."""
    jpipe, params, pipe, lm_dim, side = pair
    dcfg = dataclasses.replace(pipe.config, **overrides)
    return (JaxNestedDiffusion(jpipe.vision_module, jax_config_of(dcfg)), params,
            NestedDiffusion(pipe.vision_module, dcfg), lm_dim, side)


def jax_flat_noise(jpipe, key, images):
    """The timesteps and noise the JAX ``Diffusion.get_loss`` draws from
    ``key``, as keyword arguments of the port's ``get_loss``."""
    key, _ = jax.random.split(key)
    eps, _, _, _, time = jpipe.sampler.get_eps_time(key, jnp.asarray(images))
    return {"time": torch.from_numpy(np.array(time)).long(),
            "eps": torch.from_numpy(np.array(eps))}


def jax_nested_noise(jpipe, key, images):
    """The timesteps and per-resolution noise the JAX
    ``NestedDiffusion.get_loss`` draws from ``key``, as keyword arguments
    of the port's ``get_loss``."""
    k_et, k_renoise, _ = jax.random.split(key, 3)
    eps, _, _, _, time = jpipe.sampler.get_eps_time(k_et, jnp.asarray(images))
    scales = jpipe.scales
    b, side, _, c = images.shape
    keys = jax.random.split(k_renoise, len(scales))
    eps_list = [np.array(eps)] + [
        np.array(jax.random.normal(keys[i], (b, side * s // scales[0], side * s // scales[0], c),
                                   eps.dtype))
        for i, s in enumerate(scales) if i > 0]
    return {"time": torch.from_numpy(np.array(time)).long(),
            "eps": [torch.from_numpy(e) for e in eps_list]}


def load_subtree(module, params, prefix=()):
    """Load a JAX params subtree into a port module (wrapped under
    ``prefix`` so name-dependent conversion rules apply, then stripped);
    returns the module in eval mode."""
    tree = params
    for p in reversed(prefix):
        tree = {p: tree}
    sd = params_from_jax(tree)
    strip = "".join(f"{p.replace('_', '.')}." for p in prefix)
    module.load_state_dict({k[len(strip):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in f32."""
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
