"""Package-level checks of the PyTorch port: it never imports JAX, its
converter agrees with the JAX package's exporter, its config dataclasses
mirror the JAX ones, the shipped model YAMLs load as the JAX loader reads
them and the presets built in code equal them, and the full-width
flagship loads JAX weights strictly (slow)."""
import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.utils.torch_compat import params_to_torch_state_dict
from ml_mdm_tpu_torch import config as tcfg
from ml_mdm_tpu_torch.presets import flagship_configs, nested_configs
from ml_mdm_tpu_torch.utils.convert import params_from_jax
from torch_parity import jax_config_of, tiny_pair

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = (
        "import pkgutil, sys, importlib, ml_mdm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "ml_mdm_tpu_torch.__path__, 'ml_mdm_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'transformers', 'ml_mdm_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 10
    # the training and evaluation slices' modules among them
    assert {f"ml_mdm_tpu_torch.{m}" for m in (
        "native", "native.image", "native.tar", "native.trie_tokenizer", "reader",
        "utils.simple_logger", "trainer", "utils.checkpoint", "distributed", "parallel.mesh",
        "clis.train_parallel", "generate_html", "clis.generate_batch",
        # the evaluation slice's
        "clis.run_torchmetrics", "clis.build_vocab", "clis.download_tar_from_index",
        "clis.scrape_cc12m", "s3_helpers", "core", "language_models.clip",
        "language_models.clip_tokenizer", "tools.quality_gate")} <= names


def test_converter_matches_jax_exporter():
    _, params, pipe, _, _ = tiny_pair(seed=2)
    ref = params_to_torch_state_dict(params)
    got = params_from_jax(params)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert set(got) == set(pipe.vision_module.state_dict())
    # a bf16 tree (as the bench preset casts it) converts to the same values
    bf = params_from_jax(jax.tree_util.tree_map(
        lambda v: np.asarray(jnp.asarray(v).astype(jnp.bfloat16)), params))
    for k, v in got.items():
        assert bf[k].dtype == torch.bfloat16
        torch.testing.assert_close(bf[k], v.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["UNetConfig", "ResNetConfig",
                                  "SamplerConfig", "DiffusionConfig",
                                  "NestedUNetConfig", "NestedDiffusionConfig"])
def test_config_dataclasses_mirror_jax(name):
    from ml_mdm_tpu import diffusion, samplers
    from ml_mdm_tpu.models import layers, nested_unet, unet

    jax_cls = {"UNetConfig": unet.UNetConfig, "ResNetConfig": layers.ResNetConfig,
               "SamplerConfig": samplers.SamplerConfig,
               "DiffusionConfig": diffusion.DiffusionConfig,
               "NestedUNetConfig": nested_unet.NestedUNetConfig,
               "NestedDiffusionConfig": diffusion.NestedDiffusionConfig}[name]
    port_cls = getattr(tcfg, name)
    jf = {f.name: f for f in dataclasses.fields(jax_cls)}
    pf = {f.name: f for f in dataclasses.fields(port_cls)}
    assert list(jf) == list(pf)
    jd, pd = jax_cls(), port_cls()
    for k in jf:
        jv, pv = getattr(jd, k), getattr(pd, k)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(jv).keys() == dataclasses.asdict(pv).keys()
        else:
            assert str(jv) == str(pv), k


def test_enums_parse_like_jax():
    from ml_mdm_tpu import samplers

    for name in ("ScheduleType", "PredictionType", "ThresholdType"):
        jenum, penum = getattr(samplers, name), getattr(tcfg, name)
        assert [(m.name, m.value) for m in jenum] == [(m.name, m.value) for m in penum]
    assert tcfg.PredictionType.parse("ha_style") == tcfg.PredictionType.DDPM
    with pytest.raises(ValueError):
        tcfg.ScheduleType.parse("NOT_A_SCHEDULE")


def test_cc12m_64x64_yaml_loads():
    ucfg, dcfg = tcfg.load_model_config(
        os.path.join(REPO, "configs/models/cc12m_64x64.yaml"))
    assert ucfg.resolution_channels == [256, 512, 768]
    assert ucfg.resnet_config.use_attention_ffn
    sc = dcfg.sampler_config
    assert sc.schedule_type == tcfg.ScheduleType.DEEPFLOYD
    assert sc.prediction_type == tcfg.PredictionType.V_PREDICTION
    assert sc.threshold_function == tcfg.ThresholdType.CLIP
    # the flagship preset is this file with the T5-XL text width filled in
    pre_u, pre_d, lm_dim, _ = flagship_configs()
    assert dataclasses.replace(ucfg, conditioning_feature_dim=lm_dim) == pre_u
    assert dcfg.sampler_config == pre_d.sampler_config


def _plain(cfg):
    """A config dataclass as nested dicts, enums as their names."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return str(v) if isinstance(v, enum.Enum) else v

    return conv(dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ["cc12m_256x256", "cc12m_1024x1024"])
def test_nested_yaml_and_preset_match_jax_loader(name):
    from ml_mdm_tpu.config import get_arguments

    path = os.path.join(REPO, f"configs/models/{name}.yaml")
    args = get_arguments(args=["--config_path", path], mode="sampler")
    ucfg, dcfg = tcfg.load_model_config(path)
    assert type(ucfg).__name__ == type(args.unet_config).__name__
    assert _plain(ucfg) == _plain(args.unet_config)
    assert _plain(dcfg) == _plain(args.diffusion_config)
    # the preset is the YAML with the T5-XL text width on the outer shell,
    # as bench.py sets it
    pre_u, pre_d, lm_dim, side = nested_configs(name)
    args.unet_config.conditioning_feature_dim = lm_dim
    assert (lm_dim, side) == (2048, int(name.split("x")[-1]))
    assert _plain(pre_u) == _plain(args.unet_config)
    assert _plain(pre_d) == _plain(args.diffusion_config)


@pytest.mark.slow
def test_flagship_loads_jax_weights_strictly():
    from ml_mdm_tpu.diffusion import Diffusion as JaxDiffusion
    from ml_mdm_tpu.models.unet import UNet as JaxUNet
    from ml_mdm_tpu_torch.models.unet import UNet

    ucfg, dcfg, lm_dim, side = flagship_configs()
    jpipe = JaxDiffusion(JaxUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32),
                         jax_config_of(dcfg))
    params = jpipe.init_params(jax.random.PRNGKey(0), image_side=side,
                               lm_dim=lm_dim, seq_len=32)
    sd = params_from_jax(jax.device_get(params))
    with torch.device("meta"):
        unet = UNet(3, 3, ucfg)
    unet.load_state_dict(sd, strict=True, assign=True)
    assert sum(v.numel() for v in sd.values()) == sum(
        p.numel() for p in unet.parameters())
