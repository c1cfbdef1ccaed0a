"""The port's temporal modules against the JAX package: the attention
across frames (``TemporalAttentionBlock``, at the full and at half the
side), a stage's resample across frames (the 1-D conv, down and up), whole
tiny temporal U-Nets whose rows are the ``(b t)`` frames of b videos (with
the frame resample and rotary positions, and with ``temporal_spatial_ds``),
and the frame subsampling of the nested loss's image pyramid. Same seeded
weights (``params_from_jax``, ``load_state_dict(strict=True)``: the Conv1d
kernel and the 1-D attention's dense layers go through the converter), same
numpy inputs, f32.

Tolerances: modules and stages <= 1e-5 * max|ref| (the same f32 math, sums
in another order); the U-Nets <= 5e-4 * max|ref| (that of
``tests/test_torch_unet.py``); the pyramid exact (it only moves pixels).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_mdm_tpu.diffusion import NestedDiffusion as JaxNestedDiffusion
from ml_mdm_tpu.models import layers as jl
from ml_mdm_tpu.models.nested_unet import NestedUNet as JaxNestedUNet
from ml_mdm_tpu_torch.config import (
    NestedDiffusionConfig,
    NestedUNetConfig,
    ResNetConfig,
    UNetConfig,
)
from ml_mdm_tpu_torch.diffusion import image_pyramid
from ml_mdm_tpu_torch.models import layers as tl
from ml_mdm_tpu_torch.models.nested_unet import NestedUNet
from torch_parity import (
    jax_config_of,
    load_subtree,
    rel_err,
    seeded_tree,
    temporal_config,
    to_np,
    unet_pair,
)

torch.set_num_threads(1)

B, T, S, C, TDIM = 2, 4, 8, 32, 24


def _frames(seed, c=C):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B * T, S, S, c)).astype(np.float32),
            rng.standard_normal((B, TDIM)).astype(np.float32))


def _pair_outputs(jmod, port, x, temb, prefix, seed):
    params = seeded_tree(
        lambda k: jmod.init(k, jnp.asarray(x), jnp.asarray(temb))["params"], seed)
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        got = load_subtree(port, params, prefix)(torch.from_numpy(x), torch.from_numpy(temb))
    return np.asarray(ref), got


@pytest.mark.parametrize("down,pos_emb", [(False, False), (True, False), (True, True)])
def test_temporal_attention_block(down, pos_emb):
    x, temb = _frames(0, c=64)
    kw = dict(num_head_channels=32, down=down, pos_emb=pos_emb)
    ref, got = _pair_outputs(jl.TemporalAttentionBlock(64, **kw),
                             tl.TemporalAttentionBlock(64, **kw), x, temb, ("t_attn_0",), 1)
    assert got.shape == ref.shape == x.shape
    assert rel_err(to_np(got), ref) <= 1e-5


def test_frames_to_tokens_and_back():
    x = torch.arange(B * T * 3 * 5 * 2, dtype=torch.float32).reshape(B * T, 3, 5, 2)
    y = tl.frames_to_tokens(x, B)
    assert y.shape == (B * 3 * 5, T, 2)
    # the sequence of pixel (1, 2) of video 1 is that pixel in its T frames
    assert torch.equal(y[(1 * 3 + 1) * 5 + 2], x[T:2 * T, 1, 2])
    assert torch.equal(tl.tokens_to_frames(y, B, 3, 5), x)


@pytest.mark.parametrize("downsample,upsample,spatial_ds,frames_out,side_out", [
    (True, False, False, T // 2, S),    # the 1-D conv over frames, stride 2
    (False, True, False, T * 2, S),     # frames doubled, then the 1-D conv
    (True, False, True, T, S // 2),     # temporal_spatial_ds keeps the 2-D resample
    (False, True, True, T, S * 2),
])
def test_temporal_stage_resample(downsample, upsample, spatial_ds, frames_out, side_out):
    x, temb = _frames(2)
    rc = dict(num_channels=C, output_channels=C, num_groups_norm=8)
    kw = dict(temporal_dim=TDIM, num_residual_blocks=1, num_attention_layers=0,
              downsample_output=downsample, upsample_output=upsample,
              temporal_mode=True, temporal_spatial_ds=spatial_ds,
              num_temporal_attention_layers=1)
    jmod = jl.ResNetBlockStage(resnet_configs=[jl.ResNetConfig(**rc)], **kw)
    port = tl.ResNetBlockStage(resnet_configs=[ResNetConfig(**rc)], **kw)
    assert hasattr(port, "t_attn") != spatial_ds
    assert isinstance(port.resample, torch.nn.Conv2d if spatial_ds else torch.nn.Conv1d)
    ref, (got, acts) = _pair_outputs(jmod, port, x, temb, (), 3)
    assert got.shape == ref.shape == (B * frames_out, side_out, side_out, C)
    assert len(acts) == 2 and acts[-1] is got
    assert rel_err(to_np(got), ref) <= 1e-5


@pytest.mark.parametrize("spatial_ds,pos_emb", [(False, True), (True, False)])
def test_temporal_unet_matches_jax(spatial_ds, pos_emb):
    ucfg = temporal_config(spatial_ds, pos_emb)
    side = 16
    jmod, params, unet = unet_pair(ucfg, (B * T, side, side, 3), B, 0)
    n_tattn = sum(isinstance(m, tl.TemporalAttentionBlock) for m in unet.modules())
    assert n_tattn == (0 if spatial_ds else 6)  # one per ResNet: 2 down, 4 up
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B * T, side, side, 3)).astype(np.float32)
    t = np.array([17, 803], np.int32)  # one time per video
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), None, None, {})
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t).long(), None, None, {})
    assert got.shape == ref.shape == x.shape
    assert np.abs(np.asarray(ref)).max() > 1e-2
    assert rel_err(to_np(got), ref) <= 5e-4


def _shell(temporal, inner, nesting=False):
    return NestedUNetConfig(
        resolution_channels=[8, 8, 16], num_resnets_per_resolution=[1, 1, 1],
        attention_levels=[], num_attention_layers=[0, 0, 0], temporal_mode=temporal,
        nesting=nesting, resnet_config=ResNetConfig(num_groups_norm=8), inner_config=inner)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("temporal,scales,sides", [
    ((True,), [2, 1], [32, 16]),            # 16 frames -> every 4th: a 2 x 2 grid
    ((True, True), [4, 2, 1], [32, 16, 8]),  # ... -> every 16th of those 4: one frame
    ((True, False), [8, 4, 1], [32, 16, 4]),  # frames, then avg-pool by 4
    ((False,), [4, 1], [32, 8]),
])
def test_nested_pyramid_matches_jax_get_loss(monkeypatch, temporal, scales, sides):
    core = UNetConfig(resolution_channels=[8, 16], num_resnets_per_resolution=[1, 1],
                      attention_levels=[], num_attention_layers=[0, 0], nesting=True,
                      resnet_config=ResNetConfig(num_groups_norm=8))
    ucfg = core
    for flag in reversed(temporal):
        ucfg = _shell(flag, ucfg, nesting=True)
    ucfg.nesting = False
    port = NestedUNet(3, 3, ucfg)
    assert port.is_temporal == list(temporal)
    assert list(port.nest_ratio) + [1] == scales

    jmod = JaxNestedUNet(3, 3, jax_config_of(ucfg))
    assert list(jmod.is_temporal) == list(temporal)
    jpipe = JaxNestedDiffusion(jmod, jax_config_of(NestedDiffusionConfig()))
    images = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)

    def capture(images_list, *args, **kw):  # the pyramid is get_xt's first argument
        raise _Captured([np.asarray(x) for x in images_list])

    monkeypatch.setattr(jpipe.sampler, "get_xt", capture)
    with pytest.raises(_Captured) as caught:
        jpipe.get_loss(None, {"images": jnp.asarray(images), "lm_outputs": None,
                              "lm_mask": None}, jax.random.PRNGKey(0), train=False)
    ref = caught.value.args[0]
    got = image_pyramid(torch.from_numpy(images), scales, port.is_temporal)
    assert [tuple(g.shape) for g in got] == [(2, s, s, 3) for s in sides]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_np(g), r, rtol=0, atol=1e-6)
    if temporal == (True,):
        # frame (i, j) of the 4 x 4 grid is number 4 i + j: frames 0, 4, 8, 12 stay
        x, y = images, to_np(got[1])
        for n, (gi, gj) in enumerate([(0, 0), (1, 0), (2, 0), (3, 0)]):
            oi, oj = divmod(n, 2)
            np.testing.assert_array_equal(y[:, oi * 8:(oi + 1) * 8, oj * 8:(oj + 1) * 8],
                                          x[:, gi * 8:(gi + 1) * 8, gj * 8:(gj + 1) * 8])
