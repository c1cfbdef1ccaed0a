"""Dropout in the port's training ResNet (``ml_mdm_tpu/models/layers.py``
``ResNet`` with ``dropout`` > 0, the JAX package's plain route: silu, Flax's
``nn.Dropout``, conv2, the residual), f32 on the CPU:

- JAX's own masks, captured without touching the JAX package
  (``capture_intermediates`` records each ResNet's ``drop`` output; a
  Flax mask depends only on the rng and the shape, so the apply that
  captures them draws the masks the loss's apply draws), fed to the port
  (``set_dropout_masks`` / ``get_loss(..., dropout=...)``): one ResNet's
  output and gradients, and the tiny flagship-structured U-Net's
  ``get_loss`` and its parameter gradients, within 1e-5 of JAX's, on both
  the kernel route (``conv3x3_vjp``, whose plain versions run on the CPU)
  and the plain route (``use_kernels(False)``);
- the port's own masks (``DropoutMasks``): one generator seed gives the same
  masks, the kept fraction of each is within 4 sigma of 0.9, a stage
  recomputed in the backward (remat) draws the same mask again, and eval
  mode ignores dropout;
- ``fused_resnet.conv3x3_vjp`` against autograd of ``F.conv2d`` (dx, dw,
  dbias, the residual's gradient) and, packed, of the plain packed
  convolution;
- a narrow copy of configs/models/cifar10_32x32.yaml (dropout 0.1,
  categorical conditioning through data/cifar10.vocab) trains 2 steps
  through the port's ``train_parallel`` on a tar shard of class-captioned
  JPEGs, and ``generate_batch`` samples its checkpoint.
"""
import dataclasses
import io
import os
import tarfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp

from ml_mdm_tpu.diffusion import Diffusion as JaxDiffusion
from ml_mdm_tpu.models.layers import ResNet as JaxResNet
from ml_mdm_tpu.models.layers import ResNetConfig as JaxResNetConfig
from ml_mdm_tpu.models.unet import UNet as JaxUNet
from ml_mdm_tpu_torch import trainer
from ml_mdm_tpu_torch.clis import generate_batch, train_parallel
from ml_mdm_tpu_torch.config import ResNetConfig, get_arguments
from ml_mdm_tpu_torch.diffusion import Diffusion
from ml_mdm_tpu_torch.language_models import factory
from ml_mdm_tpu_torch.models.layers import DropoutMasks, ResNet, set_dropout_masks
from ml_mdm_tpu_torch.models.unet import UNet
from ml_mdm_tpu_torch.ops import fused_resnet
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from ml_mdm_tpu_torch.presets import flagship_configs
from ml_mdm_tpu_torch.reader import process_text
from ml_mdm_tpu_torch.utils.convert import _torch_name, params_from_jax
from torch_parity import (
    LM_LEN,
    fill_zero_leaves,
    jax_config_of,
    jax_flat_noise,
    load_subtree,
    rel_err,
    seeded_params,
    to_np,
)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RATE = 0.1
TOL = 1e-5
# the reader settings the categorical recipe needs: data/cifar10.vocab has
# no "<pad>" (the YAML's padding token), and the one-hot reads the second
# token, which is the class name's only after a BOS
CIFAR_READER = ["--reader_config.padding_token", "</s>", "--reader_config.prepad_bos", "true"]


def _masks_of(intermediates) -> dict:
    """{JAX module path: the keep mask} from captured ``drop`` outputs."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "drop":
                out[path] = np.asarray(v["__call__"][0]) != 0
            elif hasattr(v, "items"):
                walk(v, path + (k,))

    walk(intermediates, ())
    return out


def _feeder(module, masks):
    """A port mask source that hands each ResNet of ``module`` JAX's mask
    of the same module path."""
    names = {m: n for n, m in module.named_modules()}

    def feed(resnet, shape, device):
        path = tuple(p for p in names[resnet].split("."))
        jpath = next(k for k in masks if ".".join(_torch_name(k)) == ".".join(path))
        keep = torch.from_numpy(masks[jpath])
        assert tuple(keep.shape) == tuple(shape)
        return keep.to(device)

    return feed


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("cin", [16, 32])
def test_resnet_matches_jax_with_its_masks(kernels, cin):
    cfg = dict(num_channels=cin, output_channels=32, num_groups_norm=8, dropout=RATE)
    jres = JaxResNet(JaxResNetConfig(**cfg))
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = rng.standard_normal((2, 24)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    params = fill_zero_leaves(jres.init(jax.random.PRNGKey(0), x, temb)["params"], seed=cin)
    key = jax.random.PRNGKey(5)

    def jloss(p, xx):
        out = jres.apply({"params": p}, xx, temb, train=True, rngs={"dropout": key})
        return jnp.sum(out * cot)

    ref_loss, (ref_gp, ref_gx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, x)
    _, inter = jres.apply({"params": params}, x, temb, train=True, rngs={"dropout": key},
                          capture_intermediates=True, mutable=["intermediates"])
    keep = np.asarray(inter["intermediates"]["drop"]["__call__"][0]) != 0
    assert abs(keep.mean() - (1 - RATE)) < 0.05

    res = load_subtree(ResNet(ResNetConfig(**cfg), 24), params).train()
    res.kernels = kernels
    res.dropout_masks = lambda m, shape, device: torch.from_numpy(keep)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = res(tx, torch.from_numpy(temb))
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    assert rel_err(to_np(tx.grad), ref_gx) <= TOL
    ref_gp = params_from_jax(jax.device_get(ref_gp))
    for name, p in res.named_parameters():
        assert rel_err(to_np(p.grad), ref_gp[name].numpy()) <= TOL, name


def _dropout_pair(seed=3):
    """The tiny flagship structure with dropout 0.1 in both packages, f32."""
    ucfg, dcfg, lm_dim, side = flagship_configs(scaled=True)
    ucfg = dataclasses.replace(ucfg, resnet_config=dataclasses.replace(ucfg.resnet_config,
                                                                       dropout=RATE))
    jmod = JaxUNet(3, 3, jax_config_of(ucfg), dtype=jnp.float32)
    jpipe = JaxDiffusion(jmod, jax_config_of(dcfg))
    params = seeded_params(jpipe, seed, image_side=side, lm_dim=lm_dim, seq_len=LM_LEN)
    unet = UNet(3, 3, ucfg)
    unet.load_state_dict(params_from_jax(params), strict=True)
    return jpipe, params, Diffusion(unet, dcfg), lm_dim, side


@pytest.fixture(scope="module")
def pair():
    return _dropout_pair()


def _batch(b, side, lm_dim, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, LM_LEN), np.float32)
    mask[0, 5:] = 0
    return {"images": np.clip(rng.standard_normal((b, side, side, 3)) * 0.5, -1, 1
                              ).astype(np.float32),
            "lm_outputs": rng.standard_normal((b, LM_LEN, lm_dim)).astype(np.float32),
            "lm_mask": mask}


@pytest.mark.parametrize("kernels", [True, False])
def test_unet_loss_and_gradients_match_jax_with_its_masks(pair, kernels):
    jpipe, params, pipe, lm_dim, side = pair
    batch = _batch(2, side, lm_dim, seed=6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(8)

    def jloss(p):
        return jnp.mean(jpipe.get_loss(p, jb, key, train=True)[0])

    ref_loss, ref = jax.jit(jax.value_and_grad(jloss))(params)
    # the masks get_loss's apply draws: a Flax mask is a function of the
    # rng (its dropout key, folded by the module path) and the shape only
    noise = jax_flat_noise(jpipe, key, batch["images"])
    _, k_drop = jax.random.split(key)
    _, inter = jpipe.vision_module.apply(
        {"params": params}, jb["images"], jnp.asarray(noise["time"].numpy()), jb["lm_outputs"],
        jb["lm_mask"], {}, train=True, rngs={"dropout": k_drop}, capture_intermediates=True,
        mutable=["intermediates"])
    masks = _masks_of(inter["intermediates"])
    unet = pipe.vision_module.train().use_kernels(kernels)
    assert len(masks) == sum(isinstance(m, ResNet) for m in unet.modules()) >= 8
    unet.zero_grad()
    loss = pipe.get_loss({k: torch.from_numpy(v) for k, v in batch.items()}, **noise,
                         dropout=_feeder(unet, masks))[0].mean()
    loss.backward()
    unet.use_kernels(True).eval()
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    ref = params_from_jax(jax.device_get(ref))
    top = max(float(v.abs().max()) for v in ref.values())
    for name, p in unet.named_parameters():
        r = ref[name].numpy()
        g = to_np(p.grad) if p.grad is not None else np.zeros_like(r)
        # a gradient that is 0 up to rounding is held to the largest's scale
        assert np.abs(g - r).max() <= TOL * max(np.abs(r).max(), 1e-3 * top), name


def _port_loss_grads(pipe, batch, generator_seed, remat=None):
    unet = pipe.vision_module.train()
    trainer.set_remat(unet, remat)
    unet.zero_grad()
    g = torch.Generator().manual_seed(generator_seed)
    loss = pipe.get_loss(batch, g)[0].mean()
    masks = next(m.dropout_masks for m in unet.modules() if isinstance(m, ResNet))
    loss.backward()
    trainer.set_remat(unet, None)
    unet.eval()
    return float(loss), {n: p.grad.clone() for n, p in unet.named_parameters()}, masks


def test_own_masks_seeded_kept_fraction_remat_and_eval(pair):
    _, _, pipe, lm_dim, side = pair
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, side, lm_dim, seed=9).items()}
    loss1, grads1, masks1 = _port_loss_grads(pipe, batch, 11)
    loss2, grads2, masks2 = _port_loss_grads(pipe, batch, 11)
    loss3, _, masks3 = _port_loss_grads(pipe, batch, 12)
    assert isinstance(masks1, DropoutMasks) and masks1.base == masks2.base != masks3.base
    assert loss1 == loss2 != loss3
    for n in grads1:
        assert torch.equal(grads1[n], grads2[n]), n
    # every mask's kept fraction within 4 sigma of 1 - rate
    assert len(masks1.kept) >= 8
    for kept, n in masks1.kept.values():
        sigma = np.sqrt(RATE * (1 - RATE) / n)
        assert abs(float(kept) / n - (1 - RATE)) <= 4 * sigma
    # every stage recomputed in the backward draws its masks again: the same
    loss_r, grads_r, _ = _port_loss_grads(pipe, batch, 11, remat=0)
    assert loss_r == loss1
    for n in grads1:
        torch.testing.assert_close(grads_r[n], grads1[n], rtol=1e-6, atol=1e-9)
    # eval mode has no dropout: the same output as the module without it
    unet = pipe.vision_module.eval()
    nodrop = UNet(3, 3, dataclasses.replace(unet.config, resnet_config=dataclasses.replace(
        unet.config.resnet_config, dropout=0.0)))
    nodrop.load_state_dict(unet.state_dict())
    x = torch.randn(2, side, side, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 700])
    with torch.no_grad():
        a = unet(x, t, batch["lm_outputs"], batch["lm_mask"], {})
        b = nodrop.eval()(x, t, batch["lm_outputs"], batch["lm_mask"], {})
    assert torch.equal(a, b)


def test_dropout_needs_a_generator_or_masks(pair):
    _, _, pipe, lm_dim, side = pair
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, side, lm_dim, seed=9).items()}
    pipe.vision_module.train()
    try:
        with pytest.raises(ValueError, match="dropout"):
            pipe.get_loss(batch, time=torch.tensor([1, 2]), eps=torch.randn(2, side, side, 3))
        set_dropout_masks(pipe.vision_module, None)
        with pytest.raises(RuntimeError, match="masks"):
            pipe.vision_module(torch.randn(2, side, side, 3), torch.tensor([1, 2]),
                               batch["lm_outputs"], batch["lm_mask"], {})
    finally:
        pipe.vision_module.eval()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_identity_prologue_backward_against_autograd(packed, residual):
    g = torch.Generator().manual_seed(int(packed) * 2 + int(residual))
    c, cout = 8, 16
    x = torch.randn(2, 8, 8, c, generator=g)
    w = torch.randn(3, 3, c, cout, generator=g) / 8
    bias = torch.randn(cout, generator=g)
    res = torch.randn(2, 8, 8, cout, generator=g) if residual else None
    cot = torch.randn(2, 8, 8, cout, generator=g)
    if packed:
        x, cot = s2d.space_to_depth(x), s2d.space_to_depth(cot)
        res = None if res is None else s2d.space_to_depth(res)
    ins = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    rin = None if res is None else res.clone().requires_grad_(True)
    vec = s2d.pack_channel_vector if packed else (lambda v: v)
    kern = s2d.pack_conv3x3_kernel if packed else (lambda v: v)
    y = fused_resnet.conv3x3_vjp(ins[0], kern(ins[1]), vec(ins[2]), rin, packed_struct=packed)
    (y * cot).sum().backward()
    refs = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    rref = None if res is None else res.clone().requires_grad_(True)
    if packed:
        yr = fused_resnet.affine_silu_conv3x3_plain(refs[0], None, None, kern(refs[1]),
                                                    vec(refs[2]), rref, apply_silu=False,
                                                    packed_struct=True)
    else:
        yr = F.conv2d(refs[0].permute(0, 3, 1, 2), refs[1].permute(3, 2, 0, 1), refs[2],
                      padding=1).permute(0, 2, 3, 1)
        if rref is not None:
            yr = yr + rref
    (yr * cot).sum().backward()
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    for a, b in zip(ins + ([rin] if rin is not None else []),
                    refs + ([rref] if rref is not None else [])):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def _cifar_shard(path, n=12, seed=0):
    """A tar shard of ``n`` JPEGs (sides 32-48 px, seeded smooth colour
    fields) captioned with class names of data/cifar10.vocab, its TSV and
    an index TSV; returns the index's path."""
    from PIL import Image

    with open(os.path.join(REPO, "data", "cifar10.vocab")) as f:
        classes = [line.split("\t")[0] for line in f][3:]
    rng = np.random.default_rng(seed)
    with tarfile.open(f"{path}/cifar_00000.tar", "w", format=tarfile.USTAR_FORMAT) as tf, \
            open(f"{path}/cifar_00000.tsv", "w") as tsv:
        tsv.write("tar\tfile\tcaption\n")
        for i in range(n):
            w, h = (int(v) for v in rng.integers(32, 49, size=2))
            small = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
            buf = io.BytesIO()
            small.resize((w, h), Image.BICUBIC).save(buf, "JPEG", quality=90)
            info = tarfile.TarInfo(f"{i:06d}.jpg")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
            tsv.write(f"{path}/cifar_00000.tar\t{info.name}\t{classes[i % len(classes)]}\n")
    with open(f"{path}/index.tsv", "w") as f:
        f.write(f"filename\n{path}/cifar_00000.tsv\n")
    return f"{path}/index.tsv"


def test_narrow_cifar10_trains_through_the_cli(tmp_path):
    with open(os.path.join(REPO, "configs", "models", "cifar10_32x32.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["unet_config"]["resnet_config"]["dropout"] == RATE
    cfg["unet_config"]["resolution_channels"] = [16, 32, 32]
    cfg["unet_config"]["resnet_config"]["num_groups_norm"] = 8
    cfg["unet_config"]["conditioning_feature_proj_dim"] = 16
    cfg["reader_config"].update(num_readers=1, reader_buffer_size=8, shuffle_buffer_size=8)
    cfg["vocab_file"] = os.path.join(REPO, "data", "cifar10.vocab")
    narrow = tmp_path / "cifar10_narrow.yaml"
    narrow.write_text(yaml.safe_dump(cfg))
    index = _cifar_shard(str(tmp_path))
    out = tmp_path / "out"
    history = []
    args = get_arguments(["--config_path", str(narrow), "--file-list", index, "--device", "cpu",
                          "--batch-size", "4", "--num-training-steps", "2", "--save-freq", "2",
                          "--output-dir", str(out), *CIFAR_READER], mode="trainer")
    # the class name's token is the one-hot's index: the categorical recipe
    tok, lm = factory.create_lm(args, "cpu")
    tokens = process_text(["airplane", "truck"], tok, args.reader_config)
    onehot, _ = lm({"tokens": tokens}, tok)
    assert onehot.argmax(-1)[:, 0].tolist() == [tok.token_id("airplane"), tok.token_id("truck")]
    state = train_parallel.main(args, history)
    assert state.step == 2 and [n for n, *_ in history] == [1, 2]
    assert all(np.isfinite(loss) and np.isfinite(norm) for _, loss, norm, _ in history)
    samples = tmp_path / "samples"
    n = generate_batch.main(
        get_arguments(["--config_path", str(narrow), "--test-file-list", index, "--device", "cpu",
                       "--model-file", str(out / "vis_model_000002.pth"), "--sample-dir",
                       str(samples), "--min-examples", "4", "--batch-size", "4", *CIFAR_READER],
                      mode="sampler"), num_inference_steps=3)
    assert n == 4 and len([f for f in os.listdir(samples / "rank0")
                           if f.startswith("s_")]) == 4


def test_packed_dropout_resnet_matches_unpacked():
    """A training ResNet with dropout on the space-to-depth packed layout
    (its mask drawn on the packed tensor: here the unpacked mask packed)
    gives the unpacked ResNet's output and gradients within 1e-5 of each
    tensor's largest, on both routes."""
    cfg = ResNetConfig(num_channels=16, output_channels=32, num_groups_norm=8, dropout=RATE)
    g = torch.Generator().manual_seed(4)
    res = ResNet(cfg, 24).train()
    with torch.no_grad():
        for p in res.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.dim() == 1 else 0.0))
    x = torch.randn((2, 8, 8, 16), generator=g)
    temb = torch.randn((2, 24), generator=g)
    keep = torch.rand((2, 8, 8, 32), generator=g) < 1 - RATE
    cot = torch.randn((2, 8, 8, 32), generator=g)
    for kernels in (True, False):
        res.kernels = kernels
        outs = []
        for packed in (False, True):
            res.zero_grad()
            res.dropout_masks = (lambda m, shape, device, p=packed:
                                 s2d.space_to_depth(keep) if p else keep)
            tx = x.clone().requires_grad_(True)
            y = res(s2d.space_to_depth(tx) if packed else tx, temb, packed=packed)
            y = s2d.depth_to_space(y) if packed else y
            (y * cot).sum().backward()
            outs.append([y.detach(), tx.grad] + [p.grad.clone() for p in res.parameters()])
        for a, b in zip(*outs):  # f32 sums in another order
            assert rel_err(to_np(b), to_np(a)) <= 1e-5
