"""The port's attention against the JAX package: the plain version of the
flash kernel K4, the routing of ``dot_product_attention``, the 1-D attention
modules (rotary positions, ``SelfAttention1D``, ``MLP``,
``SelfAttention1DBlock``), a U-Net with the learned lm-head, and the route
end to end: the tiny flagship-structured U-Net at side 32 (so its 16 x 16
attention level has 256 tokens) with the flash route on, one forward and a
3-step DDIM sample. Same weights, same numpy inputs.

On the CPU the flash route runs ``reference_flash_attention``; the CUDA
kernel itself is held against it in ``tests/test_torch_cuda.py``. JAX's
Pallas ``flash_attention`` runs in interpret mode, as ``tests/test_ops.py``
runs it; its routed flash path exists only on a TPU, so the JAX U-Net runs
its einsum attention, the same function.

Tolerances: the plain version against the Pallas kernel and the einsum
path 2e-5 in f32 and 2e-2 in bf16 (those of ``tests/test_ops.py``); f32
modules <= 1e-5 * max|ref|; the U-Nets <= 5e-4 * max|ref| and the sample
<= 1e-3 max-abs (those of ``tests/test_torch_unet.py`` and
``tests/test_torch_sampler.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ml_mdm_tpu.models import layers as jl
from ml_mdm_tpu.ops import attention as jatt
from ml_mdm_tpu_torch.models import layers as tl
from ml_mdm_tpu_torch.ops import attention as att
from torch_parity import (
    LM_LEN,
    lm_head_config,
    load_subtree,
    rel_err,
    seeded_tree,
    tiny_pair,
    to_np,
    unet_pair,
)

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _flash_flag_from_environment(monkeypatch):
    monkeypatch.delenv("ML_MDM_TPU_FLASH", raising=False)
    att.use_flash(None)
    yield
    att.use_flash(None)


@pytest.fixture
def flash_calls(monkeypatch):
    """The calls that reach the plain version of K4 (where a CPU tensor on
    the flash route ends)."""
    calls = []
    plain = att.reference_flash_attention

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return plain(q, k, v)

    monkeypatch.setattr(att, "reference_flash_attention", spy)
    return calls


def _qkv(b, lq, lk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32) for l in (lq, lk, lk))


@pytest.mark.parametrize("lq,lk", [(256, 256), (128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_flash_attention_matches_jax(lq, lk, dtype):
    qkv = _qkv(2, lq, lk, 4, 32)
    jq, jk, jv = (jnp.asarray(t).astype(JDT[dtype]) for t in qkv)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jatt.flash_attention(jq, jk, jv), np.float32)
    einsum = np.asarray(jatt._einsum_attention(jq, jk, jv), np.float32)
    got = att.reference_flash_attention(*(torch.from_numpy(t).to(TDT[dtype]) for t in qkv))
    assert got.dtype == TDT[dtype] and got.shape == (2, lq, 4, 32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_np(got), kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(to_np(got), einsum, rtol=tol, atol=tol)


@pytest.mark.parametrize("lq,lk,d,ok", [
    (256, 256, 64, True), (1024, 1024, 96, True), (128, 384, 32, True),
    (256, 256, 256, True),      # the CPU's plain version takes the JAX rule's widest head
    (100, 100, 16, False), (256, 32, 64, False), (64, 256, 64, False),
    (256, 256, 272, False),
])
def test_flash_supported(lq, lk, d, ok):
    q, k = torch.zeros((1, lq, 2, d)), torch.zeros((1, lk, 2, d))
    assert att._flash_supported(q, k) == ok


@pytest.mark.parametrize("flag,lq,lk,masked,routed", [
    (False, 128, 128, False, False),    # the default
    (True, 128, 256, False, True),
    (True, 128, 128, True, False),      # a mask keeps the matmul route
    (True, 128, 32, False, False),      # the text length
    (True, 96, 128, False, False),
])
def test_dot_product_attention_routing(flash_calls, flag, lq, lk, masked, routed):
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, lq, lk, 2, 16, seed=1))
    mask = None
    if masked:
        mask = torch.ones((2, lk))
        mask[0, lk // 2:] = 0
    att.use_flash(flag)
    got = att.dot_product_attention(q, k, v, mask=mask)
    assert len(flash_calls) == int(routed)
    ref = att.matmul_attention(q, k, v, mask)
    if routed:
        assert rel_err(to_np(got), to_np(ref)) <= 2e-5
    else:
        assert torch.equal(got, ref)
    jm = None if mask is None else jnp.asarray(mask.numpy())
    jref = jatt._einsum_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jm)
    assert rel_err(to_np(got), jref) <= 2e-5


def test_use_flash_none_gives_the_choice_back_to_the_environment(monkeypatch):
    assert not att._use_flash()
    monkeypatch.setenv("ML_MDM_TPU_FLASH", "1")
    assert att._use_flash()
    att.use_flash(False)
    assert not att._use_flash()
    att.use_flash(None)
    assert att._use_flash()
    monkeypatch.setenv("ML_MDM_TPU_FLASH", "0")
    assert not att._use_flash()
    att.use_flash(True)
    assert att._use_flash()


def test_flash_route_has_no_backward(flash_calls):
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 128, 128, 2, 16, seed=2))
    att.use_flash(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        att.dot_product_attention(q.clone().requires_grad_(True), k, v)
    with pytest.raises(NotImplementedError):
        att.flash_attention(q, k, v.clone().requires_grad_(True))
    assert flash_calls == []
    with torch.no_grad():  # as sampling runs
        att.dot_product_attention(q.clone().requires_grad_(True), k, v)
    assert len(flash_calls) == 1
    att.use_flash(False)  # the matmul route differentiates
    qg = q.clone().requires_grad_(True)
    att.dot_product_attention(qg, k, v).sum().backward()
    assert qg.grad is not None and len(flash_calls) == 1


@pytest.mark.parametrize("bf16_logits", ["1", "0"])
def test_matmul_route_logits_dtype_gate(monkeypatch, bf16_logits):
    monkeypatch.setenv("ML_MDM_TPU_BF16_LOGITS", bf16_logits)
    qkv = _qkv(2, 64, 48, 2, 32, seed=3)
    ref = jatt._einsum_attention(*(jnp.asarray(t).astype(jnp.bfloat16) for t in qkv))
    got = att.dot_product_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in qkv))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output, and under bf16 logits a rounding of S
    # that the two libraries' matrix products need not share
    assert rel_err(to_np(got), np.asarray(ref, np.float32)) <= 1e-2
    f32 = att.matmul_attention(*(torch.from_numpy(t) for t in qkv))
    assert rel_err(to_np(got), to_np(f32)) <= 2e-2


def test_rotary_embedding():
    x = np.random.default_rng(4).standard_normal((2, 3, 7, 16)).astype(np.float32)
    ref = jl.rotary_embedding(jnp.asarray(x))
    got = tl.rotary_embedding(torch.from_numpy(x))
    assert rel_err(to_np(got), ref) <= 1e-6
    assert tl.rotary_embedding(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.float32


def _module_pair(jmod, port, x, *args, prefix=("mod",), seed=5):
    """(JAX output, the port's output) of a module pair on the same input,
    with the same seeded weights."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = seeded_tree(lambda k: jmod.init(k, jnp.asarray(x), *jargs)["params"], seed)
    ref = jmod.apply({"params": params}, jnp.asarray(x), *jargs)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    with torch.no_grad():
        got = load_subtree(port, params, prefix)(torch.from_numpy(x), *targs)
    return np.asarray(ref), to_np(got)


def _tokens(b=2, l=6, c=64, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[0, 4:] = 0
    mask[1, 1:] = 0
    return x, mask


@pytest.mark.parametrize("pos_emb,masked,ffn", [
    (False, False, False), (True, False, False), (False, True, False), (True, True, True),
])
def test_self_attention_1d(pos_emb, masked, ffn):
    x, mask = _tokens()
    kw = dict(num_head_channels=16, pos_emb=pos_emb, use_attention_ffn=ffn)
    ref, got = _module_pair(jl.SelfAttention1D(64, **kw), tl.SelfAttention1D(64, **kw),
                            x, mask if masked else None)
    assert got.shape == ref.shape == x.shape
    assert rel_err(got, ref) <= 1e-5


def test_mlp():
    x, _ = _tokens(seed=7)
    ref, got = _module_pair(jl.MLP(64, multiplier=2), tl.MLP(64, multiplier=2), x)
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_1d_block(masked):
    x, mask = _tokens(seed=8)
    ref, got = _module_pair(jl.SelfAttention1DBlock(64), tl.SelfAttention1DBlock(64),
                            x, mask if masked else None, prefix=("lm_head_0",))
    assert rel_err(got, ref) <= 1e-5


def _unet_inputs(lm_dim, side, b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    t = np.array([17, 803][:b], np.int32)
    lm = rng.standard_normal((b, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((b, LM_LEN), np.float32)
    mask[0, 5:] = 0
    return x, t, lm, mask


@pytest.mark.parametrize("masked_cross_attention", [0, 1])
def test_unet_with_lm_head_matches_jax(masked_cross_attention):
    ucfg = lm_head_config(masked_cross_attention)
    lm_dim, side = ucfg.conditioning_feature_dim, 16
    jmod, params, unet = unet_pair(ucfg, (2, side, side, 3), 2, lm_dim)
    assert len(unet.lm_head) == 2
    x, t, lm, mask = _unet_inputs(lm_dim, side, seed=9)
    ref = jmod.apply({"params": params}, *(jnp.asarray(a) for a in (x, t, lm, mask)), {})
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(lm),
                   torch.from_numpy(mask), {})
        other = unet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(lm),
                     torch.ones_like(torch.from_numpy(mask)), {})
    assert np.abs(np.asarray(ref)).max() > 1e-2
    assert rel_err(to_np(got), ref) <= 5e-4
    # unmasked heads pool with a plain mean: the mask then reaches nothing
    assert torch.equal(got, other) == (masked_cross_attention == 0)


# -- end to end: the flash route through the U-Net and the sampler --

FLASH_SIDE = 32  # level 1 is 16 x 16 = 256 tokens; level 2 (64 tokens) stays on matmul


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=2, fast_init=True)


def test_unet_with_flash_route_matches_jax(pair, flash_calls):
    jpipe, params, pipe, lm_dim, _ = pair
    x, t, lm, mask = _unet_inputs(lm_dim, FLASH_SIDE, seed=10)
    ref = jpipe.model(params, *(jnp.asarray(a) for a in (x, t, lm, mask)), {})
    args = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(lm),
            torch.from_numpy(mask), {})
    with torch.no_grad():
        off = pipe.model(*args)
        assert flash_calls == []
        att.use_flash(True)
        got = pipe.model(*args)
    # the level-1 stages hold three ResNets, each followed by one self-attention
    assert flash_calls == [(2, 256, 8, 8)] * 3
    assert rel_err(to_np(got), ref) <= 5e-4
    assert rel_err(to_np(off), ref) <= 5e-4
    unet = pipe.vision_module
    try:  # a training forward differentiates: the flash route refuses it
        with pytest.raises(NotImplementedError, match="no backward"):
            unet.train()(*args)
    finally:
        unet.eval()


def test_ddim_sample_with_flash_route_matches_jax(pair, flash_calls):
    jpipe, params, pipe, lm_dim, _ = pair
    rng = np.random.default_rng(11)
    b, side, steps = 2, FLASH_SIDE, 3
    noise = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    lm = rng.standard_normal((b, LM_LEN, lm_dim)).astype(np.float32)
    mask = np.ones((b, LM_LEN), np.float32)
    kw = dict(num_inference_steps=steps, resample_steps=True, ddim_eta=0.0, guidance_scale=1.0)
    ref = jpipe.sampler.sample(jpipe.model.fn(params), jnp.asarray(noise), jnp.asarray(lm),
                               jnp.asarray(mask), {}, jax.random.PRNGKey(0), **kw)
    att.use_flash(True)
    got = pipe.sample(b, {"lm_outputs": torch.from_numpy(lm), "lm_mask": torch.from_numpy(mask)},
                      side, noise=torch.from_numpy(noise), **kw)
    assert len(flash_calls) == 3 * steps
    assert got.shape == (b, side, side, 3) and float(got.abs().max()) <= 1.0
    assert 0.05 < float((got.abs() < 0.99).float().mean())
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-3)
