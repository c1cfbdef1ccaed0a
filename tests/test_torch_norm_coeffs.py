"""K5 (``ml_mdm_tpu_torch/ops/norm_coeffs.py``): the norms' coefficient math
in one launch, against the chains it replaces.

On the CPU: the plain versions give the bits of the eager chains they
replace (written out below as the models computed them: the sums
concatenated, the vectors repeated, ``group_norm_coeffs_from_sums``, the
FiLM fold; ``LayerNormF32``'s statistics and roundings) over bf16 and f32
parameters, ``repeat`` 1 and 4, FiLM on and off, 1-4 operands; the models
take K5 for every norm of a sampling forward, and the plain chain where a
gradient is needed or ``use_kernels(False)`` is set.

On the card (skipped elsewhere; no JAX here, so they run without the
directory's conftest: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_norm_coeffs.py -q``): the kernels against their plain
versions, (a, b) within f32 rounding (<= 1e-5 of max|plain|: the same
arithmetic, a group's sums added in another order), ``layer_norm`` within
two bf16 ULPs of the cell (a and b rounded to bf16 from statistics that
differ in their last f32 bits) and bit for bit where the statistics are
equal (rows whose sums are exact in any order); two calls the same bits;
and the launch budgets: a ResNet's norm1 one K1 an operand and one K5,
its norm2 with FiLM the time layer's SiLU and dense and one K5, a
``GroupNormF32`` at most four launches, a ``LayerNormF32`` one.
"""
import pytest
import torch
import torch.nn.functional as F

from ml_mdm_tpu_torch.config import ResNetConfig
from ml_mdm_tpu_torch.models.layers import (
    GroupNormF32,
    LayerNormF32,
    ResNet,
    SelfAttention,
    dense,
)
from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats, norm_coeffs
from ml_mdm_tpu_torch.ops import space_to_depth as s2d

BF = torch.bfloat16


# -- the chains K5 replaces, as the models computed them ----------------------


def chain_gn(s1s, s2s, n_spatial, scale, bias, g, film=None, repeat=1):
    """The norms' eager chain: the operands' sums concatenated, the scale and
    bias repeated (``pack_channel_vector``), ``group_norm_coeffs_from_sums``,
    then a ResNet's FiLM fold in f32."""
    vec = s2d.pack_channel_vector if repeat == 4 else (lambda v: v)
    s1, s2 = torch.cat(s1s, dim=-1), torch.cat(s2s, dim=-1)
    bsz, c = s1.shape
    scale, bias = vec(scale), vec(bias)
    n = n_spatial * (c // g)
    mean = s1.reshape(bsz, g, c // g).sum(-1) / n
    msq = s2.reshape(bsz, g, c // g).sum(-1) / n
    var = torch.clamp(msq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + 1e-5)
    inv_c = inv[:, :, None].expand(bsz, g, c // g).reshape(bsz, c)
    mean_c = mean[:, :, None].expand(bsz, g, c // g).reshape(bsz, c)
    a = inv_c * scale.float()
    b = bias.float() - mean_c * a
    if film is None:
        return a, b
    t = film.float()
    if bsz > t.shape[0]:
        t = t.repeat_interleave(bsz // t.shape[0], dim=0)
    ta, tb = (vec(v) for v in t.chunk(2, dim=-1))
    return a * (1.0 + ta), b * (1.0 + ta) + tb


def chain_ln(x, weight, bias):
    """``LayerNormF32``'s eager chain."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    if x.dtype == BF:
        var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
    else:
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-5)
    scale = weight.float()
    a = (inv * scale).to(x.dtype)
    b = (bias.float() - mean * inv * scale).to(x.dtype)
    return x * a + b


def _sums(bsz, cs, n_spatial, g, device="cpu"):
    """Each operand's (B, C_k) f32 sums of a bf16 activation of
    ``n_spatial`` positions, as K1 or K2 emits them."""
    out1, out2 = [], []
    for c in cs:
        x = (torch.randn((bsz, n_spatial, 1, c), generator=g) * 1.3 + 0.4).to(BF).to(device)
        s1, s2 = gn_stats.spatial_sums_plain(x)
        out1.append(s1)
        out2.append(s2)
    return out1, out2


def _vectors(c, dtype, g, device="cpu"):
    scale = (torch.randn(c, generator=g) * 0.2 + 1.0).to(dtype).to(device)
    bias = (torch.randn(c, generator=g) * 0.3).to(dtype).to(device)
    return scale, bias


# operand channels (unpacked), groups, repeat, batch, FiLM rows (0: none)
GN_CASES = [
    ((64,), 32, 1, 2, 0),
    ((64,), 32, 1, 2, 2),
    ((48, 40), 8, 1, 3, 3),        # a group across the operands' boundary
    ((32, 16, 24, 8), 8, 1, 2, 2),  # 4 operands
    ((8,), 8, 4, 2, 2),            # packed: one unpacked channel a group
    ((16, 8), 8, 4, 2, 0),
    ((24,), 4, 1, 4, 2),           # temporal: two (b t) rows a FiLM row
]


@pytest.mark.parametrize("pdtype", [torch.float32, BF])
@pytest.mark.parametrize("case", GN_CASES)
def test_gn_coeffs_plain_is_the_chain(case, pdtype):
    cs, groups, repeat, bsz, film_rows = case
    g = torch.Generator().manual_seed(1)
    n_spatial = 6
    s1s, s2s = _sums(bsz, [c * repeat for c in cs], n_spatial, g)
    scale, bias = _vectors(sum(cs), pdtype, g)
    film = (torch.randn((film_rows, 2 * sum(cs)), generator=g).to(BF) * 0.5
            if film_rows else None)
    ref = chain_gn(s1s, s2s, n_spatial, scale, bias, groups, film, repeat)
    s1 = s1s if len(cs) > 1 else s1s[0]
    s2 = s2s if len(cs) > 1 else s2s[0]
    for fn in (norm_coeffs.gn_coeffs_plain, norm_coeffs.gn_coeffs):
        got = fn(s1, s2, n_spatial, scale, bias, groups, film=film, repeat=repeat)
        assert all(t.dtype == torch.float32 for t in got)
        assert all(torch.equal(x, r) for x, r in zip(got, ref)), fn.__name__
        got = fn(s1, s2, n_spatial, scale, bias, groups, film=film, repeat=repeat, dtype=BF)
        assert all(torch.equal(x, r.to(BF)) for x, r in zip(got, ref)), fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("pdtype", [torch.float32, BF])
def test_layer_norm_plain_is_the_chain(dtype, pdtype):
    g = torch.Generator().manual_seed(2)
    x = (torch.randn((3, 5, 40), generator=g) * 2 + 0.5).to(dtype)
    weight, bias = _vectors(40, pdtype, g)
    ref = chain_ln(x, weight, bias)
    assert torch.equal(norm_coeffs.layer_norm_plain(x, weight, bias), ref)
    if dtype == BF:
        assert torch.equal(norm_coeffs.layer_norm(x, weight, bias), ref)


def test_k5_refuses_a_gradient():
    g = torch.Generator().manual_seed(3)
    (s1,), (s2,) = _sums(2, (16,), 4, g)
    scale, bias = (v.requires_grad_() for v in _vectors(16, torch.float32, g))
    with pytest.raises(NotImplementedError):
        norm_coeffs.gn_coeffs(s1, s2, 4, scale, bias, 4)
    with pytest.raises(NotImplementedError):
        norm_coeffs.layer_norm(torch.ones((2, 16), dtype=BF), scale, bias)
    with torch.no_grad():
        norm_coeffs.gn_coeffs(s1, s2, 4, scale, bias, 4)


# -- which route the models take ----------------------------------------------


@pytest.fixture
def k5_calls(monkeypatch):
    """Counts K5's calls (``gn``, ``ln``) and the plain chains' calls made
    outside K5 (``plain``: the route K5 replaces)."""
    calls = {"gn": 0, "ln": 0, "plain": 0}
    inside = []
    real_gn, real_ln = norm_coeffs.gn_coeffs, norm_coeffs.layer_norm
    plain_gn, plain_ln = norm_coeffs.gn_coeffs_plain, norm_coeffs.layer_norm_plain

    def through(real, key):
        def call(*a, **kw):
            calls[key] += 1
            inside.append(True)
            try:
                return real(*a, **kw)
            finally:
                inside.pop()
        return call

    def plain(real):
        def call(*a, **kw):
            if not inside:
                calls["plain"] += 1
            return real(*a, **kw)
        return call

    monkeypatch.setattr(norm_coeffs, "gn_coeffs", through(real_gn, "gn"))
    monkeypatch.setattr(norm_coeffs, "layer_norm", through(real_ln, "ln"))
    monkeypatch.setattr(norm_coeffs, "gn_coeffs_plain", plain(plain_gn))
    monkeypatch.setattr(norm_coeffs, "layer_norm_plain", plain(plain_ln))
    return calls


def _resnet(cin, cout, g, temporal_dim=16):
    torch.manual_seed(5)
    m = ResNet(ResNetConfig(num_channels=cin, output_channels=cout, num_groups_norm=8),
               temporal_dim).to(BF)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(BF) * 0.1)
    return m


def _resnet_inputs(cs, g, side=6, bsz=2, packed=False):
    m = 4 if packed else 1
    shape = (bsz, side // (2 if packed else 1), side // (2 if packed else 1))
    xs = tuple(torch.randn(shape + (c * m,), generator=g).to(BF) for c in cs)
    temb = torch.randn((bsz, 16), generator=g).to(BF)
    return (xs if len(xs) > 1 else xs[0]), temb


RESNETS = [((16,), 16, False), ((16,), 24, False), ((16, 8), 16, False), ((8,), 8, True)]


@pytest.mark.parametrize("cs,cout,packed", RESNETS)
def test_resnet_sampling_takes_k5(k5_calls, cs, cout, packed):
    g = torch.Generator().manual_seed(6)
    m = _resnet(sum(cs), cout, g)
    x, temb = _resnet_inputs(cs, g, packed=packed)
    with torch.no_grad():
        got = m.eval()(x, temb, packed=packed)
    assert (k5_calls["gn"], k5_calls["plain"]) == (2, 0)
    with torch.no_grad():
        m.kernels = False
        ref = m(x, temb, packed=packed)
    assert k5_calls["gn"] == 2 and k5_calls["plain"] == 2
    assert torch.equal(got, ref)  # on the CPU K5 is its plain version


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cs,cout,packed", RESNETS)
def test_resnet_with_gradients_takes_the_plain_chain(k5_calls, cs, cout, packed, train):
    g = torch.Generator().manual_seed(7)
    m = _resnet(sum(cs), cout, g).train(train)
    x, temb = _resnet_inputs(cs, g, packed=packed)
    out = m(x, temb, packed=packed)
    assert k5_calls["gn"] == 0 and k5_calls["plain"] == 2
    out.float().square().sum().backward()
    assert m.norm1.weight.grad is not None and m.norm2.weight.grad is not None
    assert float(m.norm2.weight.grad.float().abs().sum()) > 0


def test_norm_modules_take_k5_only_without_a_gradient(k5_calls):
    g = torch.Generator().manual_seed(8)
    gn, ln = GroupNormF32(8, 32).to(BF), LayerNormF32(40).to(BF)
    x = torch.randn((2, 4, 4, 32), generator=g).to(BF)
    t = torch.randn((2, 5, 40), generator=g).to(BF)
    y_gn, y_ln = gn(x), ln(t)  # the parameters require a gradient
    assert k5_calls == {"gn": 0, "ln": 0, "plain": 2}
    (y_gn.float().sum() + y_ln.float().sum()).backward()
    assert gn.weight.grad is not None and ln.weight.grad is not None
    with torch.no_grad():
        assert torch.equal(gn(x), y_gn) and torch.equal(ln(t), y_ln)
    assert k5_calls == {"gn": 1, "ln": 1, "plain": 2}
    gn.kernels = ln.kernels = False
    with torch.no_grad():
        gn(x), ln(t)
    assert k5_calls == {"gn": 1, "ln": 1, "plain": 4}


def test_nested_sampling_forward_takes_k5_for_every_norm(k5_calls):
    """Every norm of a packed nested U-Net's sampling forward goes through
    K5, none through the plain chain; ``use_kernels(False)`` sends every one
    through the plain chain."""
    from ml_mdm_tpu_torch.presets import nested_preset

    pipe, lm_dim, side = nested_preset("cc12m_1024x1024", "cpu", seed=3, scaled=True,
                                       pack_min_side=8)
    unet = pipe.vision_module
    g = torch.Generator().manual_seed(9)
    xs = pipe.get_noise(2, side, g)
    t = torch.tensor([300, 700])
    lm = torch.randn((2, 8, lm_dim), generator=g).to(BF)
    mask = torch.ones((2, 8), dtype=BF)
    norms = {}
    for m in unet.modules():
        if isinstance(m, (GroupNormF32, LayerNormF32, ResNet)):
            norms[type(m).__name__] = norms.get(type(m).__name__, 0) + 1
    with torch.no_grad():
        unet(xs, t, lm, mask, {})
    n_k5 = k5_calls["gn"] + k5_calls["ln"]
    assert k5_calls["plain"] == 0 and k5_calls["gn"] >= 2 * norms["ResNet"]
    assert k5_calls["ln"] > 0 and n_k5 <= 2 * norms["ResNet"] + sum(norms.values())
    unet.use_kernels(False)
    with torch.no_grad():
        unet(xs, t, lm, mask, {})
    assert k5_calls["gn"] + k5_calls["ln"] == n_k5 and k5_calls["plain"] == n_k5


# -- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _launches(fn) -> list:
    """The device kernels (copies and fills among them) of one call of fn."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


# the cells' shapes (the 64px core at 64 rows, the packed 1024px and 256px
# shells' 32- and 64-channel stages at 16 rows, the up path's skip concats)
# and small ragged ones: operand channels as K5 reads them, groups, repeat,
# batch, positions, FiLM rows (0: none)
CUDA_GN_CASES = [
    ((256,), 32, 1, 64, 4096, 64),
    ((768, 768), 32, 1, 64, 256, 64),
    ((1536, 1536), 32, 1, 64, 64, 0),
    ((512, 768), 32, 1, 64, 256, 64),    # a group across the operands' boundary
    ((128,), 32, 4, 16, 262144, 16),     # packed 32 channels at 1024px
    ((128, 128), 32, 4, 16, 262144, 16),
    ((256, 128), 32, 4, 16, 16384, 16),  # packed 64 channels beside 32 at 256px
    ((40, 24, 16, 8), 8, 1, 3, 37, 3),   # 4 operands, ragged
    ((96,), 8, 1, 6, 10, 2),             # temporal FiLM rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("pdtype", [torch.float32, BF])
@pytest.mark.parametrize("case", CUDA_GN_CASES)
def test_gn_coeffs_kernel(dev, case, pdtype):
    cs, groups, repeat, bsz, n_spatial, film_rows = case
    g = torch.Generator().manual_seed(11)
    s1s, s2s = _sums(bsz, cs, 8, g, dev)
    s1s = [s * (n_spatial / 8) for s in s1s]  # sums over n_spatial positions
    s2s = [s * (n_spatial / 8) for s in s2s]
    cu = sum(cs) // repeat
    scale, bias = _vectors(cu, pdtype, g, dev)
    film = (torch.randn((film_rows, 2 * cu), generator=g).to(BF).to(dev) * 0.5
            if film_rows else None)
    s1 = s1s if len(cs) > 1 else s1s[0]
    s2 = s2s if len(cs) > 1 else s2s[0]
    args = (s1, s2, n_spatial, scale, bias, groups)
    for dtype in (torch.float32, BF):
        n = norm_coeffs.launch_count
        a, b = norm_coeffs.gn_coeffs(*args, film=film, repeat=repeat, dtype=dtype)
        again = norm_coeffs.gn_coeffs(*args, film=film, repeat=repeat, dtype=dtype)
        assert norm_coeffs.launch_count == n + 2
        assert torch.equal(a, again[0]) and torch.equal(b, again[1])
        pa, pb = norm_coeffs.gn_coeffs_plain(*args, film=film, repeat=repeat)
        assert a.dtype == b.dtype == dtype and a.shape == (bsz, sum(cs))
        if dtype == torch.float32:
            assert _rel(a, pa) <= 1e-5 and _rel(b, pb) <= 1e-5
        else:  # one rounding of values within f32 rounding of the plain ones
            for got, ref in ((a, pa), (b, pb)):
                assert float((got.float() - ref).abs().max()) <= (
                    2 ** -8 * float(ref.abs().max()) + 1e-6)


def _ulps_over(got, ref) -> float:
    """max |got - ref| in units of two bf16 ULPs of the cell's own
    magnitude plus 1e-3 max|ref| (a cell near 0 where b and x a nearly
    cancel)."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(torch.finfo(BF).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - ref).abs() / (2 * ulp + 1e-3 * ref.abs().max())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 32, 2048), (16, 32, 2048), (3, 7, 768), (5, 1536),
                                   (2, 9, 1000), (4, 4096)])
@pytest.mark.parametrize("pdtype", [torch.float32, BF])
def test_layer_norm_kernel(dev, shape, pdtype):
    g = torch.Generator().manual_seed(12)
    x = (torch.randn(shape, generator=g) * 1.5 + 0.3).to(BF).to(dev)
    weight, bias = _vectors(shape[-1], pdtype, g, dev)
    n = norm_coeffs.launch_count
    y = norm_coeffs.layer_norm(x, weight, bias)
    assert norm_coeffs.launch_count == n + 1
    assert y.dtype == BF and y.shape == x.shape
    assert torch.equal(y, norm_coeffs.layer_norm(x, weight, bias))
    assert _ulps_over(y, norm_coeffs.layer_norm_plain(x, weight, bias)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("pdtype", [torch.float32, BF])
def test_layer_norm_kernel_apply_at_equal_statistics(dev, pdtype):
    """Rows of k/8 (|k| <= 32) over 2048 channels: every sum of x and of
    x*x is exact in f32 in any order, and 1/2048 is a power of two, so the
    kernel's statistics are the plain version's bit for bit, and so must be
    a, b and the rounded product and sum."""
    g = torch.Generator().manual_seed(13)
    k = torch.randint(-32, 33, (64, 32, 2048), generator=g).float()
    x = (k / 8).to(BF).to(dev)
    weight, bias = _vectors(2048, pdtype, g, dev)
    assert torch.equal(norm_coeffs.layer_norm(x, weight, bias),
                       norm_coeffs.layer_norm_plain(x, weight, bias))


@pytest.mark.cuda
def test_norm_modules_launch_budgets(dev):
    """A ``GroupNormF32`` on a bf16 activation: K1, K5, the product and the
    sum; a ``LayerNormF32``: K5 alone; each within its plain module's
    result as the kernels' own tests allow."""
    g = torch.Generator().manual_seed(14)
    gn, ln = GroupNormF32(32, 768).to(BF).to(dev), LayerNormF32(2048).to(BF).to(dev)
    with torch.no_grad():
        for p in list(gn.parameters()) + list(ln.parameters()):
            p.copy_(torch.randn(p.shape, generator=g).to(BF).to(dev) * 0.2 + 0.5)
    x = (torch.randn((64, 16, 16, 768), generator=g) + 0.3).to(BF).to(dev)
    t = torch.randn((64, 32, 2048), generator=g).to(BF).to(dev)
    with torch.no_grad():
        k_gn = _launches(lambda: gn(x))
        k_ln = _launches(lambda: ln(t))
        y_gn, y_ln = gn(x), ln(t)
        gn.kernels = ln.kernels = False
        p_gn, p_ln = gn(x), ln(t)
    assert len(k_gn) == 4 and sum("spatial_sums" in k for k in k_gn) == 1, k_gn
    assert sum("gn_coeffs" in k for k in k_gn) == 1, k_gn
    assert len(k_ln) == 1 and "layer_norm" in k_ln[0], k_ln
    assert _ulps_over(y_gn, p_gn) <= 1.0 and _ulps_over(y_ln, p_ln) <= 1.0


@pytest.mark.cuda
def test_self_attention_norms_launch_budgets(dev):
    """One ``SelfAttention`` of the 64px core (768 channels, text features
    of 2048, the FFN) on the kernel route: its two GroupNorms four launches
    each, its LayerNorm one, and its forward that many fewer than on the
    plain route."""
    torch.manual_seed(15)
    attn = SelfAttention(768, cond_dim=2048, use_attention_ffn=True).to(BF).to(dev).eval()
    g = torch.Generator().manual_seed(15)
    x = torch.randn((64, 16, 16, 768), generator=g).to(BF).to(dev)
    cond = torch.randn((64, 32, 2048), generator=g).to(BF).to(dev)
    with torch.no_grad():
        norms = [_launches(lambda: attn.norm(x)), _launches(lambda: attn.ffn[0](x)),
                 _launches(lambda: attn.norm_cond(cond))]
        fwd = _launches(lambda: attn(x, cond))
        attn.norm.kernels = attn.ffn[0].kernels = attn.norm_cond.kernels = False
        plain_norms = [_launches(lambda: attn.norm(x)), _launches(lambda: attn.ffn[0](x)),
                       _launches(lambda: attn.norm_cond(cond))]
        plain_fwd = _launches(lambda: attn(x, cond))
    assert [len(k) for k in norms] == [4, 4, 1], norms
    saved = sum(map(len, plain_norms)) - sum(map(len, norms))
    assert len(fwd) == len(plain_fwd) - saved, (len(fwd), len(plain_fwd), saved)


def _stub_conv(outputs):
    """K2's wrapper stood in for by outputs made beforehand, so that a
    profile of a ResNet holds only the launches around its convolutions."""
    def conv(x, a, b, w, bias, residual=None, *, emit_stats=False, proj_kernel=None, **kw):
        y, s1, s2, proj = outputs
        if not emit_stats:
            return y
        return (y, s1, s2) + ((proj,) if proj_kernel is not None else ())
    return conv


@pytest.mark.cuda
@pytest.mark.parametrize("cs,cout,packed", RESNETS + [((64,), 64, True), ((256, 256), 256, False)])
def test_resnet_launch_budget(dev, monkeypatch, cs, cout, packed):
    """A sampling ResNet, its convolutions stood in for: norm1 is one K1 an
    operand and one K5, norm2 with FiLM the time layer's SiLU and dense and
    one K5 (the skip concat's residual, where no shortcut takes it, one
    copy more)."""
    g = torch.Generator().manual_seed(16)
    m = _resnet(sum(cs), cout, g).to(dev).eval()
    x, temb = _resnet_inputs(cs, g, side=16, bsz=4, packed=packed)
    x = tuple(t.to(dev) for t in x) if isinstance(x, tuple) else x.to(dev)
    temb = temb.to(dev)
    x0 = x[0] if isinstance(x, tuple) else x
    shape = x0.shape[:3] + (cout * (4 if packed else 1),)
    sums = torch.rand((2, shape[0], shape[3]), device=dev) * shape[1] * shape[2] + 1.0
    outs = (torch.randn(shape, device=dev).to(BF), sums[0], sums[1],
            torch.randn(shape, device=dev).to(BF))
    monkeypatch.setattr(fused_resnet, "affine_silu_conv3x3", _stub_conv(outs))
    with torch.no_grad():
        time_layer = _launches(lambda: dense(F.silu(temb), m.time_layer, m.compute_dtype))
        kernels = _launches(lambda: m(x, temb, packed=packed))
    n_ops = len(cs)
    concat = int(n_ops > 1 and sum(cs) == cout)  # torch.cat of the operands as the residual
    k1 = sum("spatial_sums" in k for k in kernels)
    k5 = sum("gn_coeffs" in k for k in kernels)
    assert (k1, k5) == (n_ops, 2), kernels
    assert len(kernels) == n_ops + 1 + len(time_layer) + 1 + concat, (kernels, time_layer)
