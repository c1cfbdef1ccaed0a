"""The port's hand kernels against their plain versions on an NVIDIA GPU.

These tests need the card: they skip where there is none. They import
neither JAX nor the JAX package, so on the machine with the card they run
without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, bf16 (the working type): K1 sums <= 1e-5 * max|ref| (f32 sums in
another order); K2 output, stats and shortcut, and K3's gradients against
autograd of the plain version, <= 2e-2 * max|ref| (two bf16 ULPs: the
kernel's SiLU uses the fast exponential and sums in another order, so a
rounding can flip); K3's passes against their plain versions: dy', dx and
the activation <= 2e-2 * max|ref| (as K2: the fast exponential in the
sigmoid), the f32 sums da, db and dbias <= 1e-4 * max|ref| (the same
values summed in another order) and the same bits from call to call (the
partials added in a fixed order); the tiny U-Net and nested U-Net kernel
paths against their plain paths <= 5e-2 * max|ref| (those flips, carried
through ~20-40 layers); one tiny nested training step, kernel path against
plain path: loss within 1e-2 relative, gradient norm within 5e-2, cosine of
the flattened gradients >= 0.99; K4 against its plain f32 version <= 2e-2 *
max|ref| (the kernel rounds P to bf16 for the second product and the output
once to bf16; the JAX package's own test of its kernel allows the same),
and <= 1e-2 against the f32 result before its rounding; K1's split sums
bitwise equal from call to call. K2·struct and its backward: as K2 and K3.
K2·pipe against the serial packed K2: one kernel runs both (it stages the
next chunk under this one's products at every launch), so y, the shortcut
and the stats are bitwise equal; likewise an unpacked launch asked to
pipeline. K2 with the stats, in every mode, called twice on the same
inputs: y, s1, s2 (and the shortcut) bitwise equal (the stats in a fixed
order, no float atomics), and its tickets back at 0; a 64px DDIM-4
request and a ``train_256``-shaped step repeated: bitwise equal (the seed
contract, ``helpers.reproducible``). ``struct_wgrad`` of
bf16 operands on the card against the f32 products of the same values:
<= 1e-5 * max|ref| (both f32 sums). The probes P1 and P2
(``ops/kernel_anatomy.py``) against their plain versions: <= 2e-2 *
max|ref| (as K2); a double-buffered probe against its single buffer:
bitwise equal; a zero-filled probe on the cells its fill reaches: within 2
bf16 ULPs of each cell + 5e-4 * max|ref|. The f32 towers (T5, CLIP) against
the same weights on the CPU: <= 1e-4 * max|ref| (TF32 off).

The unpacked K2 (``conv3x3_wgmma_kernel``) is held at every border tap, at
rows of 8 to 96 pixels and ragged heights, at channel counts that are
multiples of 8 but not of 32, at a Cout that is no multiple of its N tile,
in every mode (1-4 operands, the shortcut with and without the stats, the
residual, SiLU off, the identity prologue), in each of its five (N tile,
m64 tiles) instances, and at the 64px model's 15 launch shapes. Its packed
mode (K2·struct) is held at each combined tap at every border, at rows of
4 to 32 packed pixels with 1 to 4 operands (32-channel ones among them), in
each instance, and in the modes and shapes of the models' packed stages.
These
tests, with ``chip_smoke.py``'s runs, are also the check on the rare
illegal memory access seen once in an early run (ROADMAP queue 3, item 2): a fault
in a kernel makes the next synchronisation raise.
"""
import pytest
import torch

from ml_mdm_tpu_torch.ops import attention, fused_resnet, gn_stats, k3_passes, kernel_anatomy
from ml_mdm_tpu_torch.ops import space_to_depth as s2d
from ml_mdm_tpu_torch.presets import flagship_64px, nested_preset

SAMPLING_MODES = ("K2", "K2·N", "K2·proj")  # K3 launches only in a backward


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _bf16_ulp_excess(got, ref) -> float:
    """max |got - ref| over cells in units of 2 bf16 ULPs of the cell's
    own magnitude + 5e-4 max|ref| (one activation rounded the other way
    moves a cell near 0 by up to about 3e-4)."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - ref).abs() / (2 * ulp + 5e-4 * ref.abs().max())).max())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(dev, bsz, h, w, cs, cout, residual, proj, seed=1):
    """bf16 operands, f32 coefficients, bf16 weights (one tuple entry per
    operand) and the optional residual and shortcut weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    ctot = sum(cs)
    xs = tuple(torch.randn((bsz, h, w, c), generator=g, device=dev).to(bf) for c in cs)
    a_s = tuple(torch.randn((bsz, c), generator=g, device=dev) * 0.2 + 1.0 for c in cs)
    b_s = tuple(torch.randn((bsz, c), generator=g, device=dev) * 0.3 for c in cs)
    ws = tuple((torch.randn((3, 3, c, cout), generator=g, device=dev)
                / (9 * ctot) ** 0.5).to(bf) for c in cs)
    bias = torch.randn((cout,), generator=g, device=dev) * 0.1
    res = (torch.randn((bsz, h, w, cout), generator=g, device=dev).to(bf)
           if residual else None)
    kw = {}
    if proj:
        kw["proj_kernel"] = tuple((torch.randn((c, cout), generator=g, device=dev)
                                   / ctot ** 0.5).to(bf) for c in cs)
        kw["proj_bias"] = torch.randn((cout,), generator=g, device=dev) * 0.1
    return xs, a_s, b_s, ws, bias, res, kw


@pytest.mark.cuda
@pytest.mark.parametrize("side,c", [(64, 256), (32, 1280), (16, 1536), (12, 40),
                                    (1024, 32)])
def test_spatial_sums_kernel(dev, side, c):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((2, side, side, c), generator=g, device=dev) + 0.3).to(torch.bfloat16)
    n = gn_stats.launch_count
    s1, s2 = gn_stats.spatial_sums(x)
    assert gn_stats.launch_count == n + 1
    p1, p2 = gn_stats.spatial_sums_plain(x)
    assert _rel(s1, p1) <= 1e-5
    assert _rel(s2, p2) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 512, 512, 128),    # the packed 1024px shell, batch 4
    (4, 1024, 1024, 32),   # the same, unpacked
    (2, 512, 512, 128),    # train_1024's batch
    (4, 128, 128, 512),    # 64 MiB: the largest narrow-spatial shape
    (3, 37, 53, 64),       # ragged H*W: the last span is partial
    (2, 12, 12, 40),       # C = 40: a masked channel block
    (1, 1024, 1024, 12),   # C = 12 in a 16-channel block, many spans
    (64, 8, 8, 1536),      # the 64px core's innermost level: one span
])
def test_spatial_sums_kernel_splits_deterministic(dev, shape):
    """The H*W split of ``gn_stats.plan`` against the plain version, and
    two calls bitwise equal (partial sums finished in a fixed order, no
    atomics)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(shape, generator=g, device=dev) + 0.3).to(torch.bfloat16)
    n = gn_stats.launch_count
    s1, s2 = gn_stats.spatial_sums(x)
    t1, t2 = gn_stats.spatial_sums(x)
    assert gn_stats.launch_count == n + 2
    assert torch.equal(s1, t1) and torch.equal(s2, t2)
    p1, p2 = gn_stats.spatial_sums_plain(x)
    assert _rel(s1, p1) <= 1e-5
    assert _rel(s2, p2) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("side,c,cout,residual,silu", [
    (64, 256, 256, False, True), (32, 1280, 512, True, True),
    (16, 768, 768, True, True), (12, 40, 24, False, True),
    (20, 64, 128, True, False),
])
def test_affine_silu_conv3x3_kernel(dev, side, c, cout, residual, silu):
    x, a, b, w, bias, res, _ = _conv_inputs(dev, 2, side, side, (c,), cout, residual, False)
    n = fused_resnet.launch_counts["K2"]
    y, s1, s2 = fused_resnet.affine_silu_conv3x3(
        x[0], a[0], b[0], w[0], bias, res, apply_silu=silu, emit_stats=True)
    torch.cuda.synchronize()
    assert fused_resnet.launch_counts["K2"] == n + 1
    py, p1, p2 = fused_resnet.affine_silu_conv3x3_plain(
        x[0], a[0], b[0], w[0], bias, res, apply_silu=silu, emit_stats=True)
    assert _rel(y, py) <= 2e-2
    assert _rel(s1, p1) <= 2e-2
    assert _rel(s2, p2) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(8, 1024, 32), (4, 1536, 64), (6, 600, 16)])
def test_affine_silu_conv3x3_kernel_wide_rows(dev, h, w, c):
    """Rows wider than 580 pixels, which the first version could not stage."""
    x, a, b, wk, bias, res, _ = _conv_inputs(dev, 2, h, w, (c,), c, True, False)
    y = fused_resnet.affine_silu_conv3x3(x[0], a[0], b[0], wk[0], bias, res)
    torch.cuda.synchronize()
    py = fused_resnet.affine_silu_conv3x3_plain(x[0], a[0], b[0], wk[0], bias, res)
    assert _rel(y, py) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cs,cout,proj,stats", [
    (64, 64, (256, 256), 256, True, True),      # core up path: skip concat + shortcut
    (128, 128, (64, 64), 64, True, True),       # 256 shell up path
    (256, 256, (32, 32), 32, True, False),      # 1024 shell up path, smaller side
    (16, 16, (768, 512), 512, False, True),     # two operands, no shortcut
    (12, 20, (16, 24, 8), 16, True, True),      # three ragged operands, ragged tile
    (32, 32, (256,), 512, True, True),          # down path: one operand + shortcut
])
def test_affine_silu_conv3x3_operands_and_shortcut(dev, h, w, cs, cout, proj, stats):
    xs, a_s, b_s, ws, bias, _, kw = _conv_inputs(dev, 2, h, w, cs, cout, False, proj)
    before = dict(fused_resnet.launch_counts)
    out = fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, ws, bias, emit_stats=stats, **kw)
    torch.cuda.synchronize()
    ref = fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, ws, bias,
                                                 emit_stats=stats, **kw)
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    assert len(out) == len(ref) == 1 + 2 * stats + proj
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert _rel(o, r) <= 2e-2
    after = fused_resnet.launch_counts
    assert after["K2"] == before["K2"] + 1
    assert after["K2·N"] == before["K2·N"] + (len(cs) > 1)
    assert after["K2·proj"] == before["K2·proj"] + proj


# -- the unpacked K2 on wgmma ----------------------------------------------------

# the 64px model's batch-64 forward: its 15 K2 launch shapes (B, H, W, operand
# channels, Cout, residual, stats, shortcut)
MAIN_PATH_64 = [
    (64, 16, 16, (512,), 768, False, True, True),
    (64, 16, 16, (768,), 768, False, True, False),
    (64, 16, 16, (768,), 768, True, False, False),
    (64, 16, 16, (768, 512), 768, False, True, True),
    (64, 16, 16, (768, 768), 768, False, True, True),
    (64, 32, 32, (256,), 512, False, True, True),
    (64, 32, 32, (512,), 512, False, True, False),
    (64, 32, 32, (512,), 512, True, False, False),
    (64, 32, 32, (512, 256), 512, False, True, True),
    (64, 32, 32, (512, 512), 512, False, True, True),
    (64, 32, 32, (768, 512), 512, False, True, True),
    (64, 64, 64, (256,), 256, False, True, False),
    (64, 64, 64, (256,), 256, True, False, False),
    (64, 64, 64, (256, 256), 256, False, True, True),
    (64, 64, 64, (512, 256), 256, False, True, True),
]


def _check_conv(dev, b, h, w, cs, cout, residual, stats, proj, silu=True, identity=False,
                seed=11):
    xs, a_s, b_s, ws, bias, res, kw = _conv_inputs(dev, b, h, w, cs, cout, residual, proj, seed)
    if identity:
        a_s = b_s = None
    before = dict(fused_resnet.launch_counts)
    out = fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, ws, bias, res, emit_stats=stats,
                                           apply_silu=silu, **kw)
    torch.cuda.synchronize()
    ref = fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, ws, bias, res, emit_stats=stats,
                                                 apply_silu=silu, **kw)
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    assert len(out) == len(ref) == 1 + 2 * stats + proj
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype and torch.isfinite(o).all()
        assert _rel(o, r) <= 2e-2
    after = fused_resnet.launch_counts
    assert after["K2"] == before["K2"] + 1 and after["K2·pipe"] == before["K2·pipe"]
    assert after["K2·struct"] == before["K2·struct"]


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(9))
def test_wgmma_k2_every_border_tap(dev, tap):
    """One tap's weights at a time (the others zero), over an image of two
    ragged tile columns and rows: each shifted read at every border."""
    xs, a_s, b_s, ws, bias, _, _ = _conv_inputs(dev, 2, 9, 40, (40,), 72, False, False, seed=tap)
    mask = torch.zeros((3, 3, 1, 1), device=dev, dtype=ws[0].dtype)
    mask.view(9)[tap] = 1
    w = (ws[0] * mask,)
    y = fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, w, bias)
    torch.cuda.synchronize()
    assert _rel(y, fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, w, bias)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 24, 32, 40, 64, 96])
@pytest.mark.parametrize("h,cs,cout", [(5, (40,), 72), (13, (8, 24), 200)])
def test_wgmma_k2_widths_and_ragged_heights(dev, h, w, cs, cout):
    """Rows of 8-96 pixels, ragged heights, C a multiple of 8 but not of
    32, Cout no multiple of the N tile; the shortcut and the stats."""
    _check_conv(dev, 2, h, w, cs, cout, True, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("cs,residual,stats,proj,silu,identity", [
    ((64,), False, False, False, True, False),
    ((64, 32), True, True, False, True, False),           # two operands, residual, stats
    ((16, 24, 8), False, True, True, True, False),        # three operands, shortcut + stats
    ((32, 32, 64, 8), True, False, True, True, False),    # four operands, shortcut alone
    ((48,), True, True, False, False, False),             # SiLU off (affine only)
    ((96,), False, False, False, False, True),            # the identity prologue
    ((40, 40), True, False, False, False, True),          # identity, two operands
])
def test_wgmma_k2_modes(dev, cs, residual, stats, proj, silu, identity):
    _check_conv(dev, 3, 12, 20, cs, 136, residual, stats, proj, silu, identity)


def _forced_plan(bn, mt):
    """conv_plan's tile rule at a chosen (N tile, m64 tiles), so that each
    instance of the kernel runs whatever the shape."""
    def plan(bsz, h, w, cs, cout, sms, proj, packed=False):
        tw = min(w, 32)
        th = max(1, min(128 * mt // tw, h, 32))
        stages = min(fused_resnet.MAX_STAGES, (fused_resnet.SMEM_LIMIT - fused_resnet.smem_bytes(
            bn, th, tw, 0)) // (bn * 128 + 16))
        tiles = bsz * -(-h // th) * -(-w // tw) * -(-cout // bn)
        return fused_resnet.ConvPlan(th, tw, bn, mt, stages,
                                     fused_resnet.smem_bytes(bn, th, tw, stages), sms, True, 0,
                                     tiles)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("bn,mt", fused_resnet.CANDIDATES)
@pytest.mark.parametrize("h,w,cs,cout,proj", [
    (16, 16, (256, 128), 320, True),    # a 320-wide Cout: the last N tile partial
    (20, 36, (72,), 64, False),         # a 4-pixel tile column, two chunks of one operand
])
def test_wgmma_k2_every_instance(dev, monkeypatch, bn, mt, h, w, cs, cout, proj):
    monkeypatch.setattr(fused_resnet, "_plan", _forced_plan(bn, mt))
    _check_conv(dev, 2, h, w, cs, cout, True, True, proj)


@pytest.mark.cuda
@pytest.mark.parametrize("key", MAIN_PATH_64, ids=str)
def test_wgmma_k2_main_path_shapes(dev, key):
    b, h, w, cs, cout, residual, stats, proj = key
    _check_conv(dev, b, h, w, cs, cout, residual, stats, proj)


@pytest.mark.cuda
def test_conv_plan_shared_memory_matches_the_kernel(dev):
    """The host's shared-memory formula is the kernel's, for every plan of
    the 64px forward's shapes and a few ragged ones."""
    lib = fused_resnet.load_library()
    for key in MAIN_PATH_64 + [(2, 9, 40, (40,), 72, 0, 0, 0), (3, 7, 8, (8,), 200, 0, 0, 1)]:
        b, h, w, cs, cout = key[:5]
        p = fused_resnet.conv_plan(b, h, w, cs, cout, 132, bool(key[-1]))
        assert lib.ml_mdm_conv3x3_smem_bytes(p.bn, p.th, p.tw, p.stages) == p.smem, key


@pytest.mark.cuda
def test_k2_weights_keep_their_layout_on_the_card(dev):
    xs, a_s, b_s, ws, bias, _, kw = _conv_inputs(dev, 2, 16, 16, (64, 32), 64, False, True)
    kept = fused_resnet.K2Weights(ws)
    proj = fused_resnet.K2Weights(kw["proj_kernel"])
    outs = [fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, w, bias, proj_kernel=p,
                                             proj_bias=kw["proj_bias"])
            for w, p in ((ws, kw["proj_kernel"]), (kept, proj), (kept, proj))]
    torch.cuda.synchronize()
    assert kept.layout(xs[0].device) is kept.layout(xs[0].device)
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (16, 64, 64, 256),     # train_256's 64px core
    (2, 512, 512, 128),    # train_1024's packed shell: 128 spans
    (3, 37, 53, 40),       # ragged H*W and a masked channel block
    (64, 8, 8, 1536),      # one span
])
def test_k3_passes_kernels(dev, shape):
    """Pass A and pass B against their plain versions; their sums the same
    bits from call to call."""
    g = torch.Generator(device=dev).manual_seed(12)
    b, c = shape[0], shape[-1]
    bf = torch.bfloat16
    dy, y, x, ds = (torch.randn(shape, generator=g, device=dev).to(bf) for _ in range(4))
    ds1 = torch.randn((b, c), generator=g, device=dev) * 1e-2
    ds2 = torch.randn((b, c), generator=g, device=dev) * 1e-3
    a = torch.randn((b, c), generator=g, device=dev) * 0.2 + 1.0
    bb = torch.randn((b, c), generator=g, device=dev) * 0.3
    before = dict(k3_passes.launch_counts)
    fold, fold2 = (k3_passes.fold(dy, y, ds1, ds2) for _ in range(2))
    chain, chain2 = (k3_passes.chain(x, ds, a, bb) for _ in range(2))
    torch.cuda.synchronize()
    assert k3_passes.launch_counts == {"K3·A": before["K3·A"] + 2, "K3·B": before["K3·B"] + 2}
    for got, again, ref, exact in (
            (fold, fold2, k3_passes.fold_plain(dy, y, ds1, ds2), (1,)),
            (chain, chain2, k3_passes.chain_plain(x, ds, a, bb), (2, 3))):
        for i, (o, r) in enumerate(zip(got, ref)):
            assert o.shape == r.shape and o.dtype == r.dtype
            assert _rel(o, r) <= (1e-4 if i in exact else 2e-2), i
        for i in exact:
            assert torch.equal(got[i], again[i]), i


def _struct_inputs(dev, bsz, h, w, cs, cout, residual, proj, seed=7):
    """Packed operands (B, h, w, 4 C_k) of random images, per-operand packed
    (3, 3, 4 C_k, 4 Cout) kernels of random HWIO kernels, (B, 4 C_k)
    coefficients, packed bias, residual and block-diagonal shortcut."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    ctot = sum(cs)
    xs = tuple(s2d.space_to_depth(torch.randn((bsz, 2 * h, 2 * w, c), generator=g, device=dev))
               .to(bf) for c in cs)
    a_s = tuple(torch.randn((bsz, 4 * c), generator=g, device=dev) * 0.2 + 1.0 for c in cs)
    b_s = tuple(torch.randn((bsz, 4 * c), generator=g, device=dev) * 0.3 for c in cs)
    ws = tuple(s2d.pack_conv3x3_kernel(torch.randn((3, 3, c, cout), generator=g, device=dev)
                                       / (9 * ctot) ** 0.5).to(bf) for c in cs)
    bias = torch.randn((4 * cout,), generator=g, device=dev) * 0.1
    res = (torch.randn((bsz, h, w, 4 * cout), generator=g, device=dev).to(bf)
           if residual else None)
    kw = {}
    if proj:
        kw["proj_kernel"] = tuple(
            s2d.pack_conv1x1_kernel(torch.randn((1, 1, c, cout), generator=g, device=dev)
                                    / ctot ** 0.5)[0, 0].to(bf) for c in cs)
        kw["proj_bias"] = torch.randn((4 * cout,), generator=g, device=dev) * 0.1
    return xs, a_s, b_s, ws, bias, res, kw


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cs,cout,residual,proj,stats", [
    (2, 256, 256, (32,), 32, False, False, True),      # the 1024px shell's stage 0, packed
    (2, 128, 128, (32, 32), 32, False, True, True),    # its stage-1 up path: N = 2 + shortcut
    (2, 64, 64, (64,), 64, True, False, False),        # stage 2 (64 channels), residual
    (1, 12, 20, (8, 16), 24, True, True, True),        # ragged tile, two operands
])
def test_struct_kernel(dev, b, h, w, cs, cout, residual, proj, stats):
    """K2·struct (4 products per chunk over the combined taps) against its
    plain version, with both weight forms."""
    xs, a_s, b_s, ws, bias, res, kw = _struct_inputs(dev, b, h, w, cs, cout, residual, proj)
    before = dict(fused_resnet.launch_counts)
    out = fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, ws, bias, res, emit_stats=stats,
                                           packed_struct=True, **kw)
    combined = tuple(fused_resnet.struct_weights(wk) for wk in ws)
    out_q = fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, combined, bias, res, emit_stats=stats,
                                             packed_struct=True, **kw)
    torch.cuda.synchronize()
    ref = fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, ws, bias, res, emit_stats=stats,
                                                 packed_struct=True, **kw)
    out, out_q, ref = ((o if isinstance(o, tuple) else (o,)) for o in (out, out_q, ref))
    assert len(out) == len(ref) == 1 + 2 * stats + proj
    for o, q, r in zip(out, out_q, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert _rel(o, r) <= 2e-2
        assert _rel(q, r) <= 2e-2
    assert fused_resnet.launch_counts["K2·struct"] == before["K2·struct"] + 2


def _check_struct(dev, b, h, w, cs, cout, residual, stats, proj, seed=7, mask=None):
    """K2·struct at packed (h, w) with unpacked operand channels ``cs`` and
    ``cout``, against its plain version; ``mask`` (2, 2) keeps some of the
    combined taps only."""
    xs, a_s, b_s, ws, bias, res, kw = _struct_inputs(dev, b, h, w, cs, cout, residual, proj, seed)
    combined = tuple(fused_resnet.struct_weights(wk) for wk in ws)
    if mask is not None:
        combined = tuple(wk * mask.to(wk.dtype)[:, :, None, None] for wk in combined)
    before = dict(fused_resnet.launch_counts)
    out = fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, combined, bias, res, emit_stats=stats,
                                           packed_struct=True, **kw)
    torch.cuda.synchronize()
    ref = fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, combined, bias, res,
                                                 emit_stats=stats, packed_struct=True, **kw)
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    assert len(out) == len(ref) == 1 + 2 * stats + proj
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype and torch.isfinite(o).all()
        assert _rel(o, r) <= 2e-2
    assert fused_resnet.launch_counts["K2·struct"] == before["K2·struct"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(4))
def test_struct_every_border_tap(dev, tap):
    """One combined tap at a time (the others zero), over a packed image of
    two ragged tile columns and ragged rows: each select's reads at every
    border, for each parity class."""
    mask = torch.zeros((2, 2), device=dev)
    mask.view(4)[tap] = 1
    _check_struct(dev, 2, 9, 40, (16,), 24, False, False, False, seed=tap, mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 16, 32])
@pytest.mark.parametrize("cs", [(8,), (16, 8), (8, 24, 16), (16, 8, 8, 16)])
def test_struct_widths_and_operands(dev, w, cs):
    """Rows of 4-32 packed pixels, 1-4 operands (32-channel ones among
    them), the residual, stats and shortcut."""
    _check_struct(dev, 2, 11, w, cs, 40, True, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("bn,mt", fused_resnet.CANDIDATES)
def test_struct_every_instance(dev, monkeypatch, bn, mt):
    monkeypatch.setattr(fused_resnet, "_plan", _forced_plan(bn, mt))
    _check_struct(dev, 2, 12, 36, (32, 16), 80, True, True, True)


@pytest.mark.cuda
def test_struct_conv3x3_fast_pads_the_packed_image(dev):
    """The packed input layer: 12 channels padded to 16 (whole 16-byte
    groups; the kernel pads them to its chunk of 64)."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = s2d.space_to_depth(torch.randn((2, 64, 64, 3), generator=g, device=dev)).to(torch.bfloat16)
    k = torch.randn((3, 3, 3, 32), generator=g, device=dev) / 5.0
    y = s2d.packed_conv(x, k, None, fast=True)
    torch.cuda.synchronize()
    ref = s2d.packed_conv(x.float(), k, None)
    assert y.shape == ref.shape and _rel(y, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cs,cout,proj,stats,struct", [
    (2, 32, 32, (64,), 64, False, True, False),
    (2, 16, 16, (256, 256), 256, True, True, False),
    (2, 24, 40, (48, 40), 64, True, False, False),     # partial chunks
    (2, 64, 64, (32,), 32, False, True, True),         # packed 128 -> 128
    (2, 32, 32, (32, 32), 32, True, True, True),
])
def test_pipelined_matches_serial(dev, b, h, w, cs, cout, proj, stats, struct):
    """K2·pipe against the serial K2 on the same inputs: packed or not, one
    kernel runs both (``pipelined`` only says which packed launches count
    as K2·pipe), so y and the shortcut are the same bits."""
    if struct:
        xs, a_s, b_s, ws, bias, res, kw = _struct_inputs(dev, b, h, w, cs, cout, True, proj)
    else:
        xs, a_s, b_s, ws, bias, res, kw = _conv_inputs(dev, b, h, w, cs, cout, True, proj)
    before = dict(fused_resnet.launch_counts)
    outs = [fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, ws, bias, res, emit_stats=stats,
                                             pipelined=pipe, packed_struct=struct, **kw)
            for pipe in (True, False)]
    torch.cuda.synchronize()
    assert fused_resnet.launch_counts["K2·pipe"] == before["K2·pipe"] + struct
    got, ref = ((o if isinstance(o, tuple) else (o,)) for o in outs)
    assert torch.equal(got[0], ref[0])
    if proj:
        assert torch.equal(got[-1], ref[-1])
    if stats:
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    plain = fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, ws, bias, res,
                                                   packed_struct=struct, **kw)
    assert _rel(got[0], plain[0] if proj else plain) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,cout,stats,residual", [
    (2, 256, 256, 32, 32, True, False),    # the 1024px shell's stage 0, packed (128 -> 128)
    (2, 64, 64, 64, 64, False, True),      # stage 2 (256 -> 256)
])
def test_struct_backward_kernel(dev, b, h, w, c, cout, stats, residual):
    """K3 with ``packed_struct`` (data gradient through K2·struct, weight
    gradient by the 4 products) against autograd of the plain version; dw is
    the UNPACKED kernel's gradient."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = s2d.space_to_depth(torch.randn((b, 2 * h, 2 * w, c), generator=g, device=dev))
    ins = [x.to(torch.bfloat16), torch.randn((b, 4 * c), generator=g, device=dev) * 0.2 + 1.0,
           torch.randn((b, 4 * c), generator=g, device=dev) * 0.3,
           torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5,
           torch.randn((4 * cout,), generator=g, device=dev) * 0.1,
           torch.randn((b, h, w, 4 * cout), generator=g, device=dev).to(torch.bfloat16)
           if residual else None]
    cots = [torch.randn((b, h, w, 4 * cout), generator=g, device=dev).to(torch.bfloat16),
            torch.randn((b, 4 * cout), generator=g, device=dev) * 1e-3,
            torch.randn((b, 4 * cout), generator=g, device=dev) * 1e-4]

    def packed(fn):
        def run(x, a, bb, w, bias, res, emit_stats):
            return fn(x, a, bb, s2d.pack_conv3x3_kernel(w), bias, res, emit_stats=emit_stats,
                      packed_struct=True)
        return run

    before = dict(fused_resnet.launch_counts)
    got = _grads(packed(fused_resnet.affine_silu_conv3x3_vjp), ins, cots, stats)
    torch.cuda.synchronize()
    assert fused_resnet.launch_counts["K3"] == before["K3"] + 1
    assert fused_resnet.launch_counts["K2·struct"] == before["K2·struct"] + 2
    ref = _grads(packed(fused_resnet.affine_silu_conv3x3_plain), ins, cots, stats)
    for name, o, r in zip(["dx", "da", "db", "dw", "dbias", "dres"], got, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        assert _rel(o, r) <= 2e-2, name


@pytest.mark.cuda
def test_struct_wgrad_keeps_f32_on_the_card(dev):
    """The packed weight gradient's products of bf16 operands stay f32."""
    g = torch.Generator(device=dev).manual_seed(10)
    s, dy = (torch.randn((2, 64, 64, 128), generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    got = fused_resnet.struct_wgrad(s, dy)
    assert got.dtype == torch.float32
    assert _rel(got, fused_resnet.struct_wgrad(s.float(), dy.float())) <= 1e-5


def _probe_id(v):
    return "-".join(f"{k}{int(x)}" for k, x in v._asdict().items())


PROBE_SHAPES = {  # B, H, W, C
    "the probes' shape": (4, 512, 512, 128),
    "one band: both clamps, W 8 (K2's tile rule: 32 rows)": (2, 16, 8, 96),
    "tiles of 8 rows at and inside a band": (2, 32, 24, 96),
    "W 40: a ragged tile": (1, 32, 40, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PROBE_SHAPES.values()), ids=list(PROBE_SHAPES))
@pytest.mark.parametrize("v", kernel_anatomy.VARIANTS, ids=_probe_id)
def test_kernel_anatomy_kernel(dev, v, shape):
    """Each probe variant (an instance of K2's kernel) at the probes' shape
    and at small ones, a partial chunk of channels (96 = 64 + 32) among
    them, against its plain version; a double buffer bitwise equal to its
    single buffer; a zero fill bitwise equal to its variant without it (and
    without the double buffer) off the cells the fill reaches, and on them
    different from it and, like it, within two bf16 ULPs of the plain
    version."""
    b, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn((b, h, w, c), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    wt = (torch.randn((max(v.n_taps, 1), c, c), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    before = dict(kernel_anatomy.launch_counts)
    got = kernel_anatomy.anatomy(x, wt, v)
    torch.cuda.synchronize()
    assert kernel_anatomy.launch_counts[f"P{v.probe}"] == before[f"P{v.probe}"] + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _rel(got, kernel_anatomy.anatomy_plain(x, wt, v)) <= 2e-2
    if v.dbuf and v._replace(dbuf=False) in kernel_anatomy.VARIANTS:
        assert torch.equal(got, kernel_anatomy.anatomy(x, wt, v._replace(dbuf=False)))
    if v.zero:
        base = v._replace(zero=False, dbuf=False)
        twin = kernel_anatomy.anatomy(x, wt, base)
        fill = kernel_anatomy.fill_cells(v, h, w).to(dev)
        assert torch.equal(got[:, ~fill], twin[:, ~fill])
        assert not torch.equal(got[:, fill], twin[:, fill])
        for out, u in ((got, v), (twin, base)):
            assert _bf16_ulp_excess(out[:, fill],
                                    kernel_anatomy.anatomy_plain(x, wt, u)[:, fill]) <= 1


@pytest.mark.cuda
def test_kernel_anatomy_refuses_what_it_does_not_take(dev):
    """On the card H is a multiple of the 16-row band and C of 8 (any W);
    bf16 only; only the probes' rows."""
    x = torch.zeros((1, 16, 12, 40), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((4, 40, 40), device=dev, dtype=torch.bfloat16)
    v = kernel_anatomy.p2_variant(True, False, False, False)
    assert kernel_anatomy.anatomy(x, w, v).shape == x.shape
    with pytest.raises(ValueError):  # not a row of the probes
        kernel_anatomy.anatomy(x, w, v._replace(zero=True))
    with pytest.raises(ValueError):  # H a multiple of the 16-row band
        kernel_anatomy.anatomy(x[:, :8], w, v)
    with pytest.raises(ValueError):  # C a multiple of 8
        kernel_anatomy.anatomy(x[..., :36], w[:, :36, :36], v)
    with pytest.raises(TypeError):  # bf16 only
        kernel_anatomy.anatomy(x.float(), w, v)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 8, 8, 12), device=dev, dtype=torch.bfloat16)
    ab = torch.zeros((1, 12), device=dev)
    with pytest.raises(ValueError):  # C not a multiple of 8
        fused_resnet.affine_silu_conv3x3(
            x, ab, ab, torch.zeros((3, 3, 12, 8), device=dev), torch.zeros(8, device=dev))
    with pytest.raises(TypeError):  # the kernel is bf16 only
        fused_resnet.affine_silu_conv3x3(
            x.float()[..., :8], ab[:, :8], ab[:, :8],
            torch.zeros((3, 3, 8, 8), device=dev), torch.zeros(8, device=dev))
    x8 = x[..., :8].contiguous()
    with pytest.raises(ValueError):  # more operands than the kernel takes
        fused_resnet.affine_silu_conv3x3(
            (x8,) * 5, (ab[:, :8],) * 5, (ab[:, :8],) * 5,
            (torch.zeros((3, 3, 8, 8), device=dev),) * 5, torch.zeros(8, device=dev))
    with pytest.raises(ValueError):  # packed: C a multiple of 8 too
        fused_resnet.affine_silu_conv3x3(
            x, ab, ab, torch.zeros((2, 2, 12, 8), device=dev),
            torch.zeros(8, device=dev), packed_struct=True)
    with pytest.raises(ValueError):  # packed: the (3, 3) kernel or its (2, 2) combined taps
        fused_resnet.affine_silu_conv3x3(
            x8, ab[:, :8], ab[:, :8], torch.zeros((1, 1, 8, 8), device=dev),
            torch.zeros(8, device=dev), packed_struct=True)


@pytest.mark.cuda
def test_tiny_unet_kernel_path_matches_plain_path(dev):
    pipe, lm_dim, side = flagship_64px(dev, seed=0, scaled=True)
    unet = pipe.vision_module
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, side, side, 3), generator=g, device=dev)
    t = torch.tensor([10, 700], device=dev)
    lm = torch.randn((2, 8, lm_dim), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((2, 8), device=dev, dtype=torch.bfloat16)
    counts = gn_stats.launch_count, dict(fused_resnet.launch_counts)
    with torch.no_grad():
        got = unet(x, t, lm, mask, {})
        assert gn_stats.launch_count > counts[0]
        for mode in SAMPLING_MODES:
            assert fused_resnet.launch_counts[mode] > counts[1][mode], mode
        ref = unet.use_kernels(False)(x, t, lm, mask, {})
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cc12m_256x256", "cc12m_1024x1024"])
def test_tiny_nested_kernel_path_matches_plain_path(dev, name):
    pipe, lm_dim, side = nested_preset(name, dev, seed=0, scaled=True)
    unet = pipe.vision_module
    g = torch.Generator(device=dev).manual_seed(3)
    xs = pipe.get_noise(2, side, g)
    t = torch.tensor([10, 700], device=dev)
    lm = torch.randn((2, 8, lm_dim), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((2, 8), device=dev, dtype=torch.bfloat16)
    counts = dict(fused_resnet.launch_counts)
    with torch.no_grad():
        got = unet(xs, t, lm, mask, {})
        for mode in SAMPLING_MODES:
            assert fused_resnet.launch_counts[mode] > counts[mode], mode
        ref = unet.use_kernels(False)(xs, t, lm, mask, {})
    assert len(got) == len(ref) == len(xs)
    for o, r, x in zip(got, ref, xs):
        assert o.shape == x.shape and torch.isfinite(o).all()
        assert _rel(o, r) <= 5e-2


@pytest.mark.cuda
def test_tiny_packed_nested2_kernel_path_matches_plain_path(dev):
    """The scaled nested2 model with packing from side 8: every shell packs
    (K2·struct in the ResNets, the packed input, output and upsample
    convolutions)."""
    pipe, lm_dim, side = nested_preset("cc12m_1024x1024", dev, seed=0, scaled=True,
                                       pack_min_side=8)
    unet = pipe.vision_module
    assert all(unet._pack_plan(torch.zeros(1, side, side, 3)))
    g = torch.Generator(device=dev).manual_seed(3)
    xs = pipe.get_noise(2, side, g)
    t = torch.tensor([10, 700], device=dev)
    lm = torch.randn((2, 8, lm_dim), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((2, 8), device=dev, dtype=torch.bfloat16)
    counts = dict(fused_resnet.launch_counts)
    with torch.no_grad():
        got = unet(xs, t, lm, mask, {})
        for mode in SAMPLING_MODES + ("K2·struct",):
            assert fused_resnet.launch_counts[mode] > counts[mode], mode
        ref = unet.use_kernels(False)(xs, t, lm, mask, {})
    for o, r, x in zip(got, ref, xs):
        assert o.shape == x.shape and torch.isfinite(o).all()
        assert _rel(o, r) <= 5e-2


def _grads(fn, ins, cots, stats):
    ins = [t.clone().requires_grad_(True) if t is not None else None for t in ins]
    out = fn(*ins, emit_stats=stats)
    outs = out if stats else (out,)
    torch.autograd.backward(outs, cots[:len(outs)])
    return [t.grad for t in ins if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,cout,stats,residual", [
    (2, 64, 64, 256, 256, True, False),     # core conv1
    (4, 32, 32, 768, 512, False, True),     # core conv2 after a width change
    (10, 256, 256, 64, 64, True, True),     # the 256px shell at the train preset's 10 rows
    (2, 8, 1024, 32, 32, True, True),       # a 1024-wide row
])
def test_k3_backward_kernel(dev, b, h, w, c, cout, stats, residual):
    x, a, bb, wk, bias, res, _ = _conv_inputs(dev, b, h, w, (c,), cout, residual, False, seed=4)
    g = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn((b, h, w, cout), generator=g, device=dev).to(torch.bfloat16),
            torch.randn((b, cout), generator=g, device=dev) * 1e-3,
            torch.randn((b, cout), generator=g, device=dev) * 1e-4]
    ins = [x[0], a[0], bb[0], wk[0].float(), bias, res]  # f32 weights, as training holds them
    before, before_passes = dict(fused_resnet.launch_counts), dict(k3_passes.launch_counts)
    got = _grads(fused_resnet.affine_silu_conv3x3_vjp, ins, cots, stats)
    torch.cuda.synchronize()
    assert fused_resnet.launch_counts["K3"] == before["K3"] + 1
    assert fused_resnet.launch_counts["K2"] == before["K2"] + 2  # forward and data gradient
    assert fused_resnet.launch_counts["K2·pipe"] == before["K2·pipe"]
    assert k3_passes.launch_counts["K3·A"] == before_passes["K3·A"] + stats
    assert k3_passes.launch_counts["K3·B"] == before_passes["K3·B"] + 1
    ref = _grads(fused_resnet.affine_silu_conv3x3_plain, ins, cots, stats)
    for name, o, r in zip(["dx", "da", "db", "dw", "dbias", "dres"], got, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        assert _rel(o, r) <= 2e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("name,pack", [("cc12m_256x256", None), ("cc12m_1024x1024", 8)])
def test_tiny_nested_training_step_kernel_path_matches_plain_path(dev, name, pack):
    """One step of the scaled 256px model, and of the scaled 1024px model
    packed from side 8 with every stage recomputed (remat, save side 0)."""
    from ml_mdm_tpu_torch import trainer

    pipe, lm_dim, side = nested_preset(name, dev, seed=0, scaled=True, train=True,
                                       pack_min_side=pack)
    unet = pipe.vision_module
    g = torch.Generator(device=dev).manual_seed(6)
    b = 3
    batch = {"images": torch.rand((b, side, side, 3), generator=g, device=dev) * 2 - 1,
             "lm_outputs": torch.randn((b, 8, lm_dim), generator=g, device=dev),
             "lm_mask": torch.ones((b, 8), device=dev)}
    batch = {k: v.to(torch.bfloat16) for k, v in batch.items()}
    time = torch.tensor([10, 400, 900], device=dev)
    eps = [torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
           for x in pipe.get_noise(b, side, g)]
    trainer.set_remat(unet, 0 if pack else None)
    results = []
    for kernels in (True, False):
        unet.use_kernels(kernels).zero_grad()
        counts = gn_stats.launch_count, dict(fused_resnet.launch_counts)
        loss = pipe.get_loss(batch, time=time, eps=eps)[0].mean()
        loss.backward()
        torch.cuda.synchronize()
        if kernels:
            assert gn_stats.launch_count > counts[0]
            for mode in ("K2", "K3") + (("K2·struct",) if pack else ()):
                assert fused_resnet.launch_counts[mode] > counts[1][mode], mode
        grads = torch.cat([p.grad.flatten() for p in unet.parameters() if p.grad is not None])
        results.append((float(loss.detach()), grads))
    unet.use_kernels(True)
    (lk, gk), (lp, gp) = results
    assert torch.isfinite(gk).all() and gk.dtype == torch.float32
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    assert abs(float(gk.norm()) - float(gp.norm())) <= 5e-2 * float(gp.norm())
    assert float(torch.nn.functional.cosine_similarity(gk, gp, dim=0)) >= 0.99


def _qkv(dev, b, lq, lk, heads, d, chunked, seed=7):
    """bf16 q (b, lq, heads, d) and k, v (b, lk, heads, d): contiguous
    tensors, or with ``chunked`` (lq == lk) the three chunks of one
    (b, l, 3 * heads * d) tensor, as ``SelfAttention`` hands them over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if chunked:
        qkv = torch.randn((b, lq, 3 * heads * d), generator=g, device=dev).to(torch.bfloat16)
        return tuple(t.reshape(b, lq, heads, d) for t in qkv.chunk(3, dim=-1))
    return tuple(torch.randn((b, l, heads, d), generator=g, device=dev).to(torch.bfloat16)
                 for l in (lq, lk, lk))


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,d,lq,lk,chunked", [
    (3, 5, 32, 128, 384, False),    # the JAX test's shape: Lq != Lk
    (1, 7, 64, 384, 128, False),
    (3, 1, 96, 256, 128, False),    # six k-steps of 16
    (2, 3, 128, 128, 256, False),   # the widest head the kernel takes
    (4, 8, 64, 1024, 1024, True),   # the 64px model's shapes, as chunked views
    (3, 8, 96, 256, 256, True),
    (5, 3, 32, 128, 128, True),
    (1, 3, 48, 200, 72, False),     # ragged tiles: a direct call takes any length
])
def test_flash_attention_kernel(dev, b, heads, d, lq, lk, chunked):
    q, k, v = _qkv(dev, b, lq, lk, heads, d, chunked)
    assert q.is_contiguous() != chunked
    n = attention.launch_count
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launch_count == n + 1
    ref = attention.reference_flash_attention(q, k, v)
    assert out.shape == ref.shape == q.shape and out.dtype == torch.bfloat16
    assert out.is_contiguous() and torch.isfinite(out).all()
    assert _rel(out, ref) <= 2e-2
    # sharper than the stated tolerance: against the f32 result before its
    # rounding to bf16, the error stays at a few bf16 roundings of the output
    q32, k32, v32 = (t.float() for t in (q, k, v))
    assert _rel(out, attention.reference_flash_attention(q32, k32, v32)) <= 1e-2


def _check_flash(q, k, v):
    n = attention.launch_count
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launch_count == n + 1
    ref = attention.reference_flash_attention(q, k, v)
    assert out.shape == ref.shape == q.shape and out.dtype == torch.bfloat16
    assert out.is_contiguous() and torch.isfinite(out).all()
    assert _rel(out, ref) <= 2e-2
    q32, k32, v32 = (t.float() for t in (q, k, v))
    assert _rel(out, attention.reference_flash_attention(q32, k32, v32)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("lq,lk", [(200, 72), (40, 300), (128, 128), (257, 129), (130, 600)])
def test_flash_attention_kernel_every_width(dev, d, lq, lk):
    """Every head width the kernel takes (128-, 64- and 32-byte swizzled
    regions), Lq below one tile, ragged lengths, one to five key tiles (the
    three-stage ring wraps)."""
    _check_flash(*_qkv(dev, 2, lq, lk, 3, d, chunked=False))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,d", [(64, 1024, 8, 64), (64, 256, 8, 96),
                                         (8, 1024, 8, 64), (8, 256, 8, 96)])
def test_flash_attention_kernel_model_shapes(dev, b, l, heads, d):
    """The flash route's four launch shapes (64px batch 64, the 256px
    request's 8 rows), as the chunked views the model hands over."""
    _check_flash(*_qkv(dev, b, l, l, heads, d, chunked=True))


@pytest.mark.cuda
def test_flash_attention_kernel_strided_layouts(dev):
    """Operands whose strides do not grow with the axis (views of (B, H, L,
    D) tensors) and a view whose base is not 16-byte aligned (copied)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((2, 4, l, 64), generator=g, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for l in (160, 96, 96))
    _check_flash(q, k, v)
    flat = torch.randn((2 * 128 * 4 * 32 + 4,), generator=g, device=dev).to(torch.bfloat16)
    q = flat[4:].view(2, 128, 4, 32)  # 8 bytes past an aligned base
    assert q.data_ptr() % 16 == 8
    _check_flash(q, q, q)


@pytest.mark.cuda
def test_flash_route_on_the_card(dev):
    """bf16 takes K4 through ``dot_product_attention``; f32 is not a type
    the kernel takes, so it stays on the matmul route, and a direct call
    raises; a masked call stays on the matmul route; autograd raises."""
    q, k, v = _qkv(dev, 2, 128, 128, 4, 32, chunked=True)
    attention.use_flash(True)
    try:
        n = attention.launch_count
        out = attention.dot_product_attention(q, k, v)
        assert attention.launch_count == n + 1
        assert _rel(out, attention.matmul_attention(q, k, v)) <= 2e-2
        mask = torch.ones((2, 128), device=dev)
        attention.dot_product_attention(q, k, v, mask=mask)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        assert not attention._flash_supported(q32, k32)
        got = attention.dot_product_attention(q32, k32, v32)
        assert attention.launch_count == n + 1
        assert torch.equal(got, attention.matmul_attention(q32, k32, v32))
        with pytest.raises(TypeError):
            attention.flash_attention(q32, k32, v32)
        with pytest.raises(NotImplementedError):
            attention.dot_product_attention(q.clone().requires_grad_(True), k, v)
    finally:
        attention.use_flash(None)


@pytest.mark.cuda
def test_t5_encoder_on_the_card_matches_the_cpu(dev):
    """The text tower in f32 on the card against the same weights on the
    CPU, padded rows included: <= 1e-4 * max|ref| (the same f32 sums in
    another order, TF32 off)."""
    from ml_mdm_tpu_torch.language_models import t5

    cfg = t5.T5Config(vocab_size=1000, d_model=256, d_kv=32, d_ff=640, num_layers=4,
                      num_heads=8)
    enc = t5.init_t5_(t5.T5Encoder(cfg), torch.Generator().manual_seed(0)).eval()
    ids = torch.randint(0, 1000, (3, 150), generator=torch.Generator().manual_seed(1))
    mask = torch.ones((3, 150))
    mask[1, 90:] = 0
    mask[2, 7:] = 0
    with torch.no_grad():
        ref = enc(ids, mask)
        got = enc.to(dev)(ids.to(dev), mask.to(dev))
    assert got.dtype == torch.float32
    assert _rel(got.cpu(), ref) <= 1e-4


@pytest.mark.cuda
def test_clip_towers_on_the_card_match_the_cpu(dev):
    """The CLIP image and text towers (``language_models/clip.py``, seeded
    random weights, 4 layers each, patch 16 at 224 px) in f32 on the card
    against the same weights on the CPU, padded captions included:
    <= 1e-4 * max|ref| each (the same f32 sums in another order, TF32
    off)."""
    from ml_mdm_tpu_torch.language_models import clip

    cfg = clip.CLIPConfig(
        text=clip._tower(dict(hidden_size=256, intermediate_size=1024, num_hidden_layers=4,
                              num_attention_heads=4, vocab_size=1000), {}),
        vision=clip._tower(dict(hidden_size=384, intermediate_size=1536, num_hidden_layers=4,
                                num_attention_heads=6, image_size=224, patch_size=16), {}),
        projection_dim=128)
    model = clip.init_clip_(clip.CLIPModel(cfg), torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    pixels = torch.randn((5, 3, 224, 224), generator=g)
    eos = model.text_model.config.eos_token_id = 999
    ids = torch.randint(0, eos, (3, 20), generator=g)
    mask = torch.ones_like(ids)
    ids[:, -1] = eos
    ids[1, 9:] = eos  # a caption of 10 tokens, padded with the end token
    mask[1, 10:] = 0
    with torch.no_grad():
        ref = (model.get_image_features(pixels), model.get_text_features(ids, mask))
        model.to(dev)
        got = (model.get_image_features(pixels.to(dev)),
               model.get_text_features(ids.to(dev), mask.to(dev)))
    for g_, r in zip(got, ref):
        assert g_.dtype == torch.float32 and g_.shape == r.shape
        assert _rel(g_.cpu(), r) <= 1e-4


@pytest.mark.cuda
def test_data_plane_is_built_into_the_ports_build_directory(dev):
    """The reader's C++ data plane is compiled from the port's own
    datacore.cpp into ml_mdm_tpu_torch/_build/ and loaded from there, never
    from the JAX package's ml_mdm_tpu/native/."""
    import os

    from ml_mdm_tpu_torch import native

    ok = native.available()
    report = native.build_report()
    assert report["path"].startswith(str(native.BUILD_DIR) + os.sep)
    assert "ml_mdm_tpu" + os.sep + "native" not in report.get("command", "")
    if not ok:
        pytest.skip(f"the data plane did not build on this machine: {report}")
    lib_path = os.path.realpath(native.load()._name)
    assert lib_path.startswith(str(native.BUILD_DIR) + os.sep), lib_path
    assert "ml_mdm_tpu" + os.sep + "native" not in lib_path


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype,adamw", [("float32", True), ("bfloat16", False)])
def test_train_state_round_trip_on_the_card(dev, tmp_path, mu_dtype, adamw):
    """Two steps of the scaled flagship on the card (fused AdamW, or the
    bf16 first moment), the train state saved and loaded into a fresh
    state: parameters, EMA, both moments (a bf16 ``exp_avg`` stays bf16),
    the counts and the step, bit for bit."""
    from ml_mdm_tpu_torch import trainer
    from ml_mdm_tpu_torch.utils import checkpoint as ckpt

    cfg = trainer.TrainerConfig(lr=1e-4, warmup_steps=2, use_adamw=adamw,
                                adam_mu_dtype=mu_dtype)
    pipe, lm_dim, side = flagship_64px(dev, seed=1, scaled=True, train=True)
    state = trainer.TrainState.create(pipe.vision_module, cfg)
    step = trainer.make_train_step(pipe, cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    for _ in range(2):
        batch = {"images": torch.rand((3, side, side, 3), generator=g, device=dev) * 2 - 1,
                 "lm_outputs": torch.randn((3, 8, lm_dim), generator=g, device=dev),
                 "lm_mask": torch.ones((3, 8), device=dev)}
        state, m = step(state, batch, g)
        assert m["skipped"] == 0
    ckpt.save_train_state(str(tmp_path / "ts"), state, {"batch_num": 2})
    fresh_pipe, _, _ = flagship_64px(dev, seed=9, scaled=True, train=True)
    fresh = trainer.TrainState.create(fresh_pipe.vision_module, cfg)
    fresh, other = ckpt.load_train_state(str(tmp_path / "ts"), fresh)
    assert fresh.step == 2 and other["batch_num"] == 2
    for k, p in state.params.items():
        assert torch.equal(fresh.params[k], p), k
        assert torch.equal(fresh.ema_params[k], state.ema_params[k]), k
        mine, theirs = fresh.optimizer.state[fresh.params[k]], state.optimizer.state[p]
        assert set(mine) == set(theirs) == {"step", "exp_avg", "exp_avg_sq"}
        for name in theirs:
            assert mine[name].dtype == theirs[name].dtype, (k, name)
            assert torch.equal(mine[name].cpu(), theirs[name].cpu()), (k, name)
        assert mine["exp_avg"].dtype == getattr(torch, mu_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("side,c,packed", [(32, 128, False), (16, 256, False), (8, 256, False),
                                           (16, 32, True)])
def test_identity_prologue_backward_matches_plain(dev, side, c, packed):
    """``conv3x3_vjp`` (the dropout ResNet's conv2: K2's identity prologue
    forward, K3's backward without the chain) at the cifar10_32x32 conv2
    shapes (batch 16; and a packed one), against autograd of its plain
    twin (``affine_silu_conv3x3_plain`` with no affine), bf16: as K3."""
    g = torch.Generator(device=dev).manual_seed(side + c)
    bf = torch.bfloat16
    s = 2 if packed else 1
    x = (torch.randn((16, side // s, side // s, c * s * s), generator=g, device=dev)).to(bf)
    w = torch.randn((3, 3, c, c), generator=g, device=dev) / (9 * c) ** 0.5
    bias = torch.randn((c,), generator=g, device=dev) * 0.1
    res = torch.randn((16, side // s, side // s, c * s * s), generator=g, device=dev).to(bf)
    cot = torch.randn(res.shape, generator=g, device=dev).to(bf)
    kern = s2d.pack_conv3x3_kernel if packed else (lambda v: v)
    vec = s2d.pack_channel_vector if packed else (lambda v: v)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, w, bias, res)]
        y = fn(ins[0], kern(ins[1]), vec(ins[2]), ins[3])
        (y.float() * cot.float()).sum().backward()
        return [y] + [t.grad for t in ins]

    before = dict(fused_resnet.launch_counts)
    got = grads(lambda *a: fused_resnet.conv3x3_vjp(*a, packed_struct=packed))
    torch.cuda.synchronize()
    assert fused_resnet.launch_counts["K2"] == before["K2"] + 2  # forward and data gradient
    assert fused_resnet.launch_counts["K3"] == before["K3"] + 1
    ref = grads(lambda xx, ww, bb, rr: fused_resnet.affine_silu_conv3x3_plain(
        xx, None, None, ww, bb, rr, apply_silu=False, packed_struct=packed))
    for name, o, r in zip(["y", "dx", "dw", "dbias", "dres"], got, ref):
        assert o.shape == r.shape, name
        assert _rel(o, r) <= 2e-2, name


@pytest.mark.cuda
def test_fsdp_step_of_one_process_matches_the_data_parallel_step(dev):
    """One train step of the scaled flagship (bf16 compute, the kernels)
    sharded by FSDP over a one-process NCCL mesh (``fsdp:1``; every
    parameter of at least 2**10 elements a DTensor), against the
    data-parallel step of the same weights, batch and noise: loss within
    1e-2 relative, gradient norm within 5e-2 (the step tolerances), the
    parameters after the update as close;
    K2 and K3 launched under the sharded step."""
    import torch.distributed as dist

    from ml_mdm_tpu_torch import parallel, trainer

    cfg = trainer.TrainerConfig(lr=1e-4, warmup_steps=2)
    g = torch.Generator(device=dev).manual_seed(4)
    results = []
    try:
        for sharded in (False, True):
            pipe, lm_dim, side = flagship_64px(dev, seed=2, scaled=True, train=True)
            layout = None
            if sharded:
                layout = parallel.shard_module(
                    pipe.vision_module, parallel.make_mesh((1, 1), dev), min_size=2**10)
                assert len(layout.dims) >= 60
            state = trainer.TrainState.create(pipe.vision_module, cfg, layout=layout)
            step = trainer.make_train_step(pipe, cfg)
            g.manual_seed(4)
            batch = {"images": torch.rand((4, side, side, 3), generator=g, device=dev) * 2 - 1,
                     "lm_outputs": torch.randn((4, 8, lm_dim), generator=g, device=dev),
                     "lm_mask": torch.ones((4, 8), device=dev)}
            noise = {"time": torch.tensor([5, 300, 600, 900], device=dev),
                     "eps": torch.randn((4, side, side, 3), generator=g, device=dev)}
            before = dict(fused_resnet.launch_counts)
            state, m = step(state, batch, noise=noise)
            torch.cuda.synchronize()
            assert m["skipped"] == 0
            for mode in ("K2", "K3"):
                assert fused_resnet.launch_counts[mode] > before[mode], mode
            params = torch.cat([(layout.full(p) if layout else p.detach()).flatten()
                                for k, p in state.params.items()])
            results.append((m, params))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (md, pd), (mf, pf) = results
    assert abs(mf["loss"] - md["loss"]) <= 1e-2 * abs(md["loss"])
    assert abs(mf["grad_norm"] - md["grad_norm"]) <= 5e-2 * md["grad_norm"]
    assert _rel(pf, pd) <= 1e-2


# K2 with the stats, two calls on the same inputs, in every mode: (B, H, W,
# unpacked operand channels, Cout, shortcut, packed, pipelined, forced (N
# tile, m64 tiles) or None). "persistent": the plan's output tiles outnumber
# its grid, so one block takes several tiles in turn; "own slots": a tile
# too small to hold the per-warp slots, which then take shared memory of
# their own (a forced plan).
STATS_REPEAT = {
    "unpacked": (2, 12, 20, (64,), 136, False, False, None, None),
    "unpacked, persistent": (8, 64, 64, (128,), 256, False, False, None, None),
    "unpacked, ragged, persistent": (4, 40, 72, (64,), 200, False, False, None, None),
    "one tile an image": (16, 8, 8, (256,), 256, False, False, None, None),
    "own slots, one tile": (3, 4, 4, (64,), 256, False, False, None, (256, 1)),
    "own slots, two tiles": (2, 40, 1, (64,), 256, False, False, None, (256, 1)),
    "K2·N": (2, 16, 16, (64, 32), 128, False, False, None, None),
    "K2·N, persistent": (4, 64, 64, (64, 64, 32), 128, False, False, None, None),
    "K2·proj": (2, 16, 16, (128, 64), 128, True, False, None, None),
    "K2·proj, persistent": (4, 64, 64, (128, 64), 128, True, False, None, None),
    "K2·struct": (2, 12, 20, (16, 8), 24, False, True, None, None),
    "K2·struct, persistent": (4, 64, 64, (32,), 32, False, True, None, None),
    "K2·struct N proj, persistent": (4, 64, 64, (32, 32), 32, True, True, None, None),
    "K2·pipe, persistent": (2, 128, 128, (32,), 32, False, True, True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STATS_REPEAT))
def test_k2_stats_same_bits_from_call_to_call(dev, monkeypatch, name):
    """K2 with ``emit_stats`` twice on the same inputs: y, s1, s2 and the
    shortcut bitwise equal (each sum in ``stats_order``'s order, whatever
    the order the blocks arrive in), each within 2e-2 of its plain version,
    and every ticket back at 0 after the calls."""
    b, h, w, cs, cout, proj, packed, pipe, forced = STATS_REPEAT[name]
    if forced is not None:
        monkeypatch.setattr(fused_resnet, "_plan", _forced_plan(*forced))
    inputs = (_struct_inputs if packed else _conv_inputs)(dev, b, h, w, cs, cout, True, proj)
    xs, a_s, b_s, ws, bias, res, kw = inputs
    co = cout * (4 if packed else 1)
    p = fused_resnet._plan(b, h, w, tuple(x.shape[-1] for x in xs), co, 132, proj, packed)
    order = fused_resnet.stats_order(p, b, h, w, co)
    if "persistent" in name:
        assert p.tiles > p.grid, p
    assert order.slots_in_tile == ("own slots" not in name)
    assert (len(order.tiles) == 1) == ("one tile" in name)
    before = dict(fused_resnet.launch_counts)
    outs = [fused_resnet.affine_silu_conv3x3(xs, a_s, b_s, ws, bias, res, emit_stats=True,
                                             pipelined=pipe, packed_struct=packed, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_resnet.launch_counts["K2"] == before["K2"] + 2
    assert fused_resnet.launch_counts["K2·pipe"] == before["K2·pipe"] + 2 * bool(pipe)
    assert len(outs[0]) == 3 + proj
    for o, again in zip(*outs):
        assert torch.equal(o, again)
    ref = fused_resnet.affine_silu_conv3x3_plain(xs, a_s, b_s, ws, bias, res, emit_stats=True,
                                                 packed_struct=packed, **kw)
    for o, r in zip(outs[0], ref):
        assert o.shape == r.shape and torch.isfinite(o).all()
        assert _rel(o, r) <= 2e-2
    assert not gn_stats.ticket_buffer(xs[0].device.index, max(order.tickets, 1)).any()


@pytest.mark.cuda
def test_k2_stats_call_is_one_launch(dev):
    """A stats-emitting K2 call with its weights' layout kept and the
    identity prologue runs one device kernel: s1 and s2 are written by it,
    not zeroed first, and its tickets need no fill."""
    xs, _, _, ws, bias, _, _ = _conv_inputs(dev, 4, 64, 64, (64,), 128, False, False)
    kept = fused_resnet.K2Weights(ws)
    run = lambda: fused_resnet.affine_silu_conv3x3(xs, None, None, kept, bias,  # noqa: E731
                                                   apply_silu=False, emit_stats=True)
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "conv3x3_wgmma_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_stats_slots_shared_memory_matches_the_kernel(dev):
    """The host's shared-memory formula is the kernel's where the per-warp
    slots fit in an activated tile and where they take memory of their
    own."""
    lib = fused_resnet.load_library()
    for bn, th, tw in ((128, 8, 32), (256, 4, 32), (256, 4, 4), (256, 32, 1), (64, 4, 4)):
        assert lib.ml_mdm_conv3x3_smem_bytes(bn, th, tw, 2) == fused_resnet.smem_bytes(
            bn, th, tw, 2), (bn, th, tw)


@pytest.mark.cuda
def test_64px_request_same_bits_from_call_to_call(dev):
    """The flagship at full size on the kernel route: a batch-4 DDIM-4
    request twice from the same seed, bitwise equal."""
    pipe, lm_dim, side = flagship_64px(dev, seed=0)
    outs = []
    for _ in range(2):
        g = torch.Generator(device=dev).manual_seed(5)
        cond = {"lm_outputs": torch.randn((4, 8, lm_dim), generator=g, device=dev)
                .to(torch.bfloat16),
                "lm_mask": torch.ones((4, 8), device=dev, dtype=torch.bfloat16)}
        counts = dict(fused_resnet.launch_counts)
        outs.append(pipe.sample(4, cond, side, g, num_inference_steps=4, ddim_eta=0.0))
        torch.cuda.synchronize()
        for mode in SAMPLING_MODES:
            assert fused_resnet.launch_counts[mode] > counts[mode], mode
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_train_256_step_same_bits_from_call_to_call(dev):
    """One step of the ``train_256`` preset's model and recipe (cc12m_256x256
    at full size, f32 parameters, bf16 compute, its packed stage) at batch
    2 (the least that its ``mixed_ratio`` of 2:1 gives rows at both
    resolutions), twice from the same weights, batch and noise (a fresh
    train state each time): loss, gradient norm, parameters and EMA bitwise
    equal."""
    from ml_mdm_tpu_torch import trainer

    pipe, lm_dim, side = nested_preset("cc12m_256x256", dev, seed=0, train=True)
    unet = pipe.vision_module
    cfg = trainer.TrainerConfig(lr=5e-5, warmup_steps=10, gradient_clip_norm=2.0)
    start = {k: p.detach().clone() for k, p in unet.named_parameters()}
    results = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in unet.named_parameters():
                p.copy_(start[k])
        state = trainer.TrainState.create(unet, cfg)
        step = trainer.make_train_step(pipe, cfg)
        g = torch.Generator(device=dev).manual_seed(7)
        batch = {"images": torch.rand((2, side, side, 3), generator=g, device=dev) * 2 - 1,
                 "lm_outputs": torch.randn((2, 32, lm_dim), generator=g, device=dev),
                 "lm_mask": torch.ones((2, 32), device=dev)}
        counts = dict(fused_resnet.launch_counts)
        state, m = step(state, batch, g)
        torch.cuda.synchronize()
        assert m["skipped"] == 0
        for mode in ("K2", "K2·struct", "K3"):
            assert fused_resnet.launch_counts[mode] > counts[mode], mode
        results.append((m, {k: p.detach().clone() for k, p in state.params.items()},
                        {k: e.clone() for k, e in state.ema_params.items()}))
        del state, step
    (m0, p0, e0), (m1, p1, e1) = results
    assert (m0["loss"], m0["grad_norm"]) == (m1["loss"], m1["grad_norm"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(e0[k], e1[k]) for k in e0)
    assert any(not torch.equal(p0[k], start[k]) for k in p0)
