"""The unpacked K2 kernel's host side on the CPU: ``conv_plan`` (tile, N
tile, ring depth, shared memory, grid) at every unpacked launch shape of the
three models' forwards and training steps and at ragged shapes, and
``conv_weight_layout`` read exactly as the kernel reads it. No card, no
compiler: ``_emulate`` replays one launch block by block as
``csrc/fused_resnet.cu`` ``conv3x3_wgmma_kernel`` runs it, from the same
addresses. It stages each 64-channel chunk of the raw tile and its halo with
16-byte group j of staged pixel p at j ^ (p mod 8) and activates it, reads A
through the ldmatrix row addresses of each of the 9 shifted taps, reads B
from the host layout as the K-major 128-byte-swizzled descriptor addresses
it (group j of row n at j ^ (n mod 8)), with the part of a slot past the
copied rows left stale (NaN here), and stores only the pixels and channels
that exist. Its result is held against ``F.conv2d``: a transposed layout, a
dropped swizzle or a wrong tap order gives another convolution.

Tolerances: the emulation's f32 accumulator against the f64 convolution of
the same bf16 activation and weights, 1e-5 of max|ref| (f32 sums in another
order); its bf16 y against the plain version, 1e-2 of max|ref| (one rounding
of that f32 sum can flip).
"""
import math

import pytest
import torch
import torch.nn.functional as F

from ml_mdm_tpu_torch.ops import fused_resnet as fr

torch.set_num_threads(1)

# The unpacked K2 launches (B, H, W, operand channels, Cout, shortcut) of
# one forward or training step of each model at full size, recorded on the
# meta device (no memory, no arithmetic) by wrapping the kernel's entry
# point as chip_smoke.py does; training steps include K3's data gradients.
MODEL_LAUNCHES = {
    "cc12m_64x64 forward, batch 64": [
        (64, 16, 16, (512,), 768, 1), (64, 16, 16, (768,), 768, 0),
        (64, 16, 16, (768, 512), 768, 1), (64, 16, 16, (768, 768), 768, 1),
        (64, 32, 32, (256,), 512, 1), (64, 32, 32, (512,), 512, 0),
        (64, 32, 32, (512, 256), 512, 1), (64, 32, 32, (512, 512), 512, 1),
        (64, 32, 32, (768, 512), 512, 1), (64, 64, 64, (256,), 256, 0),
        (64, 64, 64, (256, 256), 256, 1), (64, 64, 64, (512, 256), 256, 1),
    ],
    "cc12m_256x256 forward, 8 rows": [
        (8, 16, 16, (512,), 768, 1), (8, 16, 16, (768,), 768, 0),
        (8, 16, 16, (768, 512), 768, 1), (8, 16, 16, (768, 768), 768, 1),
        (8, 32, 32, (256,), 512, 1), (8, 32, 32, (512,), 512, 0),
        (8, 32, 32, (512, 256), 512, 1), (8, 32, 32, (512, 512), 512, 1),
        (8, 32, 32, (768, 512), 512, 1), (8, 64, 64, (128,), 256, 1),
        (8, 64, 64, (256,), 256, 0), (8, 64, 64, (256, 128), 256, 1),
        (8, 64, 64, (256, 256), 256, 1), (8, 64, 64, (512, 256), 256, 1),
        (8, 128, 128, (64,), 128, 1), (8, 128, 128, (128,), 128, 0),
        (8, 128, 128, (128,), 512, 0), (8, 128, 128, (128, 64), 128, 1),
        (8, 128, 128, (128, 128), 128, 1), (8, 128, 128, (256, 128), 128, 1),
    ],
    "cc12m_1024x1024 forward, batch 4": [
        (4, 16, 16, (512,), 768, 1), (4, 16, 16, (768,), 768, 0),
        (4, 16, 16, (768, 512), 768, 1), (4, 16, 16, (768, 768), 768, 1),
        (4, 32, 32, (256,), 512, 1), (4, 32, 32, (512,), 512, 0),
        (4, 32, 32, (512, 256), 512, 1), (4, 32, 32, (512, 512), 512, 1),
        (4, 32, 32, (768, 512), 512, 1), (4, 64, 64, (128,), 256, 1),
        (4, 64, 64, (256,), 256, 0), (4, 64, 64, (256, 128), 256, 1),
        (4, 64, 64, (256, 256), 256, 1), (4, 64, 64, (512, 256), 256, 1),
        (4, 128, 128, (64,), 128, 1), (4, 128, 128, (128,), 128, 0),
        (4, 128, 128, (128, 64), 128, 1), (4, 128, 128, (128, 128), 128, 1),
        (4, 128, 128, (256, 128), 128, 1), (4, 256, 256, (64,), 256, 0),
        (4, 512, 512, (32,), 128, 0),
    ],
    "cc12m_1024x1024 forward, batch 4, unpacked": [
        (4, 16, 16, (512,), 768, 1), (4, 16, 16, (768,), 768, 0),
        (4, 16, 16, (768, 512), 768, 1), (4, 16, 16, (768, 768), 768, 1),
        (4, 32, 32, (256,), 512, 1), (4, 32, 32, (512,), 512, 0),
        (4, 32, 32, (512, 256), 512, 1), (4, 32, 32, (512, 512), 512, 1),
        (4, 32, 32, (768, 512), 512, 1), (4, 64, 64, (128,), 256, 1),
        (4, 64, 64, (256,), 256, 0), (4, 64, 64, (256, 128), 256, 1),
        (4, 64, 64, (256, 256), 256, 1), (4, 64, 64, (512, 256), 256, 1),
        (4, 128, 128, (64,), 128, 1), (4, 128, 128, (128,), 128, 0),
        (4, 128, 128, (128, 64), 128, 1), (4, 128, 128, (128, 128), 128, 1),
        (4, 128, 128, (256, 128), 128, 1), (4, 256, 256, (32,), 64, 1),
        (4, 256, 256, (64,), 64, 0), (4, 256, 256, (64, 32), 64, 1),
        (4, 256, 256, (64, 64), 64, 1), (4, 256, 256, (128, 64), 64, 1),
        (4, 512, 512, (32,), 32, 0), (4, 512, 512, (32, 32), 32, 1),
        (4, 512, 512, (64, 32), 32, 1), (4, 1024, 1024, (32,), 32, 0),
        (4, 1024, 1024, (32, 32), 32, 1),
    ],
    "train_256 step, batch 16": [
        (10, 64, 64, (128,), 256, 0), (10, 64, 64, (256,), 128, 0),
        (10, 64, 64, (256,), 256, 0), (10, 64, 64, (256,), 384, 0),
        (10, 64, 64, (256,), 512, 0), (10, 64, 64, (384,), 256, 0),
        (10, 64, 64, (512,), 256, 0), (10, 128, 128, (64,), 128, 0),
        (10, 128, 128, (128,), 64, 0), (10, 128, 128, (128,), 128, 0),
        (10, 128, 128, (128,), 192, 0), (10, 128, 128, (128,), 256, 0),
        (10, 128, 128, (128,), 384, 0), (10, 128, 128, (192,), 128, 0),
        (10, 128, 128, (256,), 128, 0), (10, 128, 128, (384,), 128, 0),
        (16, 16, 16, (512,), 768, 0), (16, 16, 16, (768,), 512, 0),
        (16, 16, 16, (768,), 768, 0), (16, 16, 16, (768,), 1280, 0),
        (16, 16, 16, (768,), 1536, 0), (16, 16, 16, (1280,), 768, 0),
        (16, 16, 16, (1536,), 768, 0), (16, 32, 32, (256,), 512, 0),
        (16, 32, 32, (512,), 256, 0), (16, 32, 32, (512,), 512, 0),
        (16, 32, 32, (512,), 768, 0), (16, 32, 32, (512,), 1024, 0),
        (16, 32, 32, (512,), 1280, 0), (16, 32, 32, (768,), 512, 0),
        (16, 32, 32, (1024,), 512, 0), (16, 32, 32, (1280,), 512, 0),
        (16, 64, 64, (256,), 256, 0), (16, 64, 64, (256,), 512, 0),
        (16, 64, 64, (256,), 768, 0), (16, 64, 64, (512,), 256, 0),
        (16, 64, 64, (768,), 256, 0),
    ],
    "train_1024 step, batch 2": [
        (2, 16, 16, (512,), 768, 0), (2, 16, 16, (768,), 512, 0), (2, 16, 16, (768,), 768, 0),
        (2, 16, 16, (768,), 1280, 0), (2, 16, 16, (768,), 1536, 0),
        (2, 16, 16, (1280,), 768, 0), (2, 16, 16, (1536,), 768, 0), (2, 32, 32, (256,), 512, 0),
        (2, 32, 32, (512,), 256, 0), (2, 32, 32, (512,), 512, 0), (2, 32, 32, (512,), 768, 0),
        (2, 32, 32, (512,), 1024, 0), (2, 32, 32, (512,), 1280, 0), (2, 32, 32, (768,), 512, 0),
        (2, 32, 32, (1024,), 512, 0), (2, 32, 32, (1280,), 512, 0), (2, 64, 64, (128,), 256, 0),
        (2, 64, 64, (256,), 128, 0), (2, 64, 64, (256,), 256, 0), (2, 64, 64, (256,), 384, 0),
        (2, 64, 64, (256,), 512, 0), (2, 64, 64, (256,), 768, 0), (2, 64, 64, (384,), 256, 0),
        (2, 64, 64, (512,), 256, 0), (2, 64, 64, (768,), 256, 0), (2, 128, 128, (64,), 128, 0),
        (2, 128, 128, (128,), 64, 0), (2, 128, 128, (128,), 128, 0),
        (2, 128, 128, (128,), 192, 0), (2, 128, 128, (128,), 256, 0),
        (2, 128, 128, (128,), 384, 0), (2, 128, 128, (192,), 128, 0),
        (2, 128, 128, (256,), 128, 0), (2, 128, 128, (384,), 128, 0),
    ],
}

RAGGED = [
    (2, 12, 20, (16, 24, 8), 16, 1),   # three ragged operands, ragged tiles
    (1, 37, 53, (64,), 96, 0),         # H*W no multiple of any tile
    (3, 7, 40, (8,), 200, 1),          # W = 40: a second tile column of 8
    (2, 5, 96, (40,), 72, 0),          # W = 96: three tile columns, H < TH
    (16, 16, 16, (768,), 768, 1),      # the 64px CFG request's 16 rows at 16^2
    (16, 8, 8, (768,), 768, 0),        # 64 pixels an image
    (1, 1, 1, (8,), 8, 0),
    (1, 64, 1024, (32,), 32, 0),       # a 1024-wide row of the 1024px shell, unpacked
]


def _check_plan(b, h, w, cs, cout, proj):
    p = fr.conv_plan(b, h, w, cs, cout, 132, bool(proj))
    assert (p.bn, p.mt) in fr.CANDIDATES
    assert p.smem == fr.smem_bytes(p.bn, p.th, p.tw, p.stages) <= fr.SMEM_LIMIT
    assert 2 <= p.stages <= fr.MAX_STAGES
    assert p.tw == min(w, 32) and 1 <= p.th <= min(h, 32)
    assert p.th * p.tw <= 128 * p.mt and p.th * p.tw > 128 * (p.mt - 1)
    assert p.bn <= max(64, -(-cout // 64) * 64)
    tiles = b * -(-h // p.th) * -(-w // p.tw)
    assert p.grid == min(132, tiles * -(-cout // p.bn)) and p.persistent
    n_q = sum(-(-c // 64) for c in cs)
    assert p.l2_bytes >= tiles * n_q * (9 + proj) * -(-cout // 64) * 64 * 128
    return p


@pytest.mark.parametrize("name", sorted(MODEL_LAUNCHES))
def test_conv_plan_fits_every_model_launch(name):
    """Every unpacked launch of the models fits the block's 232,448 bytes of
    shared memory with at least two ring slots; where the launch has the
    work, it fills the 132 SMs with persistent blocks."""
    for key in MODEL_LAUNCHES[name]:
        p = _check_plan(*key)
        b, h, w, cs, cout, _ = key
        if b * h * w * -(-cout // 64) >= 132 * 128:
            assert p.grid >= 132, key


def test_model_launches_recorded():
    assert len(MODEL_LAUNCHES["cc12m_64x64 forward, batch 64"]) == 12  # of the 15 launch shapes
    assert len({k for v in MODEL_LAUNCHES.values() for k in v}) == 134


def test_conv_plan_at_the_64px_shapes():
    """The 64px batch-64 forward: M = 256 output pixels a block (weights
    read from L2 once per 256 pixels), N = 128, a ring of 6 slices beside
    the three staged tiles; and the CFG request's 4,096-pixel 768-channel
    launch still spread over the SMs."""
    for b, h, w, cs, cout, proj in MODEL_LAUNCHES["cc12m_64x64 forward, batch 64"]:
        p = fr.conv_plan(b, h, w, cs, cout, 132, bool(proj))
        assert (p.bn, p.mt, p.stages) == (128, 2, 6) and p.th * p.tw == 256
    p = fr.conv_plan(16, 16, 16, (768,), 768, 132, True)
    assert p.grid == 132 and p.bn == 128 and p.th * p.tw == 128


@pytest.mark.parametrize("key", RAGGED, ids=str)
def test_conv_plan_covers_ragged_tiles(key):
    """Each output (pixel, channel) is stored exactly once, by the
    persistent blocks' walk over the output tiles (block b takes b, b +
    grid, ...), each tile's decomposition (N tiles fastest) and the stores'
    masks."""
    b, h, w, cs, cout, proj = key
    p = _check_plan(*key)
    covered = torch.zeros((b, h, w, cout), dtype=torch.int32)
    tiles_w, n_nt = -(-w // p.tw), -(-cout // p.bn)
    tiles_img = -(-h // p.th) * tiles_w
    m = torch.arange(p.th * p.tw)
    tiles = [tl for block in range(p.grid) for tl in range(block, b * tiles_img * n_nt, p.grid)]
    assert sorted(tiles) == list(range(b * tiles_img * n_nt))
    for tile in tiles:
        nt, mtile = tile % n_nt, tile // n_nt
        img, t = mtile // tiles_img, mtile % tiles_img
        oh, ow = (t // tiles_w) * p.th + m // p.tw, (t % tiles_w) * p.tw + m % p.tw
        ok = (oh < h) & (ow < w)
        n = torch.arange(nt * p.bn, min((nt + 1) * p.bn, cout))
        covered[img, oh[ok][:, None], ow[ok][:, None], n[None, :]] += 1
    assert bool((covered == 1).all())


# -- the kernel's reading of the layout, replayed -------------------------------


def _bf(t):
    return t.to(torch.bfloat16).float()


def _emulate(xs, a_s, b_s, ws, bias, residual, bn, mt, apply_silu=True):
    """One launch as the wgmma kernel runs it (module docstring). Returns
    (y in bf16, the f32 accumulator before the epilogue)."""
    bsz, h, w = xs[0].shape[:3]
    cs = [x.shape[-1] for x in xs]
    cout = ws[0].shape[-1]
    cpad = -(-cout // 64) * 64
    layout = fr.conv_weight_layout(ws).float()          # (n_q, 9, cpad, 64)
    n_q = layout.shape[0]
    tw = min(w, 32)
    th = max(1, min(128 * mt // tw, h, 32))
    sw, tile_px = tw + 2, th * tw
    n_stage = (th + 2) * sw
    tiles_w = -(-w // tw)
    tiles_img = -(-h // th) * tiles_w
    n_nt = -(-cout // bn)
    chunks = [(k, q * 64) for k, c in enumerate(cs) for q in range(-(-c // 64))]
    assert len(chunks) == n_q
    px = torch.arange(n_stage)
    m = torch.arange(128 * mt).clamp(max=tile_px - 1)   # rows past the tile repeat its last
    p0 = (m // tw) * sw + m % tw
    kk = torch.arange(64)
    acc_all = torch.full((bsz, h, w, cout), float("nan"))
    y = torch.zeros((bsz, h, w, cout))
    for block in range(bsz * tiles_img * n_nt):
        nt, mtile = block % n_nt, block // n_nt
        img, t = mtile // tiles_img, mtile % tiles_img
        r0, col0, n0 = (t // tiles_w) * th, (t % tiles_w) * tw, nt * bn
        ih, iw = r0 - 1 + px // sw, col0 - 1 + px % sw
        inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
        acc = torch.zeros((128 * mt, bn), dtype=torch.float64)
        for q, (k, c0) in enumerate(chunks):
            # the staged tile as the kernel writes it: [pixel][position][8]
            ch = c0 + kk
            okc = ch < cs[k]
            vals = torch.zeros((n_stage, 64))
            src = xs[k][img, ih.clamp(0, h - 1), iw.clamp(0, w - 1)][:, ch.clamp(max=cs[k] - 1)]
            if a_s is not None:
                v = src.float() * a_s[k][img, ch.clamp(max=cs[k] - 1)] + b_s[k][img, ch.clamp(
                    max=cs[k] - 1)]
                src = _bf(F.silu(v) if apply_silu else v)
            vals = torch.where(inside[:, None] & okc[None, :], src.float(), vals)
            phys = torch.zeros((n_stage, 8, 8))
            pos = torch.arange(8)[None, :] ^ (px[:, None] % 8)   # group j at j ^ (p mod 8)
            phys[px[:, None], pos] = vals.reshape(n_stage, 8, 8)
            # the ring slot: the copied rows of the layout's slice, stale past them
            rows = min(bn, cpad - n0)
            for tap in range(9):
                slot = torch.full((bn, 8, 8), float("nan"))
                slot[:rows] = layout[q, tap, n0:n0 + rows].reshape(rows, 8, 8)
                n = torch.arange(bn)
                b_mat = slot[n[:, None], (kk[None, :] // 8) ^ (n[:, None] % 8), kk[None, :] % 8]
                p = p0 + (tap // 3) * sw + tap % 3              # ldmatrix row addresses
                a_mat = phys[p[:, None], (kk[None, :] // 8) ^ (p[:, None] % 8), kk[None, :] % 8]
                acc += a_mat.double() @ b_mat.double().t()
        mm = torch.arange(128 * mt)
        oh, ow = r0 + mm // tw, col0 + mm % tw
        ok = (mm < tile_px) & (oh < h) & (ow < w)
        ncols = torch.arange(n0, min(n0 + bn, cout))
        sel = acc[ok][:, : len(ncols)].float()
        acc_all[img, oh[ok][:, None], ow[ok][:, None], ncols[None, :]] = sel
        out = sel + (bias[ncols] if bias is not None else 0.0)
        if residual is not None:
            out = out + residual[img, oh[ok], ow[ok]][:, ncols].float()
        y[img, oh[ok][:, None], ow[ok][:, None], ncols[None, :]] = out
    return y.to(torch.bfloat16), acc_all


def _inputs(bsz, h, w, cs, cout, seed, residual=True):
    g = torch.Generator().manual_seed(seed)
    ctot = sum(cs)
    xs = tuple(torch.randn((bsz, h, w, c), generator=g).to(torch.bfloat16) for c in cs)
    a_s = tuple(torch.randn((bsz, c), generator=g) * 0.2 + 1.0 for c in cs)
    b_s = tuple(torch.randn((bsz, c), generator=g) * 0.3 for c in cs)
    ws = tuple((torch.randn((3, 3, c, cout), generator=g) / (9 * ctot) ** 0.5).to(torch.bfloat16)
               for c in cs)
    bias = torch.randn((cout,), generator=g) * 0.1
    res = torch.randn((bsz, h, w, cout), generator=g).to(torch.bfloat16) if residual else None
    return xs, a_s, b_s, ws, bias, res


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


@pytest.mark.parametrize("bn,mt", fr.CANDIDATES)
@pytest.mark.parametrize("h,w,cs,cout", [
    (5, 12, (8,), 40),           # C = 8, ragged rows, Cout below one N tile
    (9, 40, (24, 40), 200),      # C = 24 + 40, W = 40, Cout not a multiple of N
    (6, 8, (72,), 136),          # two chunks of one operand (72 = 64 + 8)
])
def test_layout_read_as_the_kernel_reads_it(bn, mt, h, w, cs, cout):
    """The replayed launch gives the convolution of the activated
    concatenation with the HWIO weights, at every (N tile, m64 tiles) of
    the plan's candidates."""
    xs, a_s, b_s, ws, bias, res = _inputs(2, h, w, cs, cout, seed=len(cs) + bn + mt)
    y, acc = _emulate(xs, a_s, b_s, ws, bias, res, bn, mt)
    act = torch.cat([_bf(F.silu(x.float() * a[:, None, None] + b[:, None, None]))
                     for x, a, b in zip(xs, a_s, b_s)], dim=-1)
    wk = torch.cat([wi.float() for wi in ws], dim=2)
    ref = F.conv2d(act.double().permute(0, 3, 1, 2), wk.double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    assert not torch.isnan(acc).any()
    assert _rel(acc, ref) <= 1e-5
    plain = fr.affine_silu_conv3x3_plain(xs, a_s, b_s, ws, bias, res)
    assert y.dtype == plain.dtype and _rel(y.float(), plain.float()) <= 1e-2


def test_layout_of_the_shortcut_and_identity_prologue():
    """The shortcut's (C_k, Cout) matrices lay out as one tap; the identity
    prologue (no a, b: ``conv3x3_fast``) gives conv3x3_fast's plain version."""
    xs, _, _, ws, bias, _ = _inputs(2, 7, 9, (24,), 72, seed=3, residual=False)
    y, acc = _emulate(xs, None, None, ws, bias, None, 64, 1)
    plain = fr.conv3x3_fast(xs[0], ws[0], bias)
    ref = F.conv2d(xs[0].double().permute(0, 3, 1, 2), ws[0].double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    assert _rel(acc, ref) <= 1e-5
    assert _rel(y.float(), plain.float()) <= 1e-2
    p = torch.randn((40, 72)).to(torch.bfloat16)
    lay = fr.conv_weight_layout((p,))
    assert lay.shape == (1, 1, 128, 64)
    n = torch.arange(128)[:, None]
    k = torch.arange(64)[None, :]
    back = lay[0, 0].reshape(128, 8, 8)[n, (k // 8) ^ (n % 8), k % 8]   # (cpad, 64): [n][k]
    assert torch.equal(back[:72, :40], p.t()) and not back[72:].any() and not back[:, 40:].any()


def test_k2_weights_keep_their_layout():
    ws = (torch.randn((3, 3, 16, 24)), torch.randn((3, 3, 8, 24)))
    kw = fr.K2Weights(ws)
    lay = kw.layout(torch.device("cpu"))
    assert kw.layout(torch.device("cpu")) is lay
    assert torch.equal(lay, fr.conv_weight_layout(ws)) and fr._kernels(kw) == ws
    x = tuple(torch.randn((1, 4, 4, c)) for c in (16, 8))
    a = tuple(torch.ones((1, c)) for c in (16, 8))
    b = tuple(torch.zeros((1, c)) for c in (16, 8))
    assert torch.equal(fr.affine_silu_conv3x3(x, a, b, kw, None),
                       fr.affine_silu_conv3x3(x, a, b, ws, None))


def test_sampling_weights_follow_packing():
    """A model's kept sampling weights are keyed on packing too: after a
    packed forward, turning packing off gives the forward of a model built
    unpacked (the packed weights are not reused for the unpacked route)."""
    from ml_mdm_tpu_torch.models.layers import ResNetBlockStage
    from ml_mdm_tpu_torch.presets import nested_preset, set_pack_min_side

    def build(pack):
        pipe, lm_dim, side = nested_preset("cc12m_1024x1024", "cpu", seed=3, scaled=True,
                                           pack_min_side=pack)
        return pipe, lm_dim, side

    (pipe, lm_dim, side), (ref_pipe, _, _) = build(8), build(0)
    g = torch.Generator().manual_seed(4)
    xs = pipe.get_noise(1, side, g)
    t = torch.tensor([300])
    lm = torch.randn((1, 8, lm_dim), generator=g).to(torch.bfloat16)
    mask = torch.ones((1, 8), dtype=torch.bfloat16)
    unet = pipe.vision_module
    with torch.no_grad():
        unet(xs, t, lm, mask, {})  # the packed route keeps its weights
        set_pack_min_side(unet.config, 0)
        for m in unet.modules():
            if isinstance(m, ResNetBlockStage):
                m.pack_min_side = 0
        got = unet(xs, t, lm, mask, {})
        ref = ref_pipe.vision_module(xs, t, lm, mask, {})
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
