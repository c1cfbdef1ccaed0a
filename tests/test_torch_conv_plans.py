"""The K2 kernel's host side on the CPU: ``conv_plan`` (tile, N tile, ring
depth, shared memory, grid) at every launch shape of the three models'
forwards and training steps, unpacked and packed, and at ragged shapes, and
``conv_weight_layout`` read exactly as the kernel reads it. No card, no
compiler: ``_emulate`` replays one launch block by block as
``csrc/fused_resnet.cu`` ``conv3x3_wgmma_kernel`` runs it, from the same
addresses. It stages each 64-channel chunk of the raw tile and its halo with
16-byte group j of staged pixel p at j ^ (p mod 8) and activates it (packed:
each 16-byte raw group stored as four 4-byte pieces into the parity-class
order, channel 4 i + code at position 16 code + i), reads A through the
ldmatrix row addresses of each tap's shifted rows (packed: of each combined
tap and k-step, at the host's ``struct_tap_offsets``, which the kernel
reads), reads B from the host layout as the K-major 128-byte-swizzled
descriptor addresses it (group j of row n at j ^ (n mod 8)), with the part
of a slot past the copied rows left stale (NaN here), runs the shortcut's
pass over the raw tile through the centre, and stores only the pixels and
channels that exist. Unpacked, its result is held against ``F.conv2d``: a
transposed layout, a dropped swizzle or a wrong tap order gives another
convolution. Packed, against the JAX ``affine_silu_conv3x3(...,
packed_struct=True, interpret=True)`` on numpy inputs from a seed: a dropped
permutation or a select reading the wrong neighbour gives another one.

Tolerances: the emulation's f32 accumulator against the f64 convolution of
the same bf16 activation and weights, 1e-5 of max|ref| (f32 sums in another
order); its bf16 y against the plain version, 1e-2 of max|ref| (one rounding
of that f32 sum can flip). Packed against JAX: f32 inputs (bf16-exact
weights, which the layout keeps exactly) 1e-5 of max|ref| (f32 sums in
another order); bf16 inputs 2e-2 (two bf16 ULPs: the activation and the
output are rounded at the same places, the sums' order can flip one).
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ml_mdm_tpu.ops import fused_resnet as jfr
from ml_mdm_tpu.ops import space_to_depth as js2d
from ml_mdm_tpu_torch.ops import fused_resnet as fr
from torch_parity import rel_err, to_np

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

# The packed K2 launches (B, H, W, operand channels, Cout, shortcut), in
# packed channels, of the nested forwards and training steps at full size,
# recorded on the meta device as above: the 256px and 1024px forwards and
# the train_256 and train_1024 steps (K3's data gradients included).
PACKED_LAUNCHES = {
    "cc12m_256x256 forward, 8 rows": [
        (8, 128, 128, (16,), 256, 0), (8, 128, 128, (256,), 16, 0),
        (8, 128, 128, (256,), 256, 0), (8, 128, 128, (256, 256), 256, 1),
        (8, 128, 128, (512, 256), 256, 1),
    ],
    "cc12m_1024x1024 forward, batch 4": [
        (4, 128, 128, (128,), 256, 1), (4, 128, 128, (256,), 256, 0),
        (4, 128, 128, (256, 128), 256, 1), (4, 128, 128, (256, 256), 256, 1),
        (4, 128, 128, (512, 256), 256, 1), (4, 256, 256, (128,), 128, 0),
        (4, 256, 256, (128, 128), 128, 1), (4, 256, 256, (256, 128), 128, 1),
        (4, 512, 512, (16,), 128, 0), (4, 512, 512, (128,), 16, 0),
        (4, 512, 512, (128,), 128, 0), (4, 512, 512, (128, 128), 128, 1),
    ],
    "train_256 step, batch 16": [
        (10, 128, 128, (256,), 256, 0), (10, 128, 128, (256,), 512, 0),
        (10, 128, 128, (256,), 768, 0), (10, 128, 128, (512,), 256, 0),
        (10, 128, 128, (768,), 256, 0),
    ],
    "train_1024 step, batch 2": [
        (2, 128, 128, (128,), 256, 0), (2, 128, 128, (256,), 128, 0),
        (2, 128, 128, (256,), 256, 0), (2, 128, 128, (256,), 384, 0),
        (2, 128, 128, (256,), 512, 0), (2, 128, 128, (256,), 768, 0),
        (2, 128, 128, (384,), 256, 0), (2, 128, 128, (512,), 256, 0),
        (2, 128, 128, (768,), 256, 0), (2, 256, 256, (128,), 128, 0),
        (2, 256, 256, (128,), 256, 0), (2, 256, 256, (128,), 384, 0),
        (2, 256, 256, (256,), 128, 0), (2, 256, 256, (384,), 128, 0),
        (2, 512, 512, (128,), 128, 0), (2, 512, 512, (128,), 256, 0),
        (2, 512, 512, (256,), 128, 0),
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


def _check_plan(b, h, w, cs, cout, proj, packed=False):
    p = fr.conv_plan(b, h, w, cs, cout, 132, bool(proj), packed)
    assert (p.bn, p.mt) in fr.CANDIDATES
    assert p.smem == fr.smem_bytes(p.bn, p.th, p.tw, p.stages) <= fr.SMEM_LIMIT
    assert 2 <= p.stages <= fr.MAX_STAGES
    assert p.tw == min(w, 32) and 1 <= p.th <= min(h, 32)
    assert p.th * p.tw <= 128 * p.mt and p.th * p.tw > 128 * (p.mt - 1)
    assert p.bn <= max(64, -(-cout // 64) * 64)
    tiles = b * -(-h // p.th) * -(-w // p.tw)
    assert p.tiles == tiles * -(-cout // p.bn)
    assert p.grid == min(132, p.tiles) and p.persistent
    n_q = sum(-(-c // 64) for c in cs)
    assert p.l2_bytes >= tiles * n_q * ((4 if packed else 9) + proj) * -(-cout // 64) * 64 * 128
    return p


@pytest.mark.parametrize("name", sorted(MODEL_LAUNCHES))
def test_conv_plan_fits_every_model_launch(name):
    """Every unpacked launch of the models fits the block's 232,448 bytes of
    shared memory with at least two ring slots; where the launch has the
    work, it fills the 132 SMs with persistent blocks. The stats' per-warp
    slots fit in an activated tile, so they take no shared memory (no ring
    slot) of their own."""
    for key in MODEL_LAUNCHES[name]:
        p = _check_plan(*key)
        b, h, w, cs, cout, _ = key
        assert fr.stats_order(p, b, h, w, cout).slots_in_tile, key
        if b * h * w * -(-cout // 64) >= 132 * 128:
            assert p.grid >= 132, key


def test_model_launches_recorded():
    assert len(MODEL_LAUNCHES["cc12m_64x64 forward, batch 64"]) == 12  # of the 15 launch shapes
    assert len({k for v in MODEL_LAUNCHES.values() for k in v}) == 134
    assert len({k for v in PACKED_LAUNCHES.values() for k in v}) == 39


@pytest.mark.parametrize("name", sorted(PACKED_LAUNCHES))
def test_conv_plan_fits_every_packed_launch(name):
    """Every packed launch of the models has its plan (4 taps a chunk, the
    unpacked tiles and ring) and fills the 132 SMs; K2·pipe's rule in the
    kernel's terms (chunks of 64 channels, 1024 output tiles) selects the
    launches the earlier packed kernel pipelined (2 chunks of 32 channels,
    4096 blocks of 128 pixels x 64 channels). The stats' slots fit in an
    activated tile, as unpacked."""
    for key in PACKED_LAUNCHES[name]:
        b, h, w, cs, cout, proj = key
        p = _check_plan(*key, packed=True)
        assert fr.stats_order(p, b, h, w, cout).slots_in_tile, key
        unpacked = fr.conv_plan(b, h, w, cs, cout, 132, bool(proj))
        assert p.grid == 132 and p.l2_bytes < unpacked.l2_bytes
        tw = min(w, 32)
        old_blocks = b * -(-h // (128 // tw)) * -(-w // tw) * -(-cout // 64)
        old_rule = sum(-(-c // 32) for c in cs) >= 2 and old_blocks >= 4096
        assert fr.pipelines(cs, b, h, w, cout, packed_struct=True) == old_rule, key


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


def _emulate(xs, a_s, b_s, ws, bias, residual, bn, mt, apply_silu=True, packed=False,
             proj=None, proj_bias=None):
    """One launch as the wgmma kernel runs it (module docstring). Returns
    (y in x's dtype, the f32 accumulator before the epilogue, the shortcut
    in x's dtype or None). The activation is rounded to x's dtype, as the
    kernel rounds it to bf16."""
    bsz, h, w = xs[0].shape[:3]
    dt = xs[0].dtype
    cs = [x.shape[-1] for x in xs]
    cout = ws[0].shape[-1]
    cpad = -(-cout // 64) * 64
    layout = fr.conv_weight_layout(ws, packed).float()          # (n_q, taps, cpad, 64)
    n_q, taps = layout.shape[:2]
    assert taps == (4 if packed else 9)
    p_layout = None if proj is None else fr.conv_weight_layout(proj, packed).float()
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
    # where the activation stores raw channel r = 8 j8 + e of a chunk: 16-byte
    # group and element of the row before the swizzle; packed, the 4-byte
    # piece of class code = e % 4 at group 2 code + j8 / 4, element
    # 2 (j8 % 4) + e / 4 (channel 4 i + code at position 16 code + i)
    j8, e = kk // 8, kk % 8
    grp, el = ((2 * (e % 4) + j8 // 4, 2 * (j8 % 4) + e // 4) if packed else (j8, e))

    def offsets(tap):  # each k of the tap's 64: the staged offset of its row
        if not packed:
            return torch.full((64,), (tap // 3) * sw + tap % 3)
        return torch.tensor(fr.struct_tap_offsets(tw)).reshape(4, 4)[tap][kk // 16]

    def stage(vals):  # [pixel][position][8], group j at j ^ (p mod 8)
        phys = torch.zeros((n_stage, 8, 8))
        phys[px[:, None], grp[None, :] ^ (px[:, None] % 8), el[None, :]] = vals
        return phys

    def read_a(phys, off):  # the ldmatrix rows of one tap (or the centre), k by k
        p = p0[:, None] + off[None, :]
        return phys[p, (kk[None, :] // 8) ^ (p % 8), kk[None, :] % 8]

    def read_b(lay, q, tap, n0):  # the ring slot: the copied rows, stale past them
        rows = min(bn, cpad - n0)
        slot = torch.full((bn, 8, 8), float("nan"))
        slot[:rows] = lay[q, tap, n0:n0 + rows].reshape(rows, 8, 8)
        n = torch.arange(bn)
        return slot[n[:, None], (kk[None, :] // 8) ^ (n[:, None] % 8), kk[None, :] % 8]

    acc_all = torch.full((bsz, h, w, cout), float("nan"))
    y = torch.zeros((bsz, h, w, cout))
    out_p = None if proj is None else torch.zeros((bsz, h, w, cout))
    for block in range(bsz * tiles_img * n_nt):
        nt, mtile = block % n_nt, block // n_nt
        img, t = mtile // tiles_img, mtile % tiles_img
        r0, col0, n0 = (t // tiles_w) * th, (t % tiles_w) * tw, nt * bn
        ih, iw = r0 - 1 + px // sw, col0 - 1 + px % sw
        inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
        acc = torch.zeros((128 * mt, bn), dtype=torch.float64)
        acc_p = torch.zeros((128 * mt, bn), dtype=torch.float64)
        for q, (k, c0) in enumerate(chunks):
            ch = c0 + kk
            okc = ch < cs[k]
            raw = xs[k][img, ih.clamp(0, h - 1), iw.clamp(0, w - 1)][:, ch.clamp(max=cs[k] - 1)]
            raw = torch.where(inside[:, None] & okc[None, :], raw.float(), torch.zeros(()))
            src = raw
            if a_s is not None:
                v = raw * a_s[k][img, ch.clamp(max=cs[k] - 1)] + b_s[k][img, ch.clamp(
                    max=cs[k] - 1)]
                src = (F.silu(v) if apply_silu else v).to(dt).float()
                src = torch.where(inside[:, None] & okc[None, :], src, torch.zeros(()))
            phys = stage(src)
            for tap in range(taps):
                acc += read_a(phys, offsets(tap)).double() @ read_b(layout, q, tap, n0).double().t()
            if proj is not None:  # the shortcut's pass: the raw tile through the centre
                centre = torch.full((64,), sw + 1)
                acc_p += (read_a(stage(raw), centre).double()
                          @ read_b(p_layout, q, 0, n0).double().t())
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
        if proj is not None:
            out_p[img, oh[ok][:, None], ow[ok][:, None], ncols[None, :]] = (
                acc_p[ok][:, : len(ncols)].float() + proj_bias[ncols])
    return y.to(dt), acc_all, None if proj is None else out_p.to(dt)


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
    y, acc, _ = _emulate(xs, a_s, b_s, ws, bias, res, bn, mt)
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
    y, acc, _ = _emulate(xs, None, None, ws, bias, None, 64, 1)
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


# -- the packed mode (K2·struct) replayed against the JAX kernel ----------------

PACKED_CASES = {  # B, unpacked (H, W), unpacked operand channels, unpacked Cout,
    # residual, shortcut, identity prologue; the plan's (N tile, m64 tiles)
    "ragged W < 32": (2, (10, 24), (8,), 8, True, False, False, (64, 2)),
    "two operands (K2·N)": (1, (12, 20), (16, 24), 48, False, False, False, (128, 1)),
    "shortcut (K2·proj)": (2, (8, 72), (8, 16), 16, True, True, False, (64, 1)),
    "identity prologue (K3's dx)": (2, (10, 16), (24,), 16, False, False, True, (64, 2)),
    "32-channel operand beside a 64": (1, (8, 40), (8, 16), 24, True, True, False, (128, 2)),
}


def _bf16_exact(v):
    return to_np(torch.from_numpy(np.array(v)).to(torch.bfloat16))


def _packed_case(name, dtype):
    """Numpy inputs from a seed for one case: packed images of random
    unpacked ones, per-operand packed kernels of random unpacked ones
    (identity prologue: flipped and io-transposed, as K3's data gradient
    takes them), coefficients, bias, residual and shortcut matrices, the
    weights bf16-exact. Returns the torch inputs, the JAX reference's
    outputs (y[, proj]) and the plan's (N tile, m64 tiles)."""
    b, (hu, wu), cs, cout, residual, shortcut, identity, plan = PACKED_CASES[name]
    rng = np.random.default_rng(sorted(PACKED_CASES).index(name))
    h, w = hu // 2, wu // 2

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    xs = [np.array(js2d.space_to_depth(jnp.asarray(rand(b, hu, wu, c)))) for c in cs]
    if identity:  # the forward kernel (3, 3, 4 Cout, 4 C) flipped and io-transposed
        ws = [np.asarray(jnp.flip(js2d.pack_conv3x3_kernel(jnp.asarray(
            rand(3, 3, cout, c, scale=0.2))), (0, 1)).swapaxes(2, 3)) for c in cs]
    else:
        ws = [np.asarray(js2d.pack_conv3x3_kernel(jnp.asarray(rand(3, 3, c, cout, scale=0.2))))
              for c in cs]
    ws = [_bf16_exact(wk) for wk in ws]
    a_s = [rand(b, 4 * c, scale=0.2) + 1.0 for c in cs]
    b_s = [rand(b, 4 * c, scale=0.3) for c in cs]
    bias, res = rand(4 * cout, scale=0.1), rand(b, h, w, 4 * cout)
    pk = [_bf16_exact(rand(4 * c, 4 * cout, scale=0.2)) for c in cs]
    pb = rand(4 * cout, scale=0.1)
    jdt = jnp.dtype(dtype)
    jx = tuple(jnp.asarray(x, jdt) for x in xs)
    kw = dict(interpret=True, packed_struct=True)
    if shortcut:
        kw.update(proj_kernel=tuple(jnp.asarray(p) for p in pk), proj_bias=jnp.asarray(pb))
    if identity:
        ja = tuple(jnp.ones((b, 4 * c), jnp.float32) for c in cs)
        jb = tuple(jnp.zeros((b, 4 * c), jnp.float32) for c in cs)
        kw["apply_silu"] = False
    else:
        ja, jb = tuple(map(jnp.asarray, a_s)), tuple(map(jnp.asarray, b_s))
    ref = jfr.affine_silu_conv3x3(jx, ja, jb, tuple(map(jnp.asarray, ws)), jnp.asarray(bias),
                                  jnp.asarray(res, jdt) if residual else None, **kw)
    ref = [np.asarray(r, np.float32) for r in (ref if isinstance(ref, tuple) else (ref,))]
    tdt = getattr(torch, dtype)
    t = dict(xs=tuple(torch.from_numpy(x).to(tdt) for x in xs),
             a_s=None if identity else tuple(map(torch.from_numpy, a_s)),
             b_s=None if identity else tuple(map(torch.from_numpy, b_s)),
             ws=tuple(map(torch.from_numpy, ws)), bias=torch.from_numpy(bias),
             residual=torch.from_numpy(res).to(tdt) if residual else None,
             proj=tuple(map(torch.from_numpy, pk)) if shortcut else None,
             proj_bias=torch.from_numpy(pb) if shortcut else None,
             apply_silu=not identity)
    return t, ref, plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_packed_layout_read_as_the_kernel_reads_it(name, dtype):
    """The replayed packed launch (parity-class staging, the per-(tap,
    k-step) shifts of ``struct_tap_offsets``, the permuted and swizzled
    combined taps and shortcut) gives the JAX packed kernel's y and
    shortcut."""
    t, ref, (bn, mt) = _packed_case(name, dtype)
    y, acc, proj = _emulate(t.pop("xs"), t.pop("a_s"), t.pop("b_s"), t.pop("ws"), t.pop("bias"),
                            t.pop("residual"), bn, mt, packed=True, **t)
    assert not torch.isnan(acc).any()
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = [y] + ([proj] if proj is not None else [])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel_err(to_np(g), r) <= tol


def test_packed_layout_orders_and_shifts():
    """The packed layout is the unpacked one of the combined taps with each
    chunk's channels in parity-class order (channel 4 i + code at position
    16 code + i, so that k-step ks holds class ks),
    the (3, 3) kernel and its combined form lay out alike, and each
    (combined tap, k-step) offset is one shift of the staged tile."""
    g = torch.Generator().manual_seed(5)
    wp = torch.randn((3, 3, 96, 40), generator=g)
    lay = fr.conv_weight_layout((wp,), packed=True)
    assert lay.shape == (2, 4, 64, 64)
    assert torch.equal(lay, fr.conv_weight_layout((fr.struct_weights(wp),), packed=True))
    pos = torch.arange(64)
    order = 4 * (pos % 16) + pos // 16   # the channel at each staged position
    assert torch.equal(order.reshape(4, 16) % 4, torch.arange(4)[:, None].expand(4, 16))
    unp = fr.conv_weight_layout((fr.struct_weights(wp),))
    n = torch.arange(64)[:, None]
    k = torch.arange(64)[None, :]
    unswz = lay.reshape(2, 4, 64, 8, 8)[:, :, n, (k // 8) ^ (n % 8), k % 8]
    unswz_u = unp.reshape(2, 4, 64, 8, 8)[:, :, n, (k // 8) ^ (n % 8), k % 8]
    assert torch.equal(unswz, unswz_u[..., order])
    sw = 34
    shifts = {(o // sw - 1, o % sw - 1) for o in fr.struct_tap_offsets(32)}
    assert shifts == {(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)}
    assert fr.struct_tap_offsets(32)[:4] == (sw + 1,) * 4   # the centre tap: no shift
