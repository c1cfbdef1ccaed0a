"""K2's statistics in a fixed order, on the CPU: a numpy float32 model of
the kernel's reduction (``csrc/conv3x3_wgmma.cuh``, the epilogue), in the
order that ``fused_resnet.stats_order`` gives, run as the card runs it.

The model takes the stored y of one launch and, for each output tile
(pixel tile, N tile), adds each thread's rows (m64 tiles, then halves; the
square by one fused multiply-add, as nvcc contracts ``t += q * q``),
shuffles the warp's 8 row groups together (lane xor 4, 8, 16), writes one
slot a warp and adds the 8 slots in warp order; with more than one pixel
tile an image it writes the tile's sums to row t of the scratch and takes
a ticket, and the block that draws the last adds rows 0, 1, ... in order.
The blocks of a persistent grid take tiles b, b + grid, ...; their tiles'
epilogues arrive in a shuffled order. The result must be the same bits for
every arrival order and for grids of 1, 7 and 132 blocks, every ticket
back at 0, and within 1e-6 of the float64 sums (relative to the sum of
|y|, and of y^2). The same tiles added by float atomics in arrival order
do not give the same bits. ``stats_order``'s
scratch and tickets are held against a hand count at three launch shapes.
"""
import numpy as np
import pytest
import torch

from ml_mdm_tpu_torch.ops import fused_resnet as fr

torch.set_num_threads(1)
F32 = np.float32


def _bf16_values(rng, shape):
    """float32 values that bf16 holds exactly (the kernel sums stored bf16
    y), with a nonzero mean."""
    v = (rng.standard_normal(shape) + 0.3).astype(F32)
    return (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(F32)


def _warp_rows(plan):
    """(8 warps, 8 lane rows, mt, 2 halves) -> the tile's row m, the
    kernel's accumulator layout: (wg mt + i) 64 + 16 wp + 8 h + lane / 4."""
    m = np.zeros((fr.STAT_WARPS, 8, plan.mt, 2), dtype=np.int64)
    for w in range(fr.STAT_WARPS):
        wg, wp = divmod(w, 4)
        for r in range(8):
            for i in range(plan.mt):
                for h in range(2):
                    m[w, r, i, h] = (wg * plan.mt + i) * 64 + 16 * wp + 8 * h + r
    return m


def _tile_sums(y, plan, r0, c0):
    """The block's (s1, s2) of the pixel tile at (r0, c0), every column:
    (B, Cout) each, float32 at every step."""
    bsz, h, w, cout = y.shape
    rows = _warp_rows(plan)
    t1 = np.zeros((fr.STAT_WARPS, 8, bsz, cout), F32)
    t2 = np.zeros((fr.STAT_WARPS, 8, bsz, cout), F32)
    for i in range(plan.mt):
        for half in range(2):
            m = rows[:, :, i, half]
            oh, ow = r0 + m // plan.tw, c0 + m % plan.tw
            ok = (m < plan.th * plan.tw) & (oh < h) & (ow < w)
            q = y[:, np.minimum(oh, h - 1), np.minimum(ow, w - 1)].transpose(1, 2, 0, 3)
            ok = ok[:, :, None, None]
            t1 = np.where(ok, (t1 + q).astype(F32), t1)
            # fma(q, q, t2): q * q is exact in float64, one rounding to f32
            t2 = np.where(ok, (t2.astype(np.float64) + q.astype(np.float64) ** 2).astype(F32),
                          t2)
    for off in (1, 2, 4):  # lanes xor 4, 8, 16: lane rows xor 1, 2, 4
        partner = np.arange(8) ^ off
        t1 = (t1 + t1[:, partner]).astype(F32)
        t2 = (t2 + t2[:, partner]).astype(F32)
    s1, s2 = t1[0, 0], t2[0, 0]
    for w in range(1, fr.STAT_WARPS):  # the slots in warp order
        s1 = (s1 + t1[w, 0]).astype(F32)
        s2 = (s2 + t2[w, 0]).astype(F32)
    return s1, s2


def _tiles_by_arrival(plan, bsz, n_tiles_img, n_ntiles, grid, rng):
    """The output tiles (image, pixel tile, N tile) in one order the
    epilogues could arrive in: each block's in its own order, the blocks
    interleaved at random."""
    n = bsz * n_tiles_img * n_ntiles
    queues = [list(range(b, n, grid)) for b in range(min(grid, n))]
    order = []
    while any(queues):
        live = [q for q in queues if q]
        order.append(live[rng.integers(len(live))].pop(0))
    return [((tl // n_ntiles) // n_tiles_img, (tl // n_ntiles) % n_tiles_img, tl % n_ntiles)
            for tl in order]


def _kernel_model(y, plan, order, arrival):
    """s1, s2 (B, Cout) as the kernel takes them, with the tiles' epilogues
    arriving in ``arrival``; returns them and the tickets after the launch."""
    bsz, _, _, cout = y.shape
    sums = {t: _tile_sums(y, plan, *order.tiles[t]) for t in range(len(order.tiles))}
    s1, s2 = np.full((bsz, cout), np.nan, F32), np.full((bsz, cout), np.nan, F32)
    tickets = np.zeros(max(order.tickets, 1), np.int64)
    part = np.full(order.scratch or (2, bsz, 1, cout), np.nan, F32)
    n_tiles = len(order.tiles)
    n_ntiles = -(-cout // plan.bn)
    for img, t, nt in arrival:
        cols = slice(nt * plan.bn, min((nt + 1) * plan.bn, cout))
        v1, v2 = sums[t][0][img, cols], sums[t][1][img, cols]
        if n_tiles == 1:
            s1[img, cols], s2[img, cols] = v1, v2
            continue
        part[0, img, t, cols], part[1, img, t, cols] = v1, v2
        k = img * n_ntiles + nt
        tickets[k] += 1
        if tickets[k] == n_tiles:  # the last ticket: every tile's partials are in
            assert not np.isnan(part[:, img, :, cols]).any()
            a1, a2 = part[0, img, 0, cols], part[1, img, 0, cols]
            for r in range(1, n_tiles):
                a1 = (a1 + part[0, img, r, cols]).astype(F32)
                a2 = (a2 + part[1, img, r, cols]).astype(F32)
            s1[img, cols], s2[img, cols] = a1, a2
            tickets[k] = 0
    return s1, s2, tickets


# (B, H, W, operand channels, Cout, shortcut, packed): a 64px-shaped launch
# (two tile columns), a packed one, a ragged one (partial tiles and N tile)
# and one whose image is one tile
SHAPES = {
    "unpacked 64x64": (2, 64, 64, (256,), 256, False, False),
    "packed 32x32": (2, 32, 32, (64,), 64, False, True),
    "ragged 20x40": (2, 20, 40, (64, 32), 200, True, False),
    "one tile 8x8": (3, 8, 8, (128,), 128, False, False),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_stats_same_bits_in_every_arrival_order(name):
    b, h, w, cs, cout, proj, packed = SHAPES[name]
    rng = np.random.default_rng(0)
    y = _bf16_values(rng, (b, h, w, cout))
    plan = fr.conv_plan(b, h, w, cs, cout, fr.H100_SMS, proj, packed)
    order = fr.stats_order(plan, b, h, w, cout)
    assert (len(order.tiles) == 1) == name.startswith("one tile")
    n_ntiles = -(-cout // plan.bn)
    results = []
    for grid in (1, 7, 132):
        for _ in range(3):
            arrival = _tiles_by_arrival(plan, b, len(order.tiles), n_ntiles, grid, rng)
            s1, s2, tickets = _kernel_model(y, plan, order, arrival)
            assert not tickets.any()
            results.append((s1, s2))
    for s1, s2 in results[1:]:
        assert np.array_equal(s1.view(np.uint32), results[0][0].view(np.uint32))
        assert np.array_equal(s2.view(np.uint32), results[0][1].view(np.uint32))
    s1, s2 = results[0]
    y64 = y.astype(np.float64)
    assert np.all(np.abs(s1 - y64.sum(axis=(1, 2))) <= 1e-6 * np.abs(y64).sum(axis=(1, 2)))
    ref2 = (y64 ** 2).sum(axis=(1, 2))
    assert np.all(np.abs(s2 - ref2) <= 1e-6 * ref2)


def test_float_atomics_in_arrival_order_differ():
    """Each tile's sums added to s1 by a float atomic, in arrival order:
    two arrival orders give other bits."""
    b, h, w, cs, cout, proj, packed = SHAPES["unpacked 64x64"]
    rng = np.random.default_rng(1)
    y = _bf16_values(rng, (b, h, w, cout))
    plan = fr.conv_plan(b, h, w, cs, cout, fr.H100_SMS, proj, packed)
    order = fr.stats_order(plan, b, h, w, cout)
    sums = [_tile_sums(y, plan, *rc)[0] for rc in order.tiles]
    outs = []
    for _ in range(2):
        acc = np.zeros((b, cout), F32)
        for t in rng.permutation(len(sums)):
            acc = (acc + sums[t]).astype(F32)
        outs.append(acc)
    assert not np.array_equal(outs[0].view(np.uint32), outs[1].view(np.uint32))


def test_stats_order_tiles_follow_the_kernel():
    """Row t of the scratch is the kernel's pixel tile t of an image:
    row-major over the plan's tile grid (geo's t / tiles_w, t % tiles_w)."""
    plan = fr.conv_plan(2, 20, 40, (64, 32), 200, fr.H100_SMS, True)
    order = fr.stats_order(plan, 2, 20, 40, 200)
    tiles_w = -(-40 // plan.tw)
    assert order.tiles == tuple(((t // tiles_w) * plan.th, (t % tiles_w) * plan.tw)
                                for t in range(len(order.tiles)))


# hand counts: (B, H, W, channels, Cout, shortcut, packed) -> (tiles an
# image, tickets)
HAND = {
    # 64px forward, 64 x 64 x 256 -> 256: N tile 128, two warpgroups of 2
    # m64 tiles, so 256-pixel tiles of 8 x 32: 64 / 8 rows x 64 / 32 columns
    # = 16 a image; 2 N tiles a image, 64 images: 128 tickets
    "64px unpacked": ((64, 64, 64, (256,), 256, False, False), (16, 128)),
    # the 64px forward's K2·N with the shortcut at 32 x 32, 768 -> 512:
    # 8 x 32 tiles, 4 a image; 4 N tiles of 128: 256 tickets
    "K2·N": ((64, 32, 32, (512, 256), 512, True, False), (4, 256)),
    # the 1024px shell's stage 0 packed, 256 x 256 x 128 -> 128: 8 x 32
    # tiles, 32 x 8 = 256 a image; one N tile of 128, 2 images: 2 tickets
    "K2·struct": ((2, 256, 256, (128,), 128, False, True), (256, 2)),
}


@pytest.mark.parametrize("name", list(HAND))
def test_stats_scratch_matches_a_hand_count(name):
    (b, h, w, cs, cout, proj, packed), (tiles, tickets) = HAND[name]
    plan = fr.conv_plan(b, h, w, cs, cout, fr.H100_SMS, proj, packed)
    assert (plan.th, plan.tw, plan.bn, plan.mt) == (8, 32, 128, 2)
    order = fr.stats_order(plan, b, h, w, cout)
    assert len(order.tiles) == tiles and order.tickets == tickets
    assert order.scratch == (2, b, tiles, cout)
    assert order.slots_in_tile  # 8 warps x 2 x 128 f32 = 8 KB in a 43,520-byte tile
