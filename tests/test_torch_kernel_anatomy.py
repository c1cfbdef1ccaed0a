"""The cost-decomposition probes P1 and P2 of the port
(``ml_mdm_tpu_torch/ops/kernel_anatomy.py``, driven through
``ml_mdm_tpu_torch/tools/probe_kernel_anatomy{,2}.py``) against the JAX
package's TPU probes (``tools/probe_kernel_anatomy{,2}.py``) on the CPU.

The JAX probes run in Pallas interpret mode at a small size: their
``make`` reads B, H, W, C and TH from module globals when it builds the
call, so the tests set those, and give the probe module a ``pl`` whose
``pallas_call`` interprets (only that module's global is patched, not
``jax.experimental.pallas``). Importing a probe module sets JAX's
persistent compilation cache directory; the import below puts the setting
back at once, before anything compiles, so no cache is written. Inputs come
from a numpy seed; both packages get the same arrays.

Tolerances, on max |port - JAX| / max |JAX|:
- P1, every row of its table: 1e-2 (the port's CPU f32 sums run in another
  order than XLA's, which can flip one bf16 rounding of the output);
- P2, every row, on the cells the JAX probe defines: the same 1e-2. The
  TPU probe reads scratch that it never wrote in three places, which
  interpret mode fills with NaN: without halos the first and last row of
  every band of TH rows; with selects the last column always, and the first
  unless the zero fill is on; with the double buffer every block reads the
  buffer the previous grid step wrote, so block i's output is the single
  buffer's output of block i - 1 in (b, band) order and block 0 is
  undefined. The tests assert exactly that NaN set, compare the double
  buffer's rows after shifting JAX's output back by one block, and hold the
  port's double buffer bitwise equal to its single buffer.

The CUDA kernel (K2's ``conv3x3_wgmma_kernel`` with parts switched off)
cannot run here, so ``_replay`` replays each launch from what the host
hands the kernel (the plan's tile, the switches, the offset table, the
weights in K2's layout) with the kernel's staging rules restated, at the
file's size and at two widths whose tiles sit otherwise in the bands. Its
f64 sums equal the plain version's, built from the same activated values,
to 1e-12 of max |plain| (exact bf16 products, f64 sums in another order);
rounded to bf16 they are within one bf16 ULP of each cell of
``anatomy_plain``, plus 1e-5 of its max where a sum cancels (its f32 sums
can round the other way).
"""
import functools
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

_cache_dir = jax.config.jax_compilation_cache_dir
from tools import probe_kernel_anatomy as jax_p1  # noqa: E402
from tools import probe_kernel_anatomy2 as jax_p2  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache_dir)

from ml_mdm_tpu_torch.ops import fused_resnet as fr  # noqa: E402
from ml_mdm_tpu_torch.ops import kernel_anatomy  # noqa: E402
from ml_mdm_tpu_torch.tools import probe_kernel_anatomy as p1  # noqa: E402
from ml_mdm_tpu_torch.tools import probe_kernel_anatomy2 as p2  # noqa: E402

torch.set_num_threads(1)

B, H, W, C, TH = 2, 32, 16, 128, kernel_anatomy.TH
TOL = 1e-2


def _interpreting(module, monkeypatch):
    """The JAX probe ``module`` at the small size, its calls interpreted."""
    for name, value in dict(B=B, H=H, W=W, C=C, TH=TH).items():
        monkeypatch.setattr(module, name, value)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(module, "pl", shim)


def _inputs(n_taps, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((max(n_taps, 1), C, C)) * 0.05).astype(np.float32)
    return x, w


def _port(make, x, w, *args, **kw):
    f = make(*args, **kw)
    return f(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16))


def _close(got: torch.Tensor, ref: np.ndarray, where=None):
    got = got.float().numpy()
    where = np.ones(ref.shape, bool) if where is None else where
    assert where.any()
    err = np.abs(got - ref)[where].max() / np.abs(ref[where]).max()
    assert err <= TOL, err


def test_probe_tables_are_the_jax_probes():
    """The port's tables run the JAX scripts' rows, and its 16 variants, in
    their order, take 13 instances of K2's kernel (rows that differ only in
    act or SiLU share one)."""
    assert len(kernel_anatomy.P1_ROWS) == 9 and len(kernel_anatomy.P2_ROWS) == 7
    assert len(set(kernel_anatomy.VARIANTS)) == 16
    assert len({(kernel_anatomy.kernel_flags(v), v.selects)
                for v in kernel_anatomy.VARIANTS}) == 13
    assert p1.make.__code__.co_varnames[:4] == jax_p1.make.__code__.co_varnames[:4]
    assert p2.make.__code__.co_varnames[:5] == jax_p2.make.__code__.co_varnames[:5]


@pytest.mark.parametrize("label,kw", kernel_anatomy.P1_ROWS,
                         ids=[label for label, _ in kernel_anatomy.P1_ROWS])
def test_p1_matches_the_jax_probe(label, kw, monkeypatch):
    _interpreting(jax_p1, monkeypatch)
    args = kernel_anatomy.p1_args(kw)
    x, w = _inputs(args["n_taps"], 10)
    ref = np.asarray(jax_p1.make(**args)(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16)), np.float32)
    assert np.isfinite(ref).all()
    got = _port(p1.make, x, w, **args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    _close(got, ref)


def _jax_undefined(kw):
    """The (B, H, W) pixels the JAX probe leaves NaN (every channel of
    them), as predicted from the scratch cells it never writes."""
    band = np.zeros((TH, W), bool)
    if not kw["halos"]:
        band[[0, TH - 1], :] = True
    if kw["selects"]:
        band[:, W - 1] = True
        if not kw["when_zero"]:
            band[:, 0] = True
    blocks = np.broadcast_to(band, (B * H // TH, TH, W)).copy()
    if kw["dbuf"]:
        blocks[0] = True
    return blocks.reshape(B, H, W)


@pytest.mark.parametrize("label,kw", kernel_anatomy.P2_ROWS,
                         ids=[label for label, _ in kernel_anatomy.P2_ROWS])
def test_p2_matches_the_jax_probe_where_it_is_defined(label, kw, monkeypatch):
    _interpreting(jax_p2, monkeypatch)
    x, w = _inputs(4, 11)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    call = jax_p2.make(**kw)
    ref = np.asarray(call(xj, xj, xj, wj) if kw["halos"] else call(xj, wj), np.float32)
    undefined = _jax_undefined(kw)
    np.testing.assert_array_equal(np.isnan(ref), np.broadcast_to(undefined[..., None], ref.shape))
    got = _port(p2.make, x, w, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    assert bool(torch.isfinite(got.float()).all())
    if kw["dbuf"]:
        single = _port(p2.make, x, w, **{**kw, "dbuf": False})
        assert torch.equal(got, single)
        # JAX's block i is the single buffer's block i - 1: compare the
        # port's blocks 0 .. n-2 with JAX's 1 .. n-1
        got = got.reshape(-1, TH, W, C)[:-1]
        ref = ref.reshape(-1, TH, W, C)[1:]
    _close(got, ref, np.isfinite(ref))


@pytest.mark.parametrize("label,kw", kernel_anatomy.P2_ROWS,
                         ids=[label for label, _ in kernel_anatomy.P2_ROWS])
def test_p2_zero_fill_reaches_exactly_its_cells(label, kw):
    """The zero fill changes the plain version's y only on
    ``fill_cells``, and there changes it (where there are such cells)."""
    x, w = _inputs(4, 12)
    x, w = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    v = kernel_anatomy.p2_variant(**kw)
    y, toggled = (kernel_anatomy.anatomy_plain(x, w, u) for u in (v, v._replace(zero=not v.zero)))
    fill = kernel_anatomy.fill_cells(v, H, W)
    assert torch.equal(y[:, ~fill], toggled[:, ~fill])
    assert fill.any() == (not kw["halos"] or kw["selects"])
    if fill.any():
        # the fill moves every cell by about 0.0101 sum(w) (~6e-3): most
        # cells of bf16 y change
        assert (y[:, fill] != toggled[:, fill]).float().mean() > 0.5


# -- the probe launches replayed from what the host hands the kernel ------------

ka = kernel_anatomy
REPLAY_SHAPES = {  # B, H, W, C
    "the file's size, tiles of 16 x 16": (B, H, W, C),
    "W 8: K2's tile rule would take TH 32, across two bands": (1, 32, 8, 128),
    "W 40: tiles of 8 rows at and inside a band, a ragged tile, C 96": (1, 32, 40, 96),
}


def _replay(x, w, v):
    """One probe launch as the kernel runs it (``csrc/conv3x3_wgmma.cuh``),
    from what the host hands it: ``probe_plan``'s tile, ``kernel_flags``'
    switches, ``tap_offsets``' table and ``weight_layout``'s weights, read
    through the 128-byte swizzle as ``wgmma`` reads them. Each output tile
    stages its pixels and, but for P1, a halo of one: a cell loads its image
    pixel, or with BANDS a halo row across a band's edge loads nothing, or
    with HALOS its row clamped to the image; a cell outside the image loads
    nothing. The staging activates every loaded cell (act, or the raw value
    without it) and holds a cell that loaded nothing at 0, or at act(0) with
    FILL_ACT; channels past C are 0. With selects each chunk of 64 channels
    is staged in parity-class order (position 16 code + i holds channel
    4 i + code). Tap t's k-step ks reads positions 16 ks .. 16 ks + 15 of
    the staged pixel of each output pixel plus the table's offset ([t], or
    [4 t + ks] with selects). The activation is the plain version's
    arithmetic (the kernel's SiLU is the fast tanh form: the card's tests
    hold that). Returns the f64 sums before the epilogue's rounding (0
    taps: the staged tile), (B, H, W, C)."""
    bsz, h, wd, c = x.shape
    n = v.n_taps
    plan, flags = ka.probe_plan(bsz, h, wd, c, n), ka.kernel_flags(v)
    th, tw = plan.th, plan.tw
    assert ka.TH % th == 0
    halo = 0 if flags & ka.NO_HALO else 1
    sw, rows, cq = tw + 2 * halo, th + 2 * halo, -(-c // 64) * 64
    img, r0, col0 = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(bsz), torch.arange(0, h, th), torch.arange(0, wd, tw), indexing="ij"))
    sr, sc = torch.arange(rows).repeat_interleave(sw), torch.arange(sw).repeat(rows)
    ih = r0[:, None] - halo + sr[None, :]       # (tiles, staged pixels)
    iw = col0[:, None] - halo + sc[None, :]
    row_ok = (ih >= 0) & (ih < h)
    if flags & ka.BANDS:
        edge = (((sr == 0)[None, :] & (r0 % ka.TH == 0)[:, None])
                | ((sr == th + 1)[None, :] & ((r0 + th) % ka.TH == 0)[:, None]))
        row_ok = torch.where(edge, bool(flags & ka.HALOS), row_ok)
        if flags & ka.HALOS:
            ih = torch.where(edge, ih.clamp(0, h - 1), ih)
    loaded = row_ok & (iw >= 0) & (iw < wd)
    # a loaded cell reads its pixel, every other one reads pixel (0, 0) and
    # is zero-filled
    raw = x[img[:, None], ih.where(loaded, 0), iw.where(loaded, 0)]
    loaded = loaded[..., None]
    raw = torch.where(loaded, raw, torch.zeros((), dtype=x.dtype))
    staged = raw
    if v.act:
        staged = ka._act(raw, v)
        if not flags & ka.FILL_ACT:
            staged = torch.where(loaded, staged, torch.zeros((), dtype=x.dtype))
    staged = F.pad(staged.double(), (0, cq - c))  # (tiles, staged pixels, cq)
    if v.selects:  # each chunk in parity-class order
        pos = torch.arange(cq)
        staged = staged[..., pos // 64 * 64 + 4 * (pos % 16) + pos % 64 // 16]
    m = torch.arange(th * tw)
    p0 = (m // tw) * sw + m % tw                 # an output pixel's staged pixel, at offset 0
    if n == 0:
        acc = staged[:, p0 + halo * sw + halo]
    else:
        layout = ka.weight_layout(w, v).double()  # (chunks, taps, C padded, 64), swizzled
        nn_, kk = torch.arange(cq)[:, None], torch.arange(64)[None, :]
        wq = layout.reshape(*layout.shape[:3], 8, 8)[:, :, nn_, (kk // 8) ^ (nn_ % 8), kk % 8]
        toff = ka.tap_offsets(v, tw)
        acc = torch.zeros((len(img), th * tw, cq), dtype=torch.float64)
        for q in range(cq // 64):
            for t in range(n):
                for ks in range(4):
                    off = toff[4 * t + ks] if v.selects else toff[t]
                    k = slice(64 * q + 16 * ks, 64 * q + 16 * ks + 16)
                    acc += staged[:, p0 + off, k] @ wq[q, t, :, 16 * ks:16 * ks + 16].t()
    out = torch.full((bsz, h, wd, c), float("nan"), dtype=torch.float64)
    oh, ow = r0[:, None] + m // tw, col0[:, None] + m % tw
    ok = ow < wd
    out[img[:, None].expand_as(oh)[ok], oh[ok], ow[ok]] = acc[ok][:, :c]
    return out


def _plain_sums(x, w, v):
    """The plain version's sums in f64, from its own taps (``_p2_taps``)."""
    src = ka._act(x, v)
    if v.n_taps == 0:
        return src.double()
    c = x.shape[-1]
    taps = ([src.double().reshape(-1, c)] * v.n_taps if v.probe == 1
            else [t.double() for t in ka._p2_taps(src, v)])
    return sum(t @ w.double()[i] for i, t in enumerate(taps)).reshape(x.shape)


def _within_one_ulp(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Every cell within one bf16 ULP of its own magnitude, plus 1e-5 max
    |ref| where the sum cancels (the f32 sums' own error)."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * r.abs().max()
    return bool(((g - r).abs() <= tol).all())


@pytest.mark.parametrize("shape", list(REPLAY_SHAPES.values()), ids=list(REPLAY_SHAPES))
@pytest.mark.parametrize("v", ka.VARIANTS, ids=[
    f"P{v.probe}-{label}" for v, (label, _) in zip(ka.VARIANTS, ka.P1_ROWS + ka.P2_ROWS)])
def test_replayed_launch_is_the_plain_version(v, shape):
    rng = np.random.default_rng(sum(shape) + ka.VARIANTS.index(v))
    x = torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(np.float32)).to(torch.bfloat16)
    c = shape[-1]
    w = torch.from_numpy((rng.standard_normal((max(v.n_taps, 1), c, c)) * 0.05)
                         .astype(np.float32)).to(torch.bfloat16)
    got, ref = _replay(x, w, v), _plain_sums(x, w, v)
    assert not torch.isnan(got).any()
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert _within_one_ulp(got.to(torch.bfloat16), ka.anatomy_plain(x, w, v))


def test_probe_plan_keeps_tiles_inside_the_bands():
    """The probes' tile is K2's plan at their shape and, at every width, a
    divisor of the band in rows that fits the instance's 256 pixels."""
    p, k2 = ka.probe_plan(4, 512, 512, 128), fr.conv_plan(4, 512, 512, (128,), 128)
    assert (k2.bn, k2.mt) == (ka.BN, ka.MT) and p[:4] == (k2.th, k2.tw, k2.stages, k2.smem)
    assert p.grid == k2.grid and p.tiles == k2.tiles
    assert ka.probe_plan(4, 512, 512, 128, n_taps=0).tiles == 4096
    for wd in range(1, 70):
        p = ka.probe_plan(1, 32, wd, 96)
        assert ka.TH % p.th == 0 and p.th * p.tw <= 128 * ka.MT and p.tw == min(wd, 32)
        assert p.smem <= fr.SMEM_LIMIT and 2 <= p.stages <= fr.MAX_STAGES
    # W = 8: K2's tile rule at two m64 tiles gives 32 rows, across two bands
    assert min(128 * ka.MT // 8, 32, 32) == 32 and ka.probe_plan(1, 32, 8, 128).th == 16


def test_tap_offsets_are_the_probes_shifts():
    """P1's taps read the tile itself; P2's tap t the row shifted by
    t % 3 - 1 at the centre column; with selects K2·struct's 16 shifts."""
    sw = 34
    for v in ka.VARIANTS:
        offs = ka.tap_offsets(v, 32)
        assert len(offs) == 16
        if v.selects:
            assert offs == fr.struct_tap_offsets(32)
        elif v.probe == 1:
            assert offs == (0,) * 16
        else:
            assert [(o // sw - 1, o % sw - 1) for o in offs[:4]] == [(-1, 0), (0, 0), (1, 0),
                                                                      (-1, 0)]
