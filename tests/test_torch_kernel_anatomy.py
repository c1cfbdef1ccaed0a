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
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

_cache_dir = jax.config.jax_compilation_cache_dir
from tools import probe_kernel_anatomy as jax_p1  # noqa: E402
from tools import probe_kernel_anatomy2 as jax_p2  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache_dir)

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
    """The port's tables run the JAX scripts' rows, and its variants are the
    16 that the CUDA kernel instantiates, in its order."""
    assert len(kernel_anatomy.P1_ROWS) == 9 and len(kernel_anatomy.P2_ROWS) == 7
    assert len(set(kernel_anatomy.VARIANTS)) == 16
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
