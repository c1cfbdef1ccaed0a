"""The norms' coefficient math in one launch each (kernel K5), with its
plain versions.

K5 replaces no TPU kernel. In the JAX package the GroupNorm coefficients
(``ml_mdm_tpu/models/layers.py`` ``group_norm_coeffs_from_sums``), the FiLM
fold of a ResNet's norm2 and ``LayerNormF32`` are plain jnp that XLA fuses
into a few ops. The port runs eagerly, so as plain PyTorch each is a chain
of 15-23 launches on (B, C)-sized tensors: microseconds of device work and
tens of microseconds of host work each, which is what paces a sampling
forward on the H100. K5 is two Triton kernels, one launch a norm:

- ``gn_coeffs``: GroupNorm's (a, b), each (B, C), with x * a + b ==
  GroupNorm(x) * scale + bias, from per-channel f32 spatial sums s1, s2
  (K1's, or K2's emitted statistics). One program a batch row holds the
  row's (groups, channels a group) tile: it gathers the sums of up to 4
  channel-concatenated operands by pointer (the up path's skip concat,
  never built), reduces each group, and writes a and b, optionally with a
  ResNet's FiLM folded in (``film``). ``repeat`` reads the per-channel
  vectors (scale, bias, FiLM) as ``space_to_depth.pack_channel_vector``
  repeats them for a packed stage, so a packed shell needs no repeated
  copies.
- ``layer_norm``: LayerNorm over the last axis of a bf16 tensor, one
  program a row, with ``LayerNormF32``'s rounding points: one-pass f32
  statistics, a and b rounded to x's dtype, the product rounded, then the
  sum rounded.

Each does the plain version's arithmetic in the same order (mean and mean
square by one multiply by 1/n, var = max(msq - mean^2, 0), rsqrt(var +
eps), the same products and sums, with the compiler's multiply-add fusion
off), so a kernel differs from its plain version only in the order in which
a group's or a row's sums add up. No float atomics: each program reduces its
own data in a fixed order, so two calls give the same bits.

Neither is bound by the device: ``gn_coeffs`` reads and writes a few
(B, C) vectors (kilobytes), and ``layer_norm`` reads a (rows, C) bf16
tensor once and writes it once, a few microseconds at 3.35 TB/s. The point
is the host: one launch where there were 15-23.

K5 has no backward. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel (bf16 or f32 operands, as stated below) or raises, and
so does a call whose inputs require a gradient under grad mode: the
callers take the plain version there (``models/layers.py``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Sequence, Tuple, Union

import torch

# launches of the two Triton kernels since the count was last set to 0
launch_count = 0

MAX_OPERANDS = 4
_MAX_TILE = 16384  # elements of a program's tile (groups x channels a group, or a row)

Sums = Union[torch.Tensor, Sequence[torch.Tensor]]


def gn_affine_from_moments(mean, var, scale, bias, g, eps: float):
    """(B, g) moments -> (a, b), each (B, C) f32, with
    GroupNorm(x) * scale + bias == x * a + b."""
    bsz = mean.shape[0]
    c = scale.shape[0]
    inv = torch.rsqrt(var + eps)
    inv_c = inv[:, :, None].expand(bsz, g, c // g).reshape(bsz, c)
    mean_c = mean[:, :, None].expand(bsz, g, c // g).reshape(bsz, c)
    a = inv_c * scale.float()
    return a, bias.float() - mean_c * a


def group_norm_coeffs_from_sums(s1, s2, n_spatial: int, scale, bias, g: int,
                                eps: float = 1e-5):
    """GroupNorm coefficients from per-channel spatial sums s1, s2 (B, C)
    f32 over ``n_spatial`` positions: the one-pass E[x^2] - mean^2 form."""
    bsz, c = s1.shape
    n = n_spatial * (c // g)
    mean = s1.reshape(bsz, g, c // g).sum(-1) / n
    msq = s2.reshape(bsz, g, c // g).sum(-1) / n
    var = torch.clamp(msq - mean.square(), min=0.0)
    return gn_affine_from_moments(mean, var, scale, bias, g, eps)


def gn_coeffs_plain(s1: Sums, s2: Sums, n_spatial: int, scale, bias, groups: int,
                    eps: float = 1e-5, film=None, repeat: int = 1,
                    dtype: torch.dtype = torch.float32):
    """K5's plain version, differentiable: ``group_norm_coeffs_from_sums``
    of the sums (a sequence of operands' sums is concatenated along
    channels first), the scale and bias repeated ``repeat`` times per
    channel; with ``film``, a ResNet's FiLM folded in, norm(h) * (1 + ta) +
    tb == h * a' + b', from the time layer's (B', 2 C / repeat) output
    (B' dividing B: a temporal block's (b t) rows share their video's row;
    its halves ta, tb repeated like the scale); a and b in ``dtype``."""
    if not isinstance(s1, torch.Tensor):
        s1, s2 = torch.cat(list(s1), dim=-1), torch.cat(list(s2), dim=-1)
    if repeat > 1:
        scale, bias = (v.repeat_interleave(repeat, dim=-1) for v in (scale, bias))
    a, b = group_norm_coeffs_from_sums(s1, s2, n_spatial, scale, bias, groups, eps)
    if film is not None:
        t = film.float()
        if a.shape[0] > t.shape[0]:
            t = t.repeat_interleave(a.shape[0] // t.shape[0], dim=0)
        ta, tb = (v.repeat_interleave(repeat, dim=-1) if repeat > 1 else v
                  for v in t.chunk(2, dim=-1))
        a, b = a * (1.0 + ta), b * (1.0 + ta) + tb
    return a.to(dtype), b.to(dtype)


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """K5's plain LayerNorm over the last axis, with f32 statistics (one
    pass under bf16, centred under f32), a and b rounded to x's dtype, and
    x * a + b in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    if x.dtype == torch.bfloat16:
        var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
    else:
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    scale = weight.float()
    a = (inv * scale).to(x.dtype)
    b = (bias.float() - mean * inv * scale).to(x.dtype)
    return x * a + b


def needs_grad(*ts) -> bool:
    """Whether an input needs a gradient (grad mode on and one requires it):
    K5 has none to give."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def gn_coeffs(s1: Sums, s2: Sums, n_spatial: int, scale, bias, groups: int,
              eps: float = 1e-5, film=None, repeat: int = 1,
              dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm's (a, b), each (B, C) in ``dtype`` (f32 or bf16), in one
    launch: s1, s2 are the (B, C_k) f32 sums of 1 to 4 operands (a tensor
    or a sequence), C = sum C_k channels of ``groups`` groups, each sum over
    ``n_spatial`` positions; ``scale`` and ``bias`` (C / repeat,) in their
    own dtype; ``film`` the (B', 2 C / repeat) time-layer output or None. A
    CPU tensor takes ``gn_coeffs_plain``."""
    s1s = (s1,) if isinstance(s1, torch.Tensor) else tuple(s1)
    s2s = (s2,) if isinstance(s2, torch.Tensor) else tuple(s2)
    if needs_grad(*s1s, *s2s, scale, bias, film):
        raise NotImplementedError("gn_coeffs has no backward: take gn_coeffs_plain to "
                                  "differentiate through the coefficients")
    if s1s[0].device.type == "cpu":
        return gn_coeffs_plain(s1, s2, n_spatial, scale, bias, groups, eps, film, repeat, dtype)
    return _launch_gn(s1s, s2s, n_spatial, scale, bias, groups, eps, film, repeat, dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of a bf16 tensor in one launch, as
    ``layer_norm_plain`` computes it. A CPU tensor takes the plain version."""
    if needs_grad(x, weight, bias):
        raise NotImplementedError("layer_norm has no backward: take layer_norm_plain to "
                                  "differentiate through it")
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return _launch_ln(x, weight, bias, eps)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


_NO_SWITCH = contextlib.nullcontext()


def _on(dev: torch.device):
    """The launch goes to the current device: switch only when the
    operands are elsewhere."""
    return torch.cuda.device(dev) if dev.index != torch.cuda.current_device() else _NO_SWITCH


def _vector(v: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if v.dim() != 1 or v.shape[0] != n or v.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"norm_coeffs: {what} must be a ({n},) bf16 or f32 vector, got "
                         f"{tuple(v.shape)} {v.dtype}")
    return v.contiguous()


def _launch_gn(s1s, s2s, n_spatial, scale, bias, groups, eps, film, repeat, dtype):
    global launch_count
    dev = s1s[0].device
    if not s1s[0].is_cuda:
        raise RuntimeError(f"gn_coeffs: no kernel for device {dev}")
    n = len(s1s)
    if not 1 <= n <= MAX_OPERANDS or len(s2s) != n:
        raise ValueError(f"gn_coeffs: {n} operands' s1 and {len(s2s)} s2; the kernel takes "
                         f"1 to {MAX_OPERANDS}")
    bsz = s1s[0].shape[0]
    cs = []
    for t in s1s + s2s:
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 2
                or t.shape[0] != bsz):
            raise ValueError(f"gn_coeffs: sums must be (B, C_k) f32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for t1, t2 in zip(s1s, s2s):
        if t1.shape != t2.shape:
            raise ValueError(f"gn_coeffs: s1 {tuple(t1.shape)} and s2 {tuple(t2.shape)} differ")
        cs.append(t1.shape[1])
    c = sum(cs)
    if repeat < 1 or c % repeat or c % groups:
        raise ValueError(f"gn_coeffs: {c} channels for {groups} groups and repeat {repeat}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gn_coeffs: a and b in f32 or bf16, not {dtype}")
    cu, cpg = c // repeat, c // groups
    block_g, block_k = _pow2_at_least(groups), _pow2_at_least(cpg)
    if block_g * block_k > _MAX_TILE:
        raise ValueError(f"gn_coeffs: {groups} groups of {cpg} channels exceed the kernel's "
                         f"tile of {_MAX_TILE}")
    scale, bias = _vector(scale, cu, "scale"), _vector(bias, cu, "bias")
    has_film = film is not None
    if has_film:
        if (film.dim() != 2 or film.shape[1] != 2 * cu or bsz % film.shape[0]
                or film.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"gn_coeffs: film must be (B', {2 * cu}) bf16 or f32 with B' "
                             f"dividing {bsz}, got {tuple(film.shape)} {film.dtype}")
        film = film.contiguous()
    s1s = [t.contiguous() for t in s1s]
    s2s = [t.contiguous() for t in s2s]
    pad = MAX_OPERANDS - n  # unused operands: masked off, never read
    p1, p2, widths = s1s + s1s[:1] * pad, s2s + s2s[:1] * pad, cs + [0] * pad
    a = torch.empty((bsz, c), device=dev, dtype=dtype)
    b = torch.empty((bsz, c), device=dev, dtype=dtype)
    with _on(dev):
        _kernels()[0][(bsz,)](
            *p1, *p2, *widths, scale, bias, film if has_film else scale, a, b,
            c, cu, cpg, groups, 1.0 / (n_spatial * cpg), eps,
            bsz // film.shape[0] if has_film else 1,
            N_OPS=n, BLOCK_G=block_g, BLOCK_K=block_k, REPEAT=repeat, HAS_FILM=has_film,
            num_warps=4, enable_fp_fusion=False,
        )
    launch_count += 1
    return a, b


def _launch_ln(x, weight, bias, eps):
    global launch_count
    if not x.is_cuda:
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"layer_norm: the kernel takes bf16, got {x.dtype}")
    c = x.shape[-1]
    block = _pow2_at_least(c)
    if block > _MAX_TILE:
        raise ValueError(f"layer_norm: a row of {c} exceeds the kernel's {_MAX_TILE}")
    weight, bias = _vector(weight, c, "weight"), _vector(bias, c, "bias")
    xr = x.reshape(-1, c).contiguous()
    rows = xr.shape[0]
    y = torch.empty_like(xr)
    if rows:
        with _on(x.device):
            _kernels()[1][(rows,)](
                xr, weight, bias, y, c, 1.0 / c, eps, BLOCK=block,
                num_warps=4 if block <= 2048 else 8, enable_fp_fusion=False,
            )
        launch_count += 1
    return y.reshape(x.shape)


@functools.cache
def _kernels():
    """The two @triton.jit kernels, defined at first use so that the module
    imports where triton is absent."""
    import triton
    import triton.language

    # the Triton compiler resolves the names a kernel uses in the globals
    # of its module, not in the enclosing function
    globals()["tl"] = triton.language

    @triton.jit
    def gn_coeffs_kernel(s1_0, s1_1, s1_2, s1_3, s2_0, s2_1, s2_2, s2_3, c_0, c_1, c_2, c_3,
                         scale_ptr, bias_ptr, film_ptr, a_ptr, b_ptr,
                         c, cu, cpg, groups, inv_n, eps, film_div,
                         N_OPS: tl.constexpr, BLOCK_G: tl.constexpr, BLOCK_K: tl.constexpr,
                         REPEAT: tl.constexpr, HAS_FILM: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        gi = tl.arange(0, BLOCK_G)[:, None]
        ki = tl.arange(0, BLOCK_K)[None, :]
        ch = gi * cpg + ki  # the channel of the concatenation, group-major
        m = (gi < groups) & (ki < cpg)
        # each operand's channels [lo, lo + c_k) of the concatenation
        m0 = m & (ch < c_0)
        v1 = tl.load(s1_0 + row * c_0 + ch, mask=m0, other=0.0)
        v2 = tl.load(s2_0 + row * c_0 + ch, mask=m0, other=0.0)
        lo = c_0
        if N_OPS > 1:
            mk = m & (ch >= lo) & (ch < lo + c_1)
            v1 += tl.load(s1_1 + row * c_1 + (ch - lo), mask=mk, other=0.0)
            v2 += tl.load(s2_1 + row * c_1 + (ch - lo), mask=mk, other=0.0)
            lo += c_1
        if N_OPS > 2:
            mk = m & (ch >= lo) & (ch < lo + c_2)
            v1 += tl.load(s1_2 + row * c_2 + (ch - lo), mask=mk, other=0.0)
            v2 += tl.load(s2_2 + row * c_2 + (ch - lo), mask=mk, other=0.0)
            lo += c_2
        if N_OPS > 3:
            mk = m & (ch >= lo) & (ch < lo + c_3)
            v1 += tl.load(s1_3 + row * c_3 + (ch - lo), mask=mk, other=0.0)
            v2 += tl.load(s2_3 + row * c_3 + (ch - lo), mask=mk, other=0.0)
        mean = tl.sum(v1, axis=1)[:, None] * inv_n
        msq = tl.sum(v2, axis=1)[:, None] * inv_n
        var = tl.maximum(msq - mean * mean, 0.0)
        inv = tl.math.rsqrt(var + eps)
        u = ch // REPEAT  # the unpacked channel whose vectors this one repeats
        a = inv * tl.load(scale_ptr + u, mask=m, other=0.0).to(tl.float32)
        b = tl.load(bias_ptr + u, mask=m, other=0.0).to(tl.float32) - mean * a
        if HAS_FILM:
            t = film_ptr + (row // film_div) * 2 * cu + u
            one_ta = 1.0 + tl.load(t, mask=m, other=0.0).to(tl.float32)
            a = a * one_ta
            b = b * one_ta + tl.load(t + cu, mask=m, other=0.0).to(tl.float32)
        out = row * c + ch
        tl.store(a_ptr + out, a.to(a_ptr.dtype.element_ty), mask=m)
        tl.store(b_ptr + out, b.to(b_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def layer_norm_kernel(x_ptr, w_ptr, b_ptr, y_ptr, c, inv_n, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        m = offs < c
        xq = tl.load(x_ptr + row * c + offs, mask=m, other=0.0)
        xv = xq.to(tl.float32)
        mean = tl.sum(xv, axis=0) * inv_n
        msq = tl.sum(xv * xv, axis=0) * inv_n
        var = tl.maximum(msq - mean * mean, 0.0)
        inv = tl.math.rsqrt(var + eps)
        scale = tl.load(w_ptr + offs, mask=m, other=0.0).to(tl.float32)
        shift = tl.load(b_ptr + offs, mask=m, other=0.0).to(tl.float32)
        dt = y_ptr.dtype.element_ty
        a = (inv * scale).to(dt)
        b = (shift - mean * inv * scale).to(dt)
        prod = (xv * a.to(tl.float32)).to(dt)
        tl.store(y_ptr + row * c + offs, (prod.to(tl.float32) + b.to(tl.float32)).to(dt), mask=m)

    return gn_coeffs_kernel, layer_norm_kernel
