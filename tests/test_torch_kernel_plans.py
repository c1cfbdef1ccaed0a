"""The host side of the port's kernels, on the CPU: K1's split of H*W
(``gn_stats.plan``), the build tag that names a compiled CUDA library
(``cuda_build.build_tag``), and which operands K4's tensor maps take as
they are (``attention._addressable``). No card, no compiler: these are the
shapes, strides and hashes the kernels are launched with.
"""
import math

import numpy as np
import pytest
import torch

from ml_mdm_tpu_torch.ops import attention, cuda_build, gn_stats

# K1's launch shapes in one forward of the nested models (256px at 8 rows,
# 1024px at 4, the thin shells packed): 28 distinct (B, H, W, C)
NESTED_FORWARD_K1 = [
    (b, s, s, c)
    for b, sc in ((8, ((16, 512), (16, 768), (32, 256), (32, 512), (32, 768), (64, 128),
                       (64, 256), (64, 512), (128, 64), (128, 128), (128, 256), (128, 512))),
                  (4, ((16, 512), (16, 768), (32, 256), (32, 512), (32, 768), (64, 128),
                       (64, 256), (64, 512), (128, 64), (128, 128), (128, 256), (128, 512),
                       (256, 64), (256, 128), (256, 256), (512, 128))))
    for s, c in sc
]
RAGGED_K1 = [
    (2, 12, 12, 40),       # C = 40: one channel block, part of it masked
    (1, 1024, 1024, 12),   # C = 12: a 16-channel block, hundreds of spans
    (3, 37, 53, 64),       # H*W no multiple of any step
    (4, 1024, 1024, 32),   # the 1024px shell unpacked
    (2, 512, 512, 128),    # train_1024's packed shell
    (64, 8, 8, 1536),      # the 64px core's innermost level
    (64, 64, 64, 256),     # the 64px core's outermost level
    (1, 1, 1, 1),
    (5, 7, 9, 3),
]


def test_nested_forward_has_28_k1_shapes():
    assert len(set(NESTED_FORWARD_K1)) == 28


@pytest.mark.parametrize("shape", NESTED_FORWARD_K1 + RAGGED_K1, ids=str)
def test_spatial_sums_plan(shape):
    """Each pixel in exactly one span, the spans whole loop steps, BLOCK_C
    the power of two >= C capped at 64, and S as the rule in ``plan``
    gives it: about four programs an SM where the work allows, each
    reading at least 128 KB, S = 1 where there is not that much work."""
    b, h, w, c = shape
    p = gn_stats.plan(b, h, w, c, itemsize=2, sms=132)
    hw = h * w
    pow2 = 1 << (c - 1).bit_length()
    assert p.block_c == min(64, pow2) and p.block_c <= pow2
    assert p.block_hw * p.block_c <= gn_stats._TILE
    step = p.block_hw * gn_stats._UNROLL
    assert p.span % step == 0
    covered = np.zeros(hw, dtype=np.int64)
    for s in range(p.splits):
        covered[s * p.span:min((s + 1) * p.span, hw)] += 1
    assert (covered == 1).all()
    assert (p.splits - 1) * p.span < hw <= p.splits * p.span
    n_cblk = math.ceil(c / p.block_c)
    by_grid = math.ceil(4 * 132 / (b * n_cblk))
    by_work = hw * min(c, p.block_c) * 2 // gn_stats._MIN_BYTES
    target = max(1, min(by_grid, by_work))
    assert p.span == math.ceil(math.ceil(hw / target) / step) * step
    assert p.splits == math.ceil(hw / p.span) <= target
    if p.splits > 1:  # every span but the last reads at least _MIN_BYTES
        assert p.span * min(c, p.block_c) * 2 >= gn_stats._MIN_BYTES == 128 * 1024


def test_spatial_sums_plan_fills_the_card_at_the_thin_shells():
    """The shapes K1 starved on (4-8 programs): now hundreds."""
    for shape in [(4, 512, 512, 128), (4, 1024, 1024, 32), (2, 512, 512, 128)]:
        b, h, w, c = shape
        p = gn_stats.plan(*shape)
        assert b * math.ceil(c / p.block_c) * p.splits >= 2 * 132


def _write(path, text):
    path.write_text(text)
    return path


def test_build_tag_follows_included_headers(tmp_path):
    """Editing a header that the source includes (directly or through
    another header) changes the library's tag; editing a file it does not
    include, or a system include, does not; the flags count too."""
    src = _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\nint f();\n')
    a = _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n')
    b = _write(tmp_path / "b.cuh", "#pragma once\nint g();\n")
    other = _write(tmp_path / "other.cuh", "int h();\n")
    tag = cuda_build.build_tag(src)
    assert tag == cuda_build.build_tag(src) and len(tag) == 16
    _write(other, "int h2();\n")
    assert cuda_build.build_tag(src) == tag
    _write(b, "#pragma once\nint g2();\n")
    tag_b = cuda_build.build_tag(src)
    assert tag_b != tag
    _write(a, '#pragma once\n#include "b.cuh"\n// edited\n')
    assert cuda_build.build_tag(src) != tag_b
    assert cuda_build.build_tag(src, flags=["-O2"]) != cuda_build.build_tag(src)


def test_build_tag_of_each_kernel_source():
    """Every CUDA source of the port has a tag without a compiler."""
    tags = {n: cuda_build.build_tag(cuda_build.source_path(n))
            for n in ("fused_resnet", "flash_attention", "kernel_anatomy")}
    assert len(set(tags.values())) == 3


def _qkv_chunks(b=2, l=16, heads=4, d=32):
    qkv = torch.zeros((b, l, 3 * heads * d), dtype=torch.bfloat16)
    return qkv, [t.reshape(b, l, heads, d) for t in qkv.chunk(3, dim=-1)]


def test_flash_operands_taken_as_they_are():
    """The model's views (the chunks of one qkv tensor) and contiguous
    tensors go to the tensor maps without a copy; so do views whose
    strides do not grow with the axis."""
    qkv, chunks = _qkv_chunks()
    for t in chunks:
        assert attention._addressable(t).data_ptr() == t.data_ptr()
    x = torch.zeros((2, 4, 16, 32), dtype=torch.bfloat16).transpose(1, 2)
    assert attention._addressable(x).data_ptr() == x.data_ptr()


@pytest.mark.parametrize("case", ["stride_not_16_bytes", "inner_stride", "unaligned_base",
                                  "zero_stride"])
def test_flash_operands_copied_when_tma_cannot_address_them(case):
    """A stride that is no positive multiple of 16 bytes, a last axis that
    is not contiguous, or a base off 16 bytes: copied to a contiguous
    tensor with the same values."""
    if case == "stride_not_16_bytes":
        t = torch.zeros((2, 16, 4, 36), dtype=torch.bfloat16)[..., :32]
    elif case == "inner_stride":
        t = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)[..., ::2]
    elif case == "unaligned_base":
        t = torch.zeros((2 * 16 * 4 * 32 + 4,), dtype=torch.bfloat16)[4:].view(2, 16, 4, 32)
        assert t.data_ptr() % 16 == 8
    else:
        t = torch.zeros((2, 1, 4, 32), dtype=torch.bfloat16).expand(2, 16, 4, 32)
    got = attention._addressable(t)
    assert got.data_ptr() != t.data_ptr() and got.is_contiguous()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
