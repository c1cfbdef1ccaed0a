"""The port's hand kernels against their plain versions on an NVIDIA GPU.

These tests need the card: they skip where there is none. They import
neither JAX nor the JAX package, so on the machine with the card they run
without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, bf16 (the working type): K1 sums <= 1e-5 * max|ref| (f32 sums
in another order); K2 output and stats <= 2e-2 * max|ref| (two bf16 ULPs:
the kernel's SiLU uses the fast exponential and sums in another order, so
a rounding can flip); the tiny U-Net kernel path against its plain path
<= 5e-2 * max|ref| (those flips, carried through ~20 layers).
"""
import pytest
import torch

from ml_mdm_tpu_torch.ops import fused_resnet, gn_stats
from ml_mdm_tpu_torch.presets import flagship_64px


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("side,c", [(64, 256), (32, 1280), (16, 1536), (12, 40)])
def test_spatial_sums_kernel(dev, side, c):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((4, side, side, c), generator=g, device=dev) + 0.3).to(torch.bfloat16)
    n = gn_stats.launch_count
    s1, s2 = gn_stats.spatial_sums(x)
    assert gn_stats.launch_count == n + 1
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
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    x = torch.randn((2, side, side, c), generator=g, device=dev).to(bf)
    a = torch.randn((2, c), generator=g, device=dev) * 0.2 + 1.0
    b = torch.randn((2, c), generator=g, device=dev) * 0.3
    w = (torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5).to(bf)
    bias = torch.randn((cout,), generator=g, device=dev) * 0.1
    res = (torch.randn((2, side, side, cout), generator=g, device=dev).to(bf)
           if residual else None)
    n = fused_resnet.launch_count
    y, s1, s2 = fused_resnet.affine_silu_conv3x3(
        x, a, b, w, bias, res, apply_silu=silu, emit_stats=True)
    torch.cuda.synchronize()
    assert fused_resnet.launch_count == n + 1
    py, p1, p2 = fused_resnet.affine_silu_conv3x3_plain(
        x, a, b, w, bias, res, apply_silu=silu, emit_stats=True)
    assert _rel(y, py) <= 2e-2
    assert _rel(s1, p1) <= 2e-2
    assert _rel(s2, p2) <= 2e-2


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


@pytest.mark.cuda
def test_tiny_unet_kernel_path_matches_plain_path(dev):
    pipe, lm_dim, side = flagship_64px(dev, seed=0, scaled=True)
    unet = pipe.vision_module
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, side, side, 3), generator=g, device=dev)
    t = torch.tensor([10, 700], device=dev)
    lm = torch.randn((2, 8, lm_dim), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((2, 8), device=dev, dtype=torch.bfloat16)
    counts = gn_stats.launch_count, fused_resnet.launch_count
    with torch.no_grad():
        got = unet(x, t, lm, mask, {})
        assert gn_stats.launch_count > counts[0]
        assert fused_resnet.launch_count > counts[1]
        ref = unet.use_kernels(False)(x, t, lm, mask, {})
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 5e-2
