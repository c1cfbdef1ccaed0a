"""K6 (``ml_mdm_tpu_torch/ops/attention.py`` ``two_branch_attention``): a 2-D
``SelfAttention``'s self and text branches in one launch, on the matmul
route's definition (bf16 logits, the softmax in f32 over each branch's whole
key row, normalised weights rounded to bf16, f32 products).

On the CPU: K6's plain version (``two_branch_attention_plain``) against
``matmul_attention`` plus the branch sum, over self lengths 64 and 256, text
lengths 1, 4 and 32 with and without a mask that leaves at least one key, D
64 and 96 with 8 heads, bf16 and f32; the branches alone and K4's output
added; the logits' dtype gate; the route (``k6_route``); and the module:
``SelfAttention`` with ``kernels`` on and off gives the same bits on the CPU
(which keeps the matmul route), takes K6 where the route holds (a test lets
``k6_route`` take a CPU tensor, so K6's plain version runs) and never where
an input needs a gradient, and ``UNet.use_kernels(False)`` reaches it.

On the card (skipped elsewhere; no JAX here, so they run without the
directory's conftest, as a process of their own: ``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_k6.py -q``): the kernel
against its plain version at the cells' launch shapes (L 1024 and 256 at 64
and 16 rows, 32 text keys) and at ragged ones, masked, K4's output added,
strided and non-contiguous layouts, the logits in f32, two calls the same
bits, one launch a layer, and the device time under "unet: attention"
holding K6's kernel.

Tolerances, each relative to max|reference|:

- plain against the route, bf16: 2^-6, two bf16 ULPs of the largest output.
  The route rounds each branch's output to bf16 and then their sum; the
  plain version sums the branches in f32 and rounds once (the definition
  leaves that open), so the two differ by up to about one ULP of each
  rounding (measured: one ULP, 0.0077 at most).
- plain against the route, f32: 1e-6, the same operations, the sum of the
  branches in another order.
- kernel against plain on the card: 2^-6. The logits' f32 sums run in the
  tensor cores' order, so a logit's bf16 rounding flips now and then, the
  weights are exp(s - m) times 1 / sum (the library divides) and the output's
  one rounding sees f32 sums in another order. (Scaling the f32 product by
  d^-1/2 in place of q and k in bf16, which the definition would allow,
  reads up to 1.95e-2 here on the CPU, over this tolerance: the kernel
  scales q and k as the route does.)
"""
import pytest
import torch

from ml_mdm_tpu_torch.models.layers import SelfAttention
from ml_mdm_tpu_torch.ops import attention

BF = torch.bfloat16
BF16_TOL = 2.0 ** -6
F32_TOL = 1e-6


@pytest.fixture(autouse=True)
def _routes_from_defaults(monkeypatch):
    monkeypatch.delenv("ML_MDM_TPU_FLASH", raising=False)
    monkeypatch.delenv("ML_MDM_TPU_BF16_LOGITS", raising=False)
    attention.use_flash(None)
    yield
    attention.use_flash(None)


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _operands(b, length, lt, heads, d, dtype, masked, device="cpu", seed=0):
    """q, k, v as the chunks of one (B, L, 3 H D) tensor and k_c, v_c as the
    chunks of one (B, Lt, 2 H D) tensor, as ``SelfAttention`` hands them
    over; a (B, Lt) mask that keeps the first key of every row."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, length, 3 * heads * d), generator=g).to(dtype).to(device)
    kv = torch.randn((b, lt, 2 * heads * d), generator=g).to(dtype).to(device)
    q, k, v = (t.reshape(b, length, heads, d) for t in qkv.chunk(3, dim=-1))
    k_c, v_c = (t.reshape(b, lt, heads, d) for t in kv.chunk(2, dim=-1))
    mask = None
    if masked:
        mask = (torch.rand((b, lt), generator=g) > 0.4).to(dtype)
        mask[:, 0] = 1
        mask = mask.to(device)
    return q, k, v, k_c, v_c, mask


def _route(q, k, v, k_c, v_c, mask):
    """What ``SelfAttention`` computes off K6: two matmul-route calls and the
    sum, (B, L, H, D)."""
    return attention.matmul_attention(q, k, v) + attention.matmul_attention(q, k_c, v_c, mask)


# -- on the CPU: the plain version against the matmul route ---------------


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lt", [1, 4, 32])
@pytest.mark.parametrize("length,d", [(64, 64), (64, 96), (256, 64), (256, 96)])
def test_plain_is_the_matmul_route(length, d, lt, masked, dtype):
    ops = _operands(2, length, lt, 8, d, dtype, masked, seed=length + d + lt)
    got = attention.two_branch_attention_plain(*ops)
    ref = _route(*ops)
    assert got.shape == ref.shape == ops[0].shape and got.dtype == dtype
    assert got.is_contiguous()
    assert _rel(got, ref) <= (BF16_TOL if dtype == BF else F32_TOL)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_plain_branches_alone_and_an_addend(dtype):
    """The self branch alone (a layer without text) is the route's one call;
    the text branch with K4's output added is what the flash route sums."""
    q, k, v, k_c, v_c, mask = _operands(2, 64, 8, 8, 64, dtype, True, seed=3)
    tol = 2.0 ** -7 if dtype == BF else F32_TOL  # one rounding of the output apart
    assert _rel(attention.two_branch_attention_plain(q, k, v),
                attention.matmul_attention(q, k, v)) <= tol
    own = attention.reference_flash_attention(q, k, v)
    got = attention.two_branch_attention_plain(q, None, None, k_c, v_c, mask, add=own)
    assert _rel(got, own + attention.matmul_attention(q, k_c, v_c, mask)) <= (
        BF16_TOL if dtype == BF else F32_TOL)


@pytest.mark.parametrize("bf16_logits", ["0", "1"])
def test_plain_follows_the_logits_gate(monkeypatch, bf16_logits):
    """``ML_MDM_TPU_BF16_LOGITS=0`` keeps the logits in f32 on both."""
    monkeypatch.setenv("ML_MDM_TPU_BF16_LOGITS", bf16_logits)
    ops = _operands(2, 64, 32, 8, 64, BF, False, seed=4)
    got = attention.two_branch_attention_plain(*ops)
    assert _rel(got, _route(*ops)) <= BF16_TOL
    monkeypatch.setenv("ML_MDM_TPU_BF16_LOGITS", "1" if bf16_logits == "0" else "0")
    assert not torch.equal(attention.two_branch_attention_plain(*ops), got)


def test_k6_refuses_a_gradient():
    q, k, v, k_c, v_c, _ = _operands(1, 64, 4, 2, 32, BF, False)
    with pytest.raises(NotImplementedError):
        attention.two_branch_attention(q.clone().requires_grad_(True), k, v, k_c, v_c)
    with torch.no_grad():
        attention.two_branch_attention(q.clone().requires_grad_(True), k, v, k_c, v_c)


@pytest.mark.parametrize("kernels,dtype,d,lt,grad,devices,routed", [
    (True, BF, 64, 32, False, ("cuda", "cpu"), True),
    (True, BF, 96, 128, False, ("cuda", "cpu"), True),
    (True, BF, 64, None, False, ("cuda", "cpu"), True),    # a layer without text
    (False, BF, 64, 32, False, ("cuda", "cpu"), False),    # use_kernels(False)
    (True, torch.float32, 64, 32, False, ("cuda", "cpu"), False),
    (True, BF, 64, 32, True, ("cuda", "cpu"), False),      # training
    (True, BF, 72, 32, False, ("cuda", "cpu"), False),     # D not a multiple of 16
    (True, BF, 64, 129, False, ("cuda", "cpu"), False),    # more text than one tile
    (True, BF, 64, 32, False, ("cuda",), False),           # the CPU keeps the route
])
def test_k6_route(kernels, dtype, d, lt, grad, devices, routed):
    """``k6_route`` takes no CPU tensor; where the CPU is let in (``devices``
    holds it), the route's other conditions are ``k6_takes``'s."""
    q, _, _, k_c, v_c, _ = _operands(1, 16, lt or 1, 2, d, dtype, False)
    if lt is None:
        k_c = v_c = None
    if grad:
        q = q.clone().requires_grad_(True)
    route = attention.k6_takes if "cpu" in devices else attention.k6_route
    assert route(kernels, q, k_c, v_c) == routed


@pytest.mark.parametrize("length,d,bf16_logits,fits", [
    (1024, 64, "1", True), (1536, 64, "1", True), (1600, 64, "1", False),
    (1024, 128, "1", True), (768, 64, "0", True), (832, 64, "0", False),
    (4096, 64, "1", False),
])
def test_k6_takes_what_its_shared_memory_holds(monkeypatch, length, d, bf16_logits, fits):
    """A block keeps its rows' logits for the whole key row: in bf16 a self
    length up to 1,536 at D = 64, in f32 768; a longer layer keeps the
    matmul route."""
    monkeypatch.setenv("ML_MDM_TPU_BF16_LOGITS", bf16_logits)
    q = torch.empty((1, length, 2, d), dtype=BF)
    k_c = torch.empty((1, 32, 2, d), dtype=BF)
    assert attention.k6_takes(True, q, k_c, k_c) == fits


# -- on the CPU: the module ----------------------------------------------------


@pytest.fixture
def k6_calls(monkeypatch):
    """Calls of K6 (its plain version runs for a CPU tensor)."""
    calls = []
    real = attention.two_branch_attention

    def count(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "two_branch_attention", count)
    return calls


def _module(channels=128, cond_dim=48, dtype=BF, seed=5):
    torch.manual_seed(seed)
    m = SelfAttention(channels, cond_dim=cond_dim, use_attention_ffn=True).to(dtype).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(dtype) * 0.1)
    return m


def _module_inputs(side=8, b=2, channels=128, cond_dim=48, lt=8, dtype=BF, seed=6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, side, side, channels), generator=g).to(dtype)
    cond = torch.randn((b, lt, cond_dim), generator=g).to(dtype)
    mask = torch.ones((b, lt), dtype=dtype)
    mask[:, lt // 2:] = 0
    return x, cond, mask


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_kernels_on_and_off_agree_on_the_cpu(k6_calls, masked):
    m = _module()
    x, cond, mask = _module_inputs()
    mask = mask if masked else None
    with torch.no_grad():
        got = m(x, cond, mask)
        m.kernels = False
        ref = m(x, cond, mask)
    assert not k6_calls
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cond_dim", [0, 48])
@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_takes_k6_where_routed(monkeypatch, k6_calls, cond_dim, masked):
    """With the CPU among K6's devices, a sampling forward (no gradient)
    computes both branches in one K6 call, within two bf16 ULPs of the route's
    layer; ``kernels`` off takes the route."""
    monkeypatch.setattr(attention, "k6_route", attention.k6_takes)
    m = _module(cond_dim=cond_dim)
    x, cond, mask = _module_inputs()
    mask = mask if masked else None
    with torch.no_grad():
        got = m(x, cond if cond_dim else None, mask)
        assert len(k6_calls) == 1
        m.kernels = False
        ref = m(x, cond if cond_dim else None, mask)
    assert len(k6_calls) == 1
    # the branches' two ULPs carried through proj_out and the FFN, each
    # residual sum rounded once more: measured one ULP of the largest output
    assert _rel(got, ref) <= BF16_TOL


def test_self_attention_with_a_gradient_never_takes_k6(monkeypatch, k6_calls):
    monkeypatch.setattr(attention, "k6_route", attention.k6_takes)
    m = _module().train()
    x, cond, mask = _module_inputs()
    out = m(x, cond, mask)  # the parameters require a gradient
    assert not k6_calls
    out.float().square().sum().backward()
    assert m.qkv.weight.grad is not None and m.kv_cond.weight.grad is not None
    m.kernels = False
    assert torch.equal(m(x, cond, mask), out)


def test_k6_opens_its_span_inside_the_attention_span(monkeypatch):
    """Under a profiler of the host, each K6 call is a range "K6" whose
    parent is "unet: attention", so the device trace names K6's kernel apart
    while "unet: attention" still spans it."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(attention, "k6_route", attention.k6_takes)
    m = _module()
    x, cond, mask = _module_inputs()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        m(x, cond, mask)
    ranges = [e for e in prof.events() if e.name == "K6"]
    assert len(ranges) == 1
    parent = ranges[0].cpu_parent
    while parent is not None and parent.name != "unet: attention":
        parent = parent.cpu_parent
    assert parent is not None


def test_flash_route_gives_k6_the_text_branch(monkeypatch, k6_calls):
    """With the flash route on and the self length a multiple of 128, K4
    (its plain version here) takes the self branch and K6 the text branch,
    K4's output added."""
    monkeypatch.setattr(attention, "k6_route", attention.k6_takes)
    q, k, v, k_c, v_c, mask = _operands(2, 256, 32, 8, 64, BF, True, seed=7)
    attention.use_flash(True)
    flash = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: flash.append(1) or real(*a))
    got = attention.self_and_text_attention(q, k, v, k_c, v_c, mask)
    assert flash == [1] and len(k6_calls) == 1
    ref = (attention.dot_product_attention(q, k, v)
           + attention.dot_product_attention(q, k_c, v_c, mask))
    assert _rel(got, ref) <= BF16_TOL


def test_unet_sampling_takes_k6_for_every_attention_layer(monkeypatch, k6_calls):
    """Every 2-D attention layer of a packed nested U-Net's sampling forward
    (heads widened to 16 channels, so K6 takes them) goes through K6 once;
    ``use_kernels(False)`` sends every one back to the matmul route."""
    from ml_mdm_tpu_torch.presets import nested_preset

    monkeypatch.setattr(attention, "k6_route", attention.k6_takes)
    pipe, lm_dim, side = nested_preset("cc12m_1024x1024", "cpu", seed=3, scaled=True,
                                       pack_min_side=8)
    unet = pipe.vision_module
    layers = [mod for mod in unet.modules() if isinstance(mod, SelfAttention)]
    assert layers
    for mod in layers:
        mod.heads = mod.qkv.out_channels // 3 // 16
    g = torch.Generator().manual_seed(9)
    xs = pipe.get_noise(2, side, g)
    t = torch.tensor([300, 700])
    lm = torch.randn((2, 8, lm_dim), generator=g).to(BF)
    mask = torch.ones((2, 8), dtype=BF)
    with torch.no_grad():
        got = unet(xs, t, lm, mask, {})
        assert len(k6_calls) == len(layers)
        ref = unet.use_kernels(False)(xs, t, lm, mask, {})
    assert len(k6_calls) == len(layers)
    for o, r in zip(got, ref):
        assert _rel(o, r) <= 5e-2  # the U-Net tests' kernel-against-plain tolerance


# -- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_kernel(ops, add=None, self_branch=True):
    q, k, v, k_c, v_c, mask = ops
    if not self_branch:
        k = v = None
    n = attention.k6_launch_count
    out = attention.two_branch_attention(q, k, v, k_c, v_c, mask, add=add)
    again = attention.two_branch_attention(q, k, v, k_c, v_c, mask, add=add)
    torch.cuda.synchronize()
    assert attention.k6_launch_count == n + 2
    ref = attention.two_branch_attention_plain(q, k, v, k_c, v_c, mask, add=add)
    assert out.shape == ref.shape == q.shape and out.dtype == BF and out.is_contiguous()
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)  # no float atomics: the same bits
    assert _rel(out, ref) <= BF16_TOL
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,d", [(64, 1024, 64), (64, 256, 96), (16, 1024, 64),
                                        (16, 256, 96)])
def test_k6_kernel_cell_shapes(dev, b, length, d):
    """The 64px core's two attention shapes at the 64px cell's 64 rows and
    the 1024px cell's 16, with 32 text keys, as the chunked views the model
    hands over; within the route's own tolerance of the route too."""
    ops = _operands(b, length, 32, 8, d, BF, False, device=dev, seed=length + b)
    out = _check_kernel(ops)
    assert _rel(out, _route(*ops)) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,lt,heads,d,masked", [
    (2, 200, 7, 3, 64, True),     # ragged self length, a masked text row
    (2, 64, 1, 8, 96, False),     # one text key
    (3, 130, 32, 2, 32, True),
    (2, 256, 77, 4, 80, True),    # D padded to 128 in the tiles
    (1, 96, 128, 2, 128, False),  # the most text keys K6 holds
    (2, 300, 5, 2, 112, True),
    (1, 17, 3, 1, 16, True),
])
def test_k6_kernel_ragged_shapes(dev, b, length, lt, heads, d, masked):
    _check_kernel(_operands(b, length, lt, heads, d, BF, masked, device=dev, seed=length + d))


@pytest.mark.cuda
@pytest.mark.parametrize("mask_dtype", [torch.bool, BF, torch.float32, torch.int64])
def test_k6_kernel_masks(dev, mask_dtype):
    """A mask of any dtype, 0 where a key is masked, leaving one key a row."""
    q, k, v, k_c, v_c, mask = _operands(4, 256, 32, 8, 64, BF, True, device=dev, seed=12)
    mask = mask.to(mask_dtype)
    _check_kernel((q, k, v, k_c, v_c, mask))
    unmasked = attention.two_branch_attention(q, k, v, k_c, v_c)
    assert not torch.equal(attention.two_branch_attention(q, k, v, k_c, v_c, mask), unmasked)


@pytest.mark.cuda
def test_k6_kernel_branches_alone_and_an_addend(dev):
    """A layer without text (the self branch alone) and the flash route's
    text branch with K4's output added."""
    q, k, v, k_c, v_c, mask = _operands(8, 256, 32, 8, 96, BF, True, device=dev, seed=13)
    _check_kernel((q, k, v, None, None, None))
    own = attention.flash_attention(q, k, v)
    _check_kernel((q, k, v, k_c, v_c, mask), add=own, self_branch=False)


@pytest.mark.cuda
def test_k6_kernel_strided_layouts(dev):
    """Operands whose strides do not grow with the axis (views of (B, H, L,
    D) tensors), q, k and v with three different layouts, and views whose
    last axis is not contiguous (copied)."""
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v, k_c, v_c = (torch.randn((2, 4, n, 64), generator=g, device=dev).to(BF)
                         .transpose(1, 2) for n in (160, 160, 160, 24, 24))
    _check_kernel((q, k, v, k_c, v_c, None))
    _check_kernel((q, k.contiguous(), v.transpose(1, 2).contiguous().transpose(1, 2),
                   k_c, v_c.contiguous(), None))
    q, k, v = (torch.randn((2, 96, 64, 4), generator=g, device=dev).to(BF).transpose(2, 3)
               for _ in range(3))
    assert q.stride(-1) != 1
    _check_kernel((q, k, v, k_c[:, :8].contiguous().transpose(2, 3).contiguous()
                   .transpose(2, 3), v_c[:, :8], None))


@pytest.mark.cuda
def test_self_attention_one_k6_launch_a_layer(dev):
    """A sampling forward of one ``SelfAttention`` of the 64px core launches
    K6 once and K4 never; training takes the matmul route; with the flash
    route on, K4 takes the self branch and K6 the text branch."""
    torch.manual_seed(15)
    m = SelfAttention(768, cond_dim=2048, use_attention_ffn=True).to(BF).to(dev).eval()
    g = torch.Generator().manual_seed(15)
    x = torch.randn((8, 16, 16, 768), generator=g).to(BF).to(dev)
    cond = torch.randn((8, 32, 2048), generator=g).to(BF).to(dev)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(BF).to(dev) * 0.05)
        n6, n4 = attention.k6_launch_count, attention.launch_count
        got = m(x, cond)
        assert (attention.k6_launch_count, attention.launch_count) == (n6 + 1, n4)
        m.kernels = False
        ref = m(x, cond)
        assert attention.k6_launch_count == n6 + 1
        m.kernels = True
        attention.use_flash(True)
        m(x, cond)
        attention.use_flash(None)
        assert (attention.k6_launch_count, attention.launch_count) == (n6 + 2, n4 + 1)
    assert _rel(got, ref) <= BF16_TOL
    m.train()
    m(x, cond).float().sum().backward()
    assert attention.k6_launch_count == n6 + 2 and m.qkv.weight.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("length,d", [(256, 96), (768, 64)])
def test_k6_kernel_f32_logits(dev, monkeypatch, length, d):
    """``ML_MDM_TPU_BF16_LOGITS=0``: the logits stay in f32 in the kernel's
    store too, up to the longest self length that store holds."""
    monkeypatch.setenv("ML_MDM_TPU_BF16_LOGITS", "0")
    _check_kernel(_operands(4, length, 32, 8, d, BF, True, device=dev, seed=16))


@pytest.mark.cuda
def test_attention_span_holds_k6_on_the_device(dev):
    """On the device, the range "unet: attention" spans the kernels launched
    directly inside it, from the layer's first norm to its last product; K6's
    kernel, launched under its own range "K6" in between, lies inside that
    span, so the device time under "unet: attention" holds K6's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.manual_seed(17)
    m = SelfAttention(512, cond_dim=256, use_attention_ffn=True).to(BF).to(dev).eval()
    g = torch.Generator().manual_seed(17)
    x = torch.randn((4, 16, 16, 512), generator=g).to(BF).to(dev)
    cond = torch.randn((4, 32, 256), generator=g).to(BF).to(dev)
    with torch.no_grad():
        m(x, cond)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            m(x, cond)
            torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e.time_range for e in on_device
              if getattr(e, "is_user_annotation", False) and e.name == "unet: attention"]
    kernels = [e.time_range for e in on_device if "two_branch_attention_kernel" in e.name]
    assert ranges and len(kernels) == 1
    k = kernels[0]
    assert any(r.start <= k.start and k.end <= r.end for r in ranges)
