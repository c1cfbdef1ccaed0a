"""The readers of the program's spans (``spans.py``, ``metrics/launches.py``,
``k2_ms.py``, ``attention_ms.py``, ``recompute_ms.py``) on hand-built
traces. Times in microseconds, as the profiler gives them."""
import importlib

import pytest

import tiny  # noqa: F401  (puts the benchmark on sys.path)
import spans
from devtrace import Span, Trace


def _read(name, trace):
    reader = importlib.import_module(f"metrics.{name.split('.')[0]}")
    return reader.read(name, {"host_trace": trace})


def _sampling():
    """Two forwards, each with a K2 launch, an attention and a stage; the
    sampler's own launches between them."""
    host = [Span("unet: forward", 0, 400), Span("unet: forward", 600, 1000),
            Span("unet: down 64", 10, 300), Span("unet: down 64", 610, 900),
            Span("K2·N·proj", 20, 40), Span("K2", 620, 640), Span("unet: attention", 100, 200),
            Span("unet: attention", 700, 800),
            Span("cudaLaunchKernel", 25, 26), Span("cudaLaunchKernel", 110, 111),
            Span("cuLaunchKernel", 120, 121), Span("cudaMemcpyAsync", 300, 301),
            Span("cudaLaunchKernelExC", 625, 626), Span("cudaLaunchKernel", 710, 711),
            Span("cudaLaunchKernel", 500, 501),   # the sampler's update, between forwards
            Span("cudaStreamSynchronize", 410, 590), Span("aten::add", 109, 112)]
    ann = [Span("unet: forward", 50, 1200), Span("unet: down 64", 50, 1100),
           Span("K2·N·proj", 50, 150), Span("K2", 900, 940),
           Span("unet: attention", 200, 260), Span("unet: attention", 1000, 1030)]
    kernels = [Span("conv3x3_wgmma_kernel", 50, 150), Span("elementwise", 150, 200),
               Span("gemm", 200, 250), Span("softmax", 255, 260), Span("elementwise", 500, 520),
               Span("conv3x3_wgmma_kernel", 900, 940), Span("gemm", 1000, 1030)]
    return Trace(kernels, ann, host, 0.0)


def _step():
    """One training step: the step's thread waits in the backward while the
    engine's thread launches it; two recomputes, one of them inside K3's
    backward."""
    host = [Span("trainer: step", 0, 1000), Span("unet: forward", 10, 200),
            Span("cudaLaunchKernel", 20, 21), Span("cudaLaunchKernel", 30, 31),
            Span("autograd::engine::evaluate_function", 300, 700),  # the engine's thread
            Span("K3 backward", 310, 500), Span("remat: recompute 512", 320, 400),
            Span("cudaLaunchKernel", 330, 331), Span("cuLaunchKernelEx", 450, 451),
            Span("remat: recompute 1024", 550, 650), Span("cudaMemsetAsync", 560, 561),
            Span("trainer: readback", 800, 900), Span("cudaMemcpyAsync", 810, 811),
            Span("cudaLaunchKernel", 1100, 1101)]  # after the step
    ann = [Span("remat: recompute 512", 400, 600), Span("K3 backward", 650, 800),
           Span("remat: recompute 1024", 900, 1000)]
    kernels = [Span("a", 400, 500), Span("b", 550, 600), Span("k2", 650, 800),
               Span("c", 900, 950), Span("d", 1200, 1300)]
    return Trace(kernels, ann, host, 0.0)


def test_launches_counted_by_time_inside_the_unit():
    # forward 1: 25, 110, 120, 300 (its end); forward 2: 625, 710; not the
    # sampler's launch at 500 nor the synchronisation
    assert spans.count(_sampling(), "unet: forward") == 2
    assert spans.events_inside(_sampling(), ["cudaLaunchKernel", "cuLaunchKernel",
                                             "cudaMemcpyAsync", "cudaLaunchKernelExC"],
                               "unet: forward") == 6
    assert _read("launches.sample", _sampling()) == 3.0


def test_launches_of_a_step_on_any_thread():
    # the step's own (20, 30, 810) and the engine thread's (330, 450, 560); not
    # the launch after the step
    assert _read("launches.train", _step()) == 6.0


def test_device_time_under_leaf_spans_per_forward():
    t = _sampling()
    assert spans.ms_under(t, "K2") == pytest.approx((100 + 40) / 1e3)
    assert _read("k2_ms.sample", t) == pytest.approx(140 / 2 / 1e3)
    # attention: [200, 250) and [255, 260) busy under [200, 260); [1000, 1030)
    assert _read("attention_ms.sample", t) == pytest.approx((50 + 5 + 30) / 2 / 1e3)


def test_recompute_time_per_step():
    # [400, 500) and [550, 600) under the first recompute, [900, 950) under the second
    assert _read("recompute_ms.train", _step()) == pytest.approx((100 + 50 + 50) / 1e3)


def test_per_unit_divides_by_the_count_of_units():
    t = _step()
    t.host += [Span("trainer: step", 2000, 3000)]
    assert _read("recompute_ms.train", t) == pytest.approx(200 / 2 / 1e3)
    assert _read("launches.train", t) == 3.0


@pytest.mark.parametrize("name", ["launches.sample", "launches.train", "k2_ms.sample",
                                  "attention_ms.sample", "recompute_ms.train"])
def test_none_without_the_spans(name):
    """A program older than the spans: every reader returns None, as it
    does without a host trace."""
    host = [Span("aten::conv2d", 0, 100), Span("cudaLaunchKernel", 10, 11),
            Span("K3 backward", 200, 300), Span("trainer: Adam", 400, 500)]
    bare = Trace([Span("conv3x3_wgmma_kernel", 10, 50)], [Span("K3 backward", 200, 300)],
                 host, 0.0)
    assert _read(name, bare) is None
    assert importlib.import_module(f"metrics.{name.split('.')[0]}").read(name, {}) is None


def test_none_where_the_unit_has_no_such_span():
    """Forwards without attention or K2 spans, a step without remat."""
    fwd = Trace([Span("gemm", 10, 20)], [], [Span("unet: forward", 0, 100)], 0.0)
    assert _read("k2_ms.sample", fwd) is None
    assert _read("attention_ms.sample", fwd) is None
    assert _read("launches.sample", fwd) == 0.0
    step = Trace([Span("gemm", 10, 20)], [], [Span("trainer: step", 0, 100)], 0.0)
    assert _read("recompute_ms.train", step) is None
