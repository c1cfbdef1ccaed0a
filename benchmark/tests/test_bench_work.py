"""The yardstick's arithmetic: the FLOP count against a hand count, the
least time of a convolution, and the trace reduction on synthetic
events."""
import pytest
import torch

import tiny  # noqa: F401
import devtrace
from devtrace import MARK, Span, Trace, merge, overlap
from flops.count import conv_least_seconds, count

PEAK = {"flops_per_s": 989e12, "bytes_per_s": 3.35e12}


def _net():
    with torch.device("meta"):
        c1 = torch.nn.Conv2d(3, 8, 3, padding=1)
        c2 = torch.nn.Conv2d(8, 16, 3, stride=2, padding=1)
        lin = torch.nn.Linear(16, 4)
    return c1, c2, lin


def test_flops_forward_against_hand_count():
    c1, c2, lin = _net()
    x = torch.empty(2, 3, 32, 32, device="meta")
    with torch.no_grad():
        work = count(lambda: lin(c2(c1(x)).mean(dim=(2, 3))))
    hand = (2 * (2 * 8 * 32 * 32) * (3 * 9)      # conv1: 2 * outputs * (Cin k k)
            + 2 * (2 * 16 * 16 * 16) * (8 * 9)    # conv2, stride 2
            + 2 * 2 * 16 * 4)                     # the linear layer
    assert work["flops"] == hand
    assert [c["flops"] for c in work["convs"]] == [2 * 2 * 8 * 32 * 32 * 27,
                                                   2 * 2 * 16 * 16 * 16 * 72]


def test_flops_backward_counts_both_gradients_once():
    c1, c2, _ = _net()
    x = torch.empty(2, 3, 32, 32, device="meta")
    f1, f2 = 2 * 2 * 8 * 32 * 32 * 27, 2 * 2 * 16 * 16 * 16 * 72
    work = count(lambda: c2(c1(x)).sum().backward())
    assert work["flops"] == 2 * f1 + 3 * f2  # conv1 has no data gradient
    assert [c["dx"] for c in work["convs"]] == [False, True]


def test_conv_least_seconds():
    convs = [{"x": 10**6, "w": 10**3, "y": 10**6, "flops": 10**12, "dx": True},
             {"x": 10**9, "w": 10**3, "y": 10**9, "flops": 10**6, "dx": False}]
    fwd = conv_least_seconds(convs, PEAK)
    assert fwd == pytest.approx(1e12 / 989e12 + (2e9 + 1e3) * 2 / 3.35e12)
    bwd = conv_least_seconds(convs, PEAK, backward=True)
    assert bwd == pytest.approx(2 * 1e12 / 989e12 + (2e9 + 1e3) * 2 / 3.35e12)


def test_merge_and_overlap():
    spans = merge([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert spans == [(0, 3), (5, 8)]
    assert overlap(spans, 2, 6) == 2
    assert overlap(spans, 10, 12) == 0


def _trace():
    k = [Span("conv3x3_wgmma_kernel<1>", 10, 20), Span("elementwise", 20, 25),
         Span("conv3x3_wgmma_kernel<2>", 40, 60), Span("k3_fold_kernel", 70, 75),
         Span("multi_tensor_apply_kernel", 90, 95)]
    ann = [Span("K3 backward", 38, 61), Span("trainer: Adam", 88, 96)]
    host = [Span("aten::sample", 0, 100), Span("aten::copy_", 25, 38),
            Span("cudaStreamSynchronize", 62, 89)]
    return Trace(k, ann, host, 0.0)


def test_busy_window_and_top_ops():
    t = _trace()
    assert t.busy_and_window() == (15 + 20 + 5 + 5, 95)  # [10, 25) merged
    assert t.top_ops(2) == [("conv3x3_wgmma_kernel<2>", 20), ("conv3x3_wgmma_kernel<1>", 10)]


def test_idle_gaps_labelled_by_the_innermost_host_op():
    gaps = dict(t for t in _trace().idle_gaps(10))
    # gaps: [0, 10) and [60, 70) under sample (the sync starts at 62), [25, 40)
    # from copy_, [75, 90) in the sync
    assert gaps == {"aten::sample": 20, "aten::copy_": 15, "cudaStreamSynchronize": 15}


def test_time_under_ranges_and_named_kernels():
    t = _trace()
    assert t.time_under(["K3 backward"]) == 20
    assert t.time_under(["trainer: Adam"]) == 5
    spans = t.range_spans(["K3 backward"])
    assert t.kernel_time(["k3_fold_kernel", "conv3x3"], spans) == 5 + 10
    assert t.range_spans(["nothing"]) == []


def test_marked_window_keeps_what_lies_between_the_marks():
    k = [Span("lead_in", 0, 8), Span(MARK, 10, 11), Span("conv3x3_wgmma_kernel<1>", 12, 20),
         Span("elementwise", 30, 35), Span(MARK + "(long)", 50, 51), Span("after", 52, 60)]
    t = Trace(k, [], [Span("aten::sample", 0, 60)], 0.0).marked()
    assert (t.start, t.end) == (10, 50)
    assert [x.name for x in t.kernels] == ["conv3x3_wgmma_kernel<1>", "elementwise"]
    assert t.busy_and_window() == (8 + 5, 40)  # the marks themselves are not busy time
    assert t.kernel_time(["conv3x3"]) == 8
    one = Trace(k[:3], [], [], 0.0)
    assert one.marked() is one  # one mark marks no window
    assert Trace(k[:2] + [Span(MARK, 11, 12)], [], [], 0.0).marked().end is None
    # of two marks at the end one is lost: the other still ends the window
    t = Trace(k[:2] + [Span(MARK, 10.5, 11)] + k[2:], [], [], 0.0).marked()
    assert (t.start, t.end, t.marks) == (10, 50, 3)


def test_tracer_starts_marks_and_stops_at_its_forwards(monkeypatch):
    from drivers import sample

    seen = []

    class Prof:
        def start(self):
            seen.append(("start", len(calls)))

        def stop(self):
            seen.append(("stop", len(calls)))

    calls = []
    monkeypatch.setattr(devtrace, "profiler", lambda host=True: Prof())
    monkeypatch.setattr(devtrace, "mark", lambda: seen.append(("mark", len(calls))))
    module = torch.nn.Linear(2, 2)
    module.register_forward_hook(lambda *_: calls.append(1))
    device = sample._Tracer(module, "cpu", first=3, n=2, host=False, lead=2)
    host = sample._Tracer(module, "cpu", first=6, n=1, host=True)
    for _ in range(8):
        module(torch.zeros(1, 2))
    # forwards counted from 0, each event at the forward whose pre-hook ran it
    assert seen == [("start", 1), ("mark", 3), ("mark", 5), ("stop", 5), ("start", 6),
                    ("stop", 7)]
    for t in (device, host):
        for h in t._hooks:
            h.remove()
