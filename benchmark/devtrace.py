"""The reduction from a ``torch.profiler`` trace to what the per-layer
metrics read: the device's busy time and the traced window, device time by
kernel name, the idle gaps labelled by what the host was doing, and device
time under the program's named ranges.

``busy_and_window`` and ``top_ops`` are copies of ``chip_smoke.py``'s
``busy_and_window`` and ``top_kernels`` (the union of the kernels' spans
over the window from the first event to the last kernel's end; device time
summed by kernel name). Times are microseconds, as the profiler gives them.

A steady window is marked on the device: ``mark()`` launches two kernels of
a microsecond or so (``MARK``) where a step of the loop begins, and
``Trace.from_profiler`` keeps the kernels between the first mark and the
last, the window from one mark's start to the other's (two a place, since
the profiler has been seen to lose the record of one). The window's steps
then run as they do untraced: the profiler of the device alone
(``profiler(host=False)``) adds no work on the host, and the steps before
the first mark take up what starting it did.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MARK = "spin_kernel"  # the kernel of ``torch.cuda._sleep``, which the program never launches


@dataclass
class Span:
    name: str
    start: float
    end: float


def merge(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(spans: Sequence[Tuple[float, float]], s: float, e: float,
            starts: Optional[Sequence[float]] = None) -> float:
    """How much of [s, e] the sorted disjoint ``spans`` cover (``starts``:
    their starts, where the caller has them)."""
    starts = [a for a, _ in spans] if starts is None else starts
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0.0
    while i < len(spans) and spans[i][0] < e:
        a, b = spans[i]
        total += max(0.0, min(b, e) - max(a, s))
        i += 1
    return total


@dataclass
class Trace:
    kernels: List[Span]                  # device kernels and copies
    annotations: List[Span]              # the named ranges' spans on the device
    host: List[Span]                     # host ops and ranges
    start: float                         # the first event, or the first mark
    end: Optional[float] = None          # the last mark, where the window is marked
    marks: int = 0                       # the marks found
    _busy: Optional[List[Tuple[float, float]]] = field(default=None, repr=False)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        kernels, annotations, host = [], [], []
        events = prof.events()
        for e in events:
            sp = Span(e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                (annotations if getattr(e, "is_user_annotation", False) else kernels).append(sp)
            elif e.device_type == DeviceType.CPU and not getattr(e, "is_async", False):
                host.append(sp)
        start = min((e.time_range.start for e in events), default=0.0)
        return cls(kernels, annotations, host, start).marked()

    def marked(self) -> "Trace":
        """The trace between its first mark and its last, where other
        kernels lie between them; else itself."""
        marks = sorted(k.start for k in self.kernels if MARK in k.name)
        if not marks:
            return self
        a, b = marks[0], marks[-1]

        def within(spans):
            return [Span(x.name, max(x.start, a), min(x.end, b)) for x in spans
                    if x.end > a and x.start < b and MARK not in x.name]

        kernels = within(self.kernels)
        if not kernels:
            self.marks = len(marks)
            return self
        return Trace(kernels, within(self.annotations), within(self.host), a, b,
                     marks=len(marks))

    def busy(self) -> List[Tuple[float, float]]:
        if self._busy is None:
            self._busy = merge((k.start, k.end) for k in self.kernels)
        return self._busy

    def busy_and_window(self) -> Tuple[float, float]:
        """(device busy us, window us): the union of the kernels' spans,
        over the time from the first event (or mark) to the last kernel's
        end (or the last mark)."""
        busy = self.busy()
        if not busy:
            return 0.0, 0.0
        return sum(e - s for s, e in busy), (self.end or busy[-1][1]) - self.start

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` device operations with the most time, summed by name."""
        by_name: Dict[str, float] = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start)
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]

    def kernel_time(self, patterns: Sequence[str],
                    outside: Sequence[Tuple[float, float]] = ()) -> float:
        """Device time of the kernels whose name matches one of the regular
        expressions ``patterns``, less what of it lies in ``outside``."""
        rx = [re.compile(p) for p in patterns]
        starts = [a for a, _ in outside]
        total = 0.0
        for k in self.kernels:
            if any(r.search(k.name) for r in rx):
                total += (k.end - k.start) - overlap(outside, k.start, k.end, starts)
        return total

    def range_spans(self, names: Sequence[str]) -> List[Tuple[float, float]]:
        """The device spans of the program's ranges ``names``. The profiler
        puts on the device the kernels launched directly inside a range
        (those of a range nested in it are under that range's name), so a
        caller names every range it means."""
        return merge((a.start, a.end) for a in self.annotations if a.name in names)

    def time_under(self, names: Sequence[str]) -> float:
        """Device busy time inside the spans of the ranges ``names``."""
        spans = self.range_spans(names)
        starts = [a for a, _ in spans]
        return sum(overlap(spans, s, e, starts) for s, e in self.busy())

    def idle_gaps(self, n: int = 10, longest: int = 256) -> List[Tuple[str, float]]:
        """Idle time of the device (the gaps between busy spans, and before
        the first) summed by the innermost host op or range open when each
        gap began, over the ``longest`` gaps: the ``n`` labels with most."""
        busy = self.busy()
        gaps = [(busy[0][0] - self.start, self.start)] if busy else []
        gaps += [(b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])]
        gaps = sorted(gaps, reverse=True)[:longest]
        host = sorted(self.host, key=lambda h: h.start)
        starts = [h.start for h in host]
        by_label: Dict[str, float] = {}
        for length, t in gaps:
            label = "(no host op)"
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 20000, -1), -1):
                if host[j].end >= t:
                    label = host[j].name
                    break
            by_label[label] = by_label.get(label, 0.0) + length
        return sorted(by_label.items(), key=lambda kv: -kv[1])[:n]


def profiler(host: bool = True):
    """A profiler of the device, and of the host's ops and ranges with
    ``host``, without shapes or stacks."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)


def mark() -> None:
    """A mark of the window on the current stream (see the module's note)."""
    import torch

    torch.cuda._sleep(1)
    torch.cuda._sleep(1)
