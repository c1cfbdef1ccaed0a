"""What the readers of the program's own spans share (``metrics/launches.py``,
``k2_ms.py``, ``attention_ms.py``, ``recompute_ms.py``): the port's spans are
profiler ranges (``ml_mdm_tpu_torch/tracing.py``), so the part traced with
the host holds each one twice, as a host range (the time the program was
inside it, on the thread that opened it) and as a range on the device (the
kernels launched directly inside it, whose innermost range it is). A reader
counts the host ranges of a span that wraps a unit of work ("unet: forward",
"trainer: step") and divides by that count."""
from __future__ import annotations

import bisect
from typing import Iterable, Optional

from devtrace import Trace, merge


def count(trace: Trace, name: str) -> int:
    """How many host ranges named ``name`` the trace holds."""
    return sum(h.name == name for h in trace.host)


def events_inside(trace: Trace, events: Iterable[str], name: str) -> int:
    """How many host events named one of ``events`` start inside a host range
    named ``name``, on any thread (by time: the autograd engine launches the
    backward from its own thread while the step's thread waits in it)."""
    spans = merge((h.start, h.end) for h in trace.host if h.name == name)
    starts = [s for s, _ in spans]
    wanted = set(events)
    total = 0
    for h in trace.host:
        if h.name in wanted:
            i = bisect.bisect_right(starts, h.start) - 1
            total += i >= 0 and h.start <= spans[i][1]
    return total


def ms_under(trace: Trace, prefix: str) -> Optional[float]:
    """Device busy milliseconds inside the device ranges whose name starts
    with ``prefix``, or None where there are none. Meant for spans inside
    which no other span opens: a kernel sits under its innermost range."""
    names = sorted({a.name for a in trace.annotations if a.name.startswith(prefix)})
    return trace.time_under(names) / 1e3 if names else None


def per_unit(trace: Optional[Trace], unit: str, value) -> Optional[float]:
    """``value(trace)`` over the host ranges named ``unit``; None without a
    trace, without such a range or without a value."""
    n = count(trace, unit) if trace is not None else 0
    if not n:
        return None
    v = value(trace)
    return None if v is None else v / n
