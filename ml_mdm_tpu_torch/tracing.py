"""The port's named profiler ranges ("spans"), which open only while a
``torch.profiler`` records.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records (``torch.autograd._profiler_enabled()``) and one shared null
context otherwise: with no profiler a span costs one C call, where a bare
``record_function`` builds a range whatever happens. Nothing else turns the
spans on: no environment variable, no switch, no log.

The profiler puts each kernel under the innermost range open when it was
launched, so a span that opens inside another takes time out of it. Two
rules keep the readings apart:

- a span opens in a forward (outside any backward pass) by default, and
  with ``backward=True`` only inside one (K3's ranges, remat's recompute).
  So no forward span opens in a backward, not even in remat's recompute of
  a stage, which then counts every kernel it launches;
- ``name`` may be a callable that returns the name, for a name that costs
  something to build: it is called only when the span opens.

The spans, and what reads them (``PERF.md`` §3): "unet: forward", "unet:
down <side>", "unet: mid", "unet: up <side>" and "unet: attention"
(``models/unet.py``, ``models/layers.py``); "K2" or "K2·<modes>", one a
forward launch, and K3's backward ranges (``ops/fused_resnet.py``); "K6",
each launch of the 2-D attention's kernel, inside "unet: attention"
(``ops/attention.py``);
"remat: recompute <side>" (``models/layers.py``); "trainer: step",
"trainer: readback", "trainer: Adam" and "trainer: EMA" (``trainer.py``);
"text tower" (``language_models/factory.py``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Union

import torch

_OFF = contextlib.nullcontext()


def span(name: Union[str, Callable[[], str]], backward: bool = False):
    """A profiler range named ``name`` while a profiler records, in a
    forward (or, with ``backward``, only inside a backward pass); else the
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    # -1 outside autograd's engine; a graph task's id inside a backward pass,
    # remat's recompute included
    if (torch._C._current_graph_task_id() != -1) != backward:
        return _OFF
    return torch.profiler.record_function(name() if callable(name) else name)
