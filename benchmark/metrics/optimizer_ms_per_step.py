"""``optimizer_ms_per_step.*``: the device milliseconds a step spends under
the trainer's ranges "trainer: Adam" and "trainer: EMA" (``trainer.py``)
and the optimizer's own range nested in the first, named in
``optimizer_ms_per_step.json``, over the steps traced with the host's
ranges."""
import json
from pathlib import Path

RANGES = json.loads((Path(__file__).with_suffix(".json")).read_text())["ranges"]


def read(name, layer):
    trace, steps = layer.get("host_trace"), layer.get("host_steps")
    if trace is None or not steps or not trace.range_spans(RANGES):
        return None
    return trace.time_under(RANGES) / 1e3 / steps
