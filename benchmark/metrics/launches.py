"""``launches.*``: the host's calls that put work on the device's stream
(the CUDA API calls named in ``launches.json``: kernel launches, both
``cuda*`` and ``cu*``, graph launches, asynchronous copies and fills),
counted where they start inside the program's span of one unit of work, on
any thread, over the number of those spans, in the part traced with the
host. The unit:
``launches.sample`` a U-Net forward ("unet: forward"), ``launches.train`` a
training step ("trainer: step"). A count, so the profiler's slowing of the
host does not move it."""
import json
from pathlib import Path

import spans

NAMES = json.loads((Path(__file__).with_suffix(".json")).read_text())


def read(name, layer):
    unit = NAMES["units"][name.split(".")[1]]
    return spans.per_unit(layer.get("host_trace"), unit,
                          lambda t: spans.events_inside(t, NAMES["events"], unit))
