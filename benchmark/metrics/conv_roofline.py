"""``conv_roofline.*``: the least time of the marked window's convolutions
(each the larger of its FLOPs at the peak rate and its bytes at the peak
bandwidth, ``flops/count.py``) over the device time of the kernels that
compute them, named in ``conv_roofline.json``, in percent."""
import json
from pathlib import Path

NAMES = json.loads((Path(__file__).with_suffix(".json")).read_text())


def read(name, layer):
    trace, least = layer.get("trace"), layer.get("conv_fwd_least_s")
    if trace is None or not least:
        return None
    spent = trace.kernel_time(NAMES["kernels"]) / 1e6
    return 100.0 * least / spent if spent > 0 else None
