"""``conv_bwd_roofline.*``: the least time of the convolution gradients
(data and weight, ``flops/count.py``) of the step traced with the host's
ranges, over the device time they took: the device time under the
program's ranges named in ``conv_bwd_roofline.json`` (K3's backward) plus
that of the kernels named there outside those ranges (the other
convolutions' gradients), in percent."""
import json
from pathlib import Path

NAMES = json.loads((Path(__file__).with_suffix(".json")).read_text())


def read(name, layer):
    trace, least = layer.get("host_trace"), layer.get("conv_bwd_least_s")
    if trace is None or not least:
        return None
    spans = trace.range_spans(NAMES["ranges"])
    if not spans:
        return None
    spent = (trace.time_under(NAMES["ranges"]) + trace.kernel_time(NAMES["kernels"], spans)) / 1e6
    return 100.0 * least / spent if spent > 0 else None
