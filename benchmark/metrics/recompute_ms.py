"""``recompute_ms.*``: the device milliseconds under the program's spans
"remat: recompute <side>" (remat's recompute of a stage's forward in the
backward, ``ml_mdm_tpu_torch/models/layers.py``) over the training steps
("trainer: step"), in the part traced with the host."""
import spans


def read(name, layer):
    return spans.per_unit(layer.get("host_trace"), "trainer: step",
                          lambda t: spans.ms_under(t, "remat: recompute"))
