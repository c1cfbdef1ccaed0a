"""``k2_ms.*``: the device milliseconds under the program's K2 spans (one a
forward launch of K2, named "K2" or "K2·<modes>", ``ml_mdm_tpu_torch/ops/
fused_resnet.py``) over the U-Net forwards ("unet: forward"), in the part
traced with the host."""
import spans


def read(name, layer):
    return spans.per_unit(layer.get("host_trace"), "unet: forward",
                          lambda t: spans.ms_under(t, "K2"))
