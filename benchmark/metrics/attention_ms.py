"""``attention_ms.*``: the device milliseconds under the program's span
"unet: attention" (the U-Net's 2-D self- and text cross-attention with its
FFN, on the matmul route or K4, ``ml_mdm_tpu_torch/models/layers.py``) over
the U-Net forwards ("unet: forward"), in the part traced with the host."""
import spans


def read(name, layer):
    return spans.per_unit(layer.get("host_trace"), "unet: forward",
                          lambda t: spans.ms_under(t, "unet: attention"))
