"""``mfu.*``: the model's FLOPs of the window's work (counted on the
reference at the cell's shapes, ``flops/count.py``; recompute not counted)
over the window's time and the card's published peak (``flops/peaks.json``),
in percent."""


def read(name, layer):
    peak, flops, window = layer.get("peak"), layer.get("model_flops"), layer.get("window_s")
    if not peak or not flops or not window:
        return None
    return 100.0 * flops / (window * peak["flops_per_s"])
