"""``enqueue_ms_per_forward.*``: the host's milliseconds from a forward
pre-hook to a forward hook on the port's vision module (no
synchronisation: the time to enqueue one U-Net forward), the mean over the
window's forwards."""


def read(name, layer):
    ms = layer.get("enqueue_ms")
    return sum(ms) / len(ms) if ms else None
