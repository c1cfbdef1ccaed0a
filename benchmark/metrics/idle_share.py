"""``idle_share.*``: the share of the traced window in which no operation
ran on the device, 1 - busy / window, in percent (busy: the union of the
kernels' spans; the window: from the first mark to the last, in a trace of
the device alone, ``devtrace``)."""


def read(name, layer):
    trace = layer.get("trace")
    if trace is None:
        return None
    busy, window = trace.busy_and_window()
    return 100.0 * (1.0 - busy / window) if window > 0 else None
