"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of the device's rows, against the window's length)."""


def read(run, trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
