"""The share of the profiled rounds in which no operation ran on the
device: 1 - (union of the device's intervals / the traced window), in %."""


def read(ctx):
    if not ctx["trace"]["device"] or ctx["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
