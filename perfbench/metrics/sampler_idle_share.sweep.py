"""The share of the profiled rounds' device-idle time (the traced window
less the device's busy union) that falls inside the engine's ``sampler``
ranges, in %: per range, its length less the device's busy union within
it.  None without device events (a run on the CPU) or without a
``sampler`` range."""
import harness


def read(ctx):
    dev = ctx["trace"]["device"]
    idle = ctx["trace_window_s"] - ctx["busy_s"]
    ranges = [(s, e) for name, s, e in ctx["trace"]["host"]
              if name == "sampler"]
    if not dev or not ranges or idle <= 0:
        return None
    inside = sum((e - s) / 1e6 - harness.union_seconds(dev, s, e)
                 for s, e in ranges)
    return 100.0 * inside / idle
