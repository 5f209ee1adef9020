"""Device operations (kernels, copies, sets) in the profiled rounds, per
batch round, counted from the profiler's trace."""


def read(ctx):
    if not ctx["trace"]["device"]:
        return None
    return len(ctx["trace"]["device"]) / ctx["trace_rounds"]
