"""Host milliseconds the engine's ``sampler`` spans took over the window, per
batch round: the time to dispatch the sampler (the per-cell sampler loop with
its generator draws, and ``select_k``) for the whole batch.  The card runs
behind the host, so in a host-paced sweep this is the layer's cost."""


def read(ctx):
    spans = [e["dur"] for e in ctx["spans"] if e["name"] == "sampler"]
    if not spans or not ctx["rounds"]:
        return None
    return sum(spans) / 1e3 / ctx["rounds"]
