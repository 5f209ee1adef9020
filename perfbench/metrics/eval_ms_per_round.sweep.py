"""Host milliseconds the engine's ``eval`` spans took over the window, per
batch round: the time to dispatch the eval (the counts' variance and Gini,
val loss and accuracy on their cadence) for the whole batch.  The card runs
behind the host, so in a host-paced sweep this is the layer's cost."""


def read(ctx):
    spans = [e["dur"] for e in ctx["spans"] if e["name"] == "eval"]
    if not spans or not ctx["rounds"]:
        return None
    return sum(spans) / 1e3 / ctx["rounds"]
