"""Host milliseconds the engine's ``aggregate`` spans took over the window, per
batch round: the time to dispatch the server update (the Eq. 18 weights,
grouped FedAvg, the per-cell aggregator steps and the params restack) for the
whole batch.  The card runs behind the host, so in a host-paced sweep this is
the layer's cost."""


def read(ctx):
    spans = [e["dur"] for e in ctx["spans"] if e["name"] == "aggregate"]
    if not spans or not ctx["rounds"]:
        return None
    return sum(spans) / 1e3 / ctx["rounds"]
