"""Host milliseconds the engine's ``local_train`` spans took over the window,
per batch round: the time to dispatch local training (the learning rate, the
training generators' batch indices, the grouped trainer call and the per-cell
split) for the whole batch.  The card runs behind the host, so in a host-
paced sweep this is the layer's cost."""


def read(ctx):
    spans = [e["dur"] for e in ctx["spans"] if e["name"] == "local_train"]
    if not spans or not ctx["rounds"]:
        return None
    return sum(spans) / 1e3 / ctx["rounds"]
