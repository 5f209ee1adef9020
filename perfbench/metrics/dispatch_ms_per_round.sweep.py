"""Host milliseconds the engine's ``dispatch_segment`` spans took over the
window, per batch round (the program's own spans, recorded in the traced
run)."""


def read(ctx):
    spans = [e["dur"] for e in ctx["spans"] if e["name"] == "dispatch_segment"]
    if not spans or not ctx["rounds"]:
        return None
    return sum(spans) / 1e3 / ctx["rounds"]
