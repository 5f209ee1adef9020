"""Launches of the FedGS solve's kernels (the greedy argmax B3 and the
Q-free swap B4, the program's ``kernels.ops.KERNELS`` counters) over the
window's cell-rounds.  A uniform sweep launches neither and reads 0."""


def read(ctx):
    n = ctx["cells"] * ctx["rounds"]
    if not n:
        return None
    got = ctx["launches"]
    return (got["greedy_argmax"] + got["swap_best_fused"]) / n
