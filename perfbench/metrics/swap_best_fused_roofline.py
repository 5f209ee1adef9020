"""The Q-free best swap (B4) in the profiled rounds: its bound time per
launch at the cell's (M, N) over its mean device time, in %."""
import roofline


def read(ctx):
    return roofline.share(ctx, "swap_best_",
                          roofline.swap_best_fused(ctx["m"], ctx["n"]))
