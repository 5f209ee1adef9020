"""The greedy masked argmax (B3) in the profiled rounds: its bound time
per launch at the cell's N over its mean device time, in %."""
import roofline


def read(ctx):
    return roofline.share(ctx, "masked_argmax",
                          roofline.greedy_argmax(ctx["n"]))
