"""The window's needed operations (training, eval and the solve by
formula, ``drivers/sweep.round_flops``) over the window's seconds and the
card's float32 peak, in %."""


def read(ctx):
    if not ctx["rounds"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops_per_round"] * ctx["rounds"] / (
        ctx["window_s"] * ctx["peak_flops"])
