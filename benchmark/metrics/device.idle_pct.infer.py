"""The share of the traced slice of inference passes in which no kernel,
copy or set ran on the card (1 - the union of their intervals over the
slice), in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
