"""The share of a training step in which the card is idle, in %: 1 - the
card's busy time per traced step (the union of kernel, copy and set
intervals over the traced slice, over its steps) over the window's median
step time (the trainer's own ``iter_time``, untraced). The profiler
stretches the host's graph launches, not the kernels inside the graphs,
so the busy time is taken from the trace and the step's length from the
untraced window of the same run."""
import numpy as np


def read(ctx):
    t, r = ctx.trace, ctx.run
    if t is None or not r.win_iter:
        return None
    step_s = float(np.median(r.win_iter))
    return 100.0 * (1.0 - t["busy_s"] / r.traced_steps / step_s)
