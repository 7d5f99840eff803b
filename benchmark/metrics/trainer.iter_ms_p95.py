"""The 95th percentile of the trainer's own ``iter_time`` over the
window's steps (the time from one step's logged end to the next's: the
replayed step, its metrics read, and what the trainer does between steps;
the steps that end an epoch also carry its validation), in ms."""
import numpy as np


def read(ctx):
    it = ctx.run.win_iter
    return float(np.percentile(it, 95) * 1e3) if it else None
