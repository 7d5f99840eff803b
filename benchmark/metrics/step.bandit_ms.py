"""The bandit inside the replayed train step: the median over the spans
slice's replayed steps (``bmk/spans_slice.py``) of the device mark
interval ``step.bandit`` (the EXP3 rewards and K4's arm update), on the
card's clock, in ms."""
from bmk import spans_slice


def read(ctx):
    s = spans_slice.train(ctx)
    return None if s is None else s["step.bandit"]
