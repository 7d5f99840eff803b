"""The sampler inside the replayed train step: the median over the spans
slice's replayed steps (``bmk/spans_slice.py``) of the device mark
interval ``step.sample`` (``sample_blocks``, from the step's start), on
the card's clock, in ms."""
from bmk import spans_slice


def read(ctx):
    s = spans_slice.train(ctx)
    return None if s is None else s["step.sample"]
