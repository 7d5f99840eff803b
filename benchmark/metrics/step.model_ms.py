"""The model inside the replayed train step: the median over the spans
slice's replayed steps (``bmk/spans_slice.py``) of the device mark
interval ``step.model`` (the feature and label gathers, forward, loss,
backward, Adam), on the card's clock, in ms."""
from bmk import spans_slice


def read(ctx):
    s = spans_slice.train(ctx)
    return None if s is None else s["step.model"]
