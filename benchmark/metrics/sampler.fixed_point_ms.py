"""The sampler's Poisson fixed point (``_poisson_scale``) inside the
replayed train step: the median over the spans slice's replayed steps
(``bmk/spans_slice.py``) of the device mark pairs ``sample.fixed_point``,
summed over the step's layers, on the card's clock, in ms."""
from bmk import spans_slice


def read(ctx):
    s = spans_slice.train(ctx)
    return None if s is None else s["sample.fixed_point"]
