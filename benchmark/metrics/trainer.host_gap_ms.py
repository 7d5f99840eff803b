"""The trainer's host time a step in which the card has nothing queued:
the median over the spans slice's replayed steps (``bmk/spans_slice.py``)
of the host span ``trainer.iteration`` less its children
``trainer.launch`` (the graph's launch, during which the card already
runs the step's first nodes) and ``trainer.metrics_read`` (the host's
wait on the card), step by step, in ms."""
from bmk import spans_slice


def read(ctx):
    s = spans_slice.train(ctx)
    return None if s is None else s["host_gap"]
