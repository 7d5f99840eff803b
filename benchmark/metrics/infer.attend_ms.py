"""K7 inside a full-graph GATv2 pass: the median over the spans slice's
passes (``bmk/spans_slice.py``) of the device mark pairs ``infer.attend``
(around ``gat_attention``), summed over the pass's layers, on the card's
clock, in ms."""
from bmk import spans_slice


def read(ctx):
    s = spans_slice.infer(ctx)
    return None if s is None else s["infer.attend"]
