"""The model inside the replayed GATv2 train step: ``step.model_ms``'s
reading (the median over the spans slice's replayed steps of the device
mark interval ``step.model``: the gathers, the forward with its
attention, the loss, the backward, Adam), in ms."""
import os

from bmk.spec import load_module


def read(ctx):
    return load_module(os.path.join(ctx.cell.dir, "metrics",
                                    "step.model_ms.py"),
                       "metric_step_model_ms").read(ctx)
