"""The bandit inside the replayed GATv2 train step: ``step.bandit_ms``'s
reading (the median over the spans slice's replayed steps of the device
mark interval ``step.bandit``: the GAT rewards from the model's logits
and K4's arm update), in ms."""
import os

from bmk.spec import load_module


def read(ctx):
    return load_module(os.path.join(ctx.cell.dir, "metrics",
                                    "step.bandit_ms.py"),
                       "metric_step_bandit_ms").read(ctx)
