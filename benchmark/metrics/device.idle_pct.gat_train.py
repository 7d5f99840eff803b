"""The share of a GATv2 training step in which the card is idle, in %:
``device.idle_pct.train``'s rule (1 - the traced slice's busy time per
step over the untraced window's median step time)."""
import os

from bmk.spec import load_module


def read(ctx):
    return load_module(os.path.join(ctx.cell.dir, "metrics",
                                    "device.idle_pct.train.py"),
                       "metric_device_idle_pct_train").read(ctx)
