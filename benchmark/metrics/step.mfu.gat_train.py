"""The GATv2 training steps' model FLOPs over the window
(``costs_gatv2_train.gat_step_flops`` on each step's raw sampled node and
edge counts, as the step returns them) over the window's seconds, against
the bf16 peak of the cards the cell uses, in %."""
import os

from bmk.spec import load_module


def read(ctx):
    cfg = ctx.cfg
    if cfg["model"]["name"] != "gat" or not ctx.run.win_counts:
        return None
    c = load_module(os.path.join(ctx.cell.dir, "metrics",
                                 "costs_gatv2_train.py"), "bench_costs_gat")
    flops = sum(c.gat_step_flops(cfg, k) for k in ctx.run.win_counts)
    return 100.0 * flops / ctx.window_s / (c.BF16_FLOPS * ctx.chips)
