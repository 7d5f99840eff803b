"""The training steps' model FLOPs over the window (``costs.
sage_step_flops`` on each step's raw sampled node and edge counts, as the
step returns them) over the window's seconds, against the bf16 peak of
the cards the cell uses, in %."""


def read(ctx):
    cfg, c = ctx.cfg, ctx.costs
    if cfg["model"]["name"] != "sage" or not ctx.run.win_counts:
        return None
    g, m = cfg["graph"], cfg["model"]
    dims = ([g["n_feats"]] + [m["hidden"]] * (m["layers"] - 1)
            + [g["n_classes"]])
    flops = sum(c.sage_step_flops(dims, k) for k in ctx.run.win_counts)
    return 100.0 * flops / ctx.window_s / (c.BF16_FLOPS * ctx.chips)
