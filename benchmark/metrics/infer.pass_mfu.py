"""A full-graph pass's model FLOPs (``costs.gat_pass_flops``: the
projections and the attention) times the window's passes, over the
window's seconds, against the bf16 peak of one card, in %."""


def read(ctx):
    cfg, c, r = ctx.cfg, ctx.costs, ctx.run
    if cfg["model"]["name"] != "gat":
        return None
    flops = c.gat_pass_flops(cfg, r.inp.n_nodes, r.inp.n_edges) * r.passes
    return 100.0 * flops / ctx.window_s / (c.BF16_FLOPS * ctx.chips)
