"""K7 (``gat_attention_kernel``, the full-graph GATv2 attention) against
its roofline: the sum of its bounds over the traced passes
(``costs.gat_pass_k7_bound_s``) over its summed device time in the trace,
in %."""


def read(ctx):
    t, r = ctx.trace, ctx.run
    if t is None:
        return None
    k7 = sum(s for name, s in t["by_name"].items()
             if "gat_attention_kernel" in name)
    if k7 <= 0:
        return None
    bound = ctx.costs.gat_pass_k7_bound_s(ctx.cfg, r.inp.n_nodes,
                                          r.inp.n_edges) * r.traced_passes
    return 100.0 * bound / k7
