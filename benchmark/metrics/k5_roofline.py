"""K5 (the wide-row segment sums of the GATv2 step, ``csrc/row_scatter.cu``)
against its roofline: the traced steps' compulsory bytes
(``costs_gatv2_train.k5_step_bytes`` on each traced step's own sampled
counts) over HBM's rate, over K5's summed device time in the trace (its
five kernels), in %."""
import os
import re

from bmk.spec import load_module

K5_KERNEL = re.compile(
    r"::(rowsum_tiles|rowsum_fold|count_scan|place|order)_kernel\b")


def read(ctx):
    t, r = ctx.trace, ctx.run
    if t is None or not getattr(r, "traced_steps", 0):
        return None
    k5 = sum(s for name, s in t["by_name"].items() if K5_KERNEL.search(name))
    if k5 <= 0:
        return None
    c = load_module(os.path.join(ctx.cell.dir, "metrics",
                                 "costs_gatv2_train.py"), "bench_costs_gat")
    steps = r.counts[-r.traced_steps:]
    nbytes = sum(c.k5_step_bytes(ctx.cfg, k) for k in steps)
    return 100.0 * nbytes / c.HBM_BYTES_PER_S / k5
