#!/usr/bin/env python3
"""Splits a GATv2 train cell's ``exp3_gap`` by whether the arm's dst
cancels: one run of the cell's check (``benchmark/bmk/train.py``: build,
the set-up's fit, optionally the window, the replayed check), then the
reference followed again over each checked group, recording the kept
edges whose dst's head-mean logits cancel in the reference's own f32
logits (|sum abar| under 2^-8 sum |abar|, the rule of the port's
``bandit.alpha_cancel/<l>``), and each layer's gap over the moved arms,
over those of cancelling dsts alone and over the rest:

    python3 tools/gat_reward_split.py --seed 5150001 [--seconds 51] \
        [--root DIR] [--workload gatv2-reddit-train] [--device cuda]

``--root`` reads ``BENCHMARK.json`` and ``benchmark/`` of another
checkout-shaped directory (a copy whose configuration runs the program in
f32, say; the port is imported from this checkout). Prints one JSON line:
the check's numbers and, per group and layer, the moved arms, how many of
them belong to cancelling dsts, the three gaps, and the cancelling and
kept edges of each step."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARE = 2.0 ** -8


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--workload", default="gatv2-reddit-train")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = os.path.join(args.root, "benchmark")
    sys.path[:0] = [bench, os.path.join(bench, "reference")]
    sys.path.append(ROOT)
    import torch

    from bmk import train as btrain
    from bmk.spec import Cell
    from precision import Rounding, exact_f32

    cell = Cell(args.root, args.workload)
    dev = torch.device(args.device)
    t0 = time.time()
    r = btrain.Run(cell, args.seed, dev)
    r.build()
    r.warm()
    if args.seconds:
        r.window(args.seconds)
    r.replay_check()
    r.free()
    nums, _ = r.check()
    exact_f32()
    r.inp.to(dev)
    ref_mod = cell.reference()
    follow = ref_mod.Train._exp3
    cancelling = []  # per step: per layer the eids of cancelling dsts

    def _exp3(self, derived, norms, logits):
        per = []
        for blk, abar in zip(derived, logits):
            dst, n = blk["e_dst"], blk["n_dst_cap"]
            s = torch.zeros(n, device=abar.device).index_add(0, dst, abar)
            a = torch.zeros(n, device=abar.device).index_add(0, dst,
                                                             abar.abs())
            c = (s.abs() < SHARE * a)[dst]
            per.append((blk["eid"][c], int(c.sum()), int(c.numel())))
        cancelling.append(per)
        return follow(self, derived, norms, logits)

    ref_mod.Train._exp3 = _exp3
    min_change = cell.cfg["check"]["exp3_min_change"]
    out = {"seed": args.seed, "cell": args.workload, "checks": nums}
    for gi, group in enumerate(r.groups):
        cancelling.clear()
        start = None if group.start is None else btrain._to(
            {k: group.start[k] for k in ("params", "m", "v", "t", "arms")},
            dev)
        p0 = (start or {}).get("params") or {k: v.to(dev)
                                             for k, v in r.w0.items()}
        recs = [btrain._to(x, dev) for x in group.steps]
        ref = btrain._follow(ref_mod, cell.cfg, r.inp, p0, recs, Rounding(),
                             start)
        side = btrain._to(group.program_side(), dev)
        rows = []
        for l, (eids, vals) in enumerate(side["arms3"]):
            w_ref = ref["arms_full"][l]
            w_start = (torch.ones_like(w_ref) if start is None
                       else start["arms"][l].float())
            w_prog = w_start.clone()
            w_prog[eids.long()] = vals.float()
            moved = (w_ref - w_start).abs() >= min_change * w_start.abs()
            canc = torch.zeros_like(moved)
            for step in cancelling:
                canc[step[l][0].long()] = True
            den = float(torch.linalg.vector_norm((w_ref - w_start)[moved]))
            diff = w_prog - w_ref

            def gap(m):
                return (float(torch.linalg.vector_norm(diff[m])) / den
                        if den else 0.0)

            rows.append({
                "layer": l, "moved": int(moved.sum()),
                "moved_cancel": int((moved & canc).sum()),
                "gap": gap(moved), "gap_cancel_only": gap(moved & canc),
                "gap_without_cancel": gap(moved & ~canc),
                "cancel_edges_by_step": [s[l][1] for s in cancelling],
                "kept_edges_by_step": [s[l][2] for s in cancelling]})
        out[f"group{gi}"] = rows
    out["s"] = time.time() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
