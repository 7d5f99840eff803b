#!/usr/bin/env python3
"""Measures the floors the multi-card gates of ``chip_smoke.py --cards 4``
are set from, with no gate, on four cards of one host:

    python3 tools/multicard_gate_probe.py [N]     # default 5 comparisons

One group of four NCCL ranks (one a card) runs ``multicard_worker`` on the
main path's configuration (the Reddit-shaped graph, local batch 256 a rank,
fan-outs 4096/2048/1024, SAGE-256 x3, poisson-bandit, the caps refit from a
13-step pilot on rank 0) with ``MULTICARD_TOLERANCE`` off: 3 eager DP steps,
the captured DP step (capture, 2 timed replays), N eager steps and N
replays each against two eager DP twins from one state (the floor: the
twins against each other), the same for the range-sharded step against the
DP twins, then one GATv2 DP step and replay, and the ring inference of both
models against the one-device pass. Every step is audited across the ranks
(parameters, Adam state and DP arm weights bit-equal; K4 against its plain
version on the gathered list). Prints each rank's comparisons as one JSON
line, then the largest error of each kind, then the cards' name and power
limit."""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    from bliss_gnn_tpu_torch.ops import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        sys.exit("multicard_gate_probe: needs four CUDA cards")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    _build.build_all()
    workdir = os.path.join(ROOT, "build", "multicard_probe")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    indptr, csc_src = cs.reddit_shaped_csc()
    cs.np.save(os.path.join(workdir, "indptr.npy"), indptr)
    cs.np.save(os.path.join(workdir, "csc_src.npy"), csc_src)
    del csc_src
    cfg = dict(cs.MULTICARD_CFG, counts=(3, 2, n), gat_counts=(1, 1, 1),
               gate=False)
    runs = cs.multicard_phases(torch, cfg, workdir, "cuda", sizes=(4,))
    worst = {}
    for r in runs[4]:
        for kind in ("dp", "sharded", "gat"):
            rec = r[kind]
            print(json.dumps({"rank": r["rank"], "kind": kind, **{
                k: rec[k] for k in ("eager_vs_dp", "replayed_vs_dp",
                                    "dp_vs_dp", "replica_checks",
                                    "replicas_unequal", "k4_vs_plain")
                if k in rec}}), flush=True)
            for cmp in ("eager_vs_dp", "replayed_vs_dp", "dp_vs_dp"):
                for e in rec[cmp]:
                    for k in ("loss_err", "update_err", "exp3_err"):
                        key = f"{kind}.{cmp}.{k}"
                        worst[key] = max(worst.get(key, 0.0), e.get(k, 0.0))
    print(json.dumps({"worst": worst}), flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
