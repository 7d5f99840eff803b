#!/usr/bin/env python3
"""Repeats ``chip_smoke.py``'s ``sharded_path`` comparison N times on one
card, beside its floors, to find where a sharded step parts from its fused
twin and how far:

    python3 tools/sharded_gate_probe.py [N]      # default 3

Each run is the phase's own: the main path's configuration (the
Reddit-shaped graph, batch 256, fan-outs 4096/2048/1024, SAGE-256 x3,
poisson-bandit, the caps refit from a 13-step pilot) through
``make_sharded_train_step`` on a one-rank NCCL mesh, 13 counted eager
steps, then 3 eager steps and 3 replays of the captured chained step, each
held against a fused eager twin loaded with the same state
(``parallel_step_run`` with no gate). Beside it, the floors of the same
run: two fused eager twins against each other, and the fused chained step
replayed against its eager twin (``replayed_steps``' lockstep). Every
comparison records its loss and update errors, whether the loss agreed to
the bit (the forward pass) and the parameters whose updates parted, each
with its share of the update's norm. One JSON line a run; the last line is
the card's name and power limit."""
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from bliss_gnn_tpu_torch.ops import _build
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
    from bliss_gnn_tpu_torch.ops.gather import lut_gather
    from bliss_gnn_tpu_torch.ops.scatter import scatter_add
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.parallel.shardedstep import (
        ShardedDeviceGraph,
        init_exp3_shard,
        make_sharded_multi_train_step,
        make_sharded_train_step,
        unshard_exp3,
    )
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan, CapacityPolicy
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )
    from bliss_gnn_tpu_torch.train.steps import make_train_step

    if not torch.cuda.is_available():
        sys.exit("sharded_gate_probe: needs a CUDA card")
    n_runs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    wrappers = {"scatter_add": scatter_add, "lut_gather": lut_gather,
                "segment_sum": segment_sum, "exp3_apply": exp3_apply}
    graph, indptr_np, _ = cs.main_graph(torch, dev)
    deg_np = np.diff(indptr_np)
    L, E = len(cs.FANOUTS), graph.n_edges
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=cs.FANOUTS)
    plan = CapacityPlan.build(cs.BATCH, cs.FANOUTS, cs.N_NODES, E,
                              kind=cfg.kind, deg_std=float(deg_np.std()),
                              max_degree=int(deg_np.max()))
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, cs.N_NODES, cs.BATCH).astype(np.int32)).to(dev)
    smask = torch.ones(cs.BATCH, dtype=torch.bool, device=dev)
    # the pilot and the refit of the main path, by the program's policy
    n_pilot = cs.WARMUP_STEPS + cs.TIMED_STEPS
    policy = CapacityPolicy(n_pilot, max_degree=int(deg_np.max()))
    pilot = cs.fresh_fn(torch, graph, cfg, dev, 1)()
    step = make_train_step(graph, cfg, plan, False, device=dev)
    for _ in range(n_pilot):
        pilot, m = step(pilot, seeds, smask)
        policy.observe(m)
    change = policy.decide(plan, n_pilot)
    plan = plan if change is None else change[1]
    del pilot, step, m

    mesh = make_mesh(1, device=dev)
    sg = ShardedDeviceGraph.build(cs.host_view(graph, indptr_np),
                                  mesh, feature_dtype=torch.bfloat16)
    fused = make_train_step(graph, cfg, plan, False, device=dev)

    def new_twin():
        twin = cs.fresh_state(dev, graph, cfg,
                              init_exp3_weights(L, E, device=dev),
                              torch.Generator(device=dev).manual_seed(0))
        twin, _ = fused(twin, seeds, smask)
        return twin

    def exp3_of(s):
        w = s.exp3_weights
        return unshard_exp3(w[None], L, E) if w.dim() == 1 else w

    no_gate = {"loss": math.inf, "update": math.inf, "exp3": math.inf}
    for run in range(n_runs):
        state = cs.fresh_state(dev, graph, cfg,
                               init_exp3_shard(L, E, mesh),
                               mesh.generator(0))
        out, state = cs.parallel_step_run(
            "sharded", state,
            make_sharded_train_step(mesh, sg, cfg, plan, False),
            make_sharded_multi_train_step(mesh, sg, cfg, plan, False),
            fused, new_twin(), new_twin(), seeds, smask, wrappers, mesh,
            exp3_of, no_gate)
        del state
        replay, replay_one = cs.replayed_steps(torch, graph, cfg, plan, seeds,
                                               smask, seed=0)
        del replay_one
        torch.cuda.empty_cache()
        print(json.dumps({
            "run": run,
            "sharded_eager_vs_fused": out["eager_vs_fused"],
            "sharded_replayed_vs_fused": out["replayed_vs_fused"],
            "fused_eager_vs_fused_eager": out["fused_vs_fused"],
            "fused_replayed_vs_fused_eager":
                replay["replay_vs_eager_lockstep"]}), flush=True)
    mesh.close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
