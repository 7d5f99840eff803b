#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bliss_gnn_tpu_torch``) on one
NVIDIA GPU: builds the seven CUDA kernels from ``bliss_gnn_tpu_torch/csrc``,
checks small fused SAGE, GATv2 and GCN steps on the card against the CPU
path (and a SAGE step sampling ``full`` neighbourhoods), and small SAGE and
GATv2 steps replayed from a CUDA graph against eager steps on the card,
then drives five paths at the Reddit-shaped configuration (232,965 nodes,
114.8M edges with self-loops, 602 features, 41 classes; batch 256, fan-outs
4096/2048/1024):

    main_path  the fused poisson-bandit SAGE-256 x3 step: capacities refit
               from a pilot run and widened after an overflow; 3 warm-up
               and 10 timed eager steps (K1-K4); then the step replayed
               from a CUDA graph (``make_multi_train_step``: single
               replays, and a chain of 10 with one sync), then 3 more
               replays each held against an eager step from the same
               state; torch.profiler
               breakdowns of three more eager and three more replayed
               steps; then sampled validation (phase ``eval``: the eager
               eval step and a chained eval of 8 batches);
    gat_path   the fused step with GATv2 (hidden 256, heads 4/4/1) on the
               main path's final plan, from fresh arm weights (K1-K5),
               eager and replayed, profiles of both, and one more sampled
               step's layer-0 block (phase ``gat_call_sites``);
    gcn_path   the same with GCN-256 x3 (K1-K4), its eager step profiled;
    neighbor_path  SAGE-256 x3 with 10/10/10 uniform in-edges per dst
               (DGL's NeighborSampler fan-outs; the main path's batch),
               pilot and refit (K1-K3);
    inference  full-graph layerwise inference of the three trained models
               (K6 for SAGE and GCN, K7 for GATv2), one counted pass each
               timed per layer, then each checked against the plain
               aggregations on a CSC prefix of >= 4M edges;

then holds each kernel against its plain PyTorch version at the paths'
shapes (phase ``kernel``): K1 and K3 at each call site's shape, on the ids
of one more sampled step on the main path's final plan (phase
``call_sites``: the layer-0 block's valid edges and largest kept in-degree),
their sorted routes also against themselves (two calls, the same bits); K2
also with five tables in one launch; K4 bitwise on distinct indices and
within m - 1 bf16 ulps on an index repeated m times; K5 on uniform ids and
on that GATv2 block's ids, at both output dtypes, both routes also against
themselves. K1's and K3's ``launches`` count their route over the main
path's eager steps (K3's at the row's width), K5's over the GATv2 path's;
``launches_at_this_shape`` the row's own shape. The wrappers count in
Python, so a replayed step adds nothing to them.
Each kernel row carries ``ms`` (CUDA events around back-to-back wrapper
calls: the slower of the host's launch rate and the device) and
``device_ms`` (the same calls captured in a CUDA graph and replayed; also
for the library calls of K1-K6), for K2 and K4 the wrapper's host time
``host_us``, and for K6 and K7 the kernel launches of one wrapper call, as
its launch count moved (K6 launches once per column slice).

Then it drives the training harness (phase 7), each run with the launch
counts set to 0 before it and read after it:

    trainer    ``Trainer`` on the main path's configuration, from a host
               ``Graph`` of the Reddit-shaped CSC (random f32 features and
               labels, a 65/10/25 split): 3 eager pilot steps, the refit,
               20 chains of 10 steps replayed from one captured CUDA graph,
               one chained validation (11 chains of 8 batches and 3 eager),
               the best-state snapshot and checkpoint, ``restore_best`` and
               ``final_eval`` (K6); then the captured chained eval after a
               reseed against the eager eval step, ``load_checkpoint`` (the
               parameters and arm weights bit-equal to the best state) and
               3 chained steps through the trainer's captured step, each
               held against an eager twin loaded with the same state;
    cli_small  ``cli.main`` on synth-small, SAGE and GATv2 (2 layers,
               fan-outs 32,16, batch 64, 12 steps): the reference's metric
               series, final F1s in [0, 1] (K1-K4; K6 or K7);
    ttvf1      ``bench.py``'s time-to-validation-F1 protocol through the
               port's chained steps (synth-pubmed-hard, SAGE-256 x3,
               fan-outs 256/128/64, batch 1024, chains of 8, target 0.90),
               live bandit then frozen: steps to the target, whether each
               arm reached it, the frozen/live ratio; both arms must learn
               (validation F1 >= 0.85, finite losses).

Run from the root of a checkout:  python3 chip_smoke.py
Every phase prints one JSON line. The line before the last is the kernels'
summary, the last line the device record. Any failed check exits non-zero.
"""
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

N_NODES = 232_965
N_RAND_EDGES = 114_615_892  # directed edges; one self-loop per node is added
N_FEATS = 602
N_CLASSES = 41
BATCH = 256
FANOUTS = (4096, 2048, 1024)
HIDDEN = 256
GAT_HEADS = (4, 1)  # per hidden layer, at the output
PREFIX_EDGES = 4_000_000  # the CSC prefix the inference checks run on
WARMUP_STEPS, TIMED_STEPS = 3, 10
LOCKSTEP_STEPS = 3  # replayed steps held against eager twins, each path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
BF16_ULP = 2.0 ** -7


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def reddit_shaped_csc(seed=0):
    """The power-law graph of ``bench.py`` (degree sequence capped at 21k,
    hub degrees on random node ids, uniform srcs, one self-loop per node),
    built straight into CSC order: each dst's random in-edges in draw order,
    then its self-loop. Returns (indptr int64 [N+1], csc_src int32 [E])."""
    rng = np.random.default_rng(seed)
    e_rand = N_RAND_EDGES
    ranks = np.arange(1, N_NODES + 1, dtype=np.float64)
    wgt = ranks ** -0.8
    deg = np.minimum(wgt / wgt.sum() * e_rand, 21_000).astype(np.int64)
    deg[deg < 1] = 1
    while deg.sum() < e_rand:
        deficit = e_rand - deg.sum()
        deg = np.minimum(deg + np.minimum(deg, max(deficit // len(deg), 1)),
                         21_000)
    extra = deg.sum() - e_rand
    for i in range(N_NODES - 1, -1, -1):  # trim from the tail
        if extra <= 0:
            break
        cut = min(extra, deg[i] - 1)
        deg[i] -= cut
        extra -= cut
    node_of_rank = rng.permutation(N_NODES)
    src_rand = rng.integers(0, N_NODES, size=int(deg.sum()))  # rank order
    deg_node = np.empty(N_NODES, np.int64)
    deg_node[node_of_rank] = deg
    rank_off = np.cumsum(deg) - deg  # offset of each rank's draws
    off_node = np.empty(N_NODES, np.int64)
    off_node[node_of_rank] = rank_off
    indptr = np.zeros(N_NODES + 1, np.int64)
    np.cumsum(deg_node + 1, out=indptr[1:])
    n_edges = int(indptr[-1])
    csc_src = np.empty(n_edges, np.int32)
    loops = indptr[1:] - 1
    is_rand = np.ones(n_edges, bool)
    is_rand[loops] = False
    start_node = np.cumsum(deg_node) - deg_node  # among random edges
    take = (np.repeat(off_node - start_node, deg_node)
            + np.arange(int(deg.sum()), dtype=np.int64))
    csc_src[is_rand] = src_rand[take]
    csc_src[loops] = np.arange(N_NODES, dtype=np.int32)
    return indptr, csc_src


def time_ms(fn, reps, torch, warmup=2):
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA events
    around the calls: the slower of the host's issue rate and the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_time_ms(fn, torch, reps=20, replays=10):
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, the graph replayed ``replays`` times between two CUDA
    events. The host's issue rate drops out; the graph's gap between two
    kernels stays in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as required
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / (reps * replays)


def host_us(fn, torch, calls=1000):
    """Host time of one call of ``fn`` in microseconds: ``time.perf_counter``
    around ``calls`` calls with no sync between them. Python's cyclic
    garbage collector is paused meanwhile: one full collection of this
    process's heap would add tens of microseconds to every call's mean."""
    fn()
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return dt / calls * 1e6


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "bliss_gnn_tpu_torch", "csrc")):
        fail("run from a checkout: bliss_gnn_tpu_torch/ is missing")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, here)
    from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD, DeviceGraph
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.ops import _build
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
    from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention
    from bliss_gnn_tpu_torch.ops.gather import lut_gather
    from bliss_gnn_tpu_torch.ops.rowscatter import row_scatter_add
    from bliss_gnn_tpu_torch.ops.scatter import scatter_add
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum
    from bliss_gnn_tpu_torch.ops.spmm import spmm
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
        sample_blocks,
    )
    from bliss_gnn_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {"scatter_add": scatter_add, "lut_gather": lut_gather,
                "segment_sum": segment_sum, "exp3_apply": exp3_apply,
                "row_scatter_add": row_scatter_add, "spmm": spmm,
                "gat_attention": gat_attention}
    step_kernels = ("scatter_add", "lut_gather", "segment_sum", "exp3_apply")

    # -- phase 1: device and build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not smi_line:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi_line, flush=True)
    emit({"phase": "device", "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    build_s = _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    emit({"phase": "build", "seconds": round(build_s, 2),
          "kernels": sorted(_build.SIGNATURES)})

    # -- phase 2: small fused steps, card against the CPU path; replayed
    # steps against eager ones ---------------------------------------------
    for name in ("sage", "gat", "gcn"):
        small_step_check(torch, dev, name)
    small_step_check(torch, dev, "sage", kind="full")
    for name in ("sage", "gat"):
        small_replay_check(torch, dev, name)

    # -- phase 3a: graph and plan ----------------------------------------
    t0 = time.perf_counter()
    indptr_np, csc_src_np = reddit_shaped_csc()
    n_edges = int(csc_src_np.shape[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    indptr = torch.from_numpy(indptr_np.astype(np.int32)).to(dev)
    csc_src = torch.zeros(n_edges + EDGE_PAD, dtype=torch.int32, device=dev)
    csc_src[:n_edges] = torch.from_numpy(csc_src_np).to(dev)
    deg = (indptr[1:] - indptr[:-1]).long()
    w = torch.zeros(n_edges + EDGE_PAD, dtype=torch.bfloat16, device=dev)
    w[:n_edges] = (1.0 / deg.clamp(min=1).float()).repeat_interleave(
        deg, output_size=n_edges).to(torch.bfloat16)
    # the samplers walk the CSC only; of the CSR, GCN's norm reads the
    # out-degrees
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    graph = DeviceGraph(
        csc_indptr=indptr, csc_src=csc_src,
        csr_indptr=out_indptr(torch, csc_src[:n_edges], N_NODES),
        csr_dst=dummy, csr_eid=dummy,
        ndata={"features": torch.randn((N_NODES, N_FEATS), generator=gen,
                                       device=dev, dtype=torch.bfloat16),
               "labels": torch.randint(0, N_CLASSES, (N_NODES,),
                                       generator=gen, device=dev)},
        edata={"w": w}, n_nodes=N_NODES, n_edges=n_edges)
    deg_np = np.diff(indptr_np)
    del csc_src_np
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=FANOUTS)
    plan = CapacityPlan.build(BATCH, FANOUTS, N_NODES, n_edges, kind=cfg.kind,
                              deg_std=float(deg_np.std()),
                              max_degree=int(deg_np.max()))
    del gen
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, N_NODES, BATCH).astype(np.int32)).to(dev)
    smask = torch.ones(BATCH, dtype=torch.bool, device=dev)
    n_steps = WARMUP_STEPS + TIMED_STEPS

    def train(step_plan, seed, widen=False, cfg=cfg):
        """``n_steps`` fused steps from fresh weights and arm weights, of
        the model ``cfg.model``. With ``widen``, a step whose frontier or
        kept edges overflowed their caps widens the plan by 1.5x for the
        next step, as the reference trainer does after a refit. Returns
        the last plan too."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = build_model(cfg.model, N_FEATS, HIDDEN, N_CLASSES,
                            len(FANOUTS), num_in_heads=GAT_HEADS[0],
                            num_out_heads=GAT_HEADS[1], device=dev, seed=seed)
        opt, sched = make_optimizer(model.parameters(), 2e-3, 100)
        exp3 = (init_exp3_weights(len(cfg.fanouts), n_edges, device=dev)
                if cfg.is_bandit else None)
        state = TrainState(model, opt, sched, exp3, gen)
        step = make_train_step(graph, cfg, step_plan, False, device=dev)
        times, log = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            state, m = step(state, seeds, smask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            log.append(m)
            over = {k for l in range(len(cfg.fanouts))
                    for k in ("frontier_overflow", "block_edge_overflow")
                    if int(m[f"layer{l}/{k}"]) > 0}
            if widen and over:
                step_plan = step_plan.widen(
                    1.5, frontier="frontier_overflow" in over)
                step = make_train_step(graph, cfg, step_plan, False,
                                       device=dev)
        return state, step, times, log, step_plan

    # pilot: as many steps as the counted run, at the a-priori caps; the
    # frontier grows while the bandit learns, so refit from the maxima
    *_, pilot, _ = train(plan, seed=1)
    fr = [max(int(m[f"layer{l}/frontier_edges"]) for m in pilot)
          for l in range(3)]
    be = [max(int(m[f"layer{l}/n_block_edges_true"]) for m in pilot)
          for l in range(3)]
    tight = plan.refit(fr, be, max_degree=int(deg_np.max()))
    emit({"phase": "graph", "n_nodes": N_NODES, "n_edges": n_edges,
          "n_feats": N_FEATS, "max_degree": int(deg_np.max()),
          "seconds": round(graph_s, 2), "pilot_steps": len(pilot),
          "pilot_frontier_edges": fr, "pilot_block_edges": be,
          "prior_frontier_caps": plan.frontier_caps,
          "frontier_caps": tight.frontier_caps,
          "block_e_caps": tight.block_e_caps, "dst_caps": tight.dst_caps,
          "cand_caps": tight.cand_caps, "dense_cands": tight.dense_cands})
    del pilot

    # -- phase 3b: the main path, counted --------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    state, step, times, metrics_log, final = train(tight, seed=0, widen=True)
    launches = {name: wrappers[name].launches for name in step_kernels}
    # K1's and K3's launches by route and input shape (call site)
    by_shape = {name: dict(wrappers[name].launches_by_shape)
                for name in ("scatter_add", "segment_sum")}
    peak = torch.cuda.max_memory_allocated()
    step_ms = times[WARMUP_STEPS:]
    step_med = statistics.median(step_ms)
    losses = [float(m["train_loss"]) for m in metrics_log]
    samp_ms = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        sample_blocks(graph, cfg, final, state.generator, seeds, smask,
                      state.exp3_weights)
        torch.cuda.synchronize()
        samp_ms.append((time.perf_counter() - t0) * 1e3)
    last = metrics_log[-1]
    overflow = {k: max(int(m[k]) for m in metrics_log)
                for k in last if "overflow" in k}
    replay, replay_one = replayed_steps(torch, graph, cfg, final, seeds,
                                        smask, seed=0)
    emit({"phase": "main_path", "steps": n_steps,
          "step_ms": step_med,
          "step_ms_all": step_ms,
          "sampling_ms": statistics.median(samp_ms),
          "loss": losses, "launches": launches,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "launches_per_step_by_shape": {
              k: {s: v / n_steps for s, v in d.items()}
              for k, d in by_shape.items()},
          "overflow": overflow,
          "steps_overflowed": sum(
              any(int(v) > 0 for k, v in m.items()
                  if "frontier_overflow" in k or "block_edge_overflow" in k)
              for m in metrics_log),
          "final_frontier_caps": final.frontier_caps,
          "final_block_e_caps": final.block_e_caps,
          "num_edges": [int(last[f"num_edges/{l}"]) for l in range(3)],
          "num_nodes": [int(last[f"num_nodes/{l}"]) for l in range(4)],
          "peak_memory_bytes": peak, **replay, "nvidia_smi": smi_line})
    if not all(math.isfinite(x) for x in losses + replay["replayed_loss"]):
        fail(f"non-finite loss {losses} {replay['replayed_loss']}")
    missing = [k for k, v in launches.items() if v <= 0]
    missing += [f"{k} {route}" for k, d in by_shape.items()
                for route in ("sorted", "unsorted")
                if not any(s.startswith(route + " ") for s in d)]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    profile_steps(torch, lambda: step(state, seeds, smask), step_med,
                  smi_line)
    profile_steps(torch, replay_one, replay["replayed_step_ms"], smi_line,
                  mode="replayed")
    del replay_one
    torch.cuda.empty_cache()
    eval_phase(torch, graph, cfg, final, state, smi_line)
    sites = call_site_inputs(torch, graph, cfg, final, state.exp3_weights,
                             seeds, smask)
    emit({"phase": "call_sites", "plan_block_e_caps": final.block_e_caps,
          **{k: v for k, v in sites.items()
             if not isinstance(v, torch.Tensor)}})
    sage_model = state.model
    del state, step, metrics_log
    torch.cuda.empty_cache()

    def model_path(name, seed):
        """The counted fused step of ``name`` on the main path's final
        plan, from fresh weights and arm weights: its phase line and
        checks; for GATv2 also its profile and one more sampled step's
        ids. Returns the trained model, the last plan, K5's launches by
        route and shape, and those ids (None but for GATv2)."""
        mcfg = SamplerConfig(kind=cfg.kind, fanouts=FANOUTS, model=name)
        kernels = step_kernels + (("row_scatter_add",) if name == "gat"
                                  else ())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        mstate, mstep, mtimes, mlog, mfinal = train(final, seed=seed,
                                                    widen=True, cfg=mcfg)
        mlaunches = {k: wrappers[k].launches for k in kernels}
        # K5's launches by route and input shape (call site)
        mby_shape = dict(row_scatter_add.launches_by_shape)
        mpeak = torch.cuda.max_memory_allocated()
        msamp_ms = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            sample_blocks(graph, mcfg, mfinal, mstate.generator, seeds, smask,
                          mstate.exp3_weights)
            torch.cuda.synchronize()
            msamp_ms.append((time.perf_counter() - t0) * 1e3)
        mlosses = [float(m["train_loss"]) for m in mlog]
        moverflow = {k: max(int(m[k]) for m in mlog)
                     for k in mlog[-1] if "overflow" in k}
        mreplay, mreplay_one = replayed_steps(torch, graph, mcfg, mfinal,
                                              seeds, smask, seed=seed)
        extra = {"heads": [GAT_HEADS[0]] * (len(FANOUTS) - 1)
                 + [GAT_HEADS[1]],
                 "row_scatter_add_launches_per_step_by_shape": {
                     k: v / n_steps for k, v in mby_shape.items()}
                 } if name == "gat" else {}
        emit({"phase": f"{name}_path", "steps": n_steps, **extra,
              f"{name}_step_ms": statistics.median(mtimes[WARMUP_STEPS:]),
              f"{name}_step_ms_all": mtimes[WARMUP_STEPS:],
              "sampling_ms": statistics.median(msamp_ms),
              "loss": mlosses, "launches": mlaunches,
              "launches_per_step": {k: v / n_steps
                                    for k, v in mlaunches.items()},
              "overflow": moverflow,
              "steps_overflowed": sum(
                  any(int(v) > 0 for k, v in m.items()
                      if "frontier_overflow" in k
                      or "block_edge_overflow" in k)
                  for m in mlog),
              "final_block_e_caps": mfinal.block_e_caps,
              "peak_memory_bytes": mpeak, **mreplay, "nvidia_smi": smi_line})
        if not all(math.isfinite(x)
                   for x in mlosses + mreplay["replayed_loss"]):
            fail(f"{name}_path: non-finite loss {mlosses} "
                 f"{mreplay['replayed_loss']}")
        missing = [k for k in kernels if mlaunches[k] <= 0]
        if name == "gat":
            missing += [f"row_scatter_add {route}"
                        for route in ("sorted", "unsorted")
                        if route_launches(mby_shape, route) <= 0]
        if missing:
            fail(f"kernels not launched on the {name} path: {missing}")
        msites = None
        profile_steps(torch, lambda: mstep(mstate, seeds, smask),
                      statistics.median(mtimes[WARMUP_STEPS:]), smi_line,
                      model=name)
        if name == "gat":
            profile_steps(torch, mreplay_one, mreplay["replayed_step_ms"],
                          smi_line, model=name, mode="replayed")
        del mreplay_one
        torch.cuda.empty_cache()
        if name == "gat":
            # the ids K5 sees: one more sampled step on the GATv2 plan
            msites = call_site_inputs(torch, graph, mcfg, mfinal,
                                      mstate.exp3_weights, seeds, smask)
            emit({"phase": "gat_call_sites",
                  "plan_block_e_caps": mfinal.block_e_caps,
                  **{k: v for k, v in msites.items()
                     if not isinstance(v, torch.Tensor)}})
        model = mstate.model
        del mstate, mstep, mlog
        torch.cuda.empty_cache()
        return model, mfinal, mby_shape, msites

    # -- phase 4: the fused GATv2 and GCN steps on the final plan ---------
    gat_model, gfinal, gby_shape, gsites = model_path("gat", seed=2)
    gcn_model, *_ = model_path("gcn", seed=3)

    # -- phase 4b: SAGE with DGL's per-dst neighbor sampling --------------
    neighbor_path(torch, train, graph, deg_np, wrappers, seeds, smask,
                  smi_line)

    # -- phase 5: full-graph layerwise inference --------------------------
    layer_launches = inference_phase(
        torch, graph, indptr_np,
        {"sage": sage_model, "gcn": gcn_model, "gat": gat_model}, wrappers,
        smi_line)

    # -- phase 6: each kernel against its plain version -------------------
    del sage_model, gcn_model, gat_model
    torch.cuda.empty_cache()
    rows = kernel_checks(torch, dev, final, n_edges, launches, sites,
                         by_shape)
    rows += wide_kernel_checks(torch, dev, gfinal, graph, indptr_np,
                               gby_shape, gsites, layer_launches)

    # -- phase 7: the trainer, the CLI, time to validation F1 -------------
    workdir = os.path.join(here, "build", "chip_smoke_runs")
    shutil.rmtree(workdir, ignore_errors=True)
    host_graph, host_s = host_graph_from(torch, graph, N_CLASSES)
    del graph
    gc.collect()
    torch.cuda.empty_cache()
    trainer_phase(torch, dev, host_graph, N_CLASSES, wrappers, smi_line,
                  workdir, host_s=host_s)
    del host_graph
    gc.collect()
    cli_phase(torch, dev, wrappers, smi_line, workdir)
    ttvf1_phase(torch, dev, wrappers, smi_line)
    shutil.rmtree(workdir, ignore_errors=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def reset_counts(wrappers):
    """Sets every wrapper's launch count, and K1's and K3's counts by
    shape, to 0."""
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape = {}


def call_site_inputs(torch, graph, cfg, plan, exp3, seeds, smask, seed=5):
    """The inputs of K1's and K3's sorted and unsorted call sites, from one
    more sampled step on ``plan`` with the arm weights ``exp3``: the layer-0
    and output-layer blocks' edge lists (``e_dst`` sorted, ``e_src`` not)
    with their valid prefixes and dst and src caps, and the layer-0
    frontier's chunk owners (sorted) with the valid chunk count. Also the
    layer-0 and output-layer blocks' largest kept in-degrees, the skew the
    sorted routes see.
    Ints are plain ints (host syncs: this is set-up)."""
    from bliss_gnn_tpu_torch.sampling.frontier import gather_in_edges
    from bliss_gnn_tpu_torch.sampling.samplers import sample_blocks

    gen = torch.Generator(device=seeds.device).manual_seed(seed)
    blocks, _ = sample_blocks(graph, cfg, plan, gen, seeds, smask, exp3)
    out = {}
    for tag, b in (("0", blocks[0]), ("out", blocks[-1])):
        out.update({f"e_dst{tag}": b.e_dst, f"e_src{tag}": b.e_src,
                    f"nv{tag}": int(b.n_valid_edges()),
                    f"n_dst{tag}": b.n_dst_cap, f"n_src{tag}": b.n_src_cap})
    fr = gather_in_edges(graph.csc_indptr, graph.csc_src, blocks[1].src_gids,
                         blocks[1].src_mask, plan.frontier_caps[0])
    deg = blocks[0].in_degrees()
    out.update(owner0=fr.chunk_owner,
               n_chunks0=int(fr.chunk_valid.sum(dtype=torch.int32)),
               chunk_edges0=fr.ck, max_in_degree0=int(deg.max()),
               dsts_with_edges0=int((deg > 0).sum()),
               max_in_degree_out=int(blocks[-1].in_degrees().max()))
    return out


def profile_steps(torch, run, step_ms, smi_line, model="sage", n=3,
                  mode="eager"):
    """``torch.profiler`` over ``n`` calls of ``run``, each one fused step
    of ``model`` (``mode``: eager, or replayed from its CUDA graph), after
    its counted run. Prints the device time per step by kernel, its share
    of the profiled wall time and of the unprofiled median step time, and
    the time of the index backwards (``indexing_backward*`` kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for evt in prof.key_averages():
        if (not str(evt.device_type).endswith("CUDA")
                or getattr(evt, "is_user_annotation", False)):
            continue  # annotations span kernels already counted
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / n / 1e3, evt.count / n, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    index_ms = sum(r[0] for r in rows if "indexing_backward" in r[2])
    emit({"phase": "profile", "model": model, "mode": mode, "steps": n,
          "wall_ms_per_step": wall_ms,
          "device_ms_per_step": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "device_share_of_step_ms": device_ms / step_ms,
          "device_ops_per_step": sum(r[1] for r in rows),
          "indexing_backward_ms_per_step": index_ms,
          "indexing_backward_share_of_device": index_ms / max(device_ms,
                                                              1e-9),
          "top": [{"ms": a, "calls": c, "name": k[:90]}
                  for a, c, k in rows[:20]],
          "nvidia_smi": smi_line})
    if device_ms <= 0:
        fail(f"profile ({model}, {mode}): no device time recorded")


def load_train_state(torch, dst, src):
    """Copies ``src``'s training state into ``dst`` (built alike, its Adam
    state made by a step already): parameters, Adam's moments, step counts
    and rate, the schedule's place, the arm weights and the generator."""
    with torch.no_grad():
        for p, q in zip(dst.model.parameters(), src.model.parameters()):
            p.copy_(q)
            for k, v in src.optimizer.state[q].items():
                dst.optimizer.state[p][k].copy_(v)
        if src.exp3_weights is not None:
            dst.exp3_weights.copy_(src.exp3_weights)
    dst.scheduler.load_state_dict(src.scheduler.state_dict())
    dst.generator.set_state(src.generator.get_state())
    dst.step = src.step


LOCKSTEP_TOLERANCE = {"loss": 2.0 ** -7, "update": 2.0 ** -4,
                      "exp3": 2.0 ** -6}


def lockstep(torch, state, multi, twin, eager_step, seeds, smask, label):
    """LOCKSTEP_STEPS chained steps of ``multi`` (one batch each) on
    ``state``, each held against an eager step of ``twin`` (built alike,
    its Adam state made by a step already) loaded with ``state`` just
    before: the same weights, Adam state, arm weights and generator, so the
    same blocks and dropout masks. The loss within 2^-7 of max(|loss|, 1),
    the parameter update within 2^-4 of the eager update's norm, the arm
    weights within 2^-6 (a few bf16 ulps); fails otherwise. Returns the
    errors."""
    s1, m1 = seeds[None], smask[None]
    lock = []
    for _ in range(LOCKSTEP_STEPS):
        load_train_state(torch, twin, state)
        pre = [p.detach().clone() for p in state.model.parameters()]
        twin, me = eager_step(twin, seeds, smask)
        state, mr = multi(state, s1, m1)
        d_e = torch.cat([(p.detach() - q).flatten().float() for p, q in
                         zip(twin.model.parameters(), pre)])
        d_r = torch.cat([(p.detach() - q).flatten().float() for p, q in
                         zip(state.model.parameters(), pre)])
        le, lr_ = float(me["train_loss"]), float(mr["train_loss"][0])
        rec = {"loss_eager": le, "loss_replayed": lr_,
               "loss_err": abs(lr_ - le) / max(abs(le), 1.0),
               "update_norm": float(d_e.norm()),
               "update_err": float((d_r - d_e).norm()
                                   / d_e.norm().clamp(min=1e-30))}
        if state.exp3_weights is not None:
            w_e, w_r = twin.exp3_weights.float(), state.exp3_weights.float()
            rec["exp3_err"] = float(((w_r - w_e).abs()
                                     / w_e.abs().clamp(min=1e-30)).max())
        lock.append(rec)
        del pre, d_e, d_r
    tol = LOCKSTEP_TOLERANCE
    bad = [r for r in lock
           if not (r["loss_err"] <= tol["loss"]
                   and r["update_err"] <= tol["update"]
                   and r.get("exp3_err", 0.0) <= tol["exp3"]
                   and r["update_norm"] > 0)]
    if bad:
        fail(f"{label}: replayed steps differ from eager steps from the "
             f"same state: {lock}")
    return lock


def replayed_steps(torch, graph, cfg, plan, seeds, smask, seed):
    """The fused step of ``cfg.model`` on ``plan`` replayed from a CUDA
    graph by one chained step (``make_multi_train_step``), from fresh
    weights and arm weights and a capturable Adam: chains of one step, the
    warm-ups and the capture, then TIMED_STEPS single replays, each
    followed by a sync, then one chain of TIMED_STEPS with one sync at its
    end. Then LOCKSTEP_STEPS more replays, each held against an eager step
    of a twin state loaded with the replayed state just before (the same
    weights, Adam state, arm weights and generator, so the same blocks and
    dropout masks): the losses within 2^-7 of max(|loss|, 1), the step's
    parameter update within 2^-4 of the eager update's norm, the arm
    weights within 2^-6 (a few bf16 ulps). Free-running eager and replayed
    runs cannot be held so: the unsorted K1 and K3 sums add with atomics
    in a varying order, and the bandit's sampling carries the last bits
    into other blocks within a few steps. Returns the median single
    replay, the chained time per step, the peak memory with the graph's
    pool, the losses and the lockstep errors, and a function that replays
    one more step (the profile's)."""
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights
    from bliss_gnn_tpu_torch.train.steps import (
        CAPTURE_WARMUP_STEPS,
        TrainState,
        make_multi_train_step,
        make_optimizer,
        make_train_step,
    )

    dev = seeds.device

    def fresh():
        model = build_model(cfg.model, N_FEATS, HIDDEN, N_CLASSES,
                            len(cfg.fanouts), num_in_heads=GAT_HEADS[0],
                            num_out_heads=GAT_HEADS[1], device=dev,
                            seed=seed)
        opt, sched = make_optimizer(model.parameters(), 2e-3, 100,
                                    capturable=True)
        exp3 = (init_exp3_weights(len(cfg.fanouts), graph.n_edges,
                                  device=dev) if cfg.is_bandit else None)
        return TrainState(model, opt, sched, exp3,
                          torch.Generator(device=dev).manual_seed(seed))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    multi = make_multi_train_step(graph, cfg, plan, False, device=dev)
    s1, m1 = seeds[None], smask[None]
    losses = []
    for _ in range(CAPTURE_WARMUP_STEPS + 1):  # warm-ups, then the capture
        state, m = multi(state, s1, m1)
        losses.append(m["train_loss"])
    torch.cuda.synchronize()
    single = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = multi(state, s1, m1)
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["train_loss"])
    sk, mk = seeds.expand(TIMED_STEPS, -1), smask.expand(TIMED_STEPS, -1)
    t0 = time.perf_counter()
    state, m = multi(state, sk, mk)
    torch.cuda.synchronize()
    chained = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    losses.append(m["train_loss"])
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())

    # lockstep: the twin's first step makes its Adam state
    twin, eager_step = fresh(), make_train_step(graph, cfg, plan, False,
                                                device=dev)
    twin, _ = eager_step(twin, seeds, smask)
    lock = lockstep(torch, state, multi, twin, eager_step, seeds, smask,
                    cfg.model)
    del twin, eager_step
    torch.cuda.empty_cache()
    out = {"replayed_step_ms": statistics.median(single),
           "replayed_step_ms_all": single,
           "chained_step_ms": chained,
           "replayed_loss": torch.cat(losses).tolist(),
           "replay_steps": state.step,
           "replay_peak_memory_bytes": peak[0],
           "replay_peak_reserved_bytes": peak[1],
           "replay_vs_eager_lockstep": lock,
           "replay_vs_eager_tolerance": LOCKSTEP_TOLERANCE}

    def replay_one():
        multi(state, s1, m1)

    return out, replay_one


def eval_phase(torch, graph, cfg, plan, state, smi_line, n_batches=8):
    """Sampled validation of the trained main-path state on ``plan``: the
    eager eval step (median of 5 calls, each followed by a sync) and a
    chained eval of ``n_batches`` batches of BATCH random seeds
    (``make_multi_eval_step``: the first chain warms up, captures and
    replays; the second, timed with one sync, only replays). The arm
    weights must come out bit-equal, and the counts whole."""
    from bliss_gnn_tpu_torch.train.steps import (
        make_eval_step,
        make_multi_eval_step,
    )

    dev = graph.device
    exp3 = state.exp3_weights.clone()
    one = make_eval_step(graph, cfg, plan, False, device=dev)
    multi = make_multi_eval_step(graph, cfg, plan, False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    bseeds = torch.from_numpy(np.random.default_rng(21).integers(
        0, N_NODES, (n_batches, BATCH)).astype(np.int32)).to(dev)
    bmask = torch.ones((n_batches, BATCH), dtype=torch.bool, device=dev)
    eager = []
    for i in range(5):
        t0 = time.perf_counter()
        f1, loss_n, n = one(state, gen, bseeds[i], bmask[i])
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    f1, loss_n, n = multi(state, gen, bseeds, bmask)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    f1, loss_n, n = multi(state, gen, bseeds, bmask)
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(state.exp3_weights, exp3)
    rec = {"phase": "eval", "batches": n_batches,
           "eval_step_ms": statistics.median(eager),
           "eval_step_ms_all": eager,
           "chained_eval_ms_first_with_capture": first_ms,
           "chained_eval_ms": chain_ms,
           "chained_eval_ms_per_batch": chain_ms / n_batches,
           "n": int(n), "f1_total": float(f1.total),
           "accuracy": float(f1.tp) / max(float(f1.total), 1.0),
           "mean_loss": float(loss_n) / max(int(n), 1),
           "arm_weights_bit_equal": same, "nvidia_smi": smi_line}
    emit(rec)
    if not same:
        fail("eval changed the arm weights")
    if int(n) != n_batches * BATCH or float(f1.total) != int(n):
        fail(f"eval counted {int(n)} seeds, {float(f1.total)} in F1, of "
             f"{n_batches * BATCH}")
    if not math.isfinite(rec["mean_loss"]):
        fail(f"eval: non-finite loss {rec['mean_loss']}")


def neighbor_path(torch, train, graph, deg_np, wrappers, seeds, smask,
                  smi_line):
    """SAGE-256 x3 with DGL's per-dst neighbor sampling at its fan-outs,
    10/10/10 in-edges per dst (``examples/pytorch/graphsage/
    node_classification.py``'s ``NeighborSampler([10, 10, 10])``; that
    example's batch is 1024, this phase keeps the main path's BATCH), on
    the Reddit-shaped graph: a pilot at the a-priori caps, a refit, then the counted run
    (K1-K3; no EXP3, so no K4), its sampling alone, finite losses, and a
    profile of three more steps."""
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        sample_blocks,
    )

    fanouts = (10, 10, 10)
    ncfg = SamplerConfig(kind="neighbor", fanouts=fanouts)
    plan = CapacityPlan.build(BATCH, fanouts, graph.n_nodes, graph.n_edges,
                              kind=ncfg.kind, deg_std=float(deg_np.std()),
                              max_degree=int(deg_np.max()))
    *_, pilot, _ = train(plan, seed=4, cfg=ncfg)
    fr = [max(int(m[f"layer{l}/frontier_edges"]) for m in pilot)
          for l in range(3)]
    be = [max(int(m[f"layer{l}/n_block_edges_true"]) for m in pilot)
          for l in range(3)]
    tight = plan.refit(fr, be, max_degree=int(deg_np.max()))
    del pilot
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    state, step, times, log, final = train(tight, seed=4, widen=True,
                                           cfg=ncfg)
    kernels = ("scatter_add", "lut_gather", "segment_sum")
    launches = {k: wrappers[k].launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    samp_ms = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        sample_blocks(graph, ncfg, final, state.generator, seeds, smask)
        torch.cuda.synchronize()
        samp_ms.append((time.perf_counter() - t0) * 1e3)
    losses = [float(m["train_loss"]) for m in log]
    last = log[-1]
    emit({"phase": "neighbor_path", "fanouts": fanouts, "steps": len(log),
          "step_ms": statistics.median(times[WARMUP_STEPS:]),
          "step_ms_all": times[WARMUP_STEPS:],
          "sampling_ms": statistics.median(samp_ms), "loss": losses,
          "launches_per_step": {k: v / len(log) for k, v in launches.items()},
          "overflow": {k: max(int(m[k]) for m in log)
                       for k in last if "overflow" in k},
          "pilot_frontier_edges": fr, "pilot_block_edges": be,
          "frontier_caps": final.frontier_caps,
          "block_e_caps": final.block_e_caps, "dst_caps": final.dst_caps,
          "num_edges": [int(last[f"num_edges/{l}"]) for l in range(3)],
          "num_nodes": [int(last[f"num_nodes/{l}"]) for l in range(4)],
          "peak_memory_bytes": peak, "nvidia_smi": smi_line})
    if not all(math.isfinite(x) for x in losses):
        fail(f"neighbor_path: non-finite loss {losses}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched on the neighbor path: {missing}")
    profile_steps(torch, lambda: step(state, seeds, smask),
                  statistics.median(times[WARMUP_STEPS:]), smi_line,
                  mode="eager, neighbor 10/10/10")
    del state, step
    torch.cuda.empty_cache()


def kernel_origins(prof, pattern):
    """Where the device kernels whose names contain ``pattern`` come from,
    in a profile taken with ``with_stack=True`` and ``record_shapes=True``:
    the op that launched each and its input shapes, the autograd node that
    op ran in, and the forward op that node differentiates (matched by
    sequence number) with its package frames. One record per origin, with
    its kernels' calls and device ms, largest first."""
    events = sorted(prof.events(), key=lambda e: e.time_range.start)

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    forward = {}  # sequence number -> the forward op, the first event
    for e in events:
        if e.name.startswith("aten::") and e.sequence_nr >= 0:
            forward.setdefault(e.sequence_nr, e)
    origins = {}
    for e in events:
        hits = [k for k in getattr(e, "kernels", ()) if pattern in k.name]
        if not hits:
            continue
        node = next((p for p in ancestors(e) if p.name.endswith("Backward0")),
                    None)
        fwd = forward.get(node.sequence_nr) if node is not None else None
        frames = [p.name for p in ancestors(fwd or e)]
        frames += list(getattr(fwd or e, "stack", None) or ())
        frames = tuple(f for f in frames if "bliss_gnn_tpu_torch" in f)
        for k in hits:
            key = (k.name[:90], e.name, str(e.input_shapes),
                   node.name if node else None,
                   fwd.name if fwd else None, frames)
            rec = origins.setdefault(key, [0, 0.0])
            rec[0] += 1
            rec[1] += k.duration / 1e3
    return sorted(({"kernel": k[0], "launched_by": k[1], "input_shapes": k[2],
                    "backward_of": k[3], "forward_op": k[4],
                    "forward_frames": list(k[5]), "calls": c,
                    "device_ms": ms}
                   for k, (c, ms) in origins.items()),
                  key=lambda r: -r["device_ms"])


def small_graph(torch):
    """The small steps' graph: 3,000 nodes, 60,000 edges, 64 features, 7
    classes."""
    from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
    from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata

    g, n_cls, _ = synthetic_graph(3000, 60000, 64, 7, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    return g, n_cls


def small_step_check(torch, dev, model_name, kind="poisson-bandit"):
    """Three fused steps of ``model_name`` at a small size on the card
    (kernels) and on the CPU (plain versions), from the same weights and
    the same draws: the blocks must be identical, the losses, parameters
    and arm weights close (bf16 compute; rtol 2e-2). ``kind="full"`` takes
    every in-edge of every dst (two full hops) and draws nothing."""
    from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig, init_exp3_weights, sample_blocks)
    from bliss_gnn_tpu_torch.train.steps import (
        TrainState, make_optimizer, make_train_step)

    g, n_cls = small_graph(torch)
    cfg = SamplerConfig(kind=kind, fanouts=(256, 128), model=model_name)
    plan = CapacityPlan.build(32, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind, dense_candidates=False)
    draws_gen = torch.Generator().manual_seed(4)
    draws = [[torch.rand(c, generator=draws_gen) for c in plan.cand_caps]
             if kind != "full" else None for _ in range(3)]

    def on(d, x):
        return None if x is None else [t.to(d) for t in x]

    seeds = torch.arange(32, dtype=torch.int32)
    smask = torch.ones(32, dtype=torch.bool)
    out = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        dg = DeviceGraph.from_graph(g, device=d)
        model = build_model(model_name, 64, 32, n_cls, 2, dropout=0.0,
                            attn_drop=0.0, device=d)
        opt, sched = make_optimizer(model.parameters(), 1e-3, 10)
        st = TrainState(model, opt, sched,
                        init_exp3_weights(2, g.n_edges, device=d),
                        torch.Generator(device=d).manual_seed(0))
        step = make_train_step(dg, cfg, plan, False, device=d)
        blocks = sample_blocks(dg, cfg, plan, None, seeds.to(d), smask.to(d),
                               st.exp3_weights, draws=on(d, draws[0]))[0]
        losses = []
        for k in range(3):
            st, m = step(st, seeds.to(d), smask.to(d),
                         draws=on(d, draws[k]))
            losses.append(float(m["train_loss"]))
        out[where] = dict(
            eids=[b.eid.cpu() for b in blocks], losses=losses,
            params={k: v.detach().float().cpu()
                    for k, v in model.state_dict().items()},
            exp3=st.exp3_weights.float().cpu())
    c, k = out["cpu"], out["cuda"]
    same_blocks = all(torch.equal(a, b) for a, b in zip(c["eids"], k["eids"]))
    loss_err = max(abs(a - b) / max(abs(b), 1e-6)
                   for a, b in zip(k["losses"], c["losses"]))
    # Adam moves a parameter by about lr per step whatever the gradient's
    # size, so a near-zero gradient whose sign differs between the bf16
    # paths moves it by up to 2 lr a step: the parameters are held to
    # 2e-2 relative plus 2.5 lr per step (the ratio below must stay <= 1)
    param_err = max(((k["params"][n] - c["params"][n]).abs()
                     / (2e-2 * c["params"][n].abs() + 2.5e-3 * 3)).max().item()
                    for n in c["params"])
    exp3_err = ((k["exp3"] - c["exp3"]).abs()
                / c["exp3"].abs().clamp(min=1e-30)).max().item()
    emit({"phase": "small_step_vs_cpu", "model": model_name, "kind": kind,
          "same_blocks": same_blocks,
          "num_edges": [int(b.num_edges()) for b in blocks],
          "loss_cuda": k["losses"], "loss_cpu": c["losses"],
          "loss_rel_err": loss_err, "exp3_rel_err": exp3_err,
          "tolerance": 2e-2, "param_err_over_tolerance": param_err})
    if not same_blocks:
        fail(f"small {model_name} step: blocks differ between card and CPU")
    if not all(math.isfinite(x) for x in k["losses"]):
        fail(f"small {model_name} step: non-finite loss")
    if loss_err > 2e-2 or param_err > 1.0 or exp3_err > 2e-2:
        fail(f"small {model_name} step: card and CPU disagree")


def small_replay_check(torch, dev, model_name, k=3):
    """``k`` steps of ``model_name`` replayed from a CUDA graph
    (``make_multi_train_step``: the chain's warm-up steps, the capture, k
    replays) against as many eager steps on the card from the same state
    (weights, arm weights, generator; capturable Adam whose rate halves
    every 3 steps, so that the replays cross the staircase), at the small
    size, the sampler's uniforms injected and dropout 0.1 drawn from the
    state's generator: each step's blocks equal (the src tables, copied on
    the device into a ring, so a replay records them too), the losses
    within rtol 1e-5, every parameter and Adam moment within rtol 1e-5 and
    1e-6 of its tensor's largest magnitude (far below one update, about
    the rate per parameter), the arm weights within one bf16 ulp. The
    replays were exact in every run; the bounds leave room for a last-bit
    reorder of the atomic sums."""
    from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig, init_exp3_weights)
    from bliss_gnn_tpu_torch.train import steps

    g, n_cls = small_graph(torch)
    dg = DeviceGraph.from_graph(g, device=dev)
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(256, 128),
                        model=model_name)
    plan = CapacityPlan.build(32, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind, dense_candidates=False)
    n = steps.CAPTURE_WARMUP_STEPS + k
    draws_gen = torch.Generator().manual_seed(5)
    draws = [[torch.rand(c, generator=draws_gen).to(dev)
              for c in plan.cand_caps] for _ in range(n)]
    seeds = torch.arange(32, dtype=torch.int32, device=dev)
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    ring = [torch.zeros((n, plan.src_cap(l)), dtype=torch.int32, device=dev)
            for l in range(2)]
    row = torch.zeros(1, dtype=torch.long, device=dev)
    sample = steps.sample_blocks

    def recorded(*args, **kw):
        blocks, stats = sample(*args, **kw)
        for r, b in zip(ring, blocks):
            r.index_copy_(0, row, b.src_gids[None])
        row.add_(1)
        return blocks, stats

    def fresh():
        model = build_model(model_name, 64, 32, n_cls, 2, dropout=0.1,
                            attn_drop=0.1, device=dev)
        opt, sched = steps.make_optimizer(model.parameters(), 1e-3, 1,
                                          gamma=0.5, step_size=3,
                                          capturable=True)
        return steps.TrainState(model, opt, sched,
                                init_exp3_weights(2, g.n_edges, device=dev),
                                torch.Generator(device=dev).manual_seed(0))

    def train_tensors(st):
        out = {}
        for name, p in st.model.named_parameters():
            out[name] = p.detach().clone()
            for key, v in st.optimizer.state[p].items():
                out[f"{name}.{key}"] = v.detach().clone()
        return out

    steps.sample_blocks = recorded
    try:
        st, eager = fresh(), []
        step = steps.make_train_step(dg, cfg, plan, False, device=dev)
        for i in range(n):
            st, m = step(st, seeds, smask, draws=draws[i])
            eager.append(float(m["train_loss"]))
        want_src, want_exp3 = [r.clone() for r in ring], st.exp3_weights
        want_train = train_tensors(st)
        row.zero_()
        multi = steps.make_multi_train_step(dg, cfg, plan, False, n,
                                            device=dev)
        st, m = multi(fresh(), seeds.expand(n, -1), smask.expand(n, -1),
                      draws=draws)
        torch.cuda.synchronize()
    finally:
        steps.sample_blocks = sample
    replayed = m["train_loss"].tolist()
    same = [all(torch.equal(r[i], w[i]) for r, w in zip(ring, want_src))
            for i in range(n)]
    loss_err = max(abs(a - b) / max(abs(b), 1e-6)
                   for a, b in zip(replayed, eager))
    exp3_err = ((st.exp3_weights.float() - want_exp3.float()).abs()
                / want_exp3.float().abs().clamp(min=1e-30)).max().item()
    got_train = train_tensors(st)
    # each tensor's error over its bound (rtol 1e-5, atol 1e-6 x max|want|)
    train_err = max(
        ((got_train[n].float() - w.float()).abs()
         / (1e-5 * w.float().abs() + 1e-6 * w.float().abs().max()
            ).clamp(min=1e-30)).max().item()
        for n, w in want_train.items())
    bitwise = all(torch.equal(got_train[n], w) for n, w in want_train.items())
    emit({"phase": "small_replay_vs_eager", "model": model_name,
          "eager_steps": steps.CAPTURE_WARMUP_STEPS, "replayed_steps": k,
          "same_blocks_by_step": same, "loss_eager": eager,
          "loss_replayed": replayed, "loss_rel_err": loss_err,
          "exp3_rel_err": exp3_err, "train_tensors": len(want_train),
          "train_err_over_tolerance": train_err,
          "train_tensors_bitwise_equal": bitwise,
          "lr": st.scheduler.get_last_lr()[0],
          "tolerance": {"loss": 1e-5, "exp3": 2.0 ** -8,
                        "train": "rtol 1e-5, atol 1e-6 x max|eager|"}})
    if not all(same):
        fail(f"replayed {model_name} steps sampled other blocks than eager "
             f"ones: {same}")
    if not all(math.isfinite(x) for x in replayed):
        fail(f"replayed {model_name} steps: non-finite loss")
    if (not loss_err <= 1e-5 or not exp3_err <= 2.0 ** -8
            or not train_err <= 1.0 or got_train.keys() != want_train.keys()
            or st.scheduler.get_last_lr() != [1e-3 / 2]):
        fail(f"replayed {model_name} steps disagree with eager ones")


def kernel_row(name, launches, src, replaces, err, tol, ms, plain_ms, lib_ms,
               nbytes, flops, **extra):
    """One kernel's record, printed as a ``kernel`` phase line. The bound
    is max(bytes / HBM rate, f32 operations / f32 rate) of the call."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    r = {"name": name, "route": "cuda",
         "source": f"bliss_gnn_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches,
         "max_abs_err": err, "tolerance": tol, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": lib_ms, **extra}
    emit({"phase": "kernel", **r})
    return r


def out_indptr(torch, csc_src, n_nodes):
    """CSR row pointer (int32 [n_nodes + 1]) of the edges ``csc_src``: the
    out-degrees' prefix sum, all GCN's norm reads of the CSR."""
    deg = torch.bincount(csc_src.long(), minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int32,
                         device=csc_src.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return indptr


def csc_prefix(torch, graph, indptr_np):
    """The graph cut to the in-edges of its first k dst rows, k the least
    with at least PREFIX_EDGES edges: (graph, k, its edge count)."""
    k = int(np.searchsorted(indptr_np, PREFIX_EDGES))
    e_pre = int(indptr_np[k])
    indptr = graph.csc_indptr.clone()
    indptr[k:] = e_pre
    cut = dataclasses.replace(
        graph, csc_indptr=indptr, n_edges=e_pre,
        csr_indptr=out_indptr(torch, graph.csc_src[:e_pre], graph.n_nodes))
    return cut, k, e_pre


def inference_phase(torch, graph, indptr_np, models, wrappers, smi_line):
    """Layerwise inference of each trained model over the full graph, one
    pass each, layer by layer through ``inference_layer`` (the loop of
    ``layerwise_inference``) with a CUDA-event pair around every layer.
    The launch counts are set to 0 before the first model and read after
    the last. Then each model's logits on a CSC prefix against the same
    inference with the plain aggregations (uncounted). Returns the
    aggregation kernels' launches by kernel-row name (its shape)."""
    from bliss_gnn_tpu_torch.models.inference import (
        inference_layer,
        layerwise_inference,
    )
    from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention_plain
    from bliss_gnn_tpu_torch.ops.spmm import spmm_plain

    n_layers = len(FANOUTS)
    shape_launches, runs = {}, {}
    reset_counts(wrappers)
    for name, model in models.items():
        model.eval()
        kname = "gat_attention" if name == "gat" else "spmm"
        layers = []
        h = graph.ndata["features"].to(torch.float32)
        for l in range(n_layers):
            conv = model.layers[l]
            if name == "gat":
                rname = f"gat_attention[H={conv.num_heads},O={conv.out_feats}]"
                width = conv.num_heads * conv.out_feats
            else:
                width = min(conv.in_feats, conv.out_feats)
                rname = f"spmm[F={width}]"
            before = wrappers[kname].launches
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            h = inference_layer(name, model, graph, l, h, n_layers)
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
            n_launch = wrappers[kname].launches - before
            shape_launches[rname] = shape_launches.get(rname, 0) + n_launch
            # one bf16 src row per edge: what the kernel asks of memory
            # (computed from the edge count, not a measured byte count)
            layers.append({"layer": l, "ms": ms, "kernel": rname,
                           "edges_per_s": graph.n_edges / (ms / 1e3),
                           "launches": n_launch,
                           "row_read_bytes": graph.n_edges * width * 2})
        runs[name] = dict(layers=layers, logits_shape=list(h.shape),
                          finite=bool(torch.isfinite(h).all().item()),
                          launches=sum(x["launches"] for x in layers))
        del h
        torch.cuda.empty_cache()
    launches = {n: fn.launches for n, fn in wrappers.items()}

    prefix, k, e_pre = csc_prefix(torch, graph, indptr_np)
    ip, src = prefix.csc_indptr, prefix.csc_src
    plain = {"spmm": lambda f: spmm_plain(f, ip, src),
             "gat_attn": lambda f, a, s: gat_attention_plain(f, a, s, ip, src)}
    for name, model in models.items():
        run = runs[name]
        got = layerwise_inference(name, model, prefix, n_layers)[:k]
        want = layerwise_inference(name, model, prefix, n_layers,
                                   **plain)[:k]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        emit({"phase": "inference", "model": name,
              "ms": sum(x["ms"] for x in run["layers"]),
              "logits_shape": run["logits_shape"], "finite": run["finite"],
              "layers": run["layers"], "launches_all_models": launches,
              "prefix_rows": k, "prefix_edges": e_pre,
              "prefix_max_abs_err": err, "prefix_max_abs_logit": scale,
              "tolerance": "1e-2 x max|plain logit|",
              "nvidia_smi": smi_line})
        if not run["finite"]:
            fail(f"inference: non-finite {name} logits")
        if run["launches"] <= 0:
            fail(f"inference: no aggregation kernel launched for {name}")
        if err > 1e-2 * scale:
            fail(f"inference: {name} logits differ from the plain path "
                 f"on the prefix: {err} > 1e-2 x {scale}")
        torch.cuda.empty_cache()
    return shape_launches


def wide_kernel_checks(torch, dev, gplan, graph, indptr_np, by_shape, sites,
                       shape_launches):
    """K5 at a GATv2 layer-0 block's two shapes, on uniform ids and on the
    ids of a sampled GATv2 layer-0 block (``sites``), with K3's sorted
    route on the sorted inputs; K6 and K7 at the inference shapes, checked
    on the CSC prefix and timed on the full graph, with one PyTorch library
    call as a yardstick where one computes the same function. ``by_shape``:
    K5's launches on the GAT path by route and shape."""
    from bliss_gnn_tpu_torch.ops.gat_attention import (
        gat_attention,
        gat_attention_plain,
        gat_plan,
    )
    from bliss_gnn_tpu_torch.ops.spmm import spmm, spmm_plain, spmm_plan

    g = torch.Generator(device=dev).manual_seed(8)
    rows = []

    # K5 at layer 0 of the GATv2 step, [block edges, 4 x 256] rows: the
    # message sum and the er-gather backward send dst-sorted ids into the
    # dst cap; the el-gather backward sends unsorted src ids into the src
    # cap. Uniform ids (the inputs of the earlier K5 rows) and the real
    # block's.
    e = gplan.block_e_caps[0]
    f5 = GAT_HEADS[0] * HIDDEN
    nv = int(0.6 * e)
    data = torch.randn((e, f5), generator=g, device=dev).to(torch.bfloat16)
    data[nv:] = 0
    cases = []
    for label, s, ordered in (("sorted ids, dst cap", gplan.dst_caps[0], True),
                              ("unsorted ids, src cap", gplan.src_cap(0),
                               False)):
        ids = torch.randint(0, s, (e,), generator=g, device=dev,
                            dtype=torch.int32)
        if ordered:
            ids = torch.sort(ids).values
        cases.append((label, ids, s, nv, ordered, data))
    real = torch.randn((sites["e_dst0"].shape[0], f5), generator=g,
                       device=dev).to(torch.bfloat16)
    real[sites["nv0"]:] = 0
    cases += [("sorted: GATv2 block e_dst", sites["e_dst0"], sites["n_dst0"],
               sites["nv0"], True, real),
              ("unsorted: GATv2 block e_src", sites["e_src0"],
               sites["n_src0"], sites["nv0"], False, real)]
    for label, ids, s, nv, ordered, data in cases:
        rows.append(k5_row(torch, dev, label, data, ids, s, nv, ordered,
                           route_launches(by_shape, "sorted" if ordered
                                          else "unsorted")))
    del data, real, cases

    n, n_edges = graph.n_nodes, graph.n_edges
    prefix, k, e_pre = csc_prefix(torch, graph, indptr_np)
    ip, src = graph.csc_indptr, graph.csc_src
    pip = prefix.csc_indptr
    where = {"prefix_rows": k, "prefix_edges": e_pre}

    # K6: the SAGE aggregations, F = 256 (layers 0, 1) and 41 (layer 2)
    csr = torch.sparse_csr_tensor(
        ip, src[:n_edges], torch.ones(n_edges, device=dev), (n, n))
    for f in (HIDDEN, N_CLASSES):
        x = torch.randn((n, f), generator=g, device=dev).to(torch.bfloat16)
        got, want = spmm(x, pip, src)[:k], spmm_plain(x, pip, src)[:k]
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        del got, want
        if err > tol:
            fail(f"spmm F={f} differs from its plain version: {err} > {tol}")
        xf = x.float()
        name = f"spmm[F={f}]"
        ld, cols, _ = spmm_plan(n, f, x.dtype)
        before = spmm.launches  # the wrapper counts each slice's launch
        spmm(x, ip, src)
        per_call = spmm.launches - before
        rows.append(kernel_row(
            name, shape_launches.get(name, 0), "spmm_csr.cu",
            "bliss_gnn_tpu/ops/spmm_pallas.py:259", err,
            "atol 1e-4 x max|plain| on the prefix",
            time_ms(lambda: spmm(x, ip, src), 5, torch, warmup=1),
            time_ms(lambda: spmm_plain(x, ip, src), 1, torch, warmup=0),
            time_ms(lambda: torch.sparse.mm(csr, xf), 3, torch, warmup=1),
            n * f * 2 + (n + 1) * 4 + n_edges * 4 + n * f * 4, n_edges * f,
            device_ms=device_time_ms(lambda: spmm(x, ip, src), torch, reps=3,
                                     replays=2),
            library_device_ms=device_time_ms(
                lambda: torch.sparse.mm(csr, xf), torch, reps=3, replays=2),
            kernel_launches_per_call=per_call, slice_cols=cols,
            padded_cols=ld, shape=f"{n} x {f} bf16, {n_edges} edges",
            **where))
        del x, xf
    del csr

    # K7: the GATv2 attention, (H, O) = (4, 256) (layers 0, 1), (1, 41)
    for h, o in ((GAT_HEADS[0], HIDDEN), (GAT_HEADS[1], N_CLASSES)):
        feat = torch.randn((n, h, o), generator=g, device=dev).to(
            torch.bfloat16)
        attn = torch.randn((1, h, o), generator=g, device=dev) / o ** 0.5
        got = gat_attention(feat, attn, 0.2, pip, src)[:k]
        want = gat_attention_plain(feat, attn, 0.2, pip, src)[:k]
        err = (got - want).abs().max().item()
        tol = 2e-4 * want.abs().max().item()
        del got, want
        if err > tol:
            fail(f"gat_attention ({h}, {o}) differs from its plain version: "
                 f"{err} > {tol}")
        name = f"gat_attention[H={h},O={o}]"
        op, splits = gat_plan(h, o, feat.dtype)
        before = gat_attention.launches
        gat_attention(feat, attn, 0.2, ip, src)
        per_call = gat_attention.launches - before
        rows.append(kernel_row(
            name, shape_launches.get(name, 0), "gat_attention.cu",
            "bliss_gnn_tpu/ops/gat_pallas.py:70", err,
            "atol 2e-4 x max|plain| on the prefix",
            time_ms(lambda: gat_attention(feat, attn, 0.2, ip, src), 3, torch,
                    warmup=1),
            time_ms(lambda: gat_attention_plain(feat, attn, 0.2, ip, src), 1,
                    torch, warmup=0),
            None,
            n * h * o * 2 + (n + 1) * 4 + n_edges * 4 + n * h * o * 4
            + h * o * 4, n_edges * h * (7 * o + 2),
            device_ms=device_time_ms(
                lambda: gat_attention(feat, attn, 0.2, ip, src), torch,
                reps=2, replays=2),
            kernel_launches_per_call=per_call, padded_cols=op,
            splits_per_head=splits,
            shape=f"{n} x {h} x {o} bf16, {n_edges} edges", **where))
        del feat
    return rows


def k5_row(torch, dev, label, data, ids, s, nv, ordered, launches):
    """K5 on one input, against its plain version at both output dtypes:
    f32 within rtol 1e-5 + atol 1e-4, bf16 (each sum rounded once) within
    one bf16 ulp; two calls give the same bits. Timed at the path's bf16
    output (the bound too), with f32's device time beside it; on sorted ids
    K3's sorted route on the same inputs."""
    from bliss_gnn_tpu_torch.ops.rowscatter import (
        row_scatter_add,
        row_scatter_add_plain,
    )
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum, segment_sum_plain

    e, f = data.shape
    nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
    bf16 = torch.bfloat16

    def call(out_dtype=bf16):
        return row_scatter_add(data, ids, s, nv_d, ordered, out_dtype)

    got = call(torch.float32)
    want = row_scatter_add_plain(data, ids, s, nv_d, ordered)
    diff = (got - want).abs()
    bad = (diff > 1e-5 * want.abs() + 1e-4).sum().item()
    if bad:
        fail(f"row_scatter_add ({label}) differs from its plain version "
             f"in {bad} entries")
    same_bits = torch.equal(call(torch.float32), got)
    before = row_scatter_add.launches
    got_b = call()
    per_call = row_scatter_add.launches - before
    want_b = row_scatter_add_plain(data, ids, s, nv_d, ordered, bf16).float()
    diff_b = (got_b.float() - want_b).abs()
    bad_b = (diff_b > BF16_ULP * want_b.abs() + 1e-4).sum().item()
    if bad_b:
        fail(f"row_scatter_add ({label}, bf16 out) differs from its plain "
             f"version by more than one bf16 ulp in {bad_b} entries")
    same_bits = same_bits and torch.equal(call(), got_b)
    if not same_bits:
        fail(f"row_scatter_add ({label}): two calls give different bits")
    del got, want, got_b, want_b, diff_b
    extra = {}
    if ordered:
        # K3's sorted route on the same inputs: held to K3's tolerance and
        # to equal bits on two calls before it is timed
        def k3_call():
            return segment_sum(data, ids, s, nv_d, ids_sorted=True)

        got3 = k3_call()
        want3 = segment_sum_plain(data, ids, s, nv_d, ids_sorted=True).float()
        diff3 = (got3.float() - want3).abs()
        if (diff3 > BF16_ULP * want3.abs() + 1e-3).sum().item():
            fail(f"segment_sum (sorted, K5's {label}) differs from its plain "
                 f"version")
        if not torch.equal(k3_call(), got3):
            fail(f"segment_sum (sorted, K5's {label}): two calls give "
                 f"different bits")
        extra = dict(
            segment_sum_sorted_max_abs_err_same_inputs=diff3.max().item(),
            segment_sum_sorted_device_ms_same_inputs=device_time_ms(
                k3_call, torch))
        del got3, want3, diff3
    else:
        live = ids[:nv].long()
        live = live[(live >= 0) & (live < s)]
        extra["max_key_repeats"] = int(torch.bincount(live).max().item())
    lib = torch.zeros((s, f), device=dev, dtype=bf16)
    ids64 = ids.long()
    r = kernel_row(
        f"row_scatter_add[{label}]", launches, "row_scatter.cu",
        "bliss_gnn_tpu/ops/rowscatter_pallas.py:42", diff.max().item(),
        "f32 out: rtol 1e-5 + atol 1e-4; bf16 out: one bf16 ulp",
        time_ms(call, 20, torch),
        time_ms(lambda: row_scatter_add_plain(data, ids, s, nv_d, ordered,
                                              bf16), 5, torch),
        time_ms(lambda: lib.index_add_(0, ids64, data), 20, torch),
        nv * (f * 2 + 4) + s * f * 2, nv * f,
        device_ms=device_time_ms(call, torch),
        f32_out_device_ms=device_time_ms(lambda: call(torch.float32), torch),
        library_device_ms=device_time_ms(
            lambda: lib.index_add_(0, ids64, data), torch),
        kernel_launches_per_call=per_call, out_dtype="bfloat16",
        repeat_bitwise=same_bits,
        k5_route="sorted" if ordered else "unsorted",
        shape=f"{e} x {f} bf16 rows ({nv} valid) into {s}", **extra)
    del lib, diff
    return r


def bf16_ulp(torch, x):
    """One bf16 ulp at each value of ``x``."""
    _, e = torch.frexp(x.float())  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def route_launches(by_shape, route, f=None):
    """Launches of one route of K1 or K3 over the main path, all shapes (of
    K3's, those of row width ``f``)."""
    return sum(v for k, v in by_shape.items() if k.startswith(route + " ")
               and (f is None or k.endswith(f"x{f}")))


def kernel_checks(torch, dev, plan, n_edges, launches, sites, by_shape):
    """Each kernel and its plain version on the same card tensors, at the
    shapes of the main path's input-most layer (K1 and K3 at each call
    site's shape, from the real sampled block of ``sites``); plus one
    PyTorch library call of the same function as a yardstick. ``ms`` is
    event-timed over back-to-back wrapper calls, ``device_ms`` from
    CUDA-graph replays. ``by_shape``: K1's and K3's main-path launches by
    route and shape."""
    from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply, exp3_apply_plain
    from bliss_gnn_tpu_torch.ops.gather import (
        lut_gather,
        lut_gather_multi,
        lut_gather_multi_plain,
        lut_gather_plain,
    )
    from bliss_gnn_tpu_torch.ops.scatter import scatter_add, scatter_add_plain
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum, segment_sum_plain

    k2 = (lut_gather, lut_gather_plain)
    k4 = (exp3_apply, exp3_apply_plain)

    g = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def row(name, *args, **extra):
        rows.append(kernel_row(name, launches[name], *args, **extra))

    def on_card(n):  # the main path hands the kernels n_valid on the card
        return torch.tensor(n, dtype=torch.int32, device=dev)

    def live_prefix(n, nv):
        return torch.arange(n, device=dev) < nv

    m = plan.frontier_caps[0]  # frontier slots of the input-most layer
    nv = int(0.8 * m)
    nv_d = on_card(nv)
    # the keep-mask lookup sel[src_cpos]: K1's keys are K2's ids
    keys = torch.randint(0, N_NODES, (m,), generator=g, device=dev,
                         dtype=torch.int32)
    keys64 = keys.long()

    def k1_row(site, keys, n_out, nv, route):
        """K1 at one call site: against its plain version, the sorted route
        also against itself (two calls, the same bits)."""
        sort = route == "sorted"
        vals = torch.where(live_prefix(keys.shape[0], nv),
                           torch.rand(keys.shape[0], generator=g, device=dev),
                           0.0)
        nv_d = on_card(nv)

        def call():
            return scatter_add(keys, vals, n_out, nv_d, ids_sorted=sort)

        got = call()
        want = scatter_add_plain(keys, vals, n_out, nv_d, ids_sorted=sort)
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item() + 1e-6
        if err > tol:
            fail(f"scatter_add ({site}) differs from its plain version: "
                 f"{err} > {tol}")
        if sort and not torch.equal(call(), got):
            fail(f"scatter_add ({site}): two calls give different bits")
        lib = torch.zeros(n_out, device=dev)
        k64 = keys.long()
        rows.append(kernel_row(
            f"scatter_add[{route}: {site}]", route_launches(
                by_shape["scatter_add"], route), "scatter_add.cu",
            "bliss_gnn_tpu/ops/scatter_pallas.py:61", err, tol,
            time_ms(call, 20, torch),
            time_ms(lambda: scatter_add_plain(keys, vals, n_out, nv_d), 5,
                    torch),
            time_ms(lambda: lib.index_add_(0, k64, vals), 20, torch),
            nv * 8 + n_out * 4, nv,
            device_ms=device_time_ms(call, torch),
            library_device_ms=device_time_ms(
                lambda: lib.index_add_(0, k64, vals), torch),
            launches_at_this_shape=by_shape["scatter_add"].get(
                f"{route} n={keys.shape[0]}", 0),
            repeat_bitwise=sort or None,
            shape=f"{keys.shape[0]} keys ({nv} valid) into {n_out}"))

    # K1 unsorted: the importance sum of r^2 by src candidate, random keys
    k1_row("importance sum", keys, plan.cand_caps[0], nv, "unsorted")
    # K1 sorted: the per-dst sums of the real layer-0 block (kept count,
    # debias sum, SAGE degree, in-degree) and the frontier's chunk sums
    k1_row("block e_dst", sites["e_dst0"], sites["n_dst0"], sites["nv0"],
           "sorted")
    k1_row("chunk owners", sites["owner0"], sites["n_dst0"],
           sites["n_chunks0"], "sorted")

    # K2, one table: the keep-mask lookup sel[src_cpos]
    lut = torch.rand(plan.cand_caps[0], generator=g, device=dev) < 0.3
    got, want = k2[0](lut, keys, nv_d), k2[1](lut, keys, nv_d)
    err = float((got != want).sum().item())
    if err != 0:
        fail(f"lut_gather differs from its plain version in {err} slots")
    touched = torch.unique(keys[:nv]).numel()
    keys_sorted = torch.sort(keys).values
    row("lut_gather", "lut_gather.cu",
        "bliss_gnn_tpu/ops/gather_pallas.py:188", err, 0.0,
        time_ms(lambda: k2[0](lut, keys, nv_d), 20, torch),
        time_ms(lambda: k2[1](lut, keys, nv_d), 5, torch),
        time_ms(lambda: torch.take(lut, keys64), 20, torch),
        nv * 4 + m * 1 + touched * 1, 0,
        device_ms=device_time_ms(lambda: k2[0](lut, keys, nv_d), torch),
        library_device_ms=device_time_ms(lambda: torch.take(lut, keys64),
                                         torch),
        host_us=host_us(lambda: k2[0](lut, keys, nv_d), torch), tables=1,
        # the same lookups with the ids sorted, so that neighbouring
        # threads read neighbouring table entries: what the random reads
        # of the table cost
        device_ms_ids_sorted=device_time_ms(
            lambda: k2[0](lut, keys_sorted, nv_d), torch),
        shape=f"{m} ids ({nv} valid) into a {lut.shape[0]}-entry bool table")

    # K2, five tables: the layer-0 block-build takes of the kept edges'
    # fields, e_blk_cap sorted distinct frontier slots into the five
    # frontier-slot tables (src_cpos, dst_spos, eid: int32; edge_w,
    # alpha_w: f32), against five one-table calls on the same inputs
    e = plan.block_e_caps[0]
    nv5 = int(0.6 * e)
    nv5_d = on_card(nv5)
    eidx = torch.sort(torch.randperm(m, generator=g, device=dev)[:e]).values
    eidx = eidx.to(torch.int32)
    slots = tuple(torch.randint(0, hi, (m,), generator=g, device=dev,
                                dtype=torch.int32)
                  for hi in (plan.cand_caps[0], plan.dst_caps[0], n_edges))
    slots += tuple(torch.rand(m, generator=g, device=dev) for _ in range(2))
    got = lut_gather_multi(slots, eidx, nv5_d)
    want = lut_gather_multi_plain(slots, eidx, nv5_d)
    err = float(sum((a != b).sum().item() for a, b in zip(got, want)))
    if err != 0:
        fail(f"lut_gather_multi differs from its plain version in {err} "
             f"slots")
    width = sum(t.element_size() for t in slots)

    def five():
        lut_gather_multi(slots, eidx, nv5_d)

    def five_one_table():
        for t in slots:
            lut_gather(t, eidx, nv5_d)

    rows.append(kernel_row(
        "lut_gather[5 tables]", launches["lut_gather"], "lut_gather.cu",
        "bliss_gnn_tpu/ops/gather_pallas.py:188", err, 0.0,
        time_ms(five, 20, torch),
        time_ms(lambda: lut_gather_multi_plain(slots, eidx, nv5_d), 5,
                torch),
        None, nv5 * 4 + nv5 * width + e * width, 0,
        device_ms=device_time_ms(five, torch), host_us=host_us(five, torch),
        tables=len(slots),
        five_one_table_ms=time_ms(five_one_table, 20, torch),
        five_one_table_device_ms=device_time_ms(five_one_table, torch),
        shape=f"{e} sorted distinct ids ({nv5} valid) into five {m}-entry "
              f"tables (3 int32, 2 f32)"))
    del got, want, slots

    # K3: the SAGE aggregations by dst (sorted: layer 0 at F = 256, the
    # output layer at F = 41) and the gather backwards into the src table
    # (unsorted), on the real blocks' ids, bf16 rows zero past the prefix
    for tag, f in (("0", HIDDEN), ("out", N_CLASSES)):
        for route, ids, n_out in (
                ("sorted", sites[f"e_dst{tag}"], sites[f"n_dst{tag}"]),
                ("unsorted", sites[f"e_src{tag}"], sites[f"n_src{tag}"])):
            e, nv3 = ids.shape[0], sites[f"nv{tag}"]
            sort = route == "sorted"
            data = torch.randn((e, f), generator=g, device=dev).to(
                torch.bfloat16)
            data[nv3:] = 0
            nv3_d = on_card(nv3)

            def call():
                return segment_sum(data, ids, n_out, nv3_d, ids_sorted=sort)

            got = call()
            want = segment_sum_plain(data, ids, n_out, nv3_d,
                                     ids_sorted=sort).float()
            diff = (got.float() - want).abs()
            err = diff.max().item()
            bad = (diff > BF16_ULP * want.abs() + 1e-3).sum().item()
            site = ("aggregation" if sort else "gather backward") + (
                " layer 0" if tag == "0" else " output layer")
            if bad:
                fail(f"segment_sum ({route}, {site}) differs from its plain "
                     f"version in {bad} entries")
            if sort and not torch.equal(call(), got):
                fail(f"segment_sum ({site}): two calls give different bits")
            lib3 = torch.zeros((n_out, f), device=dev, dtype=torch.bfloat16)
            ids64 = ids.long()
            rows.append(kernel_row(
                f"segment_sum[{route}, F={f}: {site}]",
                route_launches(by_shape["segment_sum"], route, f),
                "segment_sum.cu", "bliss_gnn_tpu/ops/segsum_pallas.py:44",
                err, "rtol 2^-7 (one bf16 ulp) + atol 1e-3",
                time_ms(call, 20, torch),
                time_ms(lambda: segment_sum_plain(data, ids, n_out, nv3_d),
                        5, torch),
                time_ms(lambda: lib3.index_add_(0, ids64, data), 20, torch),
                nv3 * (f * 2 + 4) + n_out * f * 2, nv3 * f,
                device_ms=device_time_ms(call, torch),
                library_device_ms=device_time_ms(
                    lambda: lib3.index_add_(0, ids64, data), torch),
                launches_at_this_shape=by_shape["segment_sum"].get(
                    f"{route} {e}x{f}", 0),
                repeat_bitwise=sort or None,
                shape=f"{e} x {f} bf16 ({nv3} valid) into {n_out}"))
            del data, lib3, got, want, diff

    # K4: the arm-weight update of one step, all three layers, on a state
    # of random weights: distinct indices as on the main path, 30% no-op
    # slots (zero exponents); bitwise, then within m - 1 bf16 ulps with
    # each index repeated m = 1..8 times
    caps = plan.block_e_caps
    span = n_edges + EDGE_PAD
    limit = len(caps) * span
    u = sum(caps)
    idx = torch.cat([
        torch.randperm(n_edges, generator=g, device=dev)[:c] + l * span
        for l, c in enumerate(caps)]).to(torch.int32)
    idx = torch.where(torch.rand(u, generator=g, device=dev) < 0.3,
                      torch.full_like(idx, limit), idx)
    mult = torch.exp(torch.rand(u, generator=g, device=dev) * 0.5)
    st_k = (torch.rand(limit, generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    st_p = st_k.clone()
    k4[0](st_k, idx, mult, limit)
    k4[1](st_p, idx, mult, limit)
    err = (st_k.float() - st_p.float()).abs().max().item()
    if not torch.equal(st_k, st_p):
        fail(f"exp3_apply differs from its plain version on distinct "
             f"indices (max |diff| {err})")
    valid = idx < limit
    base = idx[valid][: u // 4]
    reps = torch.randint(1, 9, (base.shape[0],), generator=g, device=dev)
    idx_d = base.repeat_interleave(reps)
    idx_d = idx_d[torch.randperm(idx_d.shape[0], generator=g, device=dev)]
    mult_d = torch.exp(torch.rand(idx_d.shape[0], generator=g,
                                  device=dev) * 0.5)
    k4[0](st_k, idx_d, mult_d, limit)
    k4[1](st_p, idx_d, mult_d, limit)
    uniq, cnt = torch.unique(idx_d.long(), return_counts=True)
    changed = torch.nonzero(st_k != st_p).squeeze(1)
    if not torch.isin(changed, uniq).all():
        fail("exp3_apply changed entries it was not given")
    a, b = st_k[uniq].float(), st_p[uniq].float()
    ulp = torch.maximum(bf16_ulp(torch, a), bf16_ulp(torch, b))
    dup_err = (a - b).abs()
    dup_ratio = (dup_err / ((cnt - 1).clamp(min=1) * ulp)).max().item()
    if ((cnt == 1) & (dup_err > 0)).any() or dup_ratio > 1.0:
        fail(f"exp3_apply with repeated indices is off by more than m - 1 "
             f"bf16 ulps: {dup_ratio} x the tolerance")
    n_upd = int(valid.sum().item())
    idx_v, mult_v = idx[valid].long(), mult[valid].to(torch.bfloat16)
    row("exp3_apply", "exp3_apply.cu",
        "bliss_gnn_tpu/ops/exp3_pallas.py:62", err,
        "bitwise on distinct indices; m - 1 bf16 ulps on an index "
        "repeated m times",
        time_ms(lambda: k4[0](st_k, idx, mult, limit), 20, torch),
        time_ms(lambda: k4[1](st_p, idx, mult, limit), 5, torch),
        time_ms(lambda: st_p.scatter_reduce_(0, idx_v, mult_v, "prod"), 20,
                torch),
        u * 8 + n_upd * 4, n_upd,
        device_ms=device_time_ms(lambda: k4[0](st_k, idx, mult, limit),
                                 torch),
        library_device_ms=device_time_ms(
            lambda: st_p.scatter_reduce_(0, idx_v, mult_v, "prod"), torch),
        host_us=host_us(lambda: k4[0](st_k, idx, mult, limit), torch),
        shape=f"{u} update slots ({n_upd} valid, distinct) into "
              f"{limit} bf16",
        dup_slots=idx_d.shape[0], dup_max_repeats=int(cnt.max().item()),
        dup_max_abs_err=dup_err.max().item(),
        dup_err_over_tolerance=dup_ratio)
    del st_k, st_p
    return rows



# -- the trainer, the CLI and time to validation F1 ----------------------------

# the trainer phase: the main path's configuration through Trainer, 3 eager
# pilot steps, the refit, 20 chains of 10 replayed steps, one validation
TRAINER_CFG = dict(model="sage", sampler="poisson-bandit", fan_out=FANOUTS,
                   batch_size=BATCH, num_hidden=HIDDEN, num_layers=3,
                   num_steps=203, steps_per_call=10, eval_steps_per_call=8,
                   refit_after=3)
# the metric series of the reference's trainer (its logging interface)
REFERENCE_SERIES = ("train_acc", "train_loss", "iter_time",
                    "forward_backward_time", "val_acc", "val_loss",
                    "Final Accuracy/Train", "Final Accuracy/Validation",
                    "Final Accuracy/Test")
TTVF1_K, TTVF1_KV = 8, 4  # bench.py's train steps a chain, val batches


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def host_graph_from(torch, graph, n_classes, seed=4):
    """The main path's graph as the host ``Graph`` a user hands the
    trainer: its CSC, the CSR (the stable sort ``Graph`` makes, taken on
    the device), f32 features and labels drawn from ``seed``, per-dst
    normalised weights 1 / in-degree, and a 65/10/25 split as
    ``synthetic_graph`` makes one. Returns the graph and its seconds."""
    from bliss_gnn_tpu_torch.graph.structure import Graph

    t0 = time.perf_counter()
    dev, n, e = graph.device, graph.n_nodes, graph.n_edges
    src = graph.csc_src[:e].long()
    deg = (graph.csc_indptr[1:] - graph.csc_indptr[:-1]).long()
    order = torch.sort(src, stable=True).indices
    dst = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                  output_size=e)
    out_deg = torch.bincount(src, minlength=n)
    csr_indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    csr_indptr[1:] = torch.cumsum(out_deg, 0)
    w = (1.0 / deg.clamp(min=1).float()).repeat_interleave(deg,
                                                           output_size=e)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n, N_FEATS), generator=gen, device=dev)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)

    def host(t):
        return t.cpu().numpy()

    perm = np.random.default_rng(seed).permutation(n)
    n_train, n_val = int(0.65 * n), int(0.1 * n)
    masks = {k: np.zeros(n, dtype=bool)
             for k in ("train_mask", "val_mask", "test_mask")}
    masks["train_mask"][perm[:n_train]] = True
    masks["val_mask"][perm[n_train:n_train + n_val]] = True
    masks["test_mask"][perm[n_train + n_val:]] = True
    g = Graph.from_csc(
        host(graph.csc_indptr), host(src.to(torch.int32)), n,
        ndata={"features": host(feats), "labels": host(labels), **masks},
        edata={"w": host(w)},
        csr=(host(csr_indptr), host(dst[order]), host(order)))
    return g, time.perf_counter() - t0


def read_series(run_dir):
    """``metrics.csv`` of a run as {name: [(step, value)]}."""
    import csv

    out = {}
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        for row in csv.DictReader(f):
            out.setdefault(row["name"], []).append(
                (int(row["step"]), float(row["value"])))
    return out


def trainer_phase(torch, dev, host_graph, n_classes, wrappers, smi_line,
                  workdir, host_s=None, cfg_kw=TRAINER_CFG):
    """The training harness on the main path's configuration: ``Trainer``
    on ``host_graph`` with checkpointing, ``fit`` (eager pilot steps, the
    refit, chains of replayed steps, one chained validation, the
    checkpoint), ``restore_best`` and ``final_eval`` (K6). Then on the same
    trainer: the captured chained eval replayed after a reseed against the
    eager eval step reseeded alike (and against another seed, to show the
    check can tell); ``load_checkpoint`` (parameters and arm weights equal
    to the best state bit for bit); then LOCKSTEP_STEPS chained steps
    through the trainer's captured step, each against an eager twin loaded
    with the same state. Prints the times, captures, refits and widens,
    the memory of each plan's life, and the launches of the run."""
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights
    from bliss_gnn_tpu_torch.train import steps as tsteps
    from bliss_gnn_tpu_torch.train.steps import TrainState, make_optimizer
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    plans, timing = [], {"validate": [], "snapshot": [], "save": []}

    def memory(rec):
        if cuda:
            rec.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                       peak_reserved_bytes=torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = fn()
        sync(torch, dev)
        timing[name].append(time.perf_counter() - t0)
        return out

    class Observed(Trainer):
        """The trainer with each plan's life, validation, snapshot and
        save timed."""

        def _rebuild_steps(self):
            if plans:  # the plan being replaced: its life's peak memory
                memory(plans[-1])
            super()._rebuild_steps()
            plans.append({"from_step": getattr(self, "global_step", 0),
                          "frontier_caps": self.plan.frontier_caps,
                          "block_e_caps": self.plan.block_e_caps})

        def _validate(self, epoch):
            return timed("validate", lambda: super(Observed, self)
                         ._validate(epoch))

        def _snapshot(self):
            return timed("snapshot", lambda: super(Observed, self)
                         ._snapshot())

        def _save_checkpoint(self):
            return timed("save", lambda: super(Observed, self)
                         ._save_checkpoint())

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    captures0 = tsteps._Replay.captures
    cfg = TrainConfig(**cfg_kw, logdir=workdir, disable_checkpoint=False)
    t0 = time.perf_counter()
    tr = Observed(cfg, graph=host_graph, n_classes=n_classes,
                  multilabel=False, device=dev)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.fit()
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    memory(plans[-1])
    tr.restore_best()
    t0 = time.perf_counter()
    res = tr.final_eval()
    sync(torch, dev)
    final_s = time.perf_counter() - t0
    kernels = ("scatter_add", "lut_gather", "segment_sum", "exp3_apply",
               "spmm")
    launches = {k: wrappers[k].launches for k in kernels}
    captures = tsteps._Replay.captures - captures0
    series = read_series(tr.run_dir)
    fb = dict(series["forward_backward_time"])
    pilot = [fb[t] * 1e3 for t in sorted(fb) if t <= cfg.refit_after]
    chained = [fb[t] * 1e3 for t in sorted(fb) if t > cfg.refit_after]
    losses = [v for _, v in series["train_loss"]]

    # the captured chained eval after a reseed, against the eager eval
    K = cfg.eval_steps_per_call
    vs, vm = tr._val_batches(0, K)
    vs, vm = tr._to_device(vs), tr._to_device(vm)
    gen = tr._eval_gen

    def eager_eval(seed):
        gen.manual_seed(seed)
        acc = torch.zeros(5, dtype=torch.float64, device=dev)
        for i in range(K):
            f1, loss_n, _ = tr.eval_step(tr.state, gen, vs[i], vm[i])
            acc += torch.stack([f1.tp, f1.fp, f1.fn, f1.total,
                                loss_n]).double()
        return acc.cpu().tolist()

    gen.manual_seed(77)
    f1, loss_n, _ = tr.multi_eval(tr.state, gen, vs, vm)
    replayed = torch.stack([f1.tp, f1.fp, f1.fn, f1.total,
                            loss_n]).double().cpu().tolist()
    eager, other = eager_eval(77), eager_eval(78)

    def eval_gap(a):
        return {"tp": abs(a[0] - replayed[0]), "total": abs(a[3] - replayed[3]),
                "loss_rel": abs(a[4] - replayed[4]) / max(abs(a[4]), 1.0)}

    reseed = {"replayed": replayed, "eager_same_seed": eager,
              "eager_other_seed": other, "gap_same_seed": eval_gap(eager),
              "gap_other_seed": eval_gap(other)}

    # load_checkpoint into the live tensors, then the captured step again
    best = tr.best_state
    ckpt = tr.checkpoint_path()
    ckpt_bytes = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
    t0 = time.perf_counter()
    tr.load_checkpoint()
    sync(torch, dev)
    load_s = time.perf_counter() - t0
    params_equal = all(torch.equal(p.detach().cpu(), best["params"][n])
                       for n, p in tr.state.model.named_parameters())
    exp3_equal = torch.equal(tr.state.exp3_weights.cpu(),
                             best["exp3_weights"])
    del best
    twin_model = build_model(cfg.model,
                             int(host_graph.ndata["features"].shape[1]),
                             cfg.num_hidden, n_classes, cfg.num_layers,
                             dropout=cfg.dropout, device=dev, seed=cfg.seed)
    opt, sched = make_optimizer(twin_model.parameters(), cfg.lr, 100,
                                capturable=cuda)
    twin = TrainState(twin_model, opt, sched,
                      init_exp3_weights(cfg.num_layers, tr.graph.n_edges,
                                        device=dev),
                      torch.Generator(device=dev).manual_seed(1))
    seeds = tr._to_device(tr.train_nid[:tr.batch_size])
    smask = torch.ones(tr.batch_size, dtype=torch.bool, device=dev)
    twin, _ = tr.train_step(twin, seeds, smask)
    lock = lockstep(torch, tr.state, tr.multi_step, twin, tr.train_step,
                    seeds, smask, "trainer after load_checkpoint")
    rec = {"phase": "trainer", "config": {k: list(v) if isinstance(v, tuple)
                                          else v for k, v in cfg_kw.items()},
           "steps": tr.global_step, "init_seconds": init_s,
           "fit_seconds": fit_s,
           "pilot_step_ms": statistics.median(pilot), "pilot_step_ms_all":
           pilot, "chained_step_ms": statistics.median(chained),
           "chained_steps": len(chained),
           "chained_step_ms_by_chain": chained[::cfg.steps_per_call],
           "captures": captures, "refits": tr.n_refits,
           "widens": tr.n_widens, "plans": plans,
           "validation_seconds": timing["validate"],
           "validation_batches": -(-len(tr.val_nid) // tr.batch_size),
           "snapshot_seconds": timing["snapshot"],
           "checkpoint_save_seconds": timing["save"],
           "checkpoint_bytes": ckpt_bytes,
           "load_checkpoint_seconds": load_s,
           "final_eval_seconds": final_s,
           "val_acc": [v for _, v in series.get("val_acc", [])],
           "final_accuracy": res, "loss_first_last": [losses[0], losses[-1]],
           "launches": launches, "eval_reseed": reseed,
           "load_checkpoint_params_equal": params_equal,
           "load_checkpoint_exp3_equal": exp3_equal,
           "lockstep_after_load": lock,
           "host_preparation_seconds": host_s,
           "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line}
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        fail(f"trainer: non-finite loss {losses}")
    if not (ckpt_bytes > 0 and params_equal and exp3_equal):
        fail(f"trainer: checkpoint {ckpt} ({ckpt_bytes} bytes) did not "
             f"restore the best state: params {params_equal}, arm weights "
             f"{exp3_equal}")
    if not all(0.0 <= v <= 1.0 for v in res.values()):
        fail(f"trainer: F1 outside [0, 1]: {res}")
    # on an H100 another seed moved the loss sum by 7e-5 of itself (the
    # labels are random); a few flipped Bernoulli draws move it ~1e-7
    gap = reseed["gap_same_seed"]
    if (gap["total"] != 0 or gap["tp"] > 0.005 * replayed[3]
            or gap["loss_rel"] > 1e-6):
        fail(f"trainer: the replayed eval after a reseed differs from the "
             f"eager eval: {reseed}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"trainer: kernels not launched: {missing}")
    del tr, twin, twin_model, opt, sched
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def cli_phase(torch, dev, wrappers, smi_line, workdir):
    """``cli.main`` as a user runs it (on the card: no ``--platform``) on
    synth-small, SAGE and GATv2, 2 layers, fan-outs 32,16, batch 64, 12
    steps: the reference's series in ``metrics.csv``, the final F1s in [0,
    1], the launches of each run (K1-K4 in the steps; K6 or K7 in the
    final eval)."""
    from bliss_gnn_tpu_torch.train import cli

    t_phase = time.perf_counter()
    runs = {}
    for model, final_kernel in (("sage", "spmm"), ("gat", "gat_attention")):
        logdir = os.path.join(workdir, f"cli_{model}")
        argv = ["--dataset", "synth-small", "--model", model,
                "--num-layers", "2", "--fan-out", "32,16", "--batch-size",
                "64", "--num-steps", "12", "--logdir", logdir]
        if dev.type == "cpu":
            argv += ["--platform", "cpu"]
        reset_counts(wrappers)
        t0 = time.perf_counter()
        res = cli.main(argv)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = {k: v.launches for k, v in wrappers.items()}
        run_dir = os.path.join(logdir, os.listdir(logdir)[0], "version_0")
        names = set(read_series(run_dir))
        want = set(REFERENCE_SERIES) | {f"num_nodes/{i}" for i in range(3)} \
            | {f"num_edges/{i}" for i in range(2)}
        runs[model] = {"seconds": secs, "final_accuracy": res[0],
                       "launches": launches,
                       "missing_series": sorted(want - names)}
        missing = [k for k in ("scatter_add", "lut_gather", "segment_sum",
                               "exp3_apply", final_kernel)
                   if launches[k] <= 0]
        if missing or want - names or not 0.0 <= res[0]["Test"] <= 1.0:
            fail(f"cli_small {model}: kernels not launched {missing}, "
                 f"series missing {sorted(want - names)}, result {res}")
    emit({"phase": "cli_small", **runs,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line})


def time_to_val_f1(torch, dev, target=0.90, max_chains=25, freeze=False,
                   seed_offset=0):
    """``bench.py``'s time-to-validation-F1 protocol through the port:
    synth-pubmed-hard, SAGE-256 x3, poisson-bandit, fan-outs 256/128/64,
    batch 1024, Adam 2e-3; chains of TTVF1_K train steps (on the card one
    captured step replayed) and, after each, validation micro-F1 on a fixed
    set of TTVF1_KV batches with a fixed eval seed, until it reaches
    ``target`` or ``max_chains`` chains ran. The train seconds exclude the
    first chain (the capture) and the evaluations; the first chain is
    counted at the mean of the others. ``freeze``: the bandit ablation,
    sampling from the arm weights but never updating them.
    ``seed_offset``: moves the weights' seed (1) and the draws' (2) by
    1000 times it."""
    from bliss_gnn_tpu_torch.graph.datasets import load_dataset
    from bliss_gnn_tpu_torch.graph.structure import (
        DeviceGraph,
        Graph,
        normalized_edata,
    )
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )
    from bliss_gnn_tpu_torch.train.metrics import f1_compute
    from bliss_gnn_tpu_torch.train.steps import (
        TrainState,
        make_multi_eval_step,
        make_multi_train_step,
        make_optimizer,
    )

    g, n_classes, ml = load_dataset("synth-pubmed-hard")
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    dg = DeviceGraph.from_graph(g, device=dev)
    K, Kv, bs = TTVF1_K, TTVF1_KV, 1024
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(256, 128, 64),
                        exp3_freeze=freeze)
    plan = CapacityPlan.build(bs, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind)
    model = build_model("sage", int(g.ndata["features"].shape[1]), 256,
                        n_classes, 3, device=dev, seed=1 + 1000 * seed_offset)
    rng = np.random.default_rng(0)
    train_ids = np.where(g.ndata["train_mask"])[0]
    val_ids = np.where(g.ndata["val_mask"])[0]
    rng.choice(train_ids, bs)  # the reference's initialisation batch
    opt, sched = make_optimizer(model.parameters(), 2e-3,
                                max(1, len(train_ids) // bs),
                                capturable=dev.type == "cuda")
    state = TrainState(model, opt, sched,
                       init_exp3_weights(3, g.n_edges, device=dev),
                       torch.Generator(device=dev).manual_seed(
                           2 + 1000 * seed_offset))
    multi = make_multi_train_step(dg, cfg, plan, ml, K, device=dev)
    eval_multi = make_multi_eval_step(dg, cfg, plan, ml, device=dev)
    val_seeds = torch.from_numpy(
        rng.choice(val_ids, (Kv, bs)).astype(np.int32)).to(dev)
    val_mask = torch.ones((Kv, bs), dtype=torch.bool, device=dev)
    eval_gen = torch.Generator(device=dev)

    def val_f1():
        f1, _, _ = eval_multi(state, eval_gen.manual_seed(7), val_seeds,
                              val_mask)
        return float(f1_compute(f1, ml))

    def chain():
        s = torch.from_numpy(rng.choice(train_ids, (K, bs)).astype(
            np.int32)).to(dev)
        t0 = time.perf_counter()
        _, m = multi(state, s, torch.ones((K, bs), dtype=torch.bool,
                                          device=dev))
        sync(torch, dev)
        return time.perf_counter() - t0, m

    _, m = chain()  # warm-ups and the capture
    curve = [val_f1()]
    losses = m["train_loss"].tolist()
    steps, train_s = K, 0.0
    reached = curve[-1] >= target
    for _ in range(max_chains - 1):
        if reached:
            break
        dt, m = chain()
        train_s += dt
        steps += K
        losses += m["train_loss"].tolist()
        curve.append(val_f1())
        reached = curve[-1] >= target
    if steps > K:
        train_s += train_s / (steps / K - 1)
    elif reached:
        train_s, _ = chain()
    return {"steps": steps, "reached": reached, "train_seconds": train_s,
            "val_f1_curve": curve, "final_val_f1": curve[-1],
            "loss_first_last": [losses[0], losses[-1]],
            "finite": all(math.isfinite(x) for x in losses)}


def ttvf1_phase(torch, dev, wrappers, smi_line):
    """Time to validation F1 0.90, live bandit then frozen. The frozen arm
    is capped at 1.3x the live steps plus a chain, as
    ``tests/test_bandit_ablation.py`` caps it, or at the live arm's 25
    chains when the live arm did not reach the target. Whether an arm
    reaches 0.90, its steps and the frozen/live step ratio are
    measurements: the target lies on the plateau of the validation curve
    (0.892-0.900 at other seeds in the reference package too), so a run
    from the same seeds reaches it or not as the atomic sums' order falls
    (``tools/ttvf1_repeat.py``). The gate is that both arms learn: finite
    losses, and validation F1 at least 0.85 (chance is 1/3) and 0.05 over
    its first reading."""
    reset_counts(wrappers)
    t0 = time.perf_counter()
    live = time_to_val_f1(torch, dev)
    live_s = time.perf_counter() - t0
    launches = {k: wrappers[k].launches for k in
                ("scatter_add", "lut_gather", "segment_sum", "exp3_apply")}
    cap = (math.ceil(1.3 * live["steps"] / TTVF1_K) + 1 if live["reached"]
           else 25)
    t0 = time.perf_counter()
    frozen = time_to_val_f1(torch, dev, max_chains=cap, freeze=True)
    frozen_s = time.perf_counter() - t0
    ratio = frozen["steps"] / live["steps"] if live["reached"] else None
    emit({"phase": "ttvf1", "target": 0.90, "chain_steps": TTVF1_K,
          "val_batches": TTVF1_KV, "live": live, "frozen": frozen,
          "frozen_cap_chains": cap, "frozen_over_live_steps": ratio,
          "ratio_is_a_lower_bound": ratio is not None
          and not frozen["reached"],
          "live_phase_seconds": live_s, "frozen_phase_seconds": frozen_s,
          "seconds": live_s + frozen_s,
          "launches_live": launches, "nvidia_smi": smi_line})
    missing = [k for k, v in launches.items() if v <= 0]
    learned = {arm: r["finite"] and max(r["val_f1_curve"]) >= 0.85
               and max(r["val_f1_curve"]) >= r["val_f1_curve"][0] + 0.05
               for arm, r in (("live", live), ("frozen", frozen))}
    if missing or not all(learned.values()):
        fail(f"ttvf1: kernels not launched {missing}, or an arm did not "
             f"learn: {learned}")

if __name__ == "__main__":
    main()
