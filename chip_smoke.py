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

Then the parallel layer (``bliss_gnn_tpu_torch/parallel``): after the
main path, ``dp_path`` and ``sharded_path`` run its configuration through
the DP step and the sharded step on a one-rank NCCL mesh, each held
against the nearer of two fused twins from one state, eager and replayed
(the same blocks, equal up to the unsorted routes' atomic order, as the
two twins are to each other), with its collectives a step; after
``inference``,
``sharded_inference`` runs the trained SAGE and GATv2 node-sharded
(K7 with its partial outputs, which the ``kernel`` phase holds against
the plain version); last, ``dp2`` spawns two ranks on the one card under
gloo (synth-pubmed: DP against sharded steps, ring inference at S = 2,
then ``cli.main(["--dp", "2", "--shard-graph", ...])``).

Then the reference's precision settings (phase ``precision``, after
``sharded_inference``): the main path's configuration at f32 compute with
f32 arm weights (K4's 32-bit route), with bf16 parameters, and GATv2 at
f32 compute, each against eager twins, then f32 full-graph inference of
the f32 SAGE and GATv2 (K6 and K7 on their f32 routes); the kernel rows
add K3, K4, K5, K6 and K7 at f32. The small steps are also held against
the CPU at f32, and ``cli_small`` runs ``--precision highest``.

The K4 rows add its repeats route (the gathered deltas of data-parallel
ranks, which repeat an edge: a group-by, ``max_repeats=4``) at four
ranks' shape, bit for bit the CPU's plain version and the sorted route it
replaced (``old_route_*``: timed beside it), with one profiled call's
device work by kernel (only its memset and two kernels); its launches on
one card are ``dp2``'s.

Last, phase ``bench_torch``: ``python3 bench_torch.py`` (the reference
benchmark's keys measured through the port) in a subprocess with its
default switches but the full SBM section, its line checked for the keys
``bench.py`` prints on one card; the kernel rows add the two shapes it
gives K6 and K7 (F = 602 f32 with edge weights; (1, 256)), with its
launches. The main path's graph is ``harness_torch.build_graph``'s, cached
in ``.bench_cache/torch/``, so the subprocess reads it back.

``python3 chip_smoke.py --cards 4`` runs only the parallel layer across
four cards of one host, one NCCL rank a card (it refuses, before any work,
with fewer cards visible): the Reddit-shaped CSC built once and shared as
``.npy`` files, then groups of 1, 2 and 4 ranks, a new spawn each, at the
main path's configuration with a local batch of 256 a rank:

    multicard_dp       the DP step: 13 eager steps, the captured chained
                       step (10 synced replays, a 10-chain), eager steps
                       and replays against two eager DP twins from one
                       state (the twins against each other: the floor);
                       after every step the parameters, Adam state and arm
                       weights bit-equal across the ranks, K4 against its
                       plain version on the gathered list;
    multicard_sharded  the range-sharded step so, against DP twins (blocks
                       equal to the DP step's);
    multicard_gat      GATv2 through the DP step at S = 4 (K5);
    multicard_inference  ring inference of the trained SAGE and GATv2 at
                       S = 4 against the one-device pass on each card;
    multicard_cli      ``cli.main`` with ``--dp 4``, then ``--dp 4
                       --shard-graph`` (checkpoint, ``final_eval``);
    multicard_scaling  replayed and chained step ms at S = 1, 2, 4, weak
                       scaling, sampled edges a second, collectives, bytes
                       and memory a rank, the cards and NCCL's version.

Run from the root of a checkout:  python3 chip_smoke.py [--cards 4]
Every phase prints one JSON line. The line before the last is the kernels'
summary (one card) or the scaling summary (--cards 4), the last line the
device record. Any failed check exits non-zero.
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

from harness_torch import (
    BATCH,
    BlockRecorder,
    FANOUTS,
    GAT_HEADS,
    HIDDEN,
    LOCKSTEP_STEPS,
    MULTICARD_CFG,
    MULTICARD_SIZES,
    N_CLASSES,
    N_FEATS,
    N_NODES,
    SHARDED_TOLERANCE,
    TIMED_STEPS,
    TTVF1_K,
    TTVF1_KV,
    WARMUP_STEPS,
    bf16_ulp,
    build_graph,
    emit,
    expected_keys,
    f32_ulp,
    fail,
    fresh_state,
    graph_from_csc,
    headline_inputs,
    host_view,
    load_train_state,
    multicard_phases,
    multicard_scaling,
    out_indptr,
    parallel_step_run,
    reddit_shaped_csc,
    reset_counts,
    roofline_ms,
    same_blocks,
    sharded_inference_records,
    spmm_cost,
    switches,
    sync,
    time_to_val_f1,
)

PREFIX_EDGES = 4_000_000  # the CSC prefix the inference checks run on
BF16_ULP = 2.0 ** -7


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


def device_breakdown(fn, torch, calls=5):
    """Device microseconds a call of ``fn`` by kernel (and memset), from
    ``torch.profiler`` over ``calls`` calls after one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / calls
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")}


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


def main_graph(torch, dev):
    """The main path's graph on ``dev`` (``graph_from_csc`` of the
    Reddit-shaped CSC, ``harness_torch.build_graph``'s: cached, so the
    ``bench_torch`` phase reads it back). Returns (graph, the CSC indptr in
    host memory, seconds)."""
    t0 = time.perf_counter()
    indptr_np, csc_src_np = build_graph()
    graph = graph_from_csc(dev, indptr_np, csc_src_np, N_FEATS,
                           N_CLASSES)
    del csc_src_np
    return graph, indptr_np, time.perf_counter() - t0


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="run only the multi-card phases, on this many "
                         "cards of one host (4), one NCCL rank a card")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "bliss_gnn_tpu_torch", "csrc")):
        fail("run from a checkout: bliss_gnn_tpu_torch/ is missing")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, here)
    if args.cards:
        multicard_main(torch, here, args.cards)
        return
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
    emit({"phase": "multicard", "not_in_this_run": True,
          "note": "the parallel layer across cards (NCCL between them, "
                  "S = 1, 2, 4) runs under python3 chip_smoke.py --cards 4 "
                  "on four cards of one host"})
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
    for name in ("sage", "gat", "gcn"):
        small_step_check(torch, dev, name, prec="f32")
    for name in ("sage", "gat"):
        small_replay_check(torch, dev, name)

    # -- phase 3a: graph and plan ----------------------------------------
    graph, indptr_np, graph_s = main_graph(torch, dev)
    n_edges = graph.n_edges
    deg_np = np.diff(indptr_np)
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=FANOUTS)
    plan = CapacityPlan.build(BATCH, FANOUTS, N_NODES, n_edges, kind=cfg.kind,
                              deg_std=float(deg_np.std()),
                              max_degree=int(deg_np.max()))
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, N_NODES, BATCH).astype(np.int32)).to(dev)
    smask = torch.ones(BATCH, dtype=torch.bool, device=dev)
    n_steps = WARMUP_STEPS + TIMED_STEPS

    def train(step_plan, seed, widen=False, cfg=cfg, on=None, steps=None,
              prec=None):
        """``steps`` (default ``n_steps``) fused steps from fresh weights
        and arm weights, of the model ``cfg.model``, on the graph ``on``
        (default the main path's), at the precision ``prec`` (see
        ``precision_kw``; default bf16 compute, f32 parameters, bf16 arm
        weights). With ``widen``, a step whose frontier or kept edges
        overflowed their caps widens the plan by 1.5x for the next step, as
        the reference trainer does after a refit. Returns the last plan
        too."""
        g = graph if on is None else on
        model_kw, exp3_dtype = precision_kw(torch, prec)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = build_model(cfg.model, N_FEATS, HIDDEN, N_CLASSES,
                            len(FANOUTS), num_in_heads=GAT_HEADS[0],
                            num_out_heads=GAT_HEADS[1], device=dev, seed=seed,
                            **model_kw)
        opt, sched = make_optimizer(model.parameters(), 2e-3, 100)
        exp3 = (init_exp3_weights(len(cfg.fanouts), n_edges, device=dev,
                                  dtype=exp3_dtype)
                if cfg.is_bandit else None)
        state = TrainState(model, opt, sched, exp3, gen)
        step = make_train_step(g, cfg, step_plan, False, device=dev)
        times, log = [], []
        for _ in range(n_steps if steps is None else steps):
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
                step = make_train_step(g, cfg, step_plan, False,
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
    sites["k4_gathered"] = gathered_k4_slots(torch, graph, cfg, final,
                                             state.exp3_weights)
    emit({"phase": "call_sites", "plan_block_e_caps": final.block_e_caps,
          "k4_gathered_slots_s4": int(sites["k4_gathered"][0].numel()),
          "k4_gathered_max_repeats": sites["k4_gathered"][3],
          **{k: v for k, v in sites.items()
             if not isinstance(v, (torch.Tensor, tuple))}})
    # -- phase 3c: the main path with the features in host memory -------
    uva_path(torch, graph, cfg, final, N_FEATS, N_CLASSES, wrappers,
             smi_line, step_med)
    sage_model = state.model
    del state, step, metrics_log
    torch.cuda.empty_cache()

    # -- phase 3d: the parallel layer at one rank (NCCL) ------------------
    mesh, hv = parallel_paths(torch, graph, indptr_np, cfg, final, seeds,
                              smask, wrappers, smi_line,
                              replay["replayed_step_ms"])

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
    # -- phase 5b: node-sharded inference at one rank (sharded_path) ------
    layer_launches.update(sharded_inference_phase(
        torch, mesh, hv, graph, {"sage": sage_model, "gat": gat_model},
        wrappers, smi_line))
    mesh.close()
    del hv

    # -- phase 5c: the reference's precision settings ---------------------
    del sage_model, gcn_model, gat_model
    torch.cuda.empty_cache()
    prec_launches, k3_f32_by_shape = precision_phase(
        torch, train, graph, indptr_np, cfg, final, gfinal, seeds, smask,
        wrappers, smi_line,
        {"step_ms": step_med, "replayed_step_ms": replay["replayed_step_ms"],
         "chained_step_ms": replay["chained_step_ms"],
         "peak_memory_bytes": peak})

    # -- phase 6: each kernel against its plain version -------------------
    rows = kernel_checks(torch, dev, final, n_edges, launches, sites,
                         by_shape, prec_launches, k3_f32_by_shape)
    rows += wide_kernel_checks(torch, dev, gfinal, graph, indptr_np,
                               gby_shape, gsites, layer_launches,
                               prec_launches)
    bench_rows = bench_kernel_rows(torch, dev, graph, indptr_np)
    rows += bench_rows

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

    # -- phase 8: host-resident features, node orders, on-disk readers ---
    uva_trainer_phase(torch, dev, wrappers, smi_line, workdir)
    uva_inference_phase(torch, dev, wrappers, smi_line)
    reorder_phase(torch, dev, wrappers, smi_line)
    ondisk_phase(torch, dev, wrappers, smi_line, workdir)

    # -- phase 9: two ranks on the one card (gloo) ------------------------
    k4_repeats = dp2_phase(torch, smi_line, workdir)
    for r in rows:  # K4's repeats route runs on this card in dp2's steps
        if r["name"].startswith("exp3_apply[repeats"):
            r["launches"] = k4_repeats
    shutil.rmtree(workdir, ignore_errors=True)

    # -- phase 10: bench_torch.py, the reference benchmark's keys ----------
    bench_torch_phase(here, smi_line, bench_rows)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


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


def gathered_k4_slots(torch, graph, cfg, plan, exp3, n_ranks=4, seed=5):
    """K4's input at S = ``n_ranks`` DP ranks: each rank's blocks sampled on
    ``plan`` from its own slice of a global batch (``--cards 4``'s seeds,
    rank r's generator ``rank_seed(seed, r)``), the deltas of every rank
    gathered layer by layer in rank order (``all_gather_deltas``), random
    exponents in [0, 0.5) on valid edges and 0 (a no-op slot) elsewhere,
    as ``exp3_delta_slots`` lays them out. Hub edges are sampled by
    several ranks, so indices repeat (up to ``n_ranks`` times). Returns
    (flat indices, factors, limit, the largest repeat count)."""
    from bliss_gnn_tpu_torch.parallel.mesh import rank_seed
    from bliss_gnn_tpu_torch.sampling.samplers import (
        exp3_delta_slots,
        sample_blocks,
    )

    dev = exp3.device
    B = plan.batch_size
    seeds_np = np.random.default_rng(0).integers(
        0, graph.n_nodes, n_ranks * B).astype(np.int32)
    smask = torch.ones(B, dtype=torch.bool, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    per_layer = None
    for r in range(n_ranks):
        gen = torch.Generator(device=dev).manual_seed(rank_seed(seed, r))
        seeds = torch.from_numpy(seeds_np[r * B:(r + 1) * B]).to(dev)
        blocks, _ = sample_blocks(graph, cfg, plan, gen, seeds, smask, exp3)
        lists = [(b.eid.reshape(-1), torch.where(
            b.e_mask.reshape(-1),
            torch.rand(b.eid.numel(), generator=g, device=dev) * 0.5, 0.0))
            for b in blocks]
        per_layer = lists if per_layer is None else [
            (torch.cat([a, x]), torch.cat([d, y]))
            for (a, d), (x, y) in zip(per_layer, lists)]
    idx, mult, limit = exp3_delta_slots(per_layer, exp3.shape[1])
    live = idx[idx < limit].long()
    _, cnt = torch.unique(live, return_counts=True)
    return idx, mult, limit, int(cnt.max().item())


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


LOCKSTEP_TOLERANCE = {"loss": 2.0 ** -7, "update": 2.0 ** -4,
                      "exp3": 2.0 ** -6}


def lockstep(torch, state, multi, twin, eager_step, seeds, smask, label,
             n=LOCKSTEP_STEPS):
    """``n`` chained steps of ``multi`` (one batch each) on
    ``state``, each held against an eager step of ``twin`` (built alike,
    its Adam state made by a step already) loaded with ``state`` just
    before: the same weights, Adam state, arm weights and generator, so the
    same blocks and dropout masks. The loss within 2^-7 of max(|loss|, 1),
    the parameter update within 2^-4 of the eager update's norm, the arm
    weights within 2^-6 (a few bf16 ulps); fails otherwise. Returns the
    errors."""
    s1, m1 = seeds[None], smask[None]
    lock = []
    for _ in range(n):
        load_train_state(twin, state)
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


def replayed_steps(torch, graph, cfg, plan, seeds, smask, seed, prec=None):
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
    into other blocks within a few steps. ``prec`` as in
    ``precision_kw``. Returns the median single
    replay, the chained time per step, the peak memory with the graph's
    pool, the losses and the lockstep errors, and a function that replays
    one more step (the profile's)."""
    from bliss_gnn_tpu_torch.train.steps import (
        CAPTURE_WARMUP_STEPS,
        make_multi_train_step,
        make_train_step,
    )

    dev = seeds.device
    fresh = fresh_fn(torch, graph, cfg, dev, seed, prec)
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


def precision_kw(torch, prec):
    """``build_model``'s dtype keywords and the arm weights' dtype of a
    precision setting: ``None`` the defaults (bf16 compute, f32
    parameters, bf16 arm weights), ``"f32"`` f32 compute and f32 arm
    weights (``--precision highest`` with ``exp3_dtype="float32"``),
    ``"bf16_params"`` bf16 compute and bf16 parameters."""
    f32, bf16 = torch.float32, torch.bfloat16
    dtype, pdtype, edtype = {None: (bf16, f32, bf16), "f32": (f32, f32, f32),
                             "bf16_params": (bf16, bf16, bf16)}[prec]
    return dict(dtype=dtype, param_dtype=pdtype), edtype


def fresh_fn(torch, graph, cfg, dev, seed, prec=None):
    """A maker of fresh training states of ``cfg.model`` at ``prec``: the
    weights and the generator from ``seed``, fresh arm weights, Adam
    capturable on the card."""
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights
    from bliss_gnn_tpu_torch.train.steps import TrainState, make_optimizer

    model_kw, exp3_dtype = precision_kw(torch, prec)

    def fresh():
        model = build_model(cfg.model, N_FEATS, HIDDEN, N_CLASSES,
                            len(cfg.fanouts), num_in_heads=GAT_HEADS[0],
                            num_out_heads=GAT_HEADS[1], device=dev,
                            seed=seed, **model_kw)
        opt, sched = make_optimizer(model.parameters(), 2e-3, 100,
                                    capturable=dev.type == "cuda")
        exp3 = (init_exp3_weights(len(cfg.fanouts), graph.n_edges,
                                  device=dev, dtype=exp3_dtype)
                if cfg.is_bandit else None)
        return TrainState(model, opt, sched, exp3,
                          torch.Generator(device=dev).manual_seed(seed))

    return fresh


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


# the small f32 steps, card against CPU: f32 sums in another order (the
# atomics, cuBLAS) over three steps. GATv2's arm weights keep the bf16
# steps' 2e-2: its reward divides each logit by its dst's sum of signed
# logits, so where that sum cancels the logits' f32 rounding comes back
# amplified (1.1e-3 seen on the H100 against the CPU)
F32_STEP_RTOL = 1e-4


def small_step_check(torch, dev, model_name, kind="poisson-bandit",
                     prec=None):
    """Three fused steps of ``model_name`` at a small size on the card
    (kernels) and on the CPU (plain versions), from the same weights and
    the same draws: the blocks must be identical, the losses, parameters
    and arm weights close (bf16 compute: rtol 2e-2; ``prec="f32"``, f32
    features, compute and arm weights: rtol ``F32_STEP_RTOL``, GATv2's arm
    weights 2e-2).
    ``kind="full"`` takes every in-edge of every dst (two full hops) and
    draws nothing."""
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
    model_kw, exp3_dtype = precision_kw(torch, prec)
    out = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        dg = DeviceGraph.from_graph(g, device=d,
                                    feature_dtype=model_kw["dtype"])
        model = build_model(model_name, 64, 32, n_cls, 2, dropout=0.0,
                            attn_drop=0.0, device=d, **model_kw)
        opt, sched = make_optimizer(model.parameters(), 1e-3, 10)
        st = TrainState(model, opt, sched,
                        init_exp3_weights(2, g.n_edges, device=d,
                                          dtype=exp3_dtype),
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
    # size, so a near-zero gradient whose sign differs between the two
    # paths moves it by up to 2 lr a step: the parameters are held to
    # 2e-2 relative (F32_STEP_RTOL at f32) plus 2.5 lr per step (the ratio
    # below must stay <= 1)
    rtol = 2e-2 if prec is None else F32_STEP_RTOL
    exp3_rtol = 2e-2 if prec is None or model_name == "gat" else rtol
    param_err = max(((k["params"][n] - c["params"][n]).abs()
                     / (rtol * c["params"][n].abs() + 2.5e-3 * 3)
                     ).max().item() for n in c["params"])
    exp3_err = ((k["exp3"] - c["exp3"]).abs()
                / c["exp3"].abs().clamp(min=1e-30)).max().item()
    emit({"phase": "small_step_vs_cpu", "model": model_name, "kind": kind,
          "precision": prec or "default", "same_blocks": same_blocks,
          "num_edges": [int(b.num_edges()) for b in blocks],
          "loss_cuda": k["losses"], "loss_cpu": c["losses"],
          "loss_rel_err": loss_err, "exp3_rel_err": exp3_err,
          "tolerance": rtol, "exp3_tolerance": exp3_rtol,
          "param_err_over_tolerance": param_err})
    if not same_blocks:
        fail(f"small {model_name} step: blocks differ between card and CPU")
    if not all(math.isfinite(x) for x in k["losses"]):
        fail(f"small {model_name} step: non-finite loss")
    if loss_err > rtol or param_err > 1.0 or exp3_err > exp3_rtol:
        fail(f"small {model_name} step ({prec or 'default'}): card and CPU "
             f"disagree")


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
    is max(bytes / HBM rate, f32 operations / f32 rate) of the call
    (``roofline_ms``)."""
    bound, by = roofline_ms(nbytes, flops)
    r = {"name": name, "route": "cuda",
         "source": f"bliss_gnn_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches,
         "max_abs_err": err, "tolerance": tol, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
         "library_ms": lib_ms, **extra}
    emit({"phase": "kernel", **r})
    return r


def csc_prefix(torch, graph, indptr_np):
    """The graph cut to the in-edges of its first k dst rows, k the least
    with at least PREFIX_EDGES edges: (graph, k, its edge count)."""
    k = int(np.searchsorted(indptr_np, PREFIX_EDGES))
    e_pre = int(indptr_np[k])
    indptr = graph.csc_indptr.clone()
    indptr[k:] = e_pre
    cut = dataclasses.replace(
        graph, csc_indptr=indptr, n_edges=e_pre,
        csr_indptr=out_indptr(graph.csc_src[:e_pre], graph.n_nodes))
    return cut, k, e_pre


def inference_phase(torch, graph, indptr_np, models, wrappers, smi_line,
                    dtype=None):
    """Layerwise inference of each trained model over the full graph, one
    pass each, layer by layer through ``inference_layer`` (the loop of
    ``layerwise_inference``) with a CUDA-event pair around every layer, in
    the compute ``dtype`` (bf16 by default; f32 names its kernel rows
    ``...,f32]``). The launch counts are set to 0 before the first model
    and read after the last. Then each model's logits on a CSC prefix
    against the same inference with the plain aggregations (uncounted).
    Returns the aggregation kernels' launches by kernel-row name (its
    shape)."""
    from bliss_gnn_tpu_torch.models.inference import (
        inference_layer,
        layerwise_inference,
    )
    from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention_plain
    from bliss_gnn_tpu_torch.ops.spmm import spmm_plain

    n_layers = len(FANOUTS)
    dtype = dtype or torch.bfloat16
    tag = "" if dtype == torch.bfloat16 else ",f32"
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
                rname = (f"gat_attention[H={conv.num_heads},"
                         f"O={conv.out_feats}{tag}]")
                width = conv.num_heads * conv.out_feats
            else:
                width = min(conv.in_feats, conv.out_feats)
                rname = f"spmm[F={width}{tag}]"
            before = wrappers[kname].launches
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            h = inference_layer(name, model, graph, l, h, n_layers,
                                dtype=dtype)
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
            n_launch = wrappers[kname].launches - before
            shape_launches[rname] = shape_launches.get(rname, 0) + n_launch
            # one src row per edge: what the kernel asks of memory
            # (computed from the edge count, not a measured byte count)
            layers.append({"layer": l, "ms": ms, "kernel": rname,
                           "edges_per_s": graph.n_edges / (ms / 1e3),
                           "launches": n_launch,
                           "row_read_bytes": graph.n_edges * width
                           * dtype.itemsize})
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
        got = layerwise_inference(name, model, prefix, n_layers,
                                  dtype=dtype)[:k]
        want = layerwise_inference(name, model, prefix, n_layers,
                                   dtype=dtype, **plain)[:k]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        emit({"phase": "inference", "model": name,
              "dtype": str(dtype).replace("torch.", ""),
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
                       shape_launches, prec_launches):
    """K5 at a GATv2 layer-0 block's two shapes, on uniform ids and on the
    ids of a sampled GATv2 layer-0 block (``sites``), with K3's sorted
    route on the sorted inputs; K6 and K7 at the inference shapes, checked
    on the CSC prefix and timed on the full graph, with one PyTorch library
    call as a yardstick where one computes the same function. ``by_shape``:
    K5's launches on the GAT path by route and shape. K5 on the real
    block, K6 and K7 at (4, 256) also at f32, with the precision phase's
    launches (``prec_launches``)."""
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
    # the same at f32 compute: f32 rows summed into f32
    real32 = torch.randn(real.shape, generator=g, device=dev)
    real32[sites["nv0"]:] = 0
    cases += [(f"{label},f32", ids, s, nv, ordered, real32)
              for label, ids, s, nv, ordered, _ in cases[-2:]]
    for label, ids, s, nv, ordered, data in cases:
        k5_by = (prec_launches["row_scatter_add_f32"]
                 if data.dtype == torch.float32 else by_shape)
        rows.append(k5_row(torch, dev, label, data, ids, s, nv, ordered,
                           route_launches(k5_by, "sorted" if ordered
                                          else "unsorted")))
    del data, real, real32, cases

    n, n_edges = graph.n_nodes, graph.n_edges
    prefix, k, e_pre = csc_prefix(torch, graph, indptr_np)
    ip, src = graph.csc_indptr, graph.csc_src
    pip = prefix.csc_indptr
    where = {"prefix_rows": k, "prefix_edges": e_pre}

    # K6: the SAGE aggregations, F = 256 (layers 0, 1) and 41 (layer 2)
    csr = torch.sparse_csr_tensor(
        ip, src[:n_edges], torch.ones(n_edges, device=dev), (n, n))
    for f, dt in ((HIDDEN, torch.bfloat16), (N_CLASSES, torch.bfloat16),
                  (HIDDEN, torch.float32), (N_CLASSES, torch.float32)):
        tag = ",f32" if dt == torch.float32 else ""
        x = torch.randn((n, f), generator=g, device=dev).to(dt)
        got, want = spmm(x, pip, src)[:k], spmm_plain(x, pip, src)[:k]
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        del got, want
        if err > tol:
            fail(f"spmm F={f} differs from its plain version: {err} > {tol}")
        xf = x.float()
        name = f"spmm[F={f}{tag}]"
        ld, cols, _ = spmm_plan(n, f, x.dtype)
        before = spmm.launches  # the wrapper counts each slice's launch
        spmm(x, ip, src)
        per_call = spmm.launches - before
        rows.append(kernel_row(
            name, (prec_launches if tag else shape_launches).get(name, 0),
            "spmm_csr.cu",
            "bliss_gnn_tpu/ops/spmm_pallas.py:259", err,
            "atol 1e-4 x max|plain| on the prefix",
            time_ms(lambda: spmm(x, ip, src), 5, torch, warmup=1),
            time_ms(lambda: spmm_plain(x, ip, src), 1, torch, warmup=0),
            time_ms(lambda: torch.sparse.mm(csr, xf), 3, torch, warmup=1),
            n * f * dt.itemsize + (n + 1) * 4 + n_edges * 4 + n * f * 4,
            n_edges * f,
            device_ms=device_time_ms(lambda: spmm(x, ip, src), torch, reps=3,
                                     replays=2),
            library_device_ms=device_time_ms(
                lambda: torch.sparse.mm(csr, xf), torch, reps=3, replays=2),
            kernel_launches_per_call=per_call, slice_cols=cols,
            padded_cols=ld,
            shape=f"{n} x {f} {'f32' if tag else 'bf16'}, {n_edges} edges",
            **where))
        del x, xf
    del csr

    # K7: the GATv2 attention, (H, O) = (4, 256) (layers 0, 1), (1, 41)
    for h, o, dt in ((GAT_HEADS[0], HIDDEN, torch.bfloat16),
                     (GAT_HEADS[1], N_CLASSES, torch.bfloat16),
                     (GAT_HEADS[0], HIDDEN, torch.float32)):
        tag = ",f32" if dt == torch.float32 else ""
        feat = torch.randn((n, h, o), generator=g, device=dev).to(dt)
        attn = torch.randn((1, h, o), generator=g, device=dev) / o ** 0.5
        got = gat_attention(feat, attn, 0.2, pip, src)[:k]
        want = gat_attention_plain(feat, attn, 0.2, pip, src)[:k]
        err = (got - want).abs().max().item()
        tol = 2e-4 * want.abs().max().item()
        del got, want
        if err > tol:
            fail(f"gat_attention ({h}, {o}) differs from its plain version: "
                 f"{err} > {tol}")
        name = f"gat_attention[H={h},O={o}{tag}]"
        op, splits = gat_plan(h, o, feat.dtype)
        before = gat_attention.launches
        gat_attention(feat, attn, 0.2, ip, src)
        per_call = gat_attention.launches - before
        rows.append(kernel_row(
            name, (prec_launches if tag else shape_launches).get(name, 0),
            "gat_attention.cu",
            "bliss_gnn_tpu/ops/gat_pallas.py:70", err,
            "atol 2e-4 x max|plain| on the prefix",
            time_ms(lambda: gat_attention(feat, attn, 0.2, ip, src), 3, torch,
                    warmup=1),
            time_ms(lambda: gat_attention_plain(feat, attn, 0.2, ip, src), 1,
                    torch, warmup=0),
            None,
            n * h * o * dt.itemsize + (n + 1) * 4 + n_edges * 4
            + n * h * o * 4 + h * o * 4, n_edges * h * (7 * o + 2),
            device_ms=device_time_ms(
                lambda: gat_attention(feat, attn, 0.2, ip, src), torch,
                reps=2, replays=2),
            kernel_launches_per_call=per_call, padded_cols=op,
            splits_per_head=splits,
            shape=f"{n} x {h} x {o} {'f32' if tag else 'bf16'}, "
                  f"{n_edges} edges", **where))
        if not tag:
            rows.append(k7_partials_row(torch, feat, attn, ip, src, pip, k,
                                        shape_launches, where))
        del feat
    return rows


def k7_partials_row(torch, feat, attn, ip, src, pip, k, shape_launches,
                    where):
    """K7 with its partial outputs (the per-(dst, head) max logit and
    softmax denominator the ring inference combines buckets with): on the
    CSC prefix the attention bit-equal to the call without them, the max
    and denominator against the plain version's; timed on the full graph
    beside the call without them."""
    from bliss_gnn_tpu_torch.ops.gat_attention import (
        gat_attention,
        gat_attention_plain,
    )

    n, h, o = feat.shape
    n_edges = int(ip[-1].item())
    got = gat_attention(feat, attn, 0.2, pip, src, partials=True)
    alone = gat_attention(feat, attn, 0.2, pip, src)
    want = gat_attention_plain(feat, attn, 0.2, pip, src, partials=True)
    same = torch.equal(got[0], alone)
    got_o, got_m, got_d = (t[:k] for t in got)
    want_o, want_m, want_d = (t[:k] for t in want)
    del got, alone, want
    fin = torch.isfinite(want_m)
    same_empty = torch.equal(fin, torch.isfinite(got_m))
    m_err = (got_m[fin] - want_m[fin]).abs().max().item()
    d_err = ((got_d[fin] - want_d[fin]).abs()
             / want_d[fin]).max().item()
    o_err = (got_o - want_o).abs().max().item()
    o_tol = 2e-4 * want_o.abs().max().item()
    m_tol = 1e-4 * max(1.0, want_m[fin].abs().max().item())
    del got_o, got_m, got_d, want_o, want_m, want_d
    if not (same and same_empty and o_err <= o_tol and m_err <= m_tol
            and d_err <= 1e-4):
        fail(f"gat_attention ({h}, {o}) partials differ from the plain "
             f"version: same {same}, empty rows {same_empty}, out {o_err} "
             f"> {o_tol}, max {m_err} > {m_tol}, denominator {d_err}")
    name = f"gat_attention[H={h},O={o},partials]"
    return kernel_row(
        name, shape_launches.get(name, 0), "gat_attention.cu",
        "bliss_gnn_tpu/ops/gat_pallas.py:70", max(m_err, o_err),
        "out 2e-4 x max|plain|, max 1e-4 x max(1, max|plain|), "
        "denominator rtol 1e-4, on the prefix",
        time_ms(lambda: gat_attention(feat, attn, 0.2, ip, src,
                                      partials=True), 3, torch, warmup=1),
        time_ms(lambda: gat_attention_plain(feat, attn, 0.2, ip, src,
                                            partials=True), 1, torch,
                warmup=0),
        None,
        n * h * o * 2 + (n + 1) * 4 + n_edges * 4 + n * h * o * 4
        + h * o * 4 + 2 * n * h * 4, n_edges * h * (7 * o + 2),
        device_ms=device_time_ms(
            lambda: gat_attention(feat, attn, 0.2, ip, src, partials=True),
            torch, reps=2, replays=2),
        without_partials_ms=time_ms(
            lambda: gat_attention(feat, attn, 0.2, ip, src), 3, torch,
            warmup=1),
        without_partials_device_ms=device_time_ms(
            lambda: gat_attention(feat, attn, 0.2, ip, src), torch, reps=2,
            replays=2),
        max_err_of_max=m_err, max_rel_err_of_denominator=d_err,
        max_abs_err_of_out=o_err, out_bit_equal_without_partials=same,
        shape=f"{n} x {h} x {o} bf16, {n_edges} edges", **where)


def k5_row(torch, dev, label, data, ids, s, nv, ordered, launches):
    """K5 on one input, against its plain version at both output dtypes:
    f32 within rtol 1e-5 + atol 1e-4, bf16 (each sum rounded once) within
    one bf16 ulp; two calls give the same bits. Timed at the path's output
    dtype, the payload's (bf16 at bf16 compute, f32 at f32; the bound
    too), with the other's device time beside it; on sorted ids K3's
    sorted route on the same inputs."""
    from bliss_gnn_tpu_torch.ops.rowscatter import (
        row_scatter_add,
        row_scatter_add_plain,
    )
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum, segment_sum_plain

    e, f = data.shape
    nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
    bf16, path = torch.bfloat16, data.dtype
    other = torch.float32 if path == bf16 else bf16

    def call(out_dtype=path):
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
    call()
    per_call = row_scatter_add.launches - before
    got_b = call(bf16)
    want_b = row_scatter_add_plain(data, ids, s, nv_d, ordered, bf16).float()
    diff_b = (got_b.float() - want_b).abs()
    bad_b = (diff_b > BF16_ULP * want_b.abs() + 1e-4).sum().item()
    if bad_b:
        fail(f"row_scatter_add ({label}, bf16 out) differs from its plain "
             f"version by more than one bf16 ulp in {bad_b} entries")
    same_bits = same_bits and torch.equal(call(bf16), got_b)
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
    lib = torch.zeros((s, f), device=dev, dtype=path)
    ids64 = ids.long()
    size = path.itemsize
    dname = str(path).replace("torch.", "")
    oname = str(other).replace("torch.", "")
    r = kernel_row(
        f"row_scatter_add[{label}]", launches, "row_scatter.cu",
        "bliss_gnn_tpu/ops/rowscatter_pallas.py:42", diff.max().item(),
        "f32 out: rtol 1e-5 + atol 1e-4; bf16 out: one bf16 ulp",
        time_ms(call, 20, torch),
        time_ms(lambda: row_scatter_add_plain(data, ids, s, nv_d, ordered,
                                              path), 5, torch),
        time_ms(lambda: lib.index_add_(0, ids64, data), 20, torch),
        nv * (f * size + 4) + s * f * size, nv * f,
        device_ms=device_time_ms(call, torch),
        **{f"{oname}_out_device_ms": device_time_ms(lambda: call(other),
                                                     torch)},
        library_device_ms=device_time_ms(
            lambda: lib.index_add_(0, ids64, data), torch),
        kernel_launches_per_call=per_call, out_dtype=dname,
        repeat_bitwise=same_bits,
        k5_route="sorted" if ordered else "unsorted",
        shape=f"{e} x {f} {'f32' if size == 4 else 'bf16'} rows ({nv} "
              f"valid) into {s}", **extra)
    del lib, diff
    return r


def route_launches(by_shape, route, f=None):
    """Launches of one route of K1 or K3 over the main path, all shapes (of
    K3's, those of row width ``f``)."""
    return sum(v for k, v in by_shape.items() if k.startswith(route + " ")
               and (f is None or k.endswith(f"x{f}")))


def kernel_checks(torch, dev, plan, n_edges, launches, sites, by_shape,
                  prec_launches, k3_f32_by_shape):
    """Each kernel and its plain version on the same card tensors, at the
    shapes of the main path's input-most layer (K1 and K3 at each call
    site's shape, from the real sampled block of ``sites``); plus one
    PyTorch library call of the same function as a yardstick. ``ms`` is
    event-timed over back-to-back wrapper calls, ``device_ms`` from
    CUDA-graph replays. ``by_shape``: K1's and K3's main-path launches by
    route and shape. K3 and K4 also at f32, the precision phase's
    (``prec_launches``: K4's f32-route launches; ``k3_f32_by_shape``: K3's
    launches in the f32 SAGE run)."""
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
    for (tag, f), dt in ((tf, dt) for dt in (torch.bfloat16, torch.float32)
                         for tf in (("0", HIDDEN), ("out", N_CLASSES))):
        f32 = dt == torch.float32
        k3_by = k3_f32_by_shape if f32 else by_shape["segment_sum"]
        for route, ids, n_out in (
                ("sorted", sites[f"e_dst{tag}"], sites[f"n_dst{tag}"]),
                ("unsorted", sites[f"e_src{tag}"], sites[f"n_src{tag}"])):
            e, nv3 = ids.shape[0], sites[f"nv{tag}"]
            sort = route == "sorted"
            data = torch.randn((e, f), generator=g, device=dev).to(dt)
            data[nv3:] = 0
            nv3_d = on_card(nv3)

            def call():
                return segment_sum(data, ids, n_out, nv3_d, ids_sorted=sort)

            got = call()
            want = segment_sum_plain(data, ids, n_out, nv3_d,
                                     ids_sorted=sort).float()
            diff = (got.float() - want).abs()
            err = diff.max().item()
            # bf16: one rounding of an f32 sum (one ulp); f32: sums in
            # another order
            rtol3, atol3 = (1e-5, 1e-4) if f32 else (BF16_ULP, 1e-3)
            bad = (diff > rtol3 * want.abs() + atol3).sum().item()
            site = ("aggregation" if sort else "gather backward") + (
                " layer 0" if tag == "0" else " output layer")
            if bad:
                fail(f"segment_sum ({route}, {site}) differs from its plain "
                     f"version in {bad} entries")
            if sort and not torch.equal(call(), got):
                fail(f"segment_sum ({site}): two calls give different bits")
            lib3 = torch.zeros((n_out, f), device=dev, dtype=dt)
            ids64 = ids.long()
            size = dt.itemsize
            rows.append(kernel_row(
                f"segment_sum[{route}, F={f}{',f32' if f32 else ''}: "
                f"{site}]",
                route_launches(k3_by, route, f),
                "segment_sum.cu", "bliss_gnn_tpu/ops/segsum_pallas.py:44",
                err, ("rtol 1e-5 + atol 1e-4" if f32 else
                      "rtol 2^-7 (one bf16 ulp) + atol 1e-3"),
                time_ms(call, 20, torch),
                time_ms(lambda: segment_sum_plain(data, ids, n_out, nv3_d),
                        5, torch),
                time_ms(lambda: lib3.index_add_(0, ids64, data), 20, torch),
                nv3 * (f * size + 4) + n_out * f * size, nv3 * f,
                device_ms=device_time_ms(call, torch),
                library_device_ms=device_time_ms(
                    lambda: lib3.index_add_(0, ids64, data), torch),
                launches_at_this_shape=k3_by.get(f"{route} {e}x{f}", 0),
                repeat_bitwise=sort or None,
                shape=f"{e} x {f} {'f32' if f32 else 'bf16'} ({nv3} valid) "
                      f"into {n_out}"))
            del data, lib3, got, want, diff

    # K4: the arm-weight update of one step, all three layers, on a state
    # of random weights, bf16 and f32 (the 32-bit route): distinct indices
    # as on the main path, 30% no-op slots (zero exponents); bitwise, then
    # within m - 1 ulps of the state's dtype with each index repeated m =
    # 1..8 times
    caps = plan.block_e_caps
    span = n_edges + EDGE_PAD
    limit = len(caps) * span
    u = sum(caps)
    for dt in (torch.bfloat16, torch.float32):
        f32 = dt == torch.float32
        ulp_of = f32_ulp if f32 else bf16_ulp
        idx = torch.cat([
            torch.randperm(n_edges, generator=g, device=dev)[:c] + l * span
            for l, c in enumerate(caps)]).to(torch.int32)
        idx = torch.where(torch.rand(u, generator=g, device=dev) < 0.3,
                          torch.full_like(idx, limit), idx)
        mult = torch.exp(torch.rand(u, generator=g, device=dev) * 0.5)
        st_k = (torch.rand(limit, generator=g, device=dev) + 0.5).to(dt)
        st_p = st_k.clone()
        k4[0](st_k, idx, mult, limit)
        k4[1](st_p, idx, mult, limit)
        err = (st_k.float() - st_p.float()).abs().max().item()
        if not torch.equal(st_k, st_p):
            fail(f"exp3_apply ({dt}) differs from its plain version on "
                 f"distinct indices (max |diff| {err})")
        valid = idx < limit
        base = idx[valid][: u // 4]
        reps = torch.randint(1, 9, (base.shape[0],), generator=g, device=dev)
        idx_d = base.repeat_interleave(reps)
        idx_d = idx_d[torch.randperm(idx_d.shape[0], generator=g,
                                     device=dev)]
        mult_d = torch.exp(torch.rand(idx_d.shape[0], generator=g,
                                      device=dev) * 0.5)
        k4[0](st_k, idx_d, mult_d, limit)
        k4[1](st_p, idx_d, mult_d, limit)
        uniq, cnt = torch.unique(idx_d.long(), return_counts=True)
        changed = torch.nonzero(st_k != st_p).squeeze(1)
        if not torch.isin(changed, uniq).all():
            fail(f"exp3_apply ({dt}) changed entries it was not given")
        a, b = st_k[uniq].float(), st_p[uniq].float()
        ulp = torch.maximum(ulp_of(a), ulp_of(b))
        dup_err = (a - b).abs()
        dup_ratio = (dup_err / ((cnt - 1).clamp(min=1) * ulp)).max().item()
        if ((cnt == 1) & (dup_err > 0)).any() or dup_ratio > 1.0:
            fail(f"exp3_apply ({dt}) with repeated indices is off by more "
                 f"than m - 1 ulps: {dup_ratio} x the tolerance")
        n_upd = int(valid.sum().item())
        idx_v, mult_v = idx[valid].long(), mult[valid].to(dt)
        kind = "f32" if f32 else "bf16"
        rows.append(kernel_row(
            "exp3_apply[f32]" if f32 else "exp3_apply",
            prec_launches["exp3_apply_f32"] if f32
            else launches["exp3_apply"], "exp3_apply.cu",
            "bliss_gnn_tpu/ops/exp3_pallas.py:62", err,
            f"bitwise on distinct indices; m - 1 {kind} ulps on an index "
            f"repeated m times",
            time_ms(lambda: k4[0](st_k, idx, mult, limit), 20, torch),
            time_ms(lambda: k4[1](st_p, idx, mult, limit), 5, torch),
            time_ms(lambda: st_p.scatter_reduce_(0, idx_v, mult_v, "prod"),
                    20, torch),
            u * 8 + n_upd * 2 * dt.itemsize, n_upd,
            device_ms=device_time_ms(lambda: k4[0](st_k, idx, mult, limit),
                                     torch),
            library_device_ms=device_time_ms(
                lambda: st_p.scatter_reduce_(0, idx_v, mult_v, "prod"),
                torch),
            host_us=host_us(lambda: k4[0](st_k, idx, mult, limit), torch),
            shape=f"{u} update slots ({n_upd} valid, distinct) into "
                  f"{limit} {kind}",
            dup_slots=idx_d.shape[0], dup_max_repeats=int(cnt.max().item()),
            dup_max_abs_err=dup_err.max().item(),
            dup_err_over_tolerance=dup_ratio))
        del st_k, st_p

    # K4's repeats route at S = 4's shape: four DP ranks' sampled deltas
    # gathered (hub edges repeat up to 4 times); the same bits on two
    # calls, bit for bit the CPU's plain version and the sorted route it
    # replaced (timed beside it), one profiled call with no device work
    # but the route's memset and two kernels. ``launches`` is its count on
    # the one card's path (dp2's DP steps at S = 2, filled in after that
    # phase)
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply_sorted_runs

    idx, mult, limit_g, max_rep = sites["k4_gathered"]
    st0 = (torch.rand(limit_g, generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    st_k, st_k2, st_o, st_p = (st0.clone() for _ in range(4))
    k4[0](st_k, idx, mult, limit_g, max_repeats=4)
    k4[0](st_k2, idx, mult, limit_g, max_repeats=4)
    exp3_apply_sorted_runs(st_o, idx, mult, limit_g)
    k4[1](st_p, idx, mult, limit_g)
    st_c = st0.cpu()
    k4[1](st_c, idx.cpu(), mult.cpu(), limit_g)
    live = idx[idx < limit_g].long()
    uniq = torch.unique(live)
    a, b = st_k[uniq].float(), st_p[uniq].float()
    ulps = ((a - b).abs() / torch.maximum(bf16_ulp(a),
                                         bf16_ulp(b))).max().item()
    err = (a - b).abs().max().item()
    same = {"two_calls": torch.equal(st_k, st_k2),
            "cpu_plain": torch.equal(st_k.cpu(), st_c),
            "sorted_route": torch.equal(st_k, st_o)}
    if not all(same.values()) or ulps > 1.0:
        fail(f"exp3_apply repeats route: bitwise {same}, {ulps} ulps off "
             f"the plain version on the card")
    n_upd, u_g = int(uniq.numel()), int(idx.numel())
    mult_v = mult[idx < limit_g].to(torch.bfloat16)

    def repeats():
        k4[0](st_k, idx, mult, limit_g, max_repeats=4)

    def sorted_runs():
        exp3_apply_sorted_runs(st_o, idx, mult, limit_g)

    # the profiler sees nothing on the card but the route's memset and
    # kernels (no sort); a profile that saw no device work is recorded
    device_us = device_breakdown(repeats, torch)
    foreign = [k for k in device_us
               if "exp3_group" not in k and "memset" not in k.lower()]
    if foreign:
        fail(f"exp3_apply repeats route: profiled device work {device_us} "
             f"(only its memset and kernels expected)")
    rows.append(kernel_row(
        "exp3_apply[repeats,S=4]", None, "exp3_apply.cu",
        "bliss_gnn_tpu/ops/exp3_pallas.py:62", err,
        "the same bits on every call, bit for bit the CPU's plain version "
        "and the sorted route; one bf16 ulp of the plain version on the "
        "card", time_ms(repeats, 20, torch),
        time_ms(lambda: k4[1](st_p, idx, mult, limit_g), 5, torch),
        time_ms(lambda: st_p.scatter_reduce_(0, live, mult_v, "prod"), 20,
                torch),
        u_g * 8 + n_upd * 4, n_upd,
        device_ms=device_time_ms(repeats, torch),
        library_device_ms=device_time_ms(
            lambda: st_p.scatter_reduce_(0, live, mult_v, "prod"), torch),
        host_us=host_us(repeats, torch),
        old_route_ms=time_ms(sorted_runs, 20, torch),
        old_route_device_ms=device_time_ms(sorted_runs, torch),
        old_route_host_us=host_us(sorted_runs, torch),
        profiled_device_us=device_us,
        launches_from="dp2: rank 0's DP steps at S = 2 on this card (two "
                      "kernels a step)",
        shape=f"{u_g} update slots (4 ranks x {u_g // 4}; "
              f"{int(live.numel())} valid, {n_upd} entries, an index up to "
              f"{max_rep} times) into {limit_g} bf16",
        max_ulps=ulps, repeat_bitwise=True, **{f"bitwise_{k}": v
                                                for k, v in same.items()}))
    del st0, st_k, st_k2, st_o, st_p, st_c
    return rows


# -- precision: f32 compute, f32 arm weights, bf16 parameters ------------------


def eager_as_chain(step):
    """An eager step called as a chained step of one batch (``lockstep``'s
    ``multi``): [1, B] seeds in, the loss stacked over K = 1 out."""
    def multi(state, s1, m1):
        state, m = step(state, s1[0], m1[0])
        return state, {"train_loss": m["train_loss"][None]}

    return multi


def twin_checks(torch, graph, cfg, plan, seeds, smask, seed, prec, n_eager,
                n_replay, label):
    """From a fresh state at ``prec``: ``n_eager`` eager steps, each held
    against an eager twin loaded with the state just before, then (with
    ``n_replay``) the step captured, TIMED_STEPS single replays timed (each
    synced) and ``n_replay`` replays held against eager twins, at the
    lockstep bounds. Returns the records and the replay times."""
    from bliss_gnn_tpu_torch.train.steps import (
        CAPTURE_WARMUP_STEPS,
        make_multi_train_step,
        make_train_step,
    )

    dev = seeds.device
    fresh = fresh_fn(torch, graph, cfg, dev, seed, prec)
    eager = make_train_step(graph, cfg, plan, False, device=dev)
    state, twin = fresh(), fresh()
    twin, _ = eager(twin, seeds, smask)  # makes the twin's Adam state
    out = {"eager_vs_eager": lockstep(torch, state, eager_as_chain(eager),
                                      twin, eager, seeds, smask,
                                      f"{label} eager", n=n_eager)}
    if n_replay:
        multi = make_multi_train_step(graph, cfg, plan, False, device=dev)
        s1, m1 = seeds[None], smask[None]
        for _ in range(CAPTURE_WARMUP_STEPS + 1):  # warm-ups, the capture
            state, _ = multi(state, s1, m1)
        single = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            state, _ = multi(state, s1, m1)
            sync(dev)
            single.append((time.perf_counter() - t0) * 1e3)
        out["replayed_step_ms"] = statistics.median(single)
        out["replayed_step_ms_all"] = single
        out["replayed_vs_eager"] = lockstep(
            torch, state, multi, twin, eager, seeds, smask,
            f"{label} replayed", n=n_replay)
    out["param_dtypes"] = sorted({str(p.dtype).replace("torch.", "")
                                  for p in state.model.parameters()})
    out["exp3_dtype"] = str(state.exp3_weights.dtype).replace("torch.", "")
    del state, twin
    return out


def precision_phase(torch, train, graph, indptr_np, cfg, plan, gplan, seeds,
                    smask, wrappers, smi_line, default_ms):
    """The reference's precision settings at the main path's configuration
    (``default_ms``: the default paths' numbers from this run, printed
    beside): on a copy of the graph with f32 features, SAGE-256 x3 at f32
    compute with f32 arm weights (13 counted eager steps on the main
    path's final plan: K1-K4, K4 on its 32-bit route; 10 single replays
    and a 10-chain with 3 replays against eager twins; 3 eager steps
    against eager twins); SAGE with bf16 parameters (3 eager steps and one
    replay against eager twins); GATv2 at f32 compute on the GATv2 plan (3
    eager steps, K5 on f32 rows); then f32 full-graph inference of the f32
    SAGE and GATv2 (K6 and K7 on their f32 routes), checked on the CSC
    prefix. Returns the launches the kernel rows read and the f32 SAGE
    step's K3 launches by shape."""
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
    from bliss_gnn_tpu_torch.ops.rowscatter import row_scatter_add
    from bliss_gnn_tpu_torch.sampling.samplers import SamplerConfig

    dev = seeds.device
    t0 = time.perf_counter()
    g32 = dataclasses.replace(graph, ndata={
        **graph.ndata, "features": graph.ndata["features"].float()})
    kernels = ("scatter_add", "lut_gather", "segment_sum", "exp3_apply")
    # the default precision's eager steps in this phase, just before the
    # f32 ones: eager times drift over the script's run (PERF.md §7)
    *_, default_times, _, _ = train(plan, seed=0, widen=True)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    state, step, times, log, final = train(plan, seed=0, widen=True, on=g32,
                                           prec="f32")
    launches = {k: wrappers[k].launches for k in kernels}
    k4_routes = dict(exp3_apply.launches_by_shape)
    k3_by_shape = dict(wrappers["segment_sum"].launches_by_shape)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["train_loss"]) for m in log]
    exp3_dtype = state.exp3_weights.dtype
    sage32 = state.model
    del state, step
    replay, replay_one = replayed_steps(torch, g32, cfg, final, seeds, smask,
                                        seed=0, prec="f32")
    del replay_one
    eager_twins = twin_checks(torch, g32, cfg, final, seeds, smask, 0, "f32",
                              LOCKSTEP_STEPS, 0, "precision f32")
    bf16_params = twin_checks(torch, graph, cfg, final, seeds, smask, 0,
                              "bf16_params", LOCKSTEP_STEPS, 1,
                              "precision bf16 parameters")
    torch.cuda.empty_cache()

    # GATv2 at f32 compute, 3 eager steps on the GATv2 plan
    gcfg = SamplerConfig(kind=cfg.kind, fanouts=FANOUTS, model="gat")
    reset_counts(wrappers)
    gstate, _, gtimes, glog, _ = train(gplan, seed=2, widen=True, cfg=gcfg,
                                       on=g32, steps=3, prec="f32")
    k5_by_shape = dict(row_scatter_add.launches_by_shape)
    glaunches = {k: wrappers[k].launches
                 for k in kernels + ("row_scatter_add",)}
    glosses = [float(m["train_loss"]) for m in glog]
    gat32 = gstate.model
    del gstate
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "precision", "steps": len(log),
          "features_dtype": "float32", "exp3_dtype": str(exp3_dtype),
          "step_ms": statistics.median(times[WARMUP_STEPS:]),
          "step_ms_all": times[WARMUP_STEPS:], "loss": losses,
          "launches": launches,
          "launches_per_step": {k: v / len(log) for k, v in launches.items()},
          "exp3_apply_launches_by_route": k4_routes,
          "peak_memory_bytes": peak, **replay,
          "eager_vs_eager_twins": eager_twins,
          "bf16_params": bf16_params,
          "gat_f32_step_ms_all": gtimes, "gat_f32_loss": glosses,
          "gat_f32_launches": glaunches,
          "gat_f32_row_scatter_add_by_shape": k5_by_shape,
          "default_precision_same_run": default_ms,
          "default_step_ms_same_phase": statistics.median(
              default_times[WARMUP_STEPS:]),
          "default_step_ms_same_phase_all": default_times[WARMUP_STEPS:],
          "seconds_before_inference": seconds, "nvidia_smi": smi_line})
    if not all(math.isfinite(x) for x in losses + glosses
               + replay["replayed_loss"]):
        fail(f"precision: non-finite loss {losses} {glosses}")
    missing = [k for k, v in launches.items() if v <= 0]
    if route_launches(k4_routes, "f32") <= 0:
        missing.append("exp3_apply f32 route")
    if exp3_dtype != torch.float32:
        missing.append(f"f32 arm weights (got {exp3_dtype})")
    missing += [f"row_scatter_add {route}" for route in ("sorted", "unsorted")
                if route_launches(k5_by_shape, route) <= 0]
    if missing:
        fail(f"precision: not launched or not in f32: {missing}")
    if bf16_params["param_dtypes"] != ["bfloat16"]:
        fail(f"precision: bf16 parameters came out as "
             f"{bf16_params['param_dtypes']}")

    # f32 full-graph inference of the f32 SAGE and GATv2
    shape_launches = inference_phase(
        torch, g32, indptr_np, {"sage": sage32, "gat": gat32}, wrappers,
        smi_line, dtype=torch.float32)
    del sage32, gat32, g32
    torch.cuda.empty_cache()
    return dict(shape_launches, exp3_apply_f32=route_launches(k4_routes,
                                                              "f32"),
                row_scatter_add_f32=k5_by_shape), k3_by_shape


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
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
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
    sync(dev)
    fit_s = time.perf_counter() - t0
    memory(plans[-1])
    tr.restore_best()
    t0 = time.perf_counter()
    res = tr.final_eval()
    sync(dev)
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
    sync(dev)
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
    steps, and SAGE once more with ``--precision highest`` (f32 compute):
    the reference's series in ``metrics.csv``, the final F1s in [0, 1],
    the launches of each run (K1-K4 in the steps; K6 or K7 in the final
    eval)."""
    from bliss_gnn_tpu_torch.train import cli

    t_phase = time.perf_counter()
    runs = {}
    for model, final_kernel, extra in (
            ("sage", "spmm", []), ("gat", "gat_attention", []),
            ("sage", "spmm", ["--precision", "highest"])):
        label = model + ("_precision_highest" if extra else "")
        logdir = os.path.join(workdir, f"cli_{label}")
        argv = ["--dataset", "synth-small", "--model", model,
                "--num-layers", "2", "--fan-out", "32,16", "--batch-size",
                "64", "--num-steps", "12", "--logdir", logdir, *extra]
        if dev.type == "cpu":
            argv += ["--platform", "cpu"]
        reset_counts(wrappers)
        t0 = time.perf_counter()
        res = cli.main(argv)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = {k: v.launches for k, v in wrappers.items()}
        run_dir = os.path.join(logdir, os.listdir(logdir)[0], "version_0")
        names = set(read_series(run_dir))
        want = set(REFERENCE_SERIES) | {f"num_nodes/{i}" for i in range(3)} \
            | {f"num_edges/{i}" for i in range(2)}
        runs[label] = {"seconds": secs, "final_accuracy": res[0],
                       "launches": launches,
                       "missing_series": sorted(want - names)}
        missing = [k for k in ("scatter_add", "lut_gather", "segment_sum",
                               "exp3_apply", final_kernel)
                   if launches[k] <= 0]
        if missing or want - names or not 0.0 <= res[0]["Test"] <= 1.0:
            fail(f"cli_small {label}: kernels not launched {missing}, "
                 f"series missing {sorted(want - names)}, result {res}")
    emit({"phase": "cli_small", **runs,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line})


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
    live = time_to_val_f1(dev)
    live_s = time.perf_counter() - t0
    launches = {k: wrappers[k].launches for k in
                ("scatter_add", "lut_gather", "segment_sum", "exp3_apply")}
    cap = (math.ceil(1.3 * live["steps"] / TTVF1_K) + 1 if live["reached"]
           else 25)
    t0 = time.perf_counter()
    frozen = time_to_val_f1(dev, max_chains=cap, freeze=True)
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


# -- host-resident features (UVA), node orders, on-disk readers ------------

UVA_CACHE_ROWS = 65_536  # uva_path: 28% of the Reddit-shaped graph's nodes
UVA_STEPS, UVA_TIMED = 20, 10


def _seconds(torch, dev, fn):
    """(fn's result, its seconds to a sync)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def uva_path(torch, graph, cfg, plan, n_feats, n_classes, wrappers,
             smi_line, eager_step_ms, steps=UVA_STEPS, timed=UVA_TIMED,
             cache_rows=UVA_CACHE_ROWS, hidden=HIDDEN, batch=BATCH,
             seed=12):
    """The main path's configuration with the features in host memory: the
    device graph without them, a cold ``FeatureCache`` of ``cache_rows``
    rows over their f32 host copy, and ``steps`` split steps (sample, host
    fetch through the cache, train: ``make_uva_steps``) on ``plan`` from
    fresh weights, each on a batch of random seeds. Prints the medians over
    the last ``timed`` steps of the step's ms and its sample, fetch and
    train parts (each ended by a sync), of the miss rate and of the
    host-to-device bytes, beside the main path's eager ``step_ms``. Then
    the gate: LOCKSTEP_STEPS more split steps, each against an eager fused
    step of a twin loaded with the same state, on the same batch: the
    blocks (the fused twin's drawn again from the same generator state),
    the loss, update and arm weights at ``lockstep``'s tolerances. A
    block's src slots may differ only where the unsorted importance sums'
    atomic order flips a draw: at most 1e-3 of them."""
    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.samplers import (
        init_exp3_weights,
        sample_blocks,
    )
    from bliss_gnn_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step,
        make_uva_steps,
    )

    dev = graph.device
    t0 = time.perf_counter()
    host = graph.ndata["features"].float().cpu().numpy()
    host_copy_s = time.perf_counter() - t0
    bare = dataclasses.replace(graph, ndata={
        k: v for k, v in graph.ndata.items() if k != "features"})
    n_layers = len(cfg.fanouts)

    def fresh():
        model = build_model(cfg.model, n_feats, hidden, n_classes, n_layers,
                            device=dev, seed=seed)
        opt, sched = make_optimizer(model.parameters(), 2e-3, 100)
        return TrainState(model, opt, sched,
                          init_exp3_weights(n_layers, graph.n_edges,
                                            device=dev),
                          torch.Generator(device=dev).manual_seed(seed))

    sample_fn, train_fn, _ = make_uva_steps(bare, cfg, plan, False,
                                            device=dev)
    cache = FeatureCache(host, cache_rows, device=dev)
    rng = np.random.default_rng(seed)
    smask = torch.ones(batch, dtype=torch.bool, device=dev)

    def draw():
        return torch.from_numpy(rng.integers(
            0, graph.n_nodes, batch).astype(np.int32)).to(dev)

    def uva_step(state, seeds, smask):
        (blocks, _), t_s = _seconds(torch, dev,
                                    lambda: sample_fn(state, seeds, smask))
        b0 = cache.bytes_fetched
        (x, miss), t_f = _seconds(torch, dev, lambda: cache.gather(
            blocks[0].src_gids, blocks[0].src_mask))
        (out, m), t_t = _seconds(torch, dev,
                                 lambda: train_fn(state, blocks, x))
        rec = {"sample_ms": t_s * 1e3, "fetch_ms": t_f * 1e3,
               "train_ms": t_t * 1e3, "step_ms": (t_s + t_f + t_t) * 1e3,
               "miss_rate": miss, "h2d_bytes": cache.bytes_fetched - b0,
               "loss": float(m["train_loss"])}
        return out, m, blocks, rec

    reset_counts(wrappers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state, log = fresh(), []
    for _ in range(steps):
        state, _, _, rec = uva_step(state, draw(), smask)
        log.append(rec)
    launches = {k: wrappers[k].launches for k in
                ("scatter_add", "lut_gather", "segment_sum", "exp3_apply")}
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    tail = log[-timed:]
    med = {k: statistics.median(r[k] for r in tail)
           for k in ("step_ms", "sample_ms", "fetch_ms", "train_ms",
                     "miss_rate", "h2d_bytes")}

    # the gate: split steps against fused twins from one state
    eager_step = make_train_step(graph, cfg, plan, False, device=dev)
    twin = fresh()
    twin, _ = eager_step(twin, draw(), smask)  # makes its Adam state
    tol, lock = LOCKSTEP_TOLERANCE, []
    for _ in range(LOCKSTEP_STEPS):
        seeds = draw()
        load_train_state(twin, state)
        g_twin = torch.Generator(device=dev)
        g_twin.set_state(twin.generator.get_state())
        with torch.no_grad():
            want_blocks, _ = sample_blocks(graph, cfg, plan, g_twin, seeds,
                                           smask, twin.exp3_weights)
        pre = [p.detach().clone() for p in state.model.parameters()]
        twin, me = eager_step(twin, seeds, smask)
        state, mu, blocks, _ = uva_step(state, seeds, smask)
        d_e = torch.cat([(p.detach() - q).flatten().float() for p, q in
                         zip(twin.model.parameters(), pre)])
        d_u = torch.cat([(p.detach() - q).flatten().float() for p, q in
                         zip(state.model.parameters(), pre)])
        le, lu = float(me["train_loss"]), float(mu["train_loss"])
        w_e, w_u = twin.exp3_weights.float(), state.exp3_weights.float()
        diff = [int((a.src_gids != b.src_gids).sum())
                for a, b in zip(blocks, want_blocks)]
        valid = [int(b.src_mask.sum()) for b in want_blocks]
        lock.append({
            "loss_fused": le, "loss_uva": lu,
            "loss_err": abs(lu - le) / max(abs(le), 1.0),
            "update_norm": float(d_e.norm()),
            "update_err": float((d_u - d_e).norm()
                                / d_e.norm().clamp(min=1e-30)),
            "exp3_err": float(((w_u - w_e).abs()
                               / w_e.abs().clamp(min=1e-30)).max()),
            "blocks_equal": all(torch.equal(a.src_gids, b.src_gids)
                                and torch.equal(a.e_src, b.e_src)
                                and torch.equal(a.e_mask, b.e_mask)
                                for a, b in zip(blocks, want_blocks)),
            "src_slots_differing": diff, "src_slots_valid": valid})
        del pre, d_e, d_u, w_e, w_u, want_blocks
    rec = {"phase": "uva_path", "steps": steps, "timed_steps": timed,
           "cache_rows": cache.capacity,
           "cache_share_of_nodes": cache.capacity / graph.n_nodes,
           "host_feature_bytes": int(host.nbytes),
           "host_copy_seconds": host_copy_s,
           **{f"{k}_median": v for k, v in med.items()},
           "main_path_eager_step_ms": eager_step_ms,
           "steps_all": log, "miss_rate_cumulative": cache.miss_rate,
           "launches": launches, "peak_memory_bytes": peak,
           "lockstep_vs_fused": lock, "lockstep_tolerance": tol,
           "nvidia_smi": smi_line}
    emit(rec)
    bad = [r for r in lock
           if not (r["loss_err"] <= tol["loss"]
                   and r["update_err"] <= tol["update"]
                   and r["exp3_err"] <= tol["exp3"] and r["update_norm"] > 0
                   and all(d <= 1e-3 * v for d, v in
                           zip(r["src_slots_differing"],
                               r["src_slots_valid"])))]
    missing = [k for k, v in launches.items() if v <= 0]
    if bad or missing or not all(math.isfinite(r["loss"]) for r in log):
        fail(f"uva_path: kernels not launched {missing}, or split steps "
             f"differ from fused steps: {lock}")
    del state, twin, cache, host
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


UVA_TRAINER_CFG = dict(dataset="synth-papers100m-small", model="sage",
                       sampler="poisson-bandit", fan_out=FANOUTS,
                       batch_size=BATCH, num_hidden=HIDDEN, num_layers=3,
                       num_steps=60, use_uva=True, cache_size=131_072)


def uva_trainer_phase(torch, dev, wrappers, smi_line, workdir,
                      cfg_kw=UVA_TRAINER_CFG):
    """``Trainer`` with ``use_uva`` on synth-papers100m-small (500,000
    nodes, 8M edges, 128 features, 172 classes, 1.4% labelled) loaded by
    name, checkpointing on: ``fit`` (eager split steps; a validation at
    each epoch's end), ``restore_best``, ``final_eval`` (chunked from host
    memory: K6 over each chunk's CSC slice). Prints the ``cache_miss``
    series, the step ms, the validation seconds, ``final_eval``'s seconds
    and its host and device parts, the peak device memory. Gates: no
    features in the device graph; K1-K4 and K6 launched; the UVA logits
    within 1e-2 x max|logit| of ``layerwise_inference`` (K6) on the same
    parameters, the features uploaded for this check only."""
    from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
    from bliss_gnn_tpu_torch.models.inference import layerwise_inference
    from bliss_gnn_tpu_torch.train import trainer as ttrainer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    timing = {"validate": []}

    class Observed(ttrainer.Trainer):
        def _validate(self, epoch):
            out, s = _seconds(torch, dev, lambda: super(Observed, self)
                              ._validate(epoch))
            timing["validate"].append(s)
            return out

    parts = {}
    plain = ttrainer.layerwise_inference_uva

    def timed_uva(*a, **k):
        parts["logits"] = plain(*a, timings=parts, **k)
        return parts["logits"]

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    cfg = ttrainer.TrainConfig(**cfg_kw, logdir=workdir,
                               disable_checkpoint=False)
    tr, init_s = _seconds(torch, dev, lambda: Observed(cfg, device=dev))
    features_on_device = "features" in tr.graph.ndata
    _, fit_s = _seconds(torch, dev, tr.fit)
    peak_fit = torch.cuda.max_memory_allocated() if cuda else None
    tr.restore_best()
    ttrainer.layerwise_inference_uva = timed_uva
    try:
        res, final_s = _seconds(torch, dev, tr.final_eval)
    finally:
        ttrainer.layerwise_inference_uva = plain
    launches = {k: wrappers[k].launches for k in
                ("scatter_add", "lut_gather", "segment_sum", "exp3_apply",
                 "spmm")}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    series = read_series(tr.run_dir)
    fb = [v * 1e3 for _, v in series["forward_backward_time"]]
    miss = [v for _, v in series.get("cache_miss", [])]
    losses = [v for _, v in series["train_loss"]]
    ckpt = tr.checkpoint_path()
    # the check: the full-graph pass with the features uploaded
    heads = (cfg.num_in_heads,) * (cfg.num_layers - 1) + (cfg.num_out_heads,)
    dg = DeviceGraph.from_graph(tr.host_graph, device=dev)
    want = layerwise_inference(cfg.model, tr.state.model, dg, cfg.num_layers,
                               heads=heads).cpu()
    del dg
    logits = torch.from_numpy(parts.pop("logits"))
    err = float((logits - want).abs().max())
    scale = float(want.abs().max())
    rec = {"phase": "uva_trainer",
           "config": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in cfg_kw.items()},
           "n_nodes": tr.host_graph.n_nodes, "n_edges": tr.host_graph.n_edges,
           "train_nodes": len(tr.train_nid), "steps": tr.global_step,
           "init_seconds": init_s, "fit_seconds": fit_s,
           "step_ms": statistics.median(fb), "step_ms_all": fb,
           "cache_miss": miss, "cache_rows": tr.feature_cache.capacity,
           "h2d_bytes_per_step": tr.feature_cache.bytes_fetched
           / max(tr.global_step, 1),
           "validations": len(timing["validate"]),
           "validation_seconds": timing["validate"],
           "final_eval_seconds": final_s,
           "final_eval_host_seconds": parts.get("host_s"),
           "final_eval_device_seconds": parts.get("device_s"),
           "final_eval_chunks": parts.get("chunks"),
           "final_accuracy": res, "features_on_device": features_on_device,
           "checkpoint_bytes": (os.path.getsize(ckpt)
                                if os.path.exists(ckpt) else 0),
           "peak_memory_fit_bytes": peak_fit, "peak_memory_bytes": peak,
           "uva_vs_full_max_abs_err": err, "full_max_abs_logit": scale,
           "tolerance": "1e-2 x max|full logit|", "launches": launches,
           "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line}
    emit(rec)
    missing = [k for k, v in launches.items() if v <= 0]
    if (missing or features_on_device or err > 1e-2 * scale
            or len(miss) != tr.global_step
            or not all(math.isfinite(x) for x in losses)):
        fail(f"uva_trainer: kernels not launched {missing}, features on "
             f"the device {features_on_device}, logits {err} > 1e-2 x "
             f"{scale}, cache_miss logged {len(miss)} of {tr.global_step} "
             f"steps, or a non-finite loss")
    del tr, logits, want
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def uva_inference_phase(torch, dev, wrappers, smi_line, node_batch=512):
    """``layerwise_inference_uva`` of GATv2 and GCN (random weights, 2
    layers, hidden 256, the CLI's defaults) on synth-small, chunks of
    ``node_batch`` dsts, against the full-graph pass (K7, K6) with the
    features on the device: within 1e-2 x max|logit|; K6 and K7 launches
    per chunk and layer."""
    from bliss_gnn_tpu_torch.graph.datasets import load_dataset
    from bliss_gnn_tpu_torch.graph.structure import DeviceGraph, Graph
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.models.inference import (
        layerwise_inference,
        layerwise_inference_uva,
    )

    g, n_cls, _ = load_dataset("synth-small")
    g = Graph.canonicalize(g)
    dg = DeviceGraph.from_graph(g, device=dev)
    out = {}
    for name, kname in (("gat", "gat_attention"), ("gcn", "spmm")):
        model = build_model(name, g.ndata["features"].shape[1], HIDDEN,
                            n_cls, 2, device=dev, seed=5).eval()
        reset_counts(wrappers)
        parts = {}
        got, secs = _seconds(torch, dev, lambda: layerwise_inference_uva(
            name, model, g, 2, node_batch=node_batch, device=dev,
            timings=parts))
        launches = wrappers[kname].launches
        want = layerwise_inference(name, model, dg, 2).cpu().numpy()
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        out[name] = {"kernel": kname, "seconds": secs, **parts,
                     "launches": launches,
                     "launches_per_chunk_and_layer":
                     launches / (2 * parts["chunks"]),
                     "max_abs_err": err, "max_abs_logit": scale}
        if launches <= 0 or err > 1e-2 * scale or not np.isfinite(got).all():
            fail(f"uva_inference {name}: {out[name]}")
    emit({"phase": "uva_inference", "n_nodes": g.n_nodes,
          "n_edges": g.n_edges, "node_batch": node_batch, **out,
          "tolerance": "1e-2 x max|full logit|", "nvidia_smi": smi_line})


SBM_NODES, SBM_EDGES = 232_965, 20_000_000  # Reddit's nodes; edges cut


def reorder_phase(torch, dev, wrappers, smi_line, n_nodes=SBM_NODES,
                  n_edges=SBM_EDGES, f=256, heads=4, reps=(5, 3)):
    """K6 at F = ``f`` and K7 at (``heads``, ``f``) on ``sbm_graph``
    (Reddit's node count, its edge count cut to ``n_edges``; 50 latent
    communities) in its natural order and under ``locality_perm``'s
    ``degree``, ``cluster`` and ``hub-cluster`` orders: ``ms`` and
    ``device_ms`` of each kernel per order, the order's
    ``dense_coverage``, and each order's outputs un-permuted against the
    natural order's (K6 within 1e-3 x max, K7 within 1e-3 x max: the same
    sums in another order)."""
    from bliss_gnn_tpu_torch.graph import native
    from bliss_gnn_tpu_torch.graph.datasets import sbm_graph
    from bliss_gnn_tpu_torch.graph.reorder import (
        dense_coverage,
        locality_perm,
        propagate_labels,
    )
    from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention
    from bliss_gnn_tpu_torch.ops.spmm import spmm

    t0 = time.perf_counter()
    g, _, _ = sbm_graph(n_nodes, n_edges, 1, 41, seed=0)
    gen_s = time.perf_counter() - t0
    indptr, csc_src = g.csc_indptr, g.csc_src
    dst = np.repeat(np.arange(n_nodes, dtype=np.int64), np.diff(indptr))
    t0 = time.perf_counter()
    labels = propagate_labels(indptr, csc_src)
    lpa_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n_nodes, f), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    feat = torch.randn((n_nodes, heads, f), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    attn = torch.randn((heads, f), generator=gen, device=dev) * 0.05
    orders, ref, cuda = {}, {}, dev.type == "cuda"
    for order in ("natural", "degree", "cluster", "hub-cluster"):
        t0 = time.perf_counter()
        if order == "natural":
            perm = np.arange(n_nodes)
            ip, src = indptr, csc_src
        else:
            perm = locality_perm(indptr, csc_src, order=order, labels=labels)
            inv = np.empty(n_nodes, np.int64)
            inv[perm] = np.arange(n_nodes)
            ip, src, _ = native.build_csc(inv[csc_src], inv[dst], n_nodes)
        cov, _ = dense_coverage(indptr, csc_src, perm)
        host_s = time.perf_counter() - t0
        ip_d = torch.from_numpy(ip.astype(np.int32)).to(dev)
        src_d = torch.from_numpy(src.astype(np.int32)).to(dev)
        p_d = torch.from_numpy(perm).to(dev)
        xp, fp = x[p_d], feat[p_d]
        rec = {"dense_coverage": cov, "host_seconds": host_s}
        for kname, fn, n_rep in (
                ("spmm", lambda: spmm(xp, ip_d, src_d), reps[0]),
                ("gat_attention", lambda: gat_attention(
                    fp, attn, 0.2, ip_d, src_d), reps[1])):
            reset_counts(wrappers)
            y = fn()
            launches = wrappers[kname].launches
            if cuda:
                ms = time_ms(fn, n_rep, torch)
                dms = device_time_ms(fn, torch, reps=n_rep, replays=2)
            else:
                ms = dms = None
            inv_d = torch.empty_like(p_d)
            inv_d[p_d] = torch.arange(n_nodes, device=dev)
            y = y[inv_d]  # back to the natural ids
            if order == "natural":
                ref[kname] = y
                err = 0.0
            else:
                err = float((y - ref[kname]).abs().max())
            rec[kname] = {"ms": ms, "device_ms": dms,
                          "launches_per_call": launches,
                          "max_abs_err_vs_natural": err,
                          "max_abs_natural": float(ref[kname].abs().max())}
            del y
        orders[order] = rec
        del xp, fp, ip_d, src_d
    emit({"phase": "reorder", "n_nodes": n_nodes, "n_edges": g.n_edges,
          "f": f, "heads": heads, "graph_seconds": gen_s,
          "label_propagation_seconds": lpa_s,
          "communities_found": int(len(np.unique(labels))),
          "orders": orders, "nvidia_smi": smi_line})
    bad = [(o, k) for o, r in orders.items()
           for k in ("spmm", "gat_attention")
           if r[k]["max_abs_err_vs_natural"] > 1e-3 * r[k]["max_abs_natural"]
           or r[k]["launches_per_call"] <= 0]
    if bad:
        fail(f"reorder: outputs under another order differ, or a kernel "
             f"did not launch: {bad} {orders}")


def ondisk_phase(torch, dev, wrappers, smi_line, workdir):
    """The on-disk readers on the card's machine: every format's
    fixture written under ``workdir`` and read by name, the papers100M
    features memory-mapped; then one ``cli.main`` step on the flickr
    fixture, with the HBM features and with ``--use-uva`` (``--download``
    accepted and ignored)."""
    from bliss_gnn_tpu_torch.graph import datasets as tdata
    from bliss_gnn_tpu_torch.train import cli

    root = os.path.join(workdir, "datasets")
    want = write_ondisk_fixtures(root)
    old, tdata.DATA_ROOT = tdata.DATA_ROOT, root
    try:
        got, bad = {}, []
        for name, (n, e, c, ml) in want.items():
            g, nc, gml = tdata.load_dataset(name)
            got[name] = [g.n_nodes, g.n_edges, nc, gml]
            if (g.n_nodes != n or gml != ml or (e is not None
                                                and g.n_edges != e)
                    or (c is not None and nc != c)):
                bad.append(name)
        g, _, _ = tdata.load_dataset("ogbn-papers100m")
        memmap = isinstance(g.ndata["features"], np.memmap)
        runs = {}
        for tag, extra in (("hbm", []), ("uva", ["--use-uva",
                                                 "--cache-size", "8"])):
            argv = ["--dataset", "flickr", "--num-layers", "2", "--fan-out",
                    "4,3", "--batch-size", "4", "--num-steps", "1",
                    "--num-hidden", "8", "--download", "--logdir",
                    os.path.join(workdir, f"ondisk_{tag}"), *extra]
            if dev.type == "cpu":
                argv += ["--platform", "cpu"]
            reset_counts(wrappers)
            res = cli.main(argv)
            runs[tag] = {"final_accuracy": res[0], "launches": {
                k: v.launches for k, v in wrappers.items()}}
    finally:
        tdata.DATA_ROOT = old
    emit({"phase": "ondisk", "datasets": got, "papers100m_memmap": memmap,
          "cli": runs, "nvidia_smi": smi_line})
    if bad or not memmap or not all(
            0.0 <= r["final_accuracy"]["Train"] <= 1.0 for r in runs.values()):
        fail(f"ondisk: readers gave {got} for {bad}, memmap {memmap}, "
             f"cli {runs}")


# -- on-disk fixtures: tiny datasets in the public formats the readers take
# (numpy, scipy, pickle, json and gzip only, as the readers);
# tests/test_torch_datasets_ondisk.py reads them with both packages


def write_csv_gz(path, a, fmt):
    """A headerless comma-separated ``.csv.gz`` of the rows of ``a``."""
    import gzip

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, np.asarray(a).reshape(len(a), -1), fmt=fmt,
                   delimiter=",")


def write_planetoid(d, name, n_known=8, n_test=3, f=6, c=3, gap=False):
    """The ``ind.<name>.*`` family with a SHUFFLED test.index (tx row i
    belongs to node test_idx[i]); ``gap`` leaves a hole in the index, as
    citeseer's isolated nodes do. Returns (n, c, test_idx, tx, ty)."""
    import pickle

    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    test_idx = (np.array([n_known + 3, n_known, n_known + 1]) if gap
                else np.array([n_known + 2, n_known, n_known + 1]))
    n = n_known + (test_idx.max() - test_idx.min() + 1 if gap else n_test)
    allx = sp.csr_matrix(rng.random((n_known, f)).astype(np.float32))
    tx = sp.csr_matrix(rng.random((n_test, f)).astype(np.float32))
    ally = np.eye(c)[rng.integers(0, c, n_known)]
    ty = np.eye(c)[rng.integers(0, c, n_test)]
    graph = {i: [int(j) for j in rng.integers(0, n, 2)] for i in range(n)}
    for suffix, obj in (("x", allx[:4]), ("y", ally[:4]), ("tx", tx),
                        ("ty", ty), ("allx", allx), ("ally", ally),
                        ("graph", graph)):
        with open(os.path.join(d, f"ind.{name}.{suffix}"), "wb") as fh:
            pickle.dump(obj, fh)
    np.savetxt(os.path.join(d, f"ind.{name}.test.index"), test_idx, fmt="%d")
    return n, c, test_idx, np.asarray(tx.todense()), ty


def write_saint(d, n=12, f=5, c=4, multilabel=False):
    """GraphSAINT's layout; 6/3/3 train/val/test nodes, node 0 in the last
    class (so n_classes is c). Returns the adjacency."""
    import scipy.sparse as sp

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    adj = sp.random(n, n, density=0.3, random_state=2, format="csr")
    sp.save_npz(os.path.join(d, "adj_full.npz"), adj)
    np.save(os.path.join(d, "feats.npy"),
            rng.random((n, f)).astype(np.float32))
    if multilabel:
        cm = {str(i): [int(b) for b in rng.integers(0, 2, c)]
              for i in range(n)}
    else:
        cm = {str(i): int(rng.integers(0, c)) for i in range(n)}
        cm["0"] = c - 1
    with open(os.path.join(d, "class_map.json"), "w") as fh:
        json.dump(cm, fh)
    with open(os.path.join(d, "role.json"), "w") as fh:
        json.dump({"tr": list(range(6)), "va": [6, 7, 8],
                   "te": [9, 10, 11]}, fh)
    return adj


def write_reddit_dgl(d, n=10, f=4):
    """DGL's Reddit layout, node types 1/2/3 for 4/2/4 nodes. Returns the
    adjacency."""
    import scipy.sparse as sp

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(3)
    adj = sp.random(n, n, density=0.4, random_state=4, format="csr")
    sp.save_npz(os.path.join(d, "reddit_graph.npz"), adj)
    np.savez(os.path.join(d, "reddit_data.npz"),
             feature=rng.random((n, f)).astype(np.float32),
             label=rng.integers(0, 5, n),
             node_types=np.array([1, 1, 1, 1, 2, 2, 3, 3, 3, 3]))
    return adj


def write_ogb_csv(root, n=9, f=3):
    """ogbn-arxiv's csv.gz layout: 20 random edges, 6 distinct labels,
    4/2/3 split nodes under split/time."""
    d = os.path.join(root, "ogbn_arxiv")
    rng = np.random.default_rng(5)
    write_csv_gz(os.path.join(d, "raw", "edge.csv.gz"),
                 rng.integers(0, n, (20, 2)), "%d")
    write_csv_gz(os.path.join(d, "raw", "node-feat.csv.gz"),
                 rng.random((n, f)), "%.17g")
    labels = rng.integers(0, 6, n)
    labels[:6] = np.arange(6)
    write_csv_gz(os.path.join(d, "raw", "node-label.csv.gz"), labels, "%d")
    for fname, idx in (("train.csv.gz", [0, 1, 2, 3]),
                       ("valid.csv.gz", [4, 5]), ("test.csv.gz", [6, 7, 8])):
        write_csv_gz(os.path.join(d, "split", "time", fname), idx, "%d")


def write_ogb_papers(root, n=11, f=4):
    """papers100M's binary layout (``raw/data.npz``, ``raw/node-label.npz``
    with NaN on the unlabelled nodes 5..10) in OGB's capitalised
    directory, 2/1/2 split nodes under split/time."""
    d = os.path.join(root, "ogbn_papers100M")
    os.makedirs(os.path.join(d, "raw"), exist_ok=True)
    rng = np.random.default_rng(7)
    np.savez(os.path.join(d, "raw", "data.npz"),
             edge_index=rng.integers(0, n, (2, 25)),
             node_feat=rng.random((n, f)).astype(np.float32))
    labels = rng.integers(0, 4, n).astype(np.float64)
    labels[5:] = np.nan
    labels[:4] = [0, 1, 2, 3]
    np.savez(os.path.join(d, "raw", "node-label.npz"),
             node_label=labels.reshape(-1, 1))
    for fname, idx in (("train.csv.gz", [0, 1]), ("valid.csv.gz", [2]),
                       ("test.csv.gz", [3, 4])):
        write_csv_gz(os.path.join(d, "split", "time", fname), idx, "%d")


def write_ondisk_fixtures(root):
    """Every format's fixture under ``root``: {dataset name: (n_nodes,
    n_edges or None, n_classes, multilabel)} as the readers must give
    them (planetoid's edge count is the symmetrised dict's)."""
    out = {}
    n, c, *_ = write_planetoid(os.path.join(root, "pubmed"), "pubmed")
    out["pubmed"] = (n, None, c, False)
    n, c, *_ = write_planetoid(os.path.join(root, "citeseer"), "citeseer",
                               gap=True)
    out["citeseer"] = (n, None, c, False)
    for name, ml in (("flickr", False), ("yelp", True)):
        adj = write_saint(os.path.join(root, name), multilabel=ml)
        out[name] = (12, adj.nnz, 4, ml)
    adj = write_reddit_dgl(os.path.join(root, "reddit"))
    out["reddit"] = (10, adj.nnz, None, False)
    write_ogb_csv(root)
    out["ogbn-arxiv"] = (9, 20, 6, False)
    write_ogb_papers(root)
    out["ogbn-papers100m"] = (11, 25, 4, False)
    return out


# ---------------------------------------------------------------------------
# the parallel layer: dp_path, sharded_path (phase 3d), sharded_inference
# (phase 5b), dp2 (phase 9)
# ---------------------------------------------------------------------------


def parallel_paths(torch, graph, indptr_np, cfg, plan, seeds, smask,
                   wrappers, smi_line, fused_replayed_ms):
    """Phase 3d: the main path's configuration through the parallel layer
    at one rank (NCCL on the card): ``make_dp_train_step`` (``dp_path``)
    and ``make_sharded_train_step`` (``sharded_path``), each counted, its
    collectives recorded, and held against the fused step from one state,
    eager and replayed. Returns the mesh (open for the sharded inference)
    and the host view of the graph."""
    from bliss_gnn_tpu_torch.parallel.dp import (
        make_dp_multi_train_step,
        make_dp_train_step,
    )
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.parallel.shardedstep import (
        ShardedDeviceGraph,
        init_exp3_shard,
        make_sharded_multi_train_step,
        make_sharded_train_step,
        unshard_exp3,
    )
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights
    from bliss_gnn_tpu_torch.train.steps import make_train_step

    dev = seeds.device
    L, E = len(cfg.fanouts), graph.n_edges
    mesh = make_mesh(1, device=dev)
    fused = make_train_step(graph, cfg, plan, False, device=dev)

    def new_twin():
        twin = fresh_state(dev, graph, cfg,
                           init_exp3_weights(L, E, device=dev),
                           torch.Generator(device=dev).manual_seed(0))
        twin, _ = fused(twin, seeds, smask)  # makes Adam's state
        return twin

    # dp_path
    state = fresh_state(dev, graph, cfg,
                        init_exp3_weights(L, E, device=dev),
                        mesh.generator(0))
    out, state = parallel_step_run(
        "dp", state,
        make_dp_train_step(mesh, graph, cfg, plan, False,
                           exp3_normalize=False),
        make_dp_multi_train_step(mesh, graph, cfg, plan, False,
                                 exp3_normalize=False),
        fused, new_twin(), new_twin(), seeds, smask, wrappers, mesh,
        lambda s: s.exp3_weights, SHARDED_TOLERANCE)
    emit({"phase": "dp_path", **out,
          "fused_replayed_step_ms": fused_replayed_ms,
          "nvidia_smi": smi_line})
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # sharded_path
    t0 = time.perf_counter()
    hv = host_view(graph, indptr_np)
    sg = ShardedDeviceGraph.build(hv, mesh, feature_dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0

    def exp3_of(s):
        w = s.exp3_weights
        return unshard_exp3(w[None], L, E) if w.dim() == 1 else w

    state = fresh_state(dev, graph, cfg, init_exp3_shard(L, E, mesh),
                        mesh.generator(0))
    out, state = parallel_step_run(
        "sharded", state,
        make_sharded_train_step(mesh, sg, cfg, plan, False),
        make_sharded_multi_train_step(mesh, sg, cfg, plan, False),
        fused, new_twin(), new_twin(), seeds, smask, wrappers, mesh,
        exp3_of, SHARDED_TOLERANCE)
    gathers = {k: v for k, v in out["collectives_per_step"].items()
               if k in ("all_gather", "reduce_scatter")}
    emit({"phase": "sharded_path", **out, "build_seconds": build_s,
          "row_gather_collectives_per_step": gathers,
          "epr": sg.epr, "npr": sg.npr,
          "fused_replayed_step_ms": fused_replayed_ms,
          "nvidia_smi": smi_line})
    del state, sg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return mesh, hv


def sharded_inference_phase(torch, mesh, hv, graph, models, wrappers,
                            smi_line):
    """Phase 5b (the end of ``sharded_path``): ``sharded_inference_records``
    of the trained SAGE and GATv2 at one rank (one bucket: K6 and K7 with
    its partial outputs on the whole CSC), each printed. Returns K7's
    launches with partial outputs by kernel-row name."""
    records, partial_launches = sharded_inference_records(
        mesh, hv, graph, models, wrappers)
    for rec in records:
        emit({"phase": "sharded_inference", **rec, "nvidia_smi": smi_line})
    return partial_launches


DP2_CFG = dict(dataset="synth-pubmed", fanouts=(256, 128, 64), hidden=256,
               batch=256, steps=3)


def dp2_worker(device):
    """One of phase 9's two ranks on one card (gloo: two ranks a card):
    three DP and three sharded SAGE steps from one state on synth-pubmed,
    their collectives, then the ring inference of SAGE and GATv2 at S = 2
    against the single-device pass on this rank's card."""
    import torch

    from bliss_gnn_tpu_torch.graph.datasets import load_dataset
    from bliss_gnn_tpu_torch.graph.structure import (
        DeviceGraph,
        Graph,
        normalized_edata,
    )
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.models.inference import (
        layerwise_inference,
        layerwise_inference_sharded,
    )
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
    from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention
    from bliss_gnn_tpu_torch.ops.spmm import spmm
    from bliss_gnn_tpu_torch.parallel import commstats
    from bliss_gnn_tpu_torch.parallel.dp import make_dp_train_step
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.parallel.shardedstep import (
        ShardedDeviceGraph,
        init_exp3_shard,
        make_sharded_train_step,
        unshard_exp3,
    )
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )
    from bliss_gnn_tpu_torch.train import steps as steps_mod
    from bliss_gnn_tpu_torch.train.steps import TrainState, make_optimizer

    c = DP2_CFG
    mesh = make_mesh(None, device=device)
    dev = mesh.device
    g, n_cls, ml = load_dataset(c["dataset"])
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    dg = DeviceGraph.from_graph(g, device=dev)
    sg = ShardedDeviceGraph.build(g, mesh)
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=c["fanouts"])
    L, E = len(c["fanouts"]), g.n_edges
    plan = CapacityPlan.build(c["batch"] // mesh.size, c["fanouts"],
                              g.n_nodes, E, kind=cfg.kind)
    n_feats = g.ndata["features"].shape[1]

    def state(exp3):
        model = build_model("sage", n_feats, c["hidden"], n_cls, L,
                            device=dev, seed=0)
        opt, sched = make_optimizer(model.parameters(), 2e-3, 100)
        return TrainState(model, opt, sched, exp3, mesh.generator(0))

    rng = np.random.default_rng(0)
    train_ids = np.where(g.ndata["train_mask"])[0]
    batches = [torch.from_numpy(rng.choice(train_ids, c["batch"]).astype(
        np.int32)).to(dev) for _ in range(c["steps"])]
    smask = torch.ones(c["batch"], dtype=torch.bool, device=dev)
    runs = {}
    for label, step, st in (
            ("dp", make_dp_train_step(mesh, dg, cfg, plan, ml,
                                      exp3_normalize=False),
             state(init_exp3_weights(L, E, device=dev))),
            ("sharded", make_sharded_train_step(mesh, sg, cfg, plan, ml),
             state(init_exp3_shard(L, E, mesh)))):
        times, losses, counts = [], [], []
        exp3_apply.launches_by_shape = {}
        with BlockRecorder(steps_mod) as br:
            for i, seeds in enumerate(batches):
                with commstats.recording() as rec:
                    sync(dev)
                    t0 = time.perf_counter()
                    st, m = step(st, seeds, smask)
                    sync(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["train_loss"]))
                counts.append([int(m[f"num_edges/{l}"]) for l in range(L)])
        w = st.exp3_weights
        if label == "sharded":
            w = unshard_exp3(mesh.all_gather(w), L, E)
        runs[label] = dict(
            step_ms=times, loss=losses, num_edges=counts,
            blocks=[[tuple(t.cpu() for t in b) for b in call]
                    for call in br.calls],
            comm=commstats.comm_summary(rec.entries, mesh.size),
            params={k: v.detach().cpu()
                    for k, v in st.model.state_dict().items()},
            exp3=w.float().cpu(),
            exp3_apply_by_route=dict(exp3_apply.launches_by_shape))
        del st
    inference = {}
    for name, seed in (("sage", 1), ("gat", 2)):
        model = build_model(name, n_feats, 64, n_cls, 2, num_in_heads=4,
                            num_out_heads=1, device=dev, seed=seed)
        model.eval()
        spmm.launches = gat_attention.launches = 0
        gat_attention.launches_by_shape = {}
        sync(dev)
        t0 = time.perf_counter()
        got = layerwise_inference_sharded(name, model, g, mesh, 2)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = {"spmm": spmm.launches,
                    "gat_attention": gat_attention.launches,
                    "gat_attention_partials": sum(
                        gat_attention.launches_by_shape.values())}
        want = layerwise_inference(name, model, dg, 2)
        inference[name] = dict(
            seconds=secs, launches=launches,
            max_abs_err=(got - want).abs().max().item(),
            max_abs_logit=want.abs().max().item(),
            finite=bool(torch.isfinite(got).all().item()))
    return dict(rank=mesh.rank, backend=mesh.backend, runs=runs,
                inference=inference, n_nodes=g.n_nodes, n_edges=E)


def dp2_phase(torch, smi_line, workdir, device="cuda"):
    """Phase 9: two ranks on the one card, gloo (NCCL refuses two ranks on
    one card), spawned with a FileStore: ``dp2_worker`` on each, then
    ``cli.main(["--dp", "2", "--shard-graph", ...])`` starting its own two
    ranks, with a checkpoint and ``final_eval``. The times are gloo's
    host collectives on one card: no scaling is read from them."""
    from bliss_gnn_tpu_torch.parallel.multihost import run_ranks
    from bliss_gnn_tpu_torch.train import cli

    t0 = time.perf_counter()
    outs = run_ranks(dp2_worker, 2, (device,), device=device,
                     workdir=os.path.join(workdir, "dp2_ranks"), threads=None)
    ranks_s = time.perf_counter() - t0
    a, b = outs
    problems = []
    for run in ("dp", "sharded"):
        for k, v in a["runs"][run]["params"].items():
            if not torch.equal(v, b["runs"][run]["params"][k]):
                problems.append(f"{run} params differ across ranks: {k}")
    w_dp, w_sh = a["runs"]["dp"]["exp3"], a["runs"]["sharded"]["exp3"]
    exp3_err = float(((w_sh - w_dp).abs()
                      - 2e-2 * w_dp.abs()).clamp(min=0).max())
    if exp3_err > 1e-6:
        problems.append(f"sharded arm weights off the DP ones by {exp3_err}")
    if a["runs"]["dp"]["num_edges"] != a["runs"]["sharded"]["num_edges"]:
        problems.append("sharded and DP blocks differ")
    blocks_equal = [[same_blocks(x, y) for x, y in zip(
        o["runs"]["dp"]["blocks"], o["runs"]["sharded"]["blocks"])]
        for o in outs]
    if not all(all(r) for r in blocks_equal):
        problems.append(f"sharded and DP blocks differ: {blocks_equal}")
    # the sharded step against the DP step at test_torch_shardedstep.py's
    # bounds: losses rtol 1e-5 (atol 1e-6), parameters rtol 2e-5 (atol
    # 2e-6); each the largest excess over its bound (0 when within)
    loss_excess = max(abs(x - y) - (1e-6 + 1e-5 * abs(y)) for x, y in zip(
        a["runs"]["sharded"]["loss"], a["runs"]["dp"]["loss"]))
    param_excess = max(float(((v - a["runs"]["dp"]["params"][k]).abs()
                              - 2e-6 - 2e-5 * a["runs"]["dp"]["params"][k]
                              .abs()).max()) for k, v in
                       a["runs"]["sharded"]["params"].items())
    if loss_excess > 0:
        problems.append(f"sharded losses off the DP ones by {loss_excess}")
    if param_excess > 0:
        problems.append(f"sharded parameters off the DP ones by "
                        f"{param_excess}")
    for o in outs:
        for name, r in o["inference"].items():
            if not r["finite"] or r["max_abs_err"] > 1e-2 * r["max_abs_logit"]:
                problems.append(f"rank {o['rank']} {name} ring inference: "
                                f"{r['max_abs_err']}")
        if o["inference"]["gat"]["launches"]["gat_attention_partials"] \
                != 2 * 2:
            problems.append("K7 did not run once a bucket and layer")
        if o["inference"]["sage"]["launches"]["spmm"] < 2 * 2:
            problems.append("K6 did not run on every bucket")
    # at S = 2 the DP step's gathered deltas take K4's repeats route: its
    # two kernels once a step
    k4_repeats = sum(v for k, v in
                     a["runs"]["dp"]["exp3_apply_by_route"].items()
                     if k.startswith("repeats ") and k.endswith(" S=2"))
    if device == "cuda" and k4_repeats != 2 * DP2_CFG["steps"]:
        problems.append(f"K4's repeats route launched {k4_repeats} kernels "
                        f"in {DP2_CFG['steps']} DP steps (two a step)")

    logdir = os.path.join(workdir, "dp2_cli")
    t0 = time.perf_counter()
    res = cli.main(["--dataset", DP2_CFG["dataset"], "--model", "sage",
                    "--num-layers", "2", "--fan-out", "64,32",
                    "--batch-size", "64", "--num-steps", "6",
                    "--num-hidden", "64", "--logdir", logdir, "--dp", "2",
                    "--shard-graph", "--steps-per-call", "2",
                    "--refit-after", "2", "--exp3-renorm-every", "2"]
                   + (["--platform", "cpu"] if device == "cpu" else []))
    cli_s = time.perf_counter() - t0
    ckpts = [os.path.join(r, f) for r, _, fs in os.walk(logdir)
             for f in fs if f == "best"]
    if not ckpts or not all(0.0 <= res[0][s] <= 1.0
                            for s in ("Train", "Validation", "Test")):
        problems.append(f"cli --dp 2 --shard-graph: {res}, {ckpts}")
    strip = {o["rank"]: {run: {k: v for k, v in r.items()
                               if k not in ("params", "exp3", "blocks")}
                         for run, r in o["runs"].items()} for o in outs}
    emit({"phase": "dp2", "ranks": 2, "backend": a["backend"],
          "note": "two ranks on one card under gloo: host collectives; "
                  "no scaling is read from these times",
          "config": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in DP2_CFG.items()},
          "n_nodes": a["n_nodes"], "n_edges": a["n_edges"],
          "runs": strip, "sharded_vs_dp_exp3_excess": exp3_err,
          "sharded_vs_dp_loss_excess": max(loss_excess, 0.0),
          "sharded_vs_dp_param_excess": max(param_excess, 0.0),
          "sharded_vs_dp_blocks_equal_by_rank_and_step": blocks_equal,
          "inference": {o["rank"]: o["inference"] for o in outs},
          "ranks_seconds": ranks_s, "cli_seconds": cli_s,
          "k4_repeats_route_launches_rank0": k4_repeats,
          "cli_result": res[0], "cli_checkpoint": bool(ckpts),
          "nvidia_smi": smi_line})
    if problems:
        fail(f"dp2: {problems}")
    return k4_repeats


# -- bench_torch.py: the reference benchmark's keys through the port ----------

BENCH_TORCH_ENV = {"BLISS_BENCH_SBM": "0"}  # the full SBM graph: see PERF.md
BENCH_TORCH_TIMEOUT_S = 600


def bench_kernel_rows(torch, dev, graph, indptr_np):
    """The two kernel shapes ``bench_torch.py`` adds to the paths': K6 at
    F = 602 f32 with edge weights (its headline, ``headline_inputs``) and
    K7 at (H, O) = (1, 256) on bf16 rows (its GAT section), each against
    its plain version on the CSC prefix and timed on the full graph beside
    its plain version (K6 also beside ``torch.sparse.mm`` on the weighted
    CSR). Their ``launches`` are set by the ``bench_torch`` phase."""
    from bliss_gnn_tpu_torch.ops.gat_attention import (
        gat_attention,
        gat_attention_plain,
        gat_plan,
    )
    from bliss_gnn_tpu_torch.ops.spmm import spmm, spmm_plain, spmm_plan

    n, n_edges = graph.n_nodes, graph.n_edges
    prefix, k, e_pre = csc_prefix(torch, graph, indptr_np)
    ip, src, pip = graph.csc_indptr, graph.csc_src, prefix.csc_indptr
    where = {"prefix_rows": k, "prefix_edges": e_pre}
    w_np, x_np = headline_inputs(n, n_edges)
    w, x = torch.from_numpy(w_np).to(dev), torch.from_numpy(x_np).to(dev)
    del w_np, x_np
    got, want = spmm(x, pip, src, w)[:k], spmm_plain(x, pip, src, w)[:k]
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    del got, want
    if err > tol:
        fail(f"spmm F={N_FEATS} f32 weighted differs from its plain version: "
             f"{err} > {tol}")
    ld, cols, _ = spmm_plan(n, N_FEATS, x.dtype)
    before = spmm.launches
    spmm(x, ip, src, w)
    per_call = spmm.launches - before
    csr = torch.sparse_csr_tensor(ip, src[:n_edges], w, (n, n))
    rows = [kernel_row(
        f"spmm[F={N_FEATS},f32,weighted]", 0, "spmm_csr.cu",
        "bliss_gnn_tpu/ops/spmm_pallas.py:1004", err,
        "atol 1e-4 x max|plain| on the prefix",
        time_ms(lambda: spmm(x, ip, src, w), 5, torch, warmup=1),
        time_ms(lambda: spmm_plain(x, ip, src, w), 1, torch, warmup=0),
        time_ms(lambda: torch.sparse.mm(csr, x), 3, torch, warmup=1),
        *spmm_cost(n, n_edges, N_FEATS, 4, True),
        device_ms=device_time_ms(lambda: spmm(x, ip, src, w), torch, reps=3,
                                 replays=2),
        library_device_ms=device_time_ms(lambda: torch.sparse.mm(csr, x),
                                         torch, reps=3, replays=2),
        kernel_launches_per_call=per_call, slice_cols=cols, padded_cols=ld,
        shape=f"{n} x {N_FEATS} f32, {n_edges} weighted edges", **where)]
    del x, w, csr

    h, o = 1, HIDDEN
    g = torch.Generator(device=dev).manual_seed(9)
    feat = torch.randn((n, h, o), generator=g, device=dev).to(torch.bfloat16)
    attn = torch.randn((1, h, o), generator=g, device=dev) / o ** 0.5
    got = gat_attention(feat, attn, 0.2, pip, src)[:k]
    want = gat_attention_plain(feat, attn, 0.2, pip, src)[:k]
    err = (got - want).abs().max().item()
    tol = 2e-4 * want.abs().max().item()
    del got, want
    if err > tol:
        fail(f"gat_attention ({h}, {o}) differs from its plain version: "
             f"{err} > {tol}")
    op, splits = gat_plan(h, o, feat.dtype)
    before = gat_attention.launches
    gat_attention(feat, attn, 0.2, ip, src)
    per_call = gat_attention.launches - before
    rows.append(kernel_row(
        f"gat_attention[H={h},O={o}]", 0, "gat_attention.cu",
        "bliss_gnn_tpu/ops/gat_pallas.py:411", err,
        "atol 2e-4 x max|plain| on the prefix",
        time_ms(lambda: gat_attention(feat, attn, 0.2, ip, src), 3, torch,
                warmup=1),
        time_ms(lambda: gat_attention_plain(feat, attn, 0.2, ip, src), 1,
                torch, warmup=0),
        None,
        n * h * o * 2 + (n + 1) * 4 + n_edges * 4 + n * h * o * 4 + h * o * 4,
        n_edges * h * (7 * o + 2),
        device_ms=device_time_ms(
            lambda: gat_attention(feat, attn, 0.2, ip, src), torch, reps=2,
            replays=2),
        kernel_launches_per_call=per_call, padded_cols=op,
        splits_per_head=splits,
        shape=f"{n} x {h} x {o} bf16, {n_edges} edges", **where))
    return rows


def bench_torch_phase(here, smi_line, rows):
    """``python3 bench_torch.py`` in a subprocess on the card, the default
    switches but for ``BENCH_TORCH_ENV``: it must exit 0 with a last line of
    every key ``bench.py`` prints under those switches on one card (plus
    ``step_eager_ms``), each number finite but the time-to-F1 nulls
    ``bench.py`` allows. Prints the line on a line of its own, then the
    phase line. The launches it reports by section set the ``launches`` of
    ``rows`` (``bench_kernel_rows``': K6 at F = 602 from the headline
    section, K7 at (1, 256) from the GAT section), and the SAGE and GATv2
    steps' kernels must have launched in the step section."""
    run_env = {**os.environ, **BENCH_TORCH_ENV}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "bench_torch.py")],
        cwd=here, env=run_env, capture_output=True, text=True,
        timeout=BENCH_TORCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    notes = {}
    for line in proc.stderr.splitlines():
        if line.startswith("bench_torch: "):
            name, _, body = line[len("bench_torch: "):].partition(" ")
            notes[name] = json.loads(body)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"bench_torch: exit {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    line = json.loads(lines[-1])
    print(lines[-1], flush=True)
    scale = float(run_env.get("BLISS_BENCH_SCALE", "1.0"))
    want = expected_keys(switches(run_env, scale), False)
    nulls = {"time_to_val_f1_90_s", "ttvf1_steps"}
    bad = sorted(k for k, v in line.items()
                 if isinstance(v, float) and not math.isfinite(v)
                 or v is None and k not in nulls)
    launches = notes.get("launches", {})
    step = launches.get("step", {})
    missing = [k for k in ("scatter_add", "lut_gather", "segment_sum",
                           "exp3_apply", "row_scatter_add")
               if step.get(k, 0) <= 0]
    emit({"phase": "bench_torch", "seconds": secs, "env": {
              k: v for k, v in run_env.items() if k.startswith("BLISS_BENCH")},
          "keys_missing": sorted(want - set(line)),
          "keys_extra": sorted(set(line) - want), "not_finite": bad,
          "notes": notes, "nvidia_smi": smi_line})
    if set(line) != want or bad or missing:
        fail(f"bench_torch: keys {sorted(set(line) ^ want)}, not finite "
             f"{bad}, step kernels not launched {missing}")
    k6, k7 = rows
    k6["launches"] = launches.get("headline", {}).get("spmm", 0)
    k7["launches"] = launches.get("gat", {}).get("gat_attention", 0)
    if k6["launches"] <= 0 or k7["launches"] <= 0:
        fail(f"bench_torch: K6 or K7 not launched in its section: {launches}")
    return line


# ---------------------------------------------------------------------------
# --cards 4: the parallel layer across four cards of one host, one NCCL rank
# a card (multicard_dp, multicard_sharded, multicard_gat,
# multicard_inference, multicard_cli, multicard_scaling)
# ---------------------------------------------------------------------------


def multicard_cli(torch, workdir, device, n):
    """``cli.main`` on synth-pubmed as ``dp2`` runs it, with ``--dp n`` and
    then ``--dp n --shard-graph``: the ranks start themselves, rank 0
    writes a checkpoint, ``final_eval`` gives F1s in [0, 1]."""
    from bliss_gnn_tpu_torch.train import cli

    recs = []
    for shard in (False, True):
        logdir = os.path.join(workdir, f"cli_dp{n}{'_shard' if shard else ''}")
        argv = (["--dataset", DP2_CFG["dataset"], "--model", "sage",
                 "--num-layers", "2", "--fan-out", "64,32",
                 "--batch-size", "64", "--num-steps", "6",
                 "--num-hidden", "64", "--logdir", logdir, "--dp", str(n),
                 "--steps-per-call", "2", "--refit-after", "2",
                 "--exp3-renorm-every", "2"]
                + (["--shard-graph"] if shard else [])
                + (["--platform", "cpu"] if device == "cpu" else []))
        t0 = time.perf_counter()
        res = cli.main(argv)
        secs = time.perf_counter() - t0
        ckpts = [os.path.join(r, f) for r, _, fs in os.walk(logdir)
                 for f in fs if f == "best"]
        ok = bool(ckpts) and all(0.0 <= res[0][s] <= 1.0
                                 for s in ("Train", "Validation", "Test"))
        recs.append({"argv": argv, "seconds": secs, "result": res[0],
                     "checkpoint": bool(ckpts)})
        if not ok:
            fail(f"multicard_cli {' '.join(argv)}: {res}, {ckpts}")
    emit({"phase": "multicard_cli", "ranks": n, "runs": recs})
    return recs


def multicard_main(torch, here, n_cards):
    """``--cards 4``: only the multi-card phases, with groups of 1, 2 and 4
    ranks on the four cards. Raises before any work with fewer cards
    visible."""
    sizes = MULTICARD_SIZES
    if n_cards != sizes[-1]:
        fail(f"--cards {n_cards}: the multi-card phases are defined for "
             f"--cards {sizes[-1]} (groups of {sizes})")
    visible = torch.cuda.device_count()
    if visible < n_cards:
        fail(f"--cards {n_cards}: {visible} card(s) visible; the multi-card "
             f"phases never run on fewer")
    from bliss_gnn_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,pci.bus_id",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    lines = [l.strip() for l in smi.stdout.strip().splitlines() if l.strip()]
    if smi.returncode != 0 or len(lines) < n_cards:
        fail(f"nvidia-smi: {smi.stdout} {smi.stderr.strip()}")
    print(lines[0].rsplit(",", 1)[0], flush=True)
    emit({"phase": "device", "cards": lines, "visible": visible,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": ".".join(str(v) for v in torch.cuda.nccl.version())})
    build_s = _build.build_all()
    emit({"phase": "build", "seconds": round(build_s, 2),
          "kernels": sorted(_build.SIGNATURES)})
    workdir = os.path.join(here, "build", "chip_smoke_runs", "multicard")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    indptr_np, csc_src_np = reddit_shaped_csc()
    np.save(os.path.join(workdir, "indptr.npy"), indptr_np)
    np.save(os.path.join(workdir, "csc_src.npy"), csc_src_np)
    emit({"phase": "multicard_graph", "n_nodes": N_NODES,
          "n_edges": int(csc_src_np.shape[0]),
          "seconds": time.perf_counter() - t0})
    del csc_src_np
    runs = multicard_phases(MULTICARD_CFG, workdir, "cuda", sizes)
    multicard_cli(torch, workdir, "cuda", n_cards)
    multicard_scaling(runs, "cuda")
    shutil.rmtree(os.path.join(here, "build", "chip_smoke_runs"),
                  ignore_errors=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": n_cards}})


if __name__ == "__main__":
    main()
