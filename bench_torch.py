#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``bliss_gnn_tpu_torch``): the
keys of the JAX package's ``bench.py``, measured through the port on one
NVIDIA GPU. Prints ONE JSON line on stdout:

    metric, value, unit     spmm_agg_edges_per_s_reddit: K6 (``ops/spmm.py``)
                            on the Reddit-shaped graph, x [N, 602] f32 and
                            random edge weights, M edges/s
    vs_baseline             K6's rate over the plain path's
                            (``ops/fullgraph.py`` ``full_spmm_sum`` on the
                            card, bf16 rows, a ~16M-edge dst prefix)
    spmm_sol_frac           K6's roofline bound over its time (<= 1): the
                            larger of its compulsory bytes over the card's
                            HBM rate and its f32 operations over its f32 rate
    spmm_hidden_edges_per_s_M   K6 at F = 256, bf16 rows
    spmm_sbm_*              K6 at F = 602 f32 on the SBM graph under the
                            hub-cluster node order, its dense coverage
    dp_weak_scaling_*       with four cards visible: chip_smoke.py --cards 4's
                            scaling groups (S = 1, 2, 4)
    gat_edges_per_s_M       K7 (``ops/gat_attention.py``) at (H, O) = (1, 256)
    step_ms, gat_step_ms    the fused SAGE-256 x3 / GATv2 (heads 4/1) step at
                            refit caps (batch 256, fan-outs 4096/2048/1024),
                            replayed from a CUDA graph, each replay synced
    step_eager_ms           the same SAGE step eager
    sampling_ms             ``sample_blocks`` alone at those caps
    dp_comm_bytes_per_step, dp_predicted_scaling_pct_8
                            the DP step's collectives at 8 ranks and the
                            weak scaling they predict over NVLink
    time_to_val_f1_90_s, ttvf1_*   steps and train seconds to validation
                            F1 0.90 on synth-pubmed-hard, live and frozen
                            bandit (null where the target is not reached)

Environment, as ``bench.py``'s: BLISS_BENCH_SCALE (default 1),
BLISS_BENCH_VERBOSE=1 (progress on stderr), and =0 to skip a section:
BLISS_BENCH_SBM, BLISS_BENCH_SCALING (both on by default at scale 1 only),
BLISS_BENCH_GAT, BLISS_BENCH_STEP, BLISS_BENCH_TTF1, BLISS_BENCH_ABLATION.

Runs on the card, and raises without one; ``--platform cpu`` runs the plain
PyTorch path on the host at a small scale (the tests). Stderr carries one
``bench_torch: <name> <json>`` line each for the kernels' launches by
section, the steps' overflow counters, the sampler's timing mode and the
SBM graph's host set-up seconds. Graphs are cached in
``.bench_cache/torch/``. Every timed call ends in a device synchronise;
each rate is the best of 3 calls after a warm-up.

    python3 bench_torch.py                      # on the card
    BLISS_BENCH_SCALE=0.001 python3 bench_torch.py --platform cpu
"""
import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.sampling.block import is_overflow
from harness_torch import (
    BATCH,
    CACHE,
    FANOUTS,
    HIDDEN,
    MULTICARD_CFG,
    N_CLASSES,
    N_EDGES,
    N_FEATS,
    N_NODES,
    ROOT,
    build_graph,
    fresh_state,
    graph_from_csc,
    headline_inputs,
    kernel_wrappers,
    multicard_phases,
    multicard_scaling,
    reset_counts,
    roofline_ms,
    save_atomic,
    source_tag,
    spmm_cost,
    switches,
    sync,
    time_to_val_f1,
)

BASELINE_EDGES = 16_000_000  # the plain path's dst prefix
DP_RANKS = 8  # the ranks of bench.py's communication accounting


def emit_note(name, obj):
    print(f"bench_torch: {name} {json.dumps(obj)}", file=sys.stderr,
          flush=True)


class Log:
    def __init__(self, verbose):
        self.verbose, self.t0 = verbose, time.time()

    def __call__(self, msg):
        if self.verbose:
            print(f"[bench_torch +{time.time() - self.t0:.0f}s] {msg}",
                  file=sys.stderr, flush=True)


@contextlib.contextmanager
def stdout_to_stderr():
    """What this process or a child prints inside goes to stderr, so
    stdout carries the result line alone."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


# -- graphs -----------------------------------------------------------------


def sbm_csc(n_nodes, n_edges, cache=None):
    """``bench.py``'s SBM section's graph (``sbm_graph(N, E, 8, 41,
    seed=0)``) and its hub-cluster order (label propagation, 4 rounds),
    both cached, then relabelled by that order: (indptr, csc_src int32,
    the CSC position each relabelled edge came from, the order, its dense
    coverage, host seconds by stage)."""
    from bliss_gnn_tpu_torch.graph import native
    from bliss_gnn_tpu_torch.graph.datasets import sbm_graph
    from bliss_gnn_tpu_torch.graph.reorder import (
        dense_coverage,
        locality_perm,
        propagate_labels,
    )

    cache = cache or CACHE
    os.makedirs(cache, exist_ok=True)
    secs = {}
    t0 = time.perf_counter()
    gpath = os.path.join(cache, f"sbm_reddit_{source_tag(sbm_graph)}"
                         f"_{n_nodes}_{n_edges}.npz")
    secs["graph_cached"] = os.path.exists(gpath)
    if secs["graph_cached"]:
        d = np.load(gpath)
        indptr, csc_src = d["indptr"], d["src"]
    else:
        g, _, _ = sbm_graph(n_nodes, n_edges, 8, 41, seed=0)
        indptr, csc_src = np.asarray(g.csc_indptr), np.asarray(g.csc_src)
        del g
        save_atomic(gpath, np.savez, indptr=indptr, src=csc_src)
    secs["graph"] = time.perf_counter() - t0
    e = len(csc_src)
    t0 = time.perf_counter()
    ppath = os.path.join(
        cache, f"sbm_perm_{source_tag(propagate_labels, locality_perm)}"
        f"_{n_nodes}_{e}.npy")
    secs["order_cached"] = os.path.exists(ppath)
    if secs["order_cached"]:
        perm = np.load(ppath)
    else:
        labels = propagate_labels(indptr, csc_src, n_iters=4)
        secs["label_propagation"] = time.perf_counter() - t0
        perm = locality_perm(indptr, csc_src, order="hub-cluster",
                             labels=labels)
        save_atomic(ppath, np.save, perm)
    secs["order"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cov, _ = dense_coverage(indptr, csc_src, perm)
    secs["coverage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv = np.empty(n_nodes, np.int64)
    inv[perm] = np.arange(n_nodes)
    dst = np.repeat(np.arange(n_nodes, dtype=np.int64), np.diff(indptr))
    ip, src, eperm = native.build_csc(inv[csc_src], inv[dst], n_nodes)
    secs["relabel"] = time.perf_counter() - t0
    return ip, src.astype(np.int32), eperm, perm, cov, secs


# -- timing, bounds and launches -------------------------------------------

def call_s(fn, dev):
    """Seconds of one call of ``fn``, a device synchronise on each side."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def best_s(fn, dev, reps=3):
    """The least of ``reps`` timed calls after one warm-up."""
    call_s(fn, dev)
    return min(call_s(fn, dev) for _ in range(reps))


def spmm_bound_ms(n_rows, n_edges, f, itemsize, weighted):
    """K6's roofline bound in ms (``spmm_cost`` through ``roofline_ms``)."""
    return roofline_ms(*spmm_cost(n_rows, n_edges, f, itemsize, weighted))[0]


@contextlib.contextmanager
def counted(launches, section):
    """The kernels' launches inside, by name, into ``launches[section]``."""
    wrappers = kernel_wrappers()
    reset_counts(wrappers)
    yield
    launches[section] = {k: fn.launches for k, fn in wrappers.items()}


# -- sections ---------------------------------------------------------------


def bench_spmm(dev, indptr, csc_src, launches, log):
    """K6 at F = 602 f32 with weights (the headline), the plain path on a
    dst prefix, K6 at F = 256 bf16 (its launches in section ``hidden``)."""
    from bliss_gnn_tpu_torch.ops.fullgraph import full_spmm_sum
    from bliss_gnn_tpu_torch.ops.spmm import spmm

    n_nodes, n_edges = len(indptr) - 1, len(csc_src)
    w, x = headline_inputs(n_nodes, n_edges)
    ip = torch.from_numpy(indptr.astype(np.int32)).to(dev)
    src = torch.from_numpy(csc_src).to(dev)
    wd = torch.from_numpy(w).to(dev)
    xd = torch.from_numpy(x).to(dev)
    del w, x
    with counted(launches, "headline"):
        t = best_s(lambda: spmm(xd, ip, src, wd), dev)
    rate = n_edges / t
    log(f"K6 F={N_FEATS} f32: {t * 1e3:.2f} ms")

    sub = min(n_edges, BASELINE_EDGES)
    nk = int(np.searchsorted(indptr, sub))
    sub = int(indptr[nk])
    xb = xd.to(torch.bfloat16)
    t_plain = best_s(lambda: full_spmm_sum(xb, ip[:nk + 1], src, nk, sub,
                                           edge_vals=wd[:sub]), dev, reps=1)
    log(f"plain path on {sub} edges: {t_plain * 1e3:.1f} ms")
    bound = spmm_bound_ms(n_nodes, n_edges, N_FEATS, 4, True)
    out = {"metric": "spmm_agg_edges_per_s_reddit", "value": rate / 1e6,
           "unit": "M edges/s/chip", "vs_baseline": rate / (sub / t_plain),
           "spmm_sol_frac": bound / (t * 1e3)}
    del xd, xb

    xh = torch.from_numpy(np.random.default_rng(3).normal(
        size=(n_nodes, HIDDEN)).astype(np.float32)).to(dev).to(torch.bfloat16)
    with counted(launches, "hidden"):
        t = best_s(lambda: spmm(xh, ip, src, wd), dev)
    out["spmm_hidden_edges_per_s_M"] = n_edges / t / 1e6
    log(f"K6 F={HIDDEN} bf16: {t * 1e3:.2f} ms")
    return out


def bench_sbm(dev, n_nodes, n_edges, log):
    """K6 at F = 602 f32 with weights on the SBM graph relabelled by its
    hub-cluster order."""
    from bliss_gnn_tpu_torch.ops.spmm import spmm

    ip, src, eperm, perm, cov, secs = sbm_csc(n_nodes, n_edges)
    emit_note("sbm_setup_host_seconds", secs)
    e = len(src)
    log(f"sbm graph: {e} edges, hub-cluster coverage {cov:.3f}")
    w, x = headline_inputs(n_nodes, e)
    ipd = torch.from_numpy(ip.astype(np.int32)).to(dev)
    srcd = torch.from_numpy(src).to(dev)
    wd = torch.from_numpy(w[eperm]).to(dev)
    xd = torch.from_numpy(x[perm]).to(dev)
    del w, x
    t = best_s(lambda: spmm(xd, ipd, srcd, wd), dev)
    bound = spmm_bound_ms(n_nodes, e, N_FEATS, 4, True)
    log(f"sbm K6: {t * 1e3:.2f} ms")
    return {"spmm_sbm_edges_per_s_M": e / t / 1e6,
            "spmm_sbm_coverage": cov,
            "spmm_sbm_sol_frac": bound / (t * 1e3)}


def bench_gat(dev, indptr, csc_src, log):
    """K7 at (H, O) = (1, 256), slope 0.2, bf16 rows, in the src ranges
    of full-graph inference (the plan built in the warm-up call)."""
    from bliss_gnn_tpu_torch.ops.gat_attention import (
        RangePlans,
        gat_attention,
    )

    n_nodes, n_edges = len(indptr) - 1, len(csc_src)
    h, o = 1, 256
    rng = np.random.default_rng(0)
    feat = torch.from_numpy(rng.normal(size=(n_nodes, h, o)).astype(
        np.float32) * 0.1).to(dev).to(torch.bfloat16)
    attn = torch.from_numpy(rng.normal(size=(1, h, o)).astype(
        np.float32) * 0.1).to(dev)
    ip = torch.from_numpy(indptr.astype(np.int32)).to(dev)
    src = torch.from_numpy(csc_src).to(dev)
    ranges = RangePlans(ip, src)
    t = best_s(lambda: gat_attention(feat, attn, 0.2, ip, src,
                                     ranges=ranges), dev)
    log(f"K7 (1, 256): {t * 1e3:.2f} ms")
    return {"gat_edges_per_s_M": n_edges / t / 1e6}


class Overflow:
    """The largest overflow counters seen in the metrics of a run."""

    def __init__(self):
        self.max = {}

    def __call__(self, metrics):
        for k, v in metrics.items():
            if is_overflow(k):
                self.max[k] = max(self.max.get(k, 0),
                                  int(torch.as_tensor(v).max()))


def step_ms(dev, graph, cfg, plan, seeds, smask, eager):
    """The fused step of ``cfg.model`` on ``plan`` from fresh weights:
    with ``eager``, 3 timed eager steps after one; then the chained step
    (``make_multi_train_step``, chains of one): its warm-ups and capture,
    then 3 timed replays, each synced. Returns (best replay ms, best eager
    ms or None, the overflow counters)."""
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights
    from bliss_gnn_tpu_torch.train.steps import (
        CAPTURE_WARMUP_STEPS,
        make_multi_train_step,
        make_train_step,
    )

    state = fresh_state(dev, graph, cfg, init_exp3_weights(
        len(cfg.fanouts), graph.n_edges, device=dev),
        torch.Generator(device=dev).manual_seed(3), seed=2)
    over, eager_ms = Overflow(), None

    def timed(fn, n):
        nonlocal state
        ts = []
        for _ in range(n):
            sync(dev)
            t0 = time.perf_counter()
            state, m = fn(state)
            sync(dev)
            ts.append((time.perf_counter() - t0) * 1e3)
            over(m)
        return min(ts)

    if eager:
        step = make_train_step(graph, cfg, plan, False, device=dev)
        timed(lambda s: step(s, seeds, smask), 1)
        eager_ms = timed(lambda s: step(s, seeds, smask), 3)
    multi = make_multi_train_step(graph, cfg, plan, False, device=dev)
    s1, m1 = seeds[None], smask[None]
    timed(lambda s: multi(s, s1, m1), CAPTURE_WARMUP_STEPS + 1)
    return timed(lambda s: multi(s, s1, m1), 3), eager_ms, over.max


def sampler_ms(dev, graph, cfg, plan, seeds, smask, exp3):
    """``sample_blocks`` alone on ``plan``: on the card captured in a CUDA
    graph (after two eager warm-ups on a side stream) and replayed, the
    best of 3 synced replays; on the CPU the best of 3 eager calls.
    Returns (ms, mode)."""
    from bliss_gnn_tpu_torch.sampling.samplers import sample_blocks

    gen = torch.Generator(device=dev).manual_seed(4)

    def sample():
        return sample_blocks(graph, cfg, plan, gen, seeds, smask, exp3)

    if dev.type != "cuda":
        return best_s(sample, dev) * 1e3, "eager"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            sample()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    with torch.cuda.graph(g):
        sample()
    return best_s(g.replay, dev) * 1e3, "replayed from a CUDA graph"


def at_ranks(entries, n):
    """One rank's recorded collectives as each of ``n`` ranks issues them:
    an all-gather's output is ``n`` ranks' inputs; the all-reduces' outputs
    keep their size at any ``n``."""
    return [dataclasses.replace(c, shape=(n,) + tuple(c.shape[1:]),
                                out_bytes=c.out_bytes * n)
            if c.kind == "all_gather" else c for c in entries]


def dp_comm(dev, graph, cfg, plan, seeds, smask, replayed_ms):
    """The DP step's collectives at ``plan``: one eager step of
    ``make_dp_train_step`` on a one-rank mesh (NCCL on the card) recorded
    by ``commstats``, taken to ``DP_RANKS`` ranks (``at_ranks``), the ring
    bytes a rank sends, and the weak scaling they predict over NVLink
    beside a ``replayed_ms`` step."""
    from bliss_gnn_tpu_torch.parallel import commstats
    from bliss_gnn_tpu_torch.parallel.dp import make_dp_train_step
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights

    mesh = make_mesh(1, device=dev)
    try:
        state = fresh_state(dev, graph, cfg, init_exp3_weights(
            len(cfg.fanouts), graph.n_edges, device=dev),
            mesh.generator(3), seed=2)
        step = make_dp_train_step(mesh, graph, cfg, plan, False)
        state, _ = step(state, seeds, smask)  # makes Adam's state
        with commstats.recording() as rec:
            state, _ = step(state, seeds, smask)
            sync(dev)
    finally:
        mesh.close()
    summ = commstats.comm_summary(at_ranks(rec.entries, DP_RANKS), DP_RANKS)
    moved = summ["moved_bytes_per_device"]
    emit_note("dp_collectives", {"ranks_recorded": 1, "ranks": DP_RANKS,
                                 "per_kind": summ["per_kind"]})
    return {"dp_comm_bytes_per_step": int(moved),
            "dp_predicted_scaling_pct_8": commstats.predicted_scaling_pct(
                replayed_ms * 1e-3, moved)}


def bench_step(dev, indptr, csc_src, log):
    """``bench.py``'s steps: the graph with weights 1/in-degree, the
    a-priori plan, one pilot sample and the ``CapacityPolicy``'s refit,
    then the sampler, the SAGE and GATv2 steps and the DP step's
    collectives at those caps."""
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan, CapacityPolicy
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
        sample_blocks,
    )

    graph = graph_from_csc(dev, indptr, csc_src, N_FEATS, N_CLASSES)
    n_nodes, n_edges = graph.n_nodes, graph.n_edges
    deg = np.diff(indptr)
    bs = min(BATCH, n_nodes)
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=FANOUTS)
    plan = CapacityPlan.build(bs, FANOUTS, n_nodes, n_edges, kind=cfg.kind,
                              deg_std=float(deg.std()),
                              max_degree=int(deg.max()))
    exp3 = init_exp3_weights(len(FANOUTS), n_edges, device=dev)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, n_nodes, bs).astype(np.int32)).to(dev)
    smask = torch.ones(bs, dtype=torch.bool, device=dev)
    _, stats = sample_blocks(graph, cfg, plan,
                             torch.Generator(device=dev).manual_seed(1),
                             seeds, smask, exp3)
    policy = CapacityPolicy(1, max_degree=int(deg.max()))  # one sample
    policy.observe(stats)
    change = policy.decide(plan, 1)
    tight = plan if change is None else change[1]
    fr, be = policy.maxima(3)
    emit_note("refit", {"pilot_frontier_edges": fr, "pilot_block_edges": be,
                        "frontier_caps": tight.frontier_caps,
                        "block_e_caps": tight.block_e_caps})
    samp_ms, mode = sampler_ms(dev, graph, cfg, tight, seeds, smask, exp3)
    emit_note("sampling", {"ms": samp_ms, "mode": mode})
    del exp3
    replay_ms, eager_ms, over = step_ms(dev, graph, cfg, tight, seeds,
                                        smask, eager=True)
    log(f"step replayed {replay_ms:.2f} ms, eager {eager_ms:.1f} ms, "
        f"sampling {samp_ms:.2f} ms")
    gcfg = dataclasses.replace(cfg, model="gat")
    gat_ms, _, gover = step_ms(dev, graph, gcfg, tight, seeds, smask,
                               eager=False)
    emit_note("overflow", {"sage": over, "gat": gover})
    log(f"gat step replayed {gat_ms:.2f} ms")
    out = {"step_ms": replay_ms, "step_eager_ms": eager_ms,
           "sampling_ms": samp_ms, "gat_step_ms": gat_ms,
           "gat_sampling_ms": samp_ms}
    out.update(dp_comm(dev, graph, cfg, tight, seeds, smask, replay_ms))
    return out


def bench_dp_scaling(dev, indptr, csc_src, log):
    """Weak scaling across four cards: ``chip_smoke.py --cards 4``'s groups
    of 1, 2 and 4 NCCL ranks (``multicard_phases``) and its
    ``multicard_scaling``; the DP step's replayed weak scaling at the
    largest group. With fewer cards visible, nothing (a note on stderr)."""
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards < 4:
        print(f"[bench_torch] dp scaling skipped: {cards} card(s) visible, "
              "the scaling groups need 4", file=sys.stderr, flush=True)
        return {}
    torch.cuda.empty_cache()  # the ranks share card 0 with this process
    workdir = os.path.join(ROOT, "build", "bench_torch_multicard")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        np.save(os.path.join(workdir, "indptr.npy"), indptr)
        np.save(os.path.join(workdir, "csc_src.npy"), csc_src)
        runs = multicard_phases(MULTICARD_CFG,
                                           workdir, "cuda")
        pct = multicard_scaling(runs, "cuda")["dp"][
            "dp_weak_scaling_pct"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    s = max(pct)
    log(f"dp weak scaling: {pct[s]:.1f}% at {s} cards")
    return {"dp_weak_scaling_pct": pct[s], "dp_weak_scaling_devices": s}


def ttvf1_record(res, freeze):
    """``bench.py``'s keys of one ``time_to_val_f1`` run: an unreached
    target gives null time and steps (live); the frozen arm gives the steps
    it ran and whether it reached the target."""
    if freeze:
        return {"ttvf1_frozen_bandit_steps": res["steps"],
                "ttvf1_frozen_reached": res["reached"],
                "ttvf1_frozen_final_val_f1": res["final_val_f1"]}
    return {"time_to_val_f1_90_s": (res["train_seconds"] if res["reached"]
                                    else None),
            "ttvf1_steps": res["steps"] if res["reached"] else None,
            "ttvf1_final_val_f1": res["final_val_f1"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", type=str, default="",
                    help="cpu: the plain PyTorch path on the host; default "
                         "the CUDA card, which must exist")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    platform = args.platform.lower()
    if platform not in ("", "cuda", "gpu", "cpu"):
        raise ValueError(f"--platform {args.platform!r}: use cpu, or leave "
                         f"it out for the card")
    dev = resolve_device("cpu" if platform == "cpu" else "cuda")
    if dev.type == "cuda":
        from bliss_gnn_tpu_torch.ops import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build_all()  # every kernel, one nvcc each, all together
    scale = float(os.environ.get("BLISS_BENCH_SCALE", "1.0"))
    on = switches(os.environ, scale)
    n_nodes, n_edges = int(N_NODES * scale), int(N_EDGES * scale)
    log = Log(bool(os.environ.get("BLISS_BENCH_VERBOSE")))
    launches = {}
    with stdout_to_stderr():
        indptr, csc_src = build_graph(n_nodes, n_edges)
        log(f"graph ready: {n_nodes} nodes, {len(csc_src)} edges")
        result = bench_spmm(dev, indptr, csc_src, launches, log)
        if on["sbm"]:
            with counted(launches, "sbm"):
                result.update(bench_sbm(dev, n_nodes, n_edges, log))
        if on["scaling"]:
            result.update(bench_dp_scaling(dev, indptr, csc_src, log))
        if on["gat"]:
            with counted(launches, "gat"):
                result.update(bench_gat(dev, indptr, csc_src, log))
        if on["step"]:
            with counted(launches, "step"):
                result.update(bench_step(dev, indptr, csc_src, log))
        if on["ttf1"]:
            with counted(launches, "ttvf1"):
                res = time_to_val_f1(dev)
            log(f"ttvf1 live: {res['steps']} steps, reached "
                f"{res['reached']}, val F1 {res['final_val_f1']:.3f}")
            result.update(ttvf1_record(res, False))
            if on["ablation"]:
                res = time_to_val_f1(dev, freeze=True)
                log(f"ttvf1 frozen: {res['steps']} steps, reached "
                    f"{res['reached']}")
                result.update(ttvf1_record(res, True))
        emit_note("launches", launches)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
