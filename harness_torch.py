"""The harness that ``chip_smoke.py`` and ``bench_torch.py`` both run, in
one module that imports neither script: the main path's configuration
(the Reddit-shaped graph, SAGE-256 x3 at batch 256, fan-outs
4096/2048/1024, GATv2's heads), the benchmark line's keys and switches,
the graph builders and cache, the training-state and timing helpers, the
kernel wrappers' launch counts, the roofline bound, the time-to-val-F1
protocol, and the parallel layer's step runs and audits with the
multi-card entry (``multicard_phases``, ``multicard_scaling``,
``MULTICARD_CFG``) that ``chip_smoke.py --cards 4`` and
``bench_torch.py``'s weak-scaling section drive.

Imports torch, numpy and ``bliss_gnn_tpu_torch``; never JAX or the JAX
package. Functions that take a ``dev`` run wherever it points: on the card
for the measurements, on the CPU for the tests' rehearsals.
"""
import contextlib
import dataclasses
import hashlib
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


N_NODES = 232_965
N_RAND_EDGES = 114_615_892  # directed edges; one self-loop per node is added
N_EDGES = N_RAND_EDGES + N_NODES
N_FEATS = 602
N_CLASSES = 41
HIDDEN = 256
BATCH = 256
FANOUTS = (4096, 2048, 1024)
GAT_HEADS = (4, 1)  # per hidden layer, at the output
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
TTVF1_K, TTVF1_KV = 8, 4  # train steps a chain, validation batches
ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache", "torch")

# the keys of each section, as bench.py names them (step_eager_ms is the
# port's own: the step before capture)
KEYS = {
    "headline": ("metric", "value", "unit", "vs_baseline", "spmm_sol_frac",
                 "spmm_hidden_edges_per_s_M"),
    "sbm": ("spmm_sbm_edges_per_s_M", "spmm_sbm_coverage",
            "spmm_sbm_sol_frac"),
    "scaling": ("dp_weak_scaling_pct", "dp_weak_scaling_devices"),
    "gat": ("gat_edges_per_s_M",),
    "step": ("step_ms", "step_eager_ms", "sampling_ms", "gat_step_ms",
             "gat_sampling_ms", "dp_comm_bytes_per_step",
             "dp_predicted_scaling_pct_8"),
    "ttf1": ("time_to_val_f1_90_s", "ttvf1_steps", "ttvf1_final_val_f1"),
    "ablation": ("ttvf1_frozen_bandit_steps", "ttvf1_frozen_reached",
                 "ttvf1_frozen_final_val_f1"),
}


def switches(env, scale):
    """Which sections run, by ``bench.py``'s switches and defaults."""
    full = "1" if scale == 1.0 else "0"
    on = {"headline": True}
    for sec, var, default in (("sbm", "SBM", full), ("scaling", "SCALING", full),
                              ("gat", "GAT", "1"), ("step", "STEP", "1"),
                              ("ttf1", "TTF1", "1")):
        on[sec] = env.get(f"BLISS_BENCH_{var}", default) != "0"
    on["ablation"] = on["ttf1"] and env.get("BLISS_BENCH_ABLATION", "1") != "0"
    return on


def expected_keys(on, scaling_measured):
    """The result line's keys for the sections ``on``; the scaling keys
    only where they were measured (four cards)."""
    return {k for sec, keys in KEYS.items()
            if on[sec] and (sec != "scaling" or scaling_measured)
            for k in keys}


def reddit_shaped_csc(n_nodes=N_NODES, n_rand_edges=N_RAND_EDGES, seed=0):
    """The power-law graph of ``bench.py`` (degree sequence capped at 21k,
    hub degrees on random node ids, uniform srcs, one self-loop per node),
    built straight into CSC order: each dst's random in-edges in draw order,
    then its self-loop. Returns (indptr int64 [N+1], csc_src int32 [E])."""
    rng = np.random.default_rng(seed)
    e_rand = n_rand_edges
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    wgt = ranks ** -0.8
    deg = np.minimum(wgt / wgt.sum() * e_rand, 21_000).astype(np.int64)
    deg[deg < 1] = 1
    while deg.sum() < e_rand:
        deficit = e_rand - deg.sum()
        deg = np.minimum(deg + np.minimum(deg, max(deficit // len(deg), 1)),
                         21_000)
    extra = deg.sum() - e_rand
    for i in range(n_nodes - 1, -1, -1):  # trim from the tail
        if extra <= 0:
            break
        cut = min(extra, deg[i] - 1)
        deg[i] -= cut
        extra -= cut
    node_of_rank = rng.permutation(n_nodes)
    src_rand = rng.integers(0, n_nodes, size=int(deg.sum()))  # rank order
    deg_node = np.empty(n_nodes, np.int64)
    deg_node[node_of_rank] = deg
    rank_off = np.cumsum(deg) - deg  # offset of each rank's draws
    off_node = np.empty(n_nodes, np.int64)
    off_node[node_of_rank] = rank_off
    indptr = np.zeros(n_nodes + 1, np.int64)
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
    csc_src[loops] = np.arange(n_nodes, dtype=np.int32)
    return indptr, csc_src


def build_graph(n_nodes=N_NODES, n_edges=N_EDGES, cache=None):
    """``bench.py``'s graph at ``n_nodes`` nodes and ``n_edges`` edges
    (self-loops included), cached under ``cache`` (default ``CACHE``):
    (indptr int64, csc_src int32)."""
    cache = cache or CACHE
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"reddit_synth_{source_tag(reddit_shaped_csc)}"
                        f"_{n_nodes}_{n_edges}.npz")
    if os.path.exists(path):
        d = np.load(path)
        return d["indptr"], d["src"]
    indptr, csc_src = reddit_shaped_csc(n_nodes, n_edges - n_nodes)
    save_atomic(path, np.savez, indptr=indptr, src=csc_src)
    return indptr, csc_src


def source_tag(*fns):
    """A short hash of the source of ``fns``, the code that makes a cached
    file: it goes into the file's name, so a file made by code that has
    since changed is not read back."""
    h = hashlib.sha256()
    for fn in fns:
        h.update(inspect.getsource(fn).encode())
    return h.hexdigest()[:12]


def save_atomic(path, save, *args, **kw):
    """``save(tmp, ...)`` then a rename onto ``path``: a run cut short
    leaves no half-written cache file behind."""
    tmp = f"{path}.{os.getpid()}.tmp{os.path.splitext(path)[1]}"
    save(tmp, *args, **kw)
    os.replace(tmp, path)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def out_indptr(csc_src, n_nodes):
    """CSR row pointer (int32 [n_nodes + 1]) of the edges ``csc_src``: the
    out-degrees' prefix sum, all GCN's norm reads of the CSR."""
    deg = torch.bincount(csc_src.long(), minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int32,
                         device=csc_src.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return indptr


def graph_from_csc(dev, indptr_np, csc_src_np, n_feats, n_classes):
    """A ``DeviceGraph`` of a CSC on ``dev``: weights 1/in-degree (bf16),
    random bf16 features and labels from seed 0 (the same on every card);
    the samplers walk the CSC only, and of the CSR GCN's norm reads the
    out-degrees. ``csc_src_np`` may be a memmap."""
    from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD, DeviceGraph

    n_nodes = int(indptr_np.shape[0]) - 1
    n_edges = int(csc_src_np.shape[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    indptr = torch.from_numpy(indptr_np.astype(np.int32)).to(dev)
    csc_src = torch.zeros(n_edges + EDGE_PAD, dtype=torch.int32, device=dev)
    csc_src[:n_edges] = torch.from_numpy(np.array(csc_src_np)).to(dev)
    deg = (indptr[1:] - indptr[:-1]).long()
    w = torch.zeros(n_edges + EDGE_PAD, dtype=torch.bfloat16, device=dev)
    w[:n_edges] = (1.0 / deg.clamp(min=1).float()).repeat_interleave(
        deg, output_size=n_edges).to(torch.bfloat16)
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    graph = DeviceGraph(
        csc_indptr=indptr, csc_src=csc_src,
        csr_indptr=out_indptr(csc_src[:n_edges], n_nodes),
        csr_dst=dummy, csr_eid=dummy,
        ndata={"features": torch.randn((n_nodes, n_feats), generator=gen,
                                       device=dev, dtype=torch.bfloat16),
               "labels": torch.randint(0, n_classes, (n_nodes,),
                                       generator=gen, device=dev)},
        edata={"w": w}, n_nodes=n_nodes, n_edges=n_edges)
    sync(dev)
    return graph


def roofline_ms(nbytes, flops):
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the HBM rate and the f32 operations over the
    f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def spmm_cost(n_rows, n_edges, f, itemsize, weighted):
    """K6's compulsory (bytes, f32 operations) on a CSC of ``n_rows`` dst
    rows (and as many src rows): x read once, the row pointer, the srcs
    and the weights read once, the f32 out written once; an add per edge
    and column, and a multiply too when weighted."""
    nbytes = (n_rows * f * itemsize + (n_rows + 1) * 4 + n_edges * 4
              + (n_edges * 4 if weighted else 0) + n_rows * f * 4)
    return nbytes, n_edges * f * (2 if weighted else 1)


def kernel_wrappers():
    """Every kernel wrapper by name (their launch counts; ``gat_edge`` is
    the module, whose counts take its four functions' kernels)."""
    from bliss_gnn_tpu_torch.ops import gat_edge
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
    from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention
    from bliss_gnn_tpu_torch.ops.gather import lut_gather
    from bliss_gnn_tpu_torch.ops.poisson import poisson_scale
    from bliss_gnn_tpu_torch.ops.rowscatter import row_scatter_add
    from bliss_gnn_tpu_torch.ops.scatter import scatter_add
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum
    from bliss_gnn_tpu_torch.ops.spmm import spmm

    return {"scatter_add": scatter_add, "lut_gather": lut_gather,
            "segment_sum": segment_sum, "exp3_apply": exp3_apply,
            "row_scatter_add": row_scatter_add, "spmm": spmm,
            "gat_attention": gat_attention, "poisson_scale": poisson_scale,
            "gat_edge": gat_edge}


def reset_counts(wrappers):
    """Sets every wrapper's launch count, and its counts by shape where it
    keeps them (K1, K3, K5, K7's partial outputs, the GATv2 edge
    kernels), to 0."""
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape = {}


def headline_inputs(n_nodes, n_edges):
    """The headline's edge weights (``default_rng(1)``) and rows x [N, 602]
    (``default_rng(2)``), f32 numpy."""
    w = np.random.default_rng(1).random(n_edges).astype(np.float32)
    x = np.random.default_rng(2).normal(size=(n_nodes, N_FEATS)).astype(
        np.float32)
    return w, x


MAIN_DIMS = dict(n_feats=N_FEATS, hidden=HIDDEN, n_classes=N_CLASSES,
                 gat_heads=GAT_HEADS)


def fresh_state(dev, graph, cfg, exp3, generator, seed=0,
                dims=MAIN_DIMS):
    """A training state of ``cfg.model`` at ``dims`` (the main path's by
    default): weights from ``seed``, Adam capturable on the card."""
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.train.steps import TrainState, make_optimizer

    model = build_model(cfg.model, dims["n_feats"], dims["hidden"],
                        dims["n_classes"], len(cfg.fanouts),
                        num_in_heads=dims["gat_heads"][0],
                        num_out_heads=dims["gat_heads"][1], device=dev,
                        seed=seed)
    opt, sched = make_optimizer(model.parameters(), 2e-3, 100,
                                capturable=dev.type == "cuda")
    return TrainState(model, opt, sched, exp3, generator)


def time_to_val_f1(dev, target=0.90, max_chains=25, freeze=False,
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
        sync(dev)
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


WARMUP_STEPS, TIMED_STEPS = 3, 10


LOCKSTEP_STEPS = 3  # replayed steps held against eager twins, each path


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def load_train_state(dst, src):
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


# the one-rank DP and sharded steps, each held to the nearer of two fused
# twins from one state: the same blocks; loss and update equal up to the
# unsorted K1/K3 routes' atomic order, which parts the twins themselves.
# Over two smoke runs and six runs of tools/sharded_gate_probe.py on the
# H100 a fused step parted from its fused twin (or from its own replay) by
# up to 2.5e-4 of the update's norm and 1.9e-6 of the loss, the sharded
# step by up to 2.4e-4 from both twins, and in run BL one DP replay by
# 8.5e-5 from both (the DP step's bound was 1e-4 then, below that floor).
# So both steps at 5x the floor on the update, 50x on the loss, the arm
# weights within one bf16 ulp at any value (2^-7; 0.0066 seen)
SHARDED_TOLERANCE = {"loss": 1e-4, "update": 1.25e-3, "exp3": 2.0 ** -7}


def bf16_ulp(x):
    """One bf16 ulp at each value of ``x``."""
    _, e = torch.frexp(x.float())  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def f32_ulp(x):
    """One f32 ulp at each value of the f32 tensor ``x``."""
    _, e = torch.frexp(x)  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x), e - 24)


def step_errors(twin, state, pre, loss_twin, loss_state, exp3_of):
    """The errors of ``state``'s step against ``twin``'s from the same
    state (``pre`` the parameters before): the loss relative to max(|loss|,
    1), the parameter update's error relative to the twin's update norm
    (and by parameter, for those that differ), the largest relative
    arm-weight error (``exp3_of`` maps a state to its canonical arm
    weights)."""
    d_t = torch.cat([(p.detach() - q).flatten().float() for p, q in
                     zip(twin.model.parameters(), pre)])
    d_s = torch.cat([(p.detach() - q).flatten().float() for p, q in
                     zip(state.model.parameters(), pre)])
    rec = {"loss_twin": loss_twin, "loss": loss_state,
           "loss_err": abs(loss_state - loss_twin) / max(abs(loss_twin), 1.0),
           "update_norm": float(d_t.norm()),
           "update_err": float((d_s - d_t).norm()
                               / d_t.norm().clamp(min=1e-30))}
    # where the two parted: the parameters whose updates differ, each
    # with its error relative to the whole update's norm
    rec["parted_params"] = {
        n: float((p.detach() - q.detach()).float().norm()
                 / d_t.norm().clamp(min=1e-30))
        for (n, p), q in zip(state.model.named_parameters(),
                             twin.model.parameters())
        if not torch.equal(p, q)}
    if state.exp3_weights is not None:
        w_t, w_s = exp3_of(twin).float(), exp3_of(state).float()
        rec["exp3_err"] = float(((w_s - w_t).abs()
                                 / w_t.abs().clamp(min=1e-30)).max())
    return rec


def nearer_twin(r1, r2, tol):
    """The record of the twin a parallel step lies nearer to, in units of
    ``tol``, marked with which twin it was and the other's errors."""
    tol = tol or SHARDED_TOLERANCE  # ungated runs: scored on this scale

    def score(r):
        return max(r["loss_err"] / tol["loss"], r["update_err"] / tol["update"],
                   r.get("exp3_err", 0.0) / tol["exp3"])

    near, far, which = (r1, r2, 1) if score(r1) <= score(r2) else (r2, r1, 2)
    return {**near, "twin": which,
            "other_twin": {k: far[k] for k in ("loss_err", "update_err",
                                                "exp3_err") if k in far}}


def within(recs, tol):
    return all(r["loss_err"] <= tol["loss"]
               and r["update_err"] <= tol["update"]
               and r.get("exp3_err", 0.0) <= tol["exp3"]
               and r["update_norm"] > 0 for r in recs)


def load_state_into(dst, src, exp3_of_src):
    """``load_train_state`` with the arm weights mapped by ``exp3_of_src``
    (a sharded state's shard to the canonical layout, or back)."""
    exp3 = src.exp3_weights
    src.exp3_weights = exp3_of_src(src)
    try:
        load_train_state(dst, src)
    finally:
        src.exp3_weights = exp3


class BlockRecorder:
    """Records the blocks of every ``sample_blocks`` call of the step bodies
    (``train/steps.py``) while it is open."""

    def __init__(self, steps_mod):
        self.steps, self.calls = steps_mod, []

    def __enter__(self):
        self.orig = self.steps.sample_blocks

        def rec(*args, **kw):
            blocks, stats = self.orig(*args, **kw)
            self.calls.append([(b.src_gids.clone(), b.e_dst.clone(),
                                b.e_mask.clone(), b.eid.clone())
                               for b in blocks])
            return blocks, stats

        self.steps.sample_blocks = rec
        return self

    def __exit__(self, *exc):
        self.steps.sample_blocks = self.orig


def same_blocks(a, b):
    return all(torch.equal(x, y) for ba, bb in zip(a, b)
               for x, y in zip(ba, bb))


STEP_KERNELS = ("scatter_add", "lut_gather", "segment_sum", "exp3_apply")


def parallel_step_run(label, state, step, multi, fused, twin, twin2,
                      seeds, smask, wrappers, mesh, exp3_of, tol,
                      counts=None, kernels=STEP_KERNELS, audit=None,
                      twin_name="fused"):
    """The counted eager steps of a parallel step (``step``), one recorded
    step's collectives, eager steps against the fused step from one state
    (blocks recorded and compared; and, as the floor, a second fused twin
    against the first: the unsorted K1 and K3 routes add with atomics in
    the order of the run, so one step from one state can part in the last
    bits), then the chained step (``multi``, captured under NCCL): single
    replays and a chain, and replays against the fused step from one
    state. Each step is held to the nearer of the two fused twins
    (``nearer_twin``), gated at ``tol`` (None: recorded, not gated) with
    blocks (eager) and counts (replayed) equal; ``bitwise`` marks the steps
    that agree to the bit. ``fused`` is any eager step of the twins'
    states (``twin_name`` in the keys): across cards the DP step itself.
    ``counts``: (eager steps, timed replays, steps against the twins),
    default the main path's (13, 10, 3). ``audit`` (``RankAudit``) checks
    the state after every step, outside the timed spans, and holds K4
    against its plain version around the untimed eager steps. Returns the
    phase's numbers and the state."""
    from bliss_gnn_tpu_torch.parallel import commstats
    from bliss_gnn_tpu_torch.train import steps as steps_mod
    from bliss_gnn_tpu_torch.train.steps import CAPTURE_WARMUP_STEPS

    dev = seeds.device
    n_steps, n_timed, n_lock = counts or (WARMUP_STEPS + TIMED_STEPS,
                                          TIMED_STEPS, LOCKSTEP_STEPS)
    warm = WARMUP_STEPS if n_steps > WARMUP_STEPS else 0
    audit = audit or RankAudit(None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    times, losses = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, m = step(state, seeds, smask)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["train_loss"]))
        audit.after(state, "eager")
    launches = {k: wrappers[k].launches for k in kernels}
    edges = sum(int(m[k]) for k in m if k.startswith("num_edges/"))
    with commstats.recording() as rec:
        state, m = step(state, seeds, smask)
        sync(dev)
    comm = commstats.comm_summary(rec.entries, mesh.size)
    audit.after(state, "eager")
    # the twins' eager step in the same phase (the mesh's process group
    # alive), for a like-for-like eager comparison
    fused_times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        twin, _ = fused(twin, seeds, smask)
        sync(dev)
        fused_times.append((time.perf_counter() - t0) * 1e3)

    eager, floor = [], []
    for _ in range(n_lock):
        load_state_into(twin, state, exp3_of)
        load_state_into(twin2, state, exp3_of)
        pre = [p.detach().clone() for p in state.model.parameters()]
        with BlockRecorder(steps_mod) as br:
            twin, mt = fused(twin, seeds, smask)
            with audit.plain_shadow():
                state, ms = step(state, seeds, smask)
        audit.after(state, "eager")
        twin2, m2 = fused(twin2, seeds, smask)
        f = step_errors(twin, twin2, pre, float(mt["train_loss"]),
                        float(m2["train_loss"]), exp3_of)
        f["bitwise"] = (f["loss_err"] == 0 and f["update_err"] == 0
                        and f.get("exp3_err", 0.0) == 0)
        floor.append(f)
        r = nearer_twin(
            step_errors(twin, state, pre, float(mt["train_loss"]),
                        float(ms["train_loss"]), exp3_of),
            step_errors(twin2, state, pre, float(m2["train_loss"]),
                        float(ms["train_loss"]), exp3_of), tol)
        r["blocks_equal"] = same_blocks(br.calls[0], br.calls[1])
        r["bitwise"] = (r["loss_err"] == 0 and r["update_err"] == 0
                        and r.get("exp3_err", 0.0) == 0)
        eager.append(r)
        del pre

    s1, m1 = seeds[None], smask[None]
    for _ in range(CAPTURE_WARMUP_STEPS + 1):  # warm-ups, then the capture
        state, m = multi(state, s1, m1)
        audit.after(state, "replayed")
    sync(dev)
    single = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state, m = multi(state, s1, m1)
        sync(dev)
        single.append((time.perf_counter() - t0) * 1e3)
        audit.after(state, "replayed")
    sk, mk = seeds.expand(n_timed, -1), smask.expand(n_timed, -1)
    t0 = time.perf_counter()
    state, m = multi(state, sk, mk)
    sync(dev)
    chained = (time.perf_counter() - t0) * 1e3 / n_timed
    audit.after(state, "chain")
    replayed = []
    for _ in range(n_lock):
        load_state_into(twin, state, exp3_of)
        load_state_into(twin2, state, exp3_of)
        pre = [p.detach().clone() for p in state.model.parameters()]
        twin, mt = fused(twin, seeds, smask)
        twin2, m2 = fused(twin2, seeds, smask)
        state, mr = multi(state, s1, m1)
        audit.after(state, "replayed")
        loss_r = float(mr["train_loss"][0])
        r = nearer_twin(
            step_errors(twin, state, pre, float(mt["train_loss"]),
                        loss_r, exp3_of),
            step_errors(twin2, state, pre, float(m2["train_loss"]),
                        loss_r, exp3_of), tol)
        r["counts_equal"] = all(int(mt[k]) == int(mr[k][0]) for k in mt
                                if k.startswith(("num_nodes", "num_edges")))
        r["bitwise"] = (r["loss_err"] == 0 and r["update_err"] == 0
                        and r.get("exp3_err", 0.0) == 0)
        replayed.append(r)
        del pre
    tn = twin_name
    out = {f"{label}_step_ms": statistics.median(times[warm:]),
           f"{label}_step_ms_all": times[warm:],
           f"{label}_replayed_step_ms": statistics.median(single),
           f"{label}_replayed_step_ms_all": single,
           f"{label}_chained_step_ms": chained,
           f"{tn}_step_ms_same_phase": statistics.median(fused_times),
           f"{tn}_step_ms_same_phase_all": fused_times,
           "loss": losses, "launches": launches,
           "launches_per_step": {k: v / n_steps for k, v in launches.items()},
           "sampled_edges_per_step": edges,
           "collectives_per_step": comm["per_kind"],
           "collective_bytes_per_step": comm["total_out_bytes"],
           "collectives_count_per_step": comm["n_collectives"],
           "moved_bytes_per_step": comm["moved_bytes_per_device"],
           "backend": mesh.backend, "ranks": mesh.size,
           "captured": mesh.capturable,
           f"eager_vs_{tn}": eager, f"replayed_vs_{tn}": replayed,
           f"{tn}_vs_{tn}": floor,
           f"bitwise_vs_{tn}": sum(r["bitwise"] for r in eager + replayed),
           f"compared_vs_{tn}": len(eager + replayed),
           "tolerance": tol, **audit.summary()}
    if dev.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    bad = [r for r in eager if not r["blocks_equal"]]
    bad += [r for r in replayed if not r["counts_equal"]]
    if tol is not None and (bad or not within(eager + replayed, tol)):
        fail(f"{label}: differs from the {tn} step from one state: {out}")
    # the plain versions count nothing: kernels exist on the card alone
    missing = [k for k, v in launches.items() if v <= 0]
    if missing and dev.type == "cuda":
        fail(f"{label}: kernels not launched: {missing}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    audit.gate(label)
    return out, state


def host_view(graph, indptr_np):
    """The device graph as the host graph ``ShardedDeviceGraph.build``
    reads (its CSC, weights, features in f32, labels)."""
    import types

    n, e = graph.n_nodes, graph.n_edges
    csc_src = graph.csc_src[:e].cpu().numpy()
    return types.SimpleNamespace(
        csc_indptr=np.asarray(indptr_np), csc_src=csc_src,
        edata={"w": graph.edata["w"][:e].float().cpu().numpy()},
        ndata={"features": graph.ndata["features"].float().cpu().numpy(),
               "labels": graph.ndata["labels"].cpu().numpy()},
        n_nodes=n, n_edges=e,
        in_degrees=lambda: np.diff(np.asarray(indptr_np)),
        out_degrees=lambda: np.bincount(csc_src, minlength=n))


def sharded_inference_records(mesh, hv, graph, models, wrappers,
                              n_layers=len(FANOUTS)):
    """``layerwise_inference_sharded`` of each model of ``models`` ("sage",
    "gat") over ``mesh`` against ``layerwise_inference`` on this rank's
    device, every row within 1e-2 x max|logit|; K6 launched on every
    bucket of every layer (SAGE), K7 with its partial outputs once a bucket
    and layer (GATv2), counted by shape at the launch site
    (``gat_attention.launches_by_shape``). Two passes a model: the first
    also sets up the ring (NCCL connects a pair of ranks at its first
    send), the second is the one timed, counted and checked. Fails
    otherwise. Returns the records and K7's launches with partial outputs
    by kernel-row name."""
    from bliss_gnn_tpu_torch.models.inference import (
        layerwise_inference,
        layerwise_inference_sharded,
    )

    dev = mesh.device
    partial_launches, records = {}, []
    for name, model in models.items():
        model.eval()
        first = {}
        t0 = time.perf_counter()
        layerwise_inference_sharded(name, model, hv, mesh, n_layers,
                                    timings=first)
        sync(dev)
        first = {f"first_pass_{k}": v for k, v in first.items()}
        first["first_pass_seconds"] = time.perf_counter() - t0
        reset_counts(wrappers)
        timings = {}
        t0 = time.perf_counter()
        got = layerwise_inference_sharded(name, model, hv, mesh, n_layers,
                                          timings=timings)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = {k: wrappers[k].launches
                    for k in ("spmm", "gat_attention")}
        want = layerwise_inference(name, model, graph, n_layers)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        del got, want
        buckets = n_layers * mesh.size
        if name == "gat":
            by = dict(wrappers["gat_attention"].launches_by_shape)
            for l, conv in enumerate(model.layers):
                shape = f"partials H={conv.num_heads} O={conv.out_feats}"
                key = (f"gat_attention[H={conv.num_heads},"
                       f"O={conv.out_feats},partials]")
                partial_launches[key] = by.get(shape, 0)
            if sum(by.values()) != buckets and dev.type == "cuda":
                fail(f"sharded_inference: {by} K7 launches with partial "
                     f"outputs for {n_layers} layers x {mesh.size} "
                     f"bucket(s)")
            launches["gat_attention_partials"] = by
        rec = {"model": name, "seconds": secs, **timings, **first,
               "launches": launches, "ranks": mesh.size,
               "buckets_per_layer": mesh.size,
               "max_abs_err": err, "max_abs_logit": scale, "finite": finite,
               "tolerance": "1e-2 x max|layerwise_inference logit|"}
        records.append(rec)
        if not finite or err > 1e-2 * scale:
            fail(f"sharded_inference {name}: {err} > 1e-2 x {scale}")
        kname = "gat_attention" if name == "gat" else "spmm"
        # K6 launches at least once a bucket and layer (once per L2 column
        # slice); the plain versions count nothing
        if launches[kname] < buckets and dev.type == "cuda":
            fail(f"sharded_inference {name}: {kname} launched "
                 f"{launches[kname]} times for {buckets} buckets")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records, partial_launches


MULTICARD_SIZES = (1, 2, 4)


# the main path's configuration at a local batch of BATCH seeds a rank
# (weak scaling); counts: (eager steps, timed replays, steps against twins)
MULTICARD_CFG = dict(
    n_feats=N_FEATS, hidden=HIDDEN, n_classes=N_CLASSES, gat_heads=GAT_HEADS,
    fanouts=FANOUTS, batch=BATCH, pilot_steps=WARMUP_STEPS + TIMED_STEPS,
    counts=(WARMUP_STEPS + TIMED_STEPS, TIMED_STEPS, LOCKSTEP_STEPS),
    gat_counts=(3, 3, 3), gate=True)


# every step across cards, held to the nearer of two eager DP twins from
# one state (both step kinds: the sharded step serves the DP step's rows).
# The floor, two eager DP twins from one state, on four H100s (PERF.md):
# tools/multicard_gate_probe.py at S = 4 (5 comparisons of each step kind)
# and one --cards 4 run (3 a kind at S = 1, 2, 4) gave at most 4.57e-4 of
# the update's norm (S = 4, sharded comparisons; 3.6e-4 at S = 2 and 3.5e-4
# at S = 1) and 1.69e-5 of the loss (S = 1). So the update at 5x that
# floor and the loss at 50x, as SHARDED_TOLERANCE at one rank (a later
# probe run saw a DP step 8.5e-4 from both twins, the twins 2.5e-4 apart);
# the arm weights within one bf16 ulp at any value (2^-7: 0.00775 seen
# while the sharded step took K4's CAS route, 0 since the repeats route)
MULTICARD_TOLERANCE = {"loss": 8.5e-4, "update": 2.3e-3, "exp3": 2.0 ** -7}


class RankAudit:
    """Checks a parallel state across the mesh's ranks: after every step
    (:meth:`after`), its parameters and Adam state, and with ``exp3`` its
    arm weights, bit-equal on every rank (an all-reduce gives every rank
    the same bits, and K4's repeats route keeps the replicated arm weights
    so); around untimed eager steps (:meth:`plain_shadow`), K4's update
    held against ``exp3_apply_plain`` on the same gathered list, within one
    ulp of the state's dtype. With no mesh it checks nothing."""

    CHUNK = 1 << 25  # elements a rank all-gathers at a time

    def __init__(self, mesh, exp3=False):
        self.mesh, self.exp3 = mesh, exp3
        self.checks, self.unequal, self.plain = 0, [], []

    def _same(self, x):
        t = torch
        bits = {t.bfloat16: t.int16, t.float32: t.int32}[x.dtype]
        x = x.detach().reshape(-1)
        for chunk in x.split(self.CHUNK):
            rows = self.mesh.all_gather(chunk).view(bits)
            if not bool((rows == rows[0]).all()):
                return False
        return True

    def after(self, state, where):
        if self.mesh is None:
            return
        t = torch
        opt = state.optimizer
        flat = t.cat([v.detach().reshape(-1).float()
                      for p in state.model.parameters()
                      for v in (p, *(opt.state[p][k]
                                     for k in sorted(opt.state[p])))])
        same = {"params_adam": self._same(flat)}
        if self.exp3:
            same["exp3"] = self._same(state.exp3_weights)
        self.checks += 1
        if not all(same.values()):
            self.unequal.append({"where": where, "step": state.step, **same})

    def plain_shadow(self):
        import contextlib

        if self.mesh is None or not self.exp3:
            return contextlib.nullcontext()
        return self._shadow()

    def _shadow(self):
        import contextlib

        from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply_plain
        from bliss_gnn_tpu_torch.sampling.samplers import (
            exp3_delta_slots,
            normalize_exp3_weights,
        )
        from bliss_gnn_tpu_torch.train import steps as steps_mod

        t, audit = torch, self
        storage = steps_mod._DEFAULT_STORAGE
        apply = storage.apply_deltas

        def shadowed(exp3, deltas, normalize, max_repeats=1):
            ref = exp3.clone()
            apply(exp3, deltas, normalize, max_repeats=max_repeats)
            idx, mult, limit = exp3_delta_slots(deltas, exp3.shape[1])
            exp3_apply_plain(ref.view(-1), idx, mult, limit)
            if normalize:
                normalize_exp3_weights(ref)
            live = idx[(idx >= 0) & (idx < limit)].long()
            uniq, cnt = t.unique(live, return_counts=True)
            a, b = exp3.view(-1), ref.view(-1)
            changed = t.nonzero(a != b).squeeze(1)
            x, y = a[uniq].float(), b[uniq].float()
            ulp_of = f32_ulp if exp3.dtype == t.float32 else bf16_ulp
            ulp = t.maximum(ulp_of(x), ulp_of(y))
            audit.plain.append({
                "bound": max_repeats, "slots": int(idx.numel()),
                "live_slots": int(live.numel()),
                "entries": int(uniq.numel()),
                "max_repeats": int(cnt.max().item()) if cnt.numel() else 0,
                "repeated_entries": int((cnt > 1).sum().item()),
                "max_ulps": float(((x - y).abs() / ulp).max().item())
                if cnt.numel() else 0.0,
                "bitwise": bool(t.equal(a, b)),
                "untouched_equal": bool(t.isin(changed, uniq).all().item())})
            del ref

        @contextlib.contextmanager
        def ctx():
            storage.apply_deltas = shadowed
            try:
                yield
            finally:
                del storage.apply_deltas

        return ctx()

    def summary(self):
        if self.mesh is None:
            return {}
        return {"replica_checks": self.checks,
                "replicas_unequal": self.unequal,
                "k4_vs_plain": self.plain}

    def gate(self, label):
        if self.unequal:
            fail(f"{label}: state differs across ranks: {self.unequal}")
        bad = [r for r in self.plain
               if r["max_ulps"] > 1.0 or not r["untouched_equal"]]
        if bad:
            fail(f"{label}: K4 off exp3_apply_plain by more than one ulp on "
                 f"the gathered list: {bad}")


def card_identity(dev):
    """This rank's card: its index, name, uuid and PCI bus id (in
    ``nvidia-smi``'s format), so the parent can tell the cards apart."""
    if dev.type != "cuda":
        return {"device": str(dev)}
    p = torch.cuda.get_device_properties(dev)
    bus = getattr(p, "pci_bus_id", None)
    pci = (f"{getattr(p, 'pci_domain_id', 0):08X}:{bus:02X}:"
           f"{getattr(p, 'pci_device_id', 0):02X}.0" if bus is not None
           else None)
    uuid = str(getattr(p, "uuid", ""))
    smi = subprocess.run(
        ["nvidia-smi", f"--id=GPU-{uuid}",
         "--query-gpu=name,power.limit,pci.bus_id",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return {"device": str(dev), "name": p.name, "uuid": uuid,
            "pci_bus_id": pci, "nvidia_smi": smi.stdout.strip()
            or smi.stderr.strip()}


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def pilot_plan(graph, scfg, cfg, indptr_np, seeds, smask):
    """The main path's plan under the program's ``CapacityPolicy``: a
    pilot of ``pilot_steps`` fused steps at the a-priori caps, the refit
    from its maxima, then as many counted steps from fresh weights, each
    overflow widening the caps of its kind 1.5x. Returns the final plan
    and the pilot's numbers."""
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan, CapacityPolicy
    from bliss_gnn_tpu_torch.sampling.samplers import init_exp3_weights
    from bliss_gnn_tpu_torch.train.steps import make_train_step

    dev = seeds.device
    L, n_steps = len(scfg.fanouts), cfg["pilot_steps"]
    deg_np = np.diff(indptr_np)
    plan = CapacityPlan.build(cfg["batch"], scfg.fanouts, graph.n_nodes,
                              graph.n_edges, kind=scfg.kind,
                              deg_std=float(deg_np.std()),
                              max_degree=int(deg_np.max()))
    policy = CapacityPolicy(n_steps, max_degree=int(deg_np.max()))

    def run(step_plan, seed):
        st = fresh_state(dev, graph, scfg,
                         init_exp3_weights(L, graph.n_edges, device=dev),
                         torch.Generator(device=dev).manual_seed(seed),
                         seed=seed, dims=cfg)
        step = make_train_step(graph, scfg, step_plan, False, device=dev)
        changes = 0
        for i in range(n_steps):
            st, m = step(st, seeds, smask)
            policy.observe(m)
            change = policy.decide(step_plan, i + 1)
            if change is not None:
                step_plan = change[1]
                step = make_train_step(graph, scfg, step_plan, False,
                                       device=dev)
                changes += 1
        return step_plan, changes

    tight, _ = run(plan, 1)  # the refit follows the pilot's last step
    fr, be = policy.maxima(L)
    final, widened = run(tight, 0)
    return final, {"pilot_steps": n_steps, "pilot_frontier_edges": fr,
                   "pilot_block_edges": be, "widened": widened,
                   "frontier_caps": final.frontier_caps,
                   "block_e_caps": final.block_e_caps}


def multicard_worker(cfg, graph_dir, device, plan, last):
    """One rank of a group of S (one rank a card under NCCL; gloo ranks on
    the CPU to rehearse): the graph from ``graph_dir`` on its card, the
    plan (``pilot_plan`` on rank 0 when ``plan`` is None, broadcast), then
    the DP step and the range-sharded step of SAGE (``parallel_step_run``:
    eager steps, the captured chained step, each against two eager DP
    twins from one state; every step audited across the ranks), and, in
    the ``last`` group, GATv2 through the DP step and the ring inference
    of both trained models. Returns this rank's numbers."""
    import torch
    import torch.distributed as dist

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
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(None, device=device)
    dev, S, L = mesh.device, mesh.size, len(cfg["fanouts"])
    tol = MULTICARD_TOLERANCE if cfg["gate"] else None
    wrappers = kernel_wrappers()
    out = {"rank": mesh.rank, "ranks": S, "backend": mesh.backend,
           "pid": os.getpid(), **card_identity(dev)}
    t0 = time.perf_counter()
    indptr_np = np.load(os.path.join(graph_dir, "indptr.npy"))
    graph = graph_from_csc(
        dev, indptr_np,
        np.load(os.path.join(graph_dir, "csc_src.npy"), mmap_mode="r"),
        cfg["n_feats"], cfg["n_classes"])
    out["graph_seconds"] = time.perf_counter() - t0
    t_start = time.perf_counter()

    def note(stage):  # progress on stderr, one line a rank and stage
        print(f"[multicard S={S} rank {mesh.rank}] {stage} at "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)

    E = graph.n_edges
    # every rank made the same graph (features and labels from one seed)
    digest = torch.stack([graph.ndata["features"].sum(dtype=torch.float64),
                          graph.ndata["labels"].sum(dtype=torch.float64),
                          graph.csc_src.sum(dtype=torch.float64)])
    if not bool((mesh.all_gather(digest) == digest).all()):
        fail(f"rank {mesh.rank}: the ranks' graphs differ")
    scfg = SamplerConfig(kind="poisson-bandit", fanouts=tuple(cfg["fanouts"]))
    B = cfg["batch"]
    seeds_np = np.random.default_rng(0).integers(
        0, graph.n_nodes, max(MULTICARD_SIZES) * B).astype(np.int32)
    seeds = torch.from_numpy(seeds_np[:S * B]).to(dev)
    smask = torch.ones(S * B, dtype=torch.bool, device=dev)
    if plan is None:
        box = [pilot_plan(graph, scfg, cfg, indptr_np, seeds[:B],
                          smask[:B]) if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        plan, out["pilot"] = box[0]
    out["plan"] = plan
    note("plan")
    if last and dev.type == "cuda":
        mesh.barrier()  # every rank holds its card: who is on which card
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,gpu_bus_id",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        out["compute_apps"] = apps.stdout.strip().splitlines()
        mesh.barrier()

    def state(c, exp3, seed=0):
        return fresh_state(dev, graph, c, exp3, mesh.generator(seed),
                           dims=cfg)

    def dp_run(c, label, counts, kernels=STEP_KERNELS):
        step = make_dp_train_step(mesh, graph, c, plan, False,
                                  exp3_normalize=False)
        multi = make_dp_multi_train_step(mesh, graph, c, plan, False,
                                         exp3_normalize=False)

        def twin():
            tw = state(c, init_exp3_weights(L, E, device=dev))
            tw, _ = step(tw, seeds, smask)  # makes Adam's state
            return tw

        st = state(c, init_exp3_weights(L, E, device=dev))
        res, st = parallel_step_run(
            label, st, step, multi, step, twin(), twin(), seeds,
            smask, wrappers, mesh, lambda s: s.exp3_weights, tol,
            counts=counts, kernels=kernels,
            audit=RankAudit(mesh, exp3=True), twin_name="dp")
        return res, st.model, step

    out["dp"], sage_model, dp_step = dp_run(scfg, "dp", cfg["counts"])
    # what the DP step holds on a rank: the replicated graph and arm
    # weights [L, E + EDGE_PAD] (bf16)
    out["dp"]["storage_bytes"] = tensor_bytes(
        graph.csc_indptr, graph.csc_src, graph.csr_indptr,
        *graph.ndata.values(), *graph.edata.values()) + (
            L * graph.csc_src.numel() * 2)
    note("dp")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hv = host_view(graph, indptr_np)
    sg = ShardedDeviceGraph.build(hv, mesh, feature_dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0

    def exp3_of(s):
        w = s.exp3_weights
        return unshard_exp3(mesh.all_gather(w), L, E) if w.dim() == 1 else w

    def dp_twin():
        tw = state(scfg, init_exp3_weights(L, E, device=dev))
        tw, _ = dp_step(tw, seeds, smask)
        return tw

    res, st = parallel_step_run(
        "sharded", state(scfg, init_exp3_shard(L, E, mesh)),
        make_sharded_train_step(mesh, sg, scfg, plan, False),
        make_sharded_multi_train_step(mesh, sg, scfg, plan, False),
        dp_step, dp_twin(), dp_twin(), seeds, smask, wrappers, mesh, exp3_of,
        tol, counts=cfg["counts"], audit=RankAudit(mesh),
        twin_name="dp")
    out["sharded"] = dict(
        res, build_seconds=build_s, epr=sg.epr, npr=sg.npr,
        storage_bytes=tensor_bytes(  # this rank's shards and arm weights
            sg.csc_indptr, sg.csc_src_sh, sg.w_sh, sg.features_sh,
            sg.labels_sh) + (L * sg.epr + 1) * 2,
        row_gather_collectives_per_step={
            k: v for k, v in res["collectives_per_step"].items()
            if k in ("all_gather", "reduce_scatter")})
    del st, sg
    note("sharded")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if last:
        gcfg = dataclasses.replace(scfg, model="gat")
        out["gat"], gat_model, _ = dp_run(
            gcfg, "gat", cfg["gat_counts"],
            STEP_KERNELS + ("row_scatter_add", "gat_edge"))
        note("gat")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["inference"], out["k7_partials"] = sharded_inference_records(
            mesh, hv, graph, {"sage": sage_model, "gat": gat_model},
            wrappers, n_layers=L)
        note("inference")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def multicard_phases(cfg, graph_dir, device, sizes=MULTICARD_SIZES):
    """The groups of ``sizes`` ranks, a new spawn each (``run_ranks``, one
    rank a card under NCCL), each running ``multicard_worker``; the plan
    of the first group is handed to the others. Prints ``multicard_dp``,
    ``multicard_sharded`` per group and, for the largest,
    ``multicard_gat`` and ``multicard_inference``; fails on a gate held
    across the ranks (the backend, one card a rank). Returns each group's
    ranks' numbers by S."""
    from bliss_gnn_tpu_torch.parallel.multihost import run_ranks

    runs, plan = {}, None
    for S in sizes:
        t0 = time.perf_counter()
        threads = max(1, (os.cpu_count() or 1) // S)
        ranks = run_ranks(multicard_worker, S,
                          (cfg, graph_dir, device, plan, S == sizes[-1]),
                          device=device,
                          workdir=os.path.join(graph_dir, f"ranks{S}"),
                          threads=threads)
        spawn_s = time.perf_counter() - t0
        plan = plan or ranks[0]["plan"]
        want = "nccl" if device == "cuda" else "gloo"
        cards = [r.get("uuid") or r["device"] for r in ranks]
        if any(r["backend"] != want for r in ranks) or (
                device == "cuda" and len(set(cards)) != S):
            got = [(r["backend"], r["device"]) for r in ranks]
            fail(f"multicard S = {S}: ranks {got}: want {want}, one card a "
                 f"rank")
        apps = check_one_process_a_card(ranks) if device == "cuda" else {}
        ident = [{k: r.get(k) for k in ("rank", "device", "name", "uuid",
                                        "pci_bus_id", "nvidia_smi", "pid")}
                 for r in ranks]
        for kind in ("dp", "sharded"):
            emit({"phase": f"multicard_{kind}", "ranks": S,
                  "backend": ranks[0]["backend"], "cards": ident,
                  "group_seconds": spawn_s,
                  "graph_seconds": [r["graph_seconds"] for r in ranks],
                  "pilot": ranks[0].get("pilot"), **apps,
                  "by_rank": [r[kind] for r in ranks]})
        if S == sizes[-1]:
            emit({"phase": "multicard_gat", "ranks": S,
                  "by_rank": [r["gat"] for r in ranks]})
            emit({"phase": "multicard_inference", "ranks": S,
                  "by_rank": [{"rank": r["rank"], "models": r["inference"],
                               "k7_partials": r["k7_partials"]}
                              for r in ranks]})
        runs[S] = ranks
    return runs


def bus_key(pci):
    """A PCI bus id without its domain, lower case ("18:00.0"): the part
    ``nvidia-smi`` and CUDA's device properties print alike."""
    return ":".join((pci or "").strip().lower().split(":")[-2:])


def check_one_process_a_card(ranks):
    """``nvidia-smi``'s compute processes while every rank of the group held
    its card: where the ranks' pids show, each on its own card and no card
    with two; where they do not (a PID namespace), recorded as not
    visible."""
    apps = ranks[0].get("compute_apps") or []
    seen = {}
    for line in apps:
        pid, _, bus = (x.strip() for x in line.partition(","))
        seen.setdefault(pid, []).append(bus_key(bus))
    mine = {str(r["pid"]): bus_key(r.get("pci_bus_id")) for r in ranks}
    visible = {p: seen[p] for p in mine if p in seen}
    if visible and (set(visible) != set(mine) or any(
            v != [mine[p]] for p, v in visible.items())):
        fail(f"multicard: not one rank process a card: {apps} {mine}")
    return {"compute_apps": apps,
            "rank_pids_visible": bool(visible)}


def multicard_scaling(runs, device):
    """``multicard_scaling``: for the DP and the sharded step, the replayed
    and chained step ms (the slowest rank's), ``dp_weak_scaling_pct`` =
    replayed_step_ms(S = 1) / replayed_step_ms(S) x 100 (``bench.py``'s
    key), sampled edges a second over all ranks, collectives, bytes, the
    graph and arm weights a rank holds and peak memory a rank; each rank's
    card (``nvidia-smi`` by its uuid) and NCCL's version."""
    sizes = sorted(runs)
    out = {"phase": "multicard_scaling", "sizes": sizes}
    for kind in ("dp", "sharded"):
        rep = {S: max(r[kind][f"{kind}_replayed_step_ms"] for r in runs[S])
               for S in sizes}
        chained = {S: max(r[kind][f"{kind}_chained_step_ms"]
                          for r in runs[S]) for S in sizes}
        eager = {S: max(r[kind][f"{kind}_step_ms"] for r in runs[S])
                 for S in sizes}
        edges = {S: runs[S][0][kind]["sampled_edges_per_step"]
                 for S in sizes}
        out[kind] = {
            "replayed_step_ms": rep, "chained_step_ms": chained,
            "eager_step_ms": eager,
            "dp_weak_scaling_pct": {S: rep[sizes[0]] / rep[S] * 100.0
                                    for S in sizes[1:]},
            "chained_weak_scaling_pct": {
                S: chained[sizes[0]] / chained[S] * 100.0
                for S in sizes[1:]},
            "sampled_edges_per_s": {S: edges[S] / (rep[S] / 1e3)
                                    for S in sizes},
            "collectives_per_step_per_rank": {
                S: runs[S][0][kind]["collectives_count_per_step"]
                for S in sizes},
            "collective_bytes_per_step_per_rank": {
                S: runs[S][0][kind]["collective_bytes_per_step"]
                for S in sizes},
            "moved_bytes_per_step_per_rank": {
                S: runs[S][0][kind]["moved_bytes_per_step"] for S in sizes},
            "storage_bytes_per_rank": {
                S: runs[S][0][kind]["storage_bytes"] for S in sizes},
            "peak_memory_bytes_per_rank": {
                S: [r[kind].get("peak_memory_bytes") for r in runs[S]]
                for S in sizes}}
    out["cards"] = [{k: r.get(k) for k in ("rank", "device", "uuid",
                                           "pci_bus_id", "nvidia_smi")}
                    for r in runs[sizes[-1]]]
    out["nccl"] = (".".join(str(v) for v in torch.cuda.nccl.version())
                   if device == "cuda" else None)
    emit(out)
    vals = [v for kind in ("dp", "sharded")
            for k in ("replayed_step_ms", "dp_weak_scaling_pct",
                      "sampled_edges_per_s")
            for v in out[kind][k].values()]
    if not all(math.isfinite(v) and v > 0 for v in vals):
        fail(f"multicard_scaling: {out}")
    return out
