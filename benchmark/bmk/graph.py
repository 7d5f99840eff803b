"""The graph and the inputs of a run.

The graph's structure is fixed by the configuration (seed 0) and built once
per checkout into ``.bench_cache/benchmark/`` at the checkout's root; every
run reads it back, and the split is drawn from seed 0 too. Everything
else follows ``--seed``: the features, the labels, the weights
(``weights.py``), the batch order and the sampler's draws (the trainer's
seed).

``reddit_shaped_csc`` is a frozen copy of the generator that ``bench.py``
and ``harness_torch.py`` use (the power-law degree sequence capped at 21k
on random node ids, uniform sources, one self-loop a node), with its sizes
taken from the configuration file.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

CACHE_DIR = os.path.join(".bench_cache", "benchmark")  # in the checkout


def reddit_shaped_csc(n_nodes, n_rand_edges, degree_cap, exponent, seed=0):
    """(indptr int64 [N + 1], csc_src int32 [E]): each dst's random
    in-edges in draw order, then its self-loop; E = n_rand_edges + N."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    wgt = ranks ** -exponent
    deg = np.minimum(wgt / wgt.sum() * n_rand_edges, degree_cap).astype(
        np.int64)
    deg[deg < 1] = 1
    while deg.sum() < n_rand_edges:
        deficit = n_rand_edges - deg.sum()
        deg = np.minimum(deg + np.minimum(deg, max(deficit // len(deg), 1)),
                         degree_cap)
    extra = deg.sum() - n_rand_edges
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


def load_csc(cfg, cache):
    """The configuration's graph, from the cache or built into it:
    (indptr int64, csc_src int32, whether it was built now)."""
    g = cfg["graph"]
    name = (f"{g['generator']}_{g['n_nodes']}_{g['n_rand_edges']}_"
            f"{g['degree_cap']}_{g['exponent']}.npz")
    path = os.path.join(cache, name)
    if os.path.exists(path):
        d = np.load(path)
        return d["indptr"], d["src"], False
    indptr, src = reddit_shaped_csc(g["n_nodes"], g["n_rand_edges"],
                                    g["degree_cap"], g["exponent"])
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, indptr=indptr, src=src)
    os.replace(tmp, path)  # a run cut short leaves no half-written file
    return indptr, src, True


class Inputs:
    """What one seed gives both sides: the graph on the device (indptr
    int64, csc_src int32, the dst of every edge, the in-degrees), the
    per-dst normalised weight 1 / in-degree of every edge, bf16 features
    (as f32 holding bf16 values), labels from a seeded linear teacher on
    the features, and the published split's sizes (its nodes fixed)."""

    def __init__(self, cfg, seed, dev, indptr_np, src_np):
        g = cfg["graph"]
        n = int(indptr_np.shape[0]) - 1
        self.n_nodes, self.n_edges = n, int(src_np.shape[0])
        self.indptr = torch.from_numpy(indptr_np).to(dev)
        self.src = torch.from_numpy(src_np).to(dev)
        self.in_deg = (self.indptr[1:] - self.indptr[:-1])
        self.dst = torch.repeat_interleave(
            torch.arange(n, device=dev, dtype=torch.int32), self.in_deg,
            output_size=self.n_edges)
        self.w = (1.0 / self.in_deg.clamp(min=1).float())[self.dst.long()]
        gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
        f, c = g["n_feats"], g["n_classes"]
        self.features = torch.randn((n, f), generator=gen, device=dev,
                                    dtype=torch.float32).to(
            torch.bfloat16).float()
        teacher = torch.randn((f, c), generator=gen, device=dev)
        self.labels = torch.argmax(self.features @ teacher, dim=1)
        # the split is the dataset's, as the published one is: the same
        # for every seed (seed 0), so that every seed trains the same nodes
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        n_train, n_val, _ = g["split"]
        self.split = {"train": perm[:n_train],
                      "val": perm[n_train:n_train + n_val],
                      "test": perm[n_train + n_val:]}
        self.gen = gen  # the weights draw from it next

    def to(self, dev):
        """Moves the inputs (to host memory while the program runs, so
        that its peak is its own, and back for the reference)."""
        for k in ("indptr", "src", "in_deg", "dst", "w", "features",
                  "labels"):
            setattr(self, k, getattr(self, k).to(dev))
        self.split = {k: v.to(dev) for k, v in self.split.items()}
        return self

    def host_graph(self):
        """The host ``Graph`` a user hands the trainer: the CSC, its CSR
        (the stable sort of the srcs, taken on the device), the weights,
        the f32 features, labels and split masks."""
        from bliss_gnn_tpu_torch.graph.structure import Graph

        n, e = self.n_nodes, self.n_edges
        src = self.src.long()
        order = torch.sort(src, stable=True).indices
        csr_indptr = torch.zeros(n + 1, dtype=torch.int64,
                                 device=src.device)
        csr_indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)

        def host(t):
            return t.cpu().numpy()

        masks = {}
        for split, ids in self.split.items():
            m = torch.zeros(n, dtype=torch.bool, device=src.device)
            m[ids] = True
            masks[f"{split}_mask"] = host(m)
        return Graph.from_csc(
            host(self.indptr), host(self.src), n,
            ndata={"features": host(self.features),
                   "labels": host(self.labels), **masks},
            edata={"w": host(self.w)},
            csr=(host(csr_indptr), host(self.dst[order]),
                 host(order.to(torch.int32))))

    def device_graph(self):
        """A ``DeviceGraph`` of the CSC with bf16 features, for full-graph
        inference (which reads the CSC, the in-degrees and, for GCN, the
        out-degrees)."""
        from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD, DeviceGraph

        n, e, dev = self.n_nodes, self.n_edges, self.src.device
        csc_src = torch.zeros(e + EDGE_PAD, dtype=torch.int32, device=dev)
        csc_src[:e] = self.src
        csr_indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        csr_indptr[1:] = torch.cumsum(
            torch.bincount(self.src.long(), minlength=n), 0)
        dummy = torch.zeros(1, dtype=torch.int32, device=dev)
        return DeviceGraph(
            csc_indptr=self.indptr.to(torch.int32), csc_src=csc_src,
            csr_indptr=csr_indptr, csr_dst=dummy, csr_eid=dummy,
            ndata={"features": self.features.to(torch.bfloat16),
                   "labels": self.labels},
            edata={}, n_nodes=n, n_edges=e)


def timed(record, name):
    """A context manager adding the seconds of its body to ``record``."""
    class _T:
        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            record[name] = record.get(name, 0.0) + time.perf_counter() - self.t0

    return _T()
