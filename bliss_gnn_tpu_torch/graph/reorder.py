"""Host-side node reorderings (counterpart of
``bliss_gnn_tpu/graph/reorder.py``): the same permutations, labels and
coverage for the same input.

- ``propagate_labels``: label propagation on the undirected view, each node
  taking the most common label among its neighbours (ties to the smallest).
- ``locality_perm``: ``perm[new_id] = old_id`` under ``degree`` (by
  descending in-degree), ``cluster`` (communities by edge mass, then
  descending degree within one) or ``hub-cluster`` (the ``hub_count``
  highest-degree nodes first, then cluster order).
- ``dense_coverage``: the share of edges in (256 x 256) blocks holding at
  least ``dense_t`` edges under a permutation, the reference's predictor
  of its hybrid SpMM's rate. The CSC kernels here (K6, K7) have no dense
  tier; for them a good order shows as src rows that stay in L2, which
  ``chip_smoke.py``'s ``reorder`` phase times.
- ``best_perm``: the candidate order of the highest coverage.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _degrees(indptr: np.ndarray) -> np.ndarray:
    return np.diff(indptr)


def propagate_labels(indptr: np.ndarray, csc_src: np.ndarray,
                     n_iters: int = 4, seed: int = 0) -> np.ndarray:
    """[N] int64 community labels (arbitrary ids, not compacted): labels
    start as node ids; each iteration every node with a neighbour adopts
    its neighbours' most common label (ties to the smallest), src and dst
    voting for each other; stops early when nothing changes."""
    n = len(indptr) - 1
    dst = np.repeat(np.arange(n, dtype=np.int64), _degrees(indptr))
    src = np.asarray(csc_src, np.int64)
    voter = np.concatenate([src, dst])
    votee = np.concatenate([dst, src])
    lab = np.arange(n, dtype=np.int64)
    for _ in range(n_iters):
        key = votee * n + lab[voter]
        key.sort()
        # runs of equal (votee, label) pairs and their lengths
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        run_votee = key[starts] // n
        run_lab = key[starts] % n
        run_cnt = np.diff(np.r_[starts, len(key)])
        # per votee the longest run, ties to the smallest label
        o = np.lexsort((run_lab, -run_cnt, run_votee))
        run_votee, run_lab = run_votee[o], run_lab[o]
        first = np.r_[True, run_votee[1:] != run_votee[:-1]]
        new_lab = lab.copy()
        new_lab[run_votee[first]] = run_lab[first]
        if np.array_equal(new_lab, lab):
            break
        lab = new_lab
    return lab


def locality_perm(indptr: np.ndarray, csc_src: np.ndarray,
                  order: str = "cluster", labels: Optional[np.ndarray] = None,
                  hub_count: int = 8192, lpa_iters: int = 4) -> np.ndarray:
    """``perm[new_id] = old_id`` under ``order``; ``labels`` are the
    communities (``propagate_labels`` when None)."""
    n = len(indptr) - 1
    deg = _degrees(indptr)
    if order == "degree":
        return np.argsort(-deg, kind="stable").astype(np.int64)
    if order not in ("cluster", "hub-cluster"):
        raise ValueError(f"unknown order '{order}'")
    if labels is None:
        labels = propagate_labels(indptr, csc_src, n_iters=lpa_iters)
    # a community's edge mass: the sum of its members' in-degrees
    _, compact = np.unique(labels, return_inverse=True)
    mass = np.bincount(compact, weights=deg.astype(np.float64))
    comm_rank = np.argsort(np.argsort(-mass, kind="stable"), kind="stable")
    rank_of_node = comm_rank[compact]
    if order == "cluster":
        return np.lexsort((-deg, rank_of_node)).astype(np.int64)
    is_hub = np.zeros(n, bool)
    if hub_count > 0:
        is_hub[np.argsort(-deg, kind="stable")[:hub_count]] = True
    return np.lexsort((-deg, rank_of_node, ~is_hub * 1)).astype(np.int64)


def dense_coverage(indptr: np.ndarray, csc_src: np.ndarray, perm: np.ndarray,
                   dense_t: int = 300, band: int = 16384, wr: int = 256,
                   sub: int = 256) -> Tuple[float, dict]:
    """(coverage, stats): the share of edges in (``wr`` x ``sub``) blocks
    of at least ``dense_t`` edges once the nodes are renumbered by
    ``perm``, blocks keyed by (src band, src sub-block, dst window)."""
    n = len(indptr) - 1
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    src = inv[np.asarray(csc_src, np.int64)]
    dst = inv[np.repeat(np.arange(n, dtype=np.int64), _degrees(indptr))]
    n_wins = -(-n // wr)
    block_key = ((src // band) * (band // sub) + (src % band) // sub
                 ) * n_wins + dst // wr
    counts = np.bincount(block_key)
    dense = counts[block_key] >= dense_t
    cov = float(dense.mean()) if len(dense) else 0.0
    return cov, {
        "coverage": cov,
        "n_dense_blocks": int((counts >= dense_t).sum()),
        "dense_edges": int(dense.sum()),
        "n_edges": int(len(src)),
        # the reference's blended-rate model of its TPU hybrid SpMM (dense
        # tier ~2.35 cycles an edge, gather ~6.9); no H100 quantity
        "pred_cy_per_edge": 2.35 * cov + 6.9 * (1.0 - cov),
    }


def best_perm(indptr: np.ndarray, csc_src: np.ndarray, dense_t: int = 300,
              candidates: Tuple[str, ...] = ("degree", "cluster",
                                             "hub-cluster"),
              lpa_iters: int = 4) -> Tuple[np.ndarray, str, dict]:
    """(perm, order, {order: coverage}): the candidate of the highest
    coverage (the first on a tie), one label propagation shared by the
    cluster orders."""
    labels = None
    if any(c != "degree" for c in candidates):
        labels = propagate_labels(indptr, csc_src, n_iters=lpa_iters)
    best, covs = None, {}
    for c in candidates:
        p = locality_perm(indptr, csc_src, order=c, labels=labels)
        cov, _ = dense_coverage(indptr, csc_src, p, dense_t=dense_t)
        covs[c] = cov
        if best is None or cov > best[2]:
            best = (p, c, cov)
    return best[0], best[1], covs
