"""Edge-partitioned full-graph aggregation over a mesh of ranks
(counterpart of ``bliss_gnn_tpu/parallel/edgeshard.py``).

The edges are cut by contiguous dst ranges: each rank owns the CSC slice
of its range. Two layouts:

- :class:`EdgeShards`: features replicated; a rank aggregates its slice
  (K6) and one all-gather re-replicates the output;
- :class:`RingEdgeShards`: features and outputs node-sharded too; a rank's
  edges are cut again by the owner of their src into S buckets, and the
  feature blocks ride a ring of S - 1 ``ppermute`` rotations, each
  resident block folded in by its bucket. A bucket is the rank's in-edges
  whose src lies in one owner block; it keeps CSC order, so it is itself a
  CSC slice (an indptr over the rank's dsts and src ids into the block),
  and K6 aggregates it with no [E_bucket, F] message tensor, as
  ``layerwise_inference_uva`` runs K6 on chunk slices. For GATv2 K7 runs
  on each bucket with its partial outputs (the per-(dst, head) max and
  denominator) and the buckets' softmaxes are combined as the kernel
  merges its edge splits (``ops.gat_attention.combine_partials``); with one
  bucket there is nothing to combine.

Each rank holds only its own slice and buckets, built on the host from
the canonical graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from bliss_gnn_tpu_torch.ops.gat_attention import (
    combine_partials,
    gat_attention,
)
from bliss_gnn_tpu_torch.ops.spmm import spmm


def balanced_node_ranges(csc_indptr: np.ndarray, n_shards: int,
                         balance: str = "mixed") -> Tuple[int, ...]:
    """Contiguous node range bounds [S + 1] over the dst axis: an equal
    cut of the nodes (``nodes``), of the edges (``edges``), or (``mixed``,
    the default) of w_i = deg_i + E / N, which bounds both a shard's edges
    and its nodes within about 2x of their balanced shares."""
    n = len(csc_indptr) - 1
    if balance == "nodes":
        per = -(-n // n_shards)
        return tuple(min(n, s * per) for s in range(n_shards + 1))
    ip = np.asarray(csc_indptr, np.int64)
    E = int(ip[-1])
    if balance == "edges":
        cum = ip
    else:  # mixed
        per_node = max(1, E // max(1, n))
        cum = ip + per_node * np.arange(n + 1, dtype=np.int64)
    total = int(cum[-1])
    targets = [(s * total) // n_shards for s in range(n_shards + 1)]
    lo = np.searchsorted(cum, targets, side="left")
    lo = np.maximum.accumulate(lo)
    lo[0], lo[-1] = 0, n
    return tuple(int(x) for x in lo)


def _range_row_maps(lo: Tuple[int, ...], node_per: int):
    """(scatter index [S * node_per] into global rows, -1 on padding;
    gather index [N] from the shard layout's rows) for contiguous node
    ranges padded to ``node_per`` rows a shard."""
    S = len(lo) - 1
    idx = np.full(S * node_per, -1, np.int64)
    inv = np.zeros(lo[-1], np.int64)
    for s in range(S):
        k = lo[s + 1] - lo[s]
        idx[s * node_per:s * node_per + k] = np.arange(lo[s], lo[s + 1])
        inv[lo[s]:lo[s + 1]] = s * node_per + np.arange(k)
    return idx, inv


def _edge_vals(g, edge_vals) -> Optional[np.ndarray]:
    return None if edge_vals is None else np.asarray(edge_vals, np.float32)


def _padded_indptr(ip: np.ndarray, rows: int) -> np.ndarray:
    """``ip`` ([k + 1], from 0) extended to ``rows`` + 1 entries: the
    padded rows are empty."""
    out = np.full(rows + 1, ip[-1], np.int32)
    out[:len(ip)] = ip
    return out


@dataclasses.dataclass(frozen=True)
class EdgeShards:
    """This rank's CSC slice of its dst range, features replicated."""

    indptr: torch.Tensor  # [dst_per_shard + 1] int32, from 0
    src: torch.Tensor  # [E_s] int32 global src ids
    w: Optional[torch.Tensor]  # [E_s] f32, or None for unit weights
    dst_per_shard: int
    lo: Tuple[int, ...]
    rank: int

    @staticmethod
    def build(g, mesh, edge_vals=None, balance: str = "mixed"
              ) -> "EdgeShards":
        S, r = mesh.size, mesh.rank
        bounds = balanced_node_ranges(g.csc_indptr, S, balance)
        dst_per = max(max(bounds[s + 1] - bounds[s] for s in range(S)), 1)
        ip = np.asarray(g.csc_indptr, np.int64)
        e0, e1 = int(ip[bounds[r]]), int(ip[bounds[r + 1]])
        w = _edge_vals(g, edge_vals)
        dev = mesh.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return EdgeShards(
            indptr=up(_padded_indptr(ip[bounds[r]:bounds[r + 1] + 1] - e0,
                                     dst_per)),
            src=up(np.asarray(g.csc_src[e0:e1], np.int32)),
            w=None if w is None else up(w[e0:e1]),
            dst_per_shard=dst_per, lo=bounds, rank=r)


def make_sharded_spmm(mesh, shards: EdgeShards):
    """``fn(x [N, F] replicated) -> [dst_per_shard, F]`` f32: this rank's
    dst rows of the weighted aggregation (K6 on its slice)."""
    def fn(x: torch.Tensor) -> torch.Tensor:
        return spmm(x, shards.indptr, shards.src, edge_vals=shards.w)

    return fn


def _gather_rows(mesh, y: torch.Tensor, lo, per: int) -> torch.Tensor:
    """Every rank's [per, ...] rows all-gathered, in global node order."""
    _, inv = _range_row_maps(lo, per)
    full = mesh.all_gather(y).reshape((-1,) + tuple(y.shape[1:]))
    return full[torch.from_numpy(inv).to(full.device)]


def sharded_mean_aggregate(mesh, shards: EdgeShards, x: torch.Tensor,
                           in_degrees: torch.Tensor, n_nodes: int
                           ) -> torch.Tensor:
    """Full-graph mean aggregation, edge-sharded: [N, F] f32 on every
    rank."""
    out = _gather_rows(mesh, make_sharded_spmm(mesh, shards)(x), shards.lo,
                       shards.dst_per_shard)
    deg = torch.clamp(in_degrees.to(torch.float32), min=1.0)
    return out / deg[:, None]


@dataclasses.dataclass(frozen=True)
class RingEdgeShards:
    """This rank's dst range, its edges cut into S buckets by the owner of
    their src: bucket b is a CSC slice over the rank's ``node_per_shard``
    (padded) dsts with src ids relative to block b's first node."""

    indptr: List[torch.Tensor]  # S x [node_per + 1] int32
    src_rel: List[torch.Tensor]  # S x [E_b] int32
    w: List[Optional[torch.Tensor]]  # S x [E_b] f32, or None (unit)
    node_per_shard: int
    n_shards: int
    lo: Tuple[int, ...]
    rank: int

    @staticmethod
    def build(g, mesh, edge_vals=None, balance: str = "mixed"
              ) -> "RingEdgeShards":
        S, r, dev = mesh.size, mesh.rank, mesh.device
        bounds = balanced_node_ranges(g.csc_indptr, S, balance)
        node_per = max(max(bounds[s + 1] - bounds[s] for s in range(S)), 1)
        ip = np.asarray(g.csc_indptr, np.int64)
        e0, e1 = int(ip[bounds[r]]), int(ip[bounds[r + 1]])
        ip_rel = ip[bounds[r]:bounds[r + 1] + 1] - e0
        src = np.asarray(g.csc_src[e0:e1], np.int32)
        w = _edge_vals(g, edge_vals)
        w = None if w is None else w[e0:e1]

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        indptrs, srcs, ws = [], [], []
        if S == 1:  # one bucket: the whole CSC
            indptrs.append(up(_padded_indptr(ip_rel, node_per)))
            srcs.append(up(src))
            ws.append(None if w is None else up(w))
        else:
            owner = np.searchsorted(np.asarray(bounds), src,
                                    side="right") - 1
            for b in range(S):
                m = owner == b
                cum = np.concatenate([[0], np.cumsum(m, dtype=np.int64)])
                indptrs.append(up(_padded_indptr(cum[ip_rel], node_per)))
                srcs.append(up(src[m] - np.int32(bounds[b])))
                ws.append(None if w is None else up(w[m]))
        return RingEdgeShards(indptrs, srcs, ws, node_per, S, bounds, r)

    def shard_rows(self, x) -> np.ndarray:
        """This rank's block of global [N, ...] host rows (a memmap is read
        only there), zero-padded to ``node_per_shard`` rows."""
        a, b = self.lo[self.rank], self.lo[self.rank + 1]
        part = np.asarray(x[a:b])
        out = np.zeros((self.node_per_shard,) + part.shape[1:], part.dtype)
        out[:b - a] = part
        return out

    def unshard_rows(self, mesh, y: torch.Tensor) -> torch.Tensor:
        """Every rank's block all-gathered into global node order [N, ...]."""
        return _gather_rows(mesh, y, self.lo, self.node_per_shard)


def _ring(mesh, shards: RingEdgeShards, x_shard: torch.Tensor, fold):
    """Folds each bucket with its resident block: at ring step k this rank
    holds block (rank - k) mod S, after k rotations towards the next rank;
    S - 1 rotations in all."""
    S = shards.n_shards
    acc, x_cur = None, x_shard
    for k in range(S):
        b = (shards.rank - k) % S
        acc = fold(acc, b, x_cur)
        if k < S - 1:
            x_cur = mesh.ppermute(x_cur)
    return acc


def make_ring_spmm(mesh, shards: RingEdgeShards):
    """``fn(x_shard [node_per, F]) -> [node_per, F]`` f32, node-sharded: the
    weighted sum over the rank's in-edges, K6 on each bucket's CSC slice
    against its resident block."""
    def fold(acc, b, x_cur):
        part = spmm(x_cur, shards.indptr[b], shards.src_rel[b],
                    edge_vals=shards.w[b])
        return part if acc is None else acc + part

    return lambda x_shard: _ring(mesh, shards, x_shard, fold)


def make_ring_gat(mesh, shards: RingEdgeShards, negative_slope: float):
    """``fn(feat_shard [node_per, H, O], attn) -> [node_per, H, O]`` f32,
    node-sharded GATv2 attention. The edge softmax is per dst and the
    shards are dst ranges, so only src features ride the ring. K7 runs on
    each bucket over a table of the rank's own rows (a dst reads its own
    row at its id) then the resident block (src ids offset past them), and
    gives its partial max and denominator; the buckets combine as the
    kernel's splits do. The own block's bucket reads the own rows alone."""
    n = shards.node_per_shard

    def fn(feat_shard: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        def fold(acc, b, x_cur):
            if b == shards.rank:
                table, src = feat_shard, shards.src_rel[b]
            else:
                table = torch.cat([feat_shard, x_cur])
                src = shards.src_rel[b] + n
            part = gat_attention(table, attn, negative_slope,
                                 shards.indptr[b], src, partials=True)
            return part if acc is None else combine_partials(acc, part)

        return _ring(mesh, shards, feat_shard, fold)[0]

    return fn


def ring_mean_aggregate(mesh, shards: RingEdgeShards, x: torch.Tensor,
                        in_degrees: torch.Tensor, n_nodes: int
                        ) -> torch.Tensor:
    """Node-sharded full-graph mean aggregation of global rows ``x`` [N,
    F]: this rank's block rides the ring; [N, F] f32 on every rank."""
    a, b = shards.lo[shards.rank], shards.lo[shards.rank + 1]
    xs = torch.zeros((shards.node_per_shard,) + tuple(x.shape[1:]),
                     dtype=x.dtype, device=x.device)
    xs[:b - a] = x[a:b]
    out = shards.unshard_rows(mesh, make_ring_spmm(mesh, shards)(xs))
    deg = torch.clamp(in_degrees.to(torch.float32), min=1.0)
    return out[:n_nodes] / deg[:, None]
