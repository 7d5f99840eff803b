"""Range-sharded storage for edge-partitioned sampled training (counterpart
of ``bliss_gnn_tpu/parallel/shards.py``).

- nodes are cut into contiguous ranges of ``npr`` per rank;
- canonical edge ids are CSC order (grouped by dst), so contiguous dst
  ranges give contiguous canonical edge ranges, and every edge-indexed
  array (``csc_src``, the normalised weights, the EXP3 rows) shards into
  contiguous ``epr`` slices with no permutation;
- a rank holds O(E/S + N/S); only the [N + 1] ``csc_indptr`` stays
  replicated unless it is sharded too (:class:`NShard`).

Remote rows are read by a distributed row gather: every rank all-gathers
the int32 row requests of the mesh, serves the rows it owns (zeros
elsewhere), and one reduce-scatter hands each rank its answers. Exactly one
rank contributes a non-zero row, so the sum is exact in every dtype and
the sharded step samples what the replicated one does.

Alignment: ``epr`` is a multiple of 128 and S * epr >= E + 128, so a
``frontier_gather`` chunk (ck a power of two, at most 128) lies inside one
shard, and the padding row after the last edge exists (EDGE_PAD's
counterpart).
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def edges_per_shard(n_edges: int, n_shards: int) -> int:
    """The smallest multiple of 128 with S * epr >= E + 128."""
    return round_up(round_up(n_edges + 128, n_shards * 128) // n_shards, 128)


def nodes_per_shard(n_nodes: int, n_shards: int) -> int:
    """Node rows per rank; + 1 so the indptr's [N] entry fits the shards."""
    return round_up(n_nodes + 1, n_shards * 8) // n_shards


def _serve(mesh, local: torch.Tensor, reqs: torch.Tensor,
           per: int) -> torch.Tensor:
    """The rows ``reqs`` [S, C] of the global array whose rank-r slice of
    ``per`` rows is ``local`` on rank r: served here where owned, 0
    elsewhere; reduce-scattered back."""
    loc = reqs.to(torch.int64) - mesh.rank * per
    mine = (loc >= 0) & (loc < per)
    rows = local[loc.clamp(0, per - 1)]
    mine = mine.reshape(mine.shape + (1,) * (rows.dim() - mine.dim()))
    served = torch.where(mine, rows, torch.zeros((), dtype=rows.dtype,
                                                 device=rows.device))
    return mesh.psum_scatter(served)


class EShard:
    """This rank's contiguous slice of a canonical edge-indexed array:
    ``data[i]`` is the global entry ``rank * epr + i``. ``frontier_rows``
    makes it a drop-in for ``sampling.frontier.frontier_gather``, which
    dispatches on it."""

    def __init__(self, data: torch.Tensor, mesh, epr: int):
        self.data, self.mesh, self.epr = data, mesh, epr

    def frontier_rows(self, frontier) -> torch.Tensor:
        """``data_global`` at every slot of the frontier's chunk grid: the
        mesh's chunk-row requests all-gathered, the owned rows served, the
        answers reduce-scattered back."""
        ck = frontier.ck
        if self.epr % ck:
            raise ValueError(f"chunk size {ck} must divide edges-per-shard "
                             f"{self.epr}")
        rows_per = self.epr // ck
        reqs = self.mesh.all_gather(frontier.chunk_gidx)  # [S, C]
        grid = self.data.view(rows_per, ck)
        return _serve(self.mesh, grid, reqs, rows_per).reshape(-1)


class NShard:
    """This rank's contiguous slice of a node-indexed 1-D array (the sharded
    ``csc_indptr``); ``take1d`` makes it a drop-in for the indexing in
    ``sampling.frontier.ptr_take``."""

    def __init__(self, data: torch.Tensor, mesh, npr: int):
        self.data, self.mesh, self.npr = data, mesh, npr

    def take1d(self, idx: torch.Tensor) -> torch.Tensor:
        return sharded_node_rows(self.data, idx, self.mesh, self.npr)


def sharded_node_rows(local: torch.Tensor, gids: torch.Tensor, mesh,
                      npr: int) -> torch.Tensor:
    """rows_global[gids], the global array cut into contiguous ``npr``-row
    ranges (rank s owns rows [s * npr, (s + 1) * npr)): the input block's
    feature rows, the seed batch's labels. The reduce-scatter moves
    ``len(gids)`` rows a rank."""
    reqs = mesh.all_gather(gids.to(torch.int32))  # [S, B]
    return _serve(mesh, local, reqs, npr)


class ShardedExp3:
    """This rank's EXP3 shard, layer-major ``[L * epr + 1]``: its edge range
    of every layer's row, then a dump slot. ``layer_row`` makes it a
    drop-in for ``samplers.exp3_row``, which dispatches on it."""

    def __init__(self, local: torch.Tensor, mesh, epr: int, n_layers: int):
        self.local, self.mesh = local, mesh
        self.epr, self.n_layers = epr, n_layers

    def layer_row(self, layer: int) -> EShard:
        return EShard(self.local[layer * self.epr:(layer + 1) * self.epr],
                      self.mesh, self.epr)


def apply_exp3_deltas_sharded(local: torch.Tensor, deltas, rank: int,
                              epr: int, n_layers: int,
                              max_repeats: int = 1) -> torch.Tensor:
    """The ownership-filtered multiplicative update of this rank's flat
    shard, in place, by K4 (``state[flat_idx] *= mult``). ``deltas`` are
    every rank's all-gathered (eid, exponent) lists; this rank applies the
    updates whose edge it owns. Updates of other ranks' edges, and zero
    exponents, point at the dump slot ``L * epr``, which is K4's limit (a
    no-op index), so the slot stays 0. ``max_repeats`` S > 1 (an edge
    several of the S ranks sampled repeats in the list, once a rank) takes
    K4's repeats route, so the shard gets the DP replicas' bits for the
    same deltas."""
    dump = n_layers * epr
    idxs, mults = [], []
    for layer, (eid, dr) in enumerate(deltas):
        dr = dr.reshape(-1)
        loc = eid.reshape(-1).to(torch.int32) - rank * epr
        owned = (loc >= 0) & (loc < epr) & (dr != 0)
        idxs.append(torch.where(owned, layer * epr + loc, dump))
        mults.append(torch.exp(dr).to(torch.float32))
    exp3_apply(local, torch.cat(idxs).to(torch.int32), torch.cat(mults),
               dump, max_repeats=max_repeats)
    return local


def normalize_exp3_sharded(local: torch.Tensor, n_layers: int, epr: int,
                           mesh) -> torch.Tensor:
    """The L1 row normalisation of the sharded state, in place: per-layer
    partial sums all-reduced over the mesh."""
    w2 = local[:n_layers * epr].view(n_layers, epr)
    norm = mesh.psum(w2.sum(dim=1, dtype=torch.float32))
    inv = (1.0 / torch.clamp(norm, min=1e-12)).to(local.dtype)
    w2.mul_(inv[:, None])
    return local
