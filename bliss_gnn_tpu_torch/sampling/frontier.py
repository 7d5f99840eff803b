"""Static-shape in_subgraph and compact_graphs on the device (counterpart
of ``bliss_gnn_tpu/sampling/frontier.py``).

- ``gather_in_edges`` flattens the CSC rows of a seed set into a padded
  edge list laid out in grid-aligned chunks of ``ck`` edges: the canonical
  edge range is cut into rows of ``ck``, and each seed owns the run of rows
  its CSC range touches (slots outside the range are masked). The slot
  order decides every later compaction, so it is the reference's exactly.
- ``compact_candidates`` relabels seeds and frontier srcs densely in
  ascending global id (``dense_candidates`` skips it: position = id).
- ``compact_by_mask`` packs the indices of set entries, in order.

Ownership maps are a scatter-max of each owner at its first position,
forward-filled with ``cummax``. Scatters whose target may fall outside the
table write to one extra dump slot that is sliced off, which is the
reference's ``mode="drop"``. Nothing here syncs with the host or copies
from it (a ``t[idx] = True`` would copy the scalar, which CUDA-graph
capture refuses: flags are set with ``index_fill_``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD
from bliss_gnn_tpu_torch.ops.gather import lut_gather, lut_gather_multi
from bliss_gnn_tpu_torch.ops.segment import masked_segment_sum
from bliss_gnn_tpu_torch.parallel.shards import EShard, NShard

SENTINEL = torch.iinfo(torch.int32).max

__all__ = [
    "EDGE_PAD", "SENTINEL", "Frontier", "Candidates", "ptr_take",
    "frontier_gather", "frontier_seed_broadcast", "frontier_segment_sum",
    "gather_in_edges", "compact_candidates", "dense_candidates",
    "compact_by_mask",
]


class Frontier(NamedTuple):
    """Padded in-subgraph of a seed set in grid-aligned chunks of ``ck``."""

    eid: torch.Tensor  # [e_cap] canonical edge ids
    src_gid: torch.Tensor  # [e_cap] global src node id per slot
    dst_spos: torch.Tensor  # [e_cap] dst's position in the seeds array
    e_mask: torch.Tensor  # [e_cap] bool
    total_edges: torch.Tensor  # 0-dim: true (untruncated) edge count
    chunk_gidx: torch.Tensor  # [e_cap // ck] grid-row index of each chunk
    chunk_owner: torch.Tensor  # [e_cap // ck] owner seed position
    chunk_valid: torch.Tensor  # [e_cap // ck] bool

    @property
    def ck(self) -> int:
        return self.eid.shape[0] // self.chunk_gidx.shape[0]

    def n_valid_chunks(self) -> torch.Tensor:
        """0-dim int32: the number of valid chunks, which form a prefix."""
        return self.chunk_valid.sum(dtype=torch.int32)

    def n_valid_slots(self) -> torch.Tensor:
        """0-dim int32: every unmasked slot lies in [0, n_valid_chunks *
        ck)."""
        return self.n_valid_chunks() * self.ck


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def ptr_take(ptr, idx: torch.Tensor) -> torch.Tensor:
    """``ptr[idx]`` (every sampler read of csc_indptr goes through here);
    a node-sharded ``NShard`` serves it over the mesh."""
    if isinstance(ptr, NShard):
        return ptr.take1d(idx)
    return ptr[idx.long()]


def frontier_gather(frontier: Frontier, data) -> torch.Tensor:
    """``data[eid]`` for every frontier slot, read as whole ck-wide rows of
    ``data`` (edge-indexed, with EDGE_PAD >= ck trailing zeros); an
    edge-sharded ``EShard`` serves the rows over the mesh."""
    if isinstance(data, EShard):
        return data.frontier_rows(frontier)
    ck = frontier.ck
    j = torch.arange(ck, dtype=torch.int64, device=data.device)
    pos = frontier.chunk_gidx.long()[:, None] * ck + j[None, :]
    return data[pos.reshape(-1)]


def frontier_seed_broadcast(frontier: Frontier,
                            vals: torch.Tensor) -> torch.Tensor:
    """A per-seed vector broadcast to every slot, at chunk granularity (a
    slot's dst is its chunk's owner); the per-chunk take is K2."""
    per_chunk = lut_gather(vals, frontier.chunk_owner)
    return per_chunk[:, None].expand(-1, frontier.ck).reshape(-1)


def frontier_segment_sum(frontier: Frontier, vals: torch.Tensor,
                         n_seed_cap: int) -> torch.Tensor:
    """Per-seed sum of per-slot values (zero on masked slots): per-chunk
    partial sums, then one scatter-add of the partials by chunk owner. The
    owners are a running max, so they are sorted, and the valid chunks are
    a prefix: the sorted route of K1."""
    partial = vals.reshape(-1, frontier.ck).sum(dim=1)
    partial = torch.where(frontier.chunk_valid, partial, 0.0)
    return masked_segment_sum(
        partial, frontier.chunk_owner, n_seed_cap,
        n_valid=frontier.n_valid_chunks(), ids_sorted=True)


def gather_in_edges(csc_indptr: torch.Tensor, csc_src: torch.Tensor,
                    seeds: torch.Tensor, seeds_mask: torch.Tensor,
                    e_cap: int, ck: Optional[int] = None) -> Frontier:
    """dgl.in_subgraph as a static-shape, grid-aligned flatten of CSC rows;
    rows past the capacity are dropped (``total_edges`` keeps the count).
    ``ck`` sizes itself to the capacity per seed, as in the reference."""
    n_seeds = seeds.shape[0]
    if ck is None:
        ck = max(8, min(128, e_cap // (2 * max(1, n_seeds))))
        ck = 1 << (ck.bit_length() - 1)
    ck = min(ck, max(e_cap, 1))
    n_chunk_cap = max(1, e_cap // ck)
    e_cap = n_chunk_cap * ck
    safe_seeds = torch.where(seeds_mask, seeds, 0)
    bounds = _i32(ptr_take(csc_indptr, torch.cat([safe_seeds, safe_seeds + 1])))
    row_start, row_end = bounds[:n_seeds], bounds[n_seeds:]
    deg = torch.where(seeds_mask, row_end - row_start, 0)
    row_end = torch.where(seeds_mask, row_end, row_start)
    g_start = torch.div(row_start, ck, rounding_mode="floor")
    g_end = torch.where(
        deg > 0, torch.div(row_end + ck - 1, ck, rounding_mode="floor"),
        g_start)
    nchunks = g_end - g_start
    coff = _i32(torch.cumsum(nchunks, 0)) - nchunks  # exclusive cumsum
    total_chunks = nchunks.sum(dtype=torch.int32)
    total = deg.sum(dtype=torch.int32)

    cpos = _arange(n_chunk_cap, seeds)
    # ownership: each chunk-owning seed at its first chunk, forward-filled
    starts = torch.where((nchunks > 0) & (coff < n_chunk_cap), coff,
                         n_chunk_cap)
    own0 = torch.full((n_chunk_cap + 1,), -1, dtype=torch.int32,
                      device=seeds.device)
    own0.scatter_reduce_(0, starts.long(), _arange(n_seeds, seeds), "amax")
    owner = torch.cummax(own0[:n_chunk_cap], 0).values.clamp(0, n_seeds - 1)
    chunk_valid = cpos < torch.clamp(total_chunks, max=n_chunk_cap)
    # the owner's chunk offset, first grid row and CSC range, in one take
    o_coff, o_gstart, o_start, o_end = lut_gather_multi(
        (coff, g_start, row_start, row_end), owner)
    chunk_gidx = o_gstart + (cpos - o_coff)
    chunk_gidx = torch.where(chunk_valid, chunk_gidx, 0)

    j = _arange(ck, seeds)
    eid2d = chunk_gidx[:, None] * ck + j[None, :]
    e_mask = (chunk_valid[:, None]
              & (eid2d >= o_start[:, None])
              & (eid2d < o_end[:, None])).reshape(-1)
    eid = torch.where(e_mask, eid2d.reshape(-1), 0)
    dst_spos = torch.where(
        e_mask, owner[:, None].expand(-1, ck).reshape(-1), 0)
    frontier = Frontier(
        eid=eid, src_gid=eid, dst_spos=dst_spos, e_mask=e_mask,
        total_edges=total, chunk_gidx=chunk_gidx, chunk_owner=owner,
        chunk_valid=chunk_valid,
    )
    src = _i32(frontier_gather(frontier, csc_src))
    return frontier._replace(src_gid=torch.where(e_mask, src, 0))


class Candidates(NamedTuple):
    """Compacted node set of a frontier, seeds included. ``mask``/``n`` are
    None in dense mode until the sampler derives them from the node
    probabilities."""

    gids: torch.Tensor  # [c_cap] ascending, SENTINEL-padded
    mask: Optional[torch.Tensor]  # [c_cap] bool
    n: Optional[torch.Tensor]  # 0-dim number of valid candidates
    src_cpos: torch.Tensor  # [e_cap] candidate position of each slot's src
    seed_cpos: torch.Tensor  # [n_seeds] candidate position of each seed
    is_seed: torch.Tensor  # [c_cap] bool


def compact_candidates(seeds, seeds_mask, frontier: Frontier, c_cap: int,
                       n_nodes: int) -> Candidates:
    """dgl.compact_graphs(insg, always_preserve=seeds): mark membership in
    an [N] table, compact it, relabel through an [N] position table."""
    dev = seeds.device
    mark = torch.zeros(n_nodes + 1, dtype=torch.bool, device=dev)
    mark.index_fill_(0, torch.where(seeds_mask, seeds, n_nodes).long(), True)
    mark.index_fill_(
        0, torch.where(frontier.e_mask, frontier.src_gid, n_nodes).long(),
        True)
    idx, out_mask, n = compact_by_mask(mark[:n_nodes], c_cap)
    gids = torch.where(out_mask, idx, SENTINEL)
    pos_of_gid = torch.zeros(n_nodes + 1, dtype=torch.int32, device=dev)
    pos_of_gid[torch.where(out_mask, idx, n_nodes).long()] = _arange(c_cap, idx)
    pos_of_gid = pos_of_gid[:n_nodes]
    src_cpos = torch.where(
        frontier.e_mask,
        lut_gather(pos_of_gid, frontier.src_gid,
                   n_valid=frontier.n_valid_slots()),
        0)
    seed_cpos = torch.where(
        seeds_mask, pos_of_gid[torch.where(seeds_mask, seeds, 0).long()], 0)
    is_seed = torch.zeros(c_cap, dtype=torch.int32, device=dev)
    is_seed.scatter_reduce_(0, seed_cpos.long(), _i32(seeds_mask), "amax")
    return Candidates(gids=gids, mask=out_mask, n=n, src_cpos=src_cpos,
                      seed_cpos=seed_cpos, is_seed=(is_seed > 0) & out_mask)


def dense_candidates(seeds, seeds_mask, frontier: Frontier, c_cap: int,
                     n_nodes: int) -> Candidates:
    """compact_graphs skipped: candidate position == global node id. Needs
    c_cap > n_nodes (one out-of-range dump slot)."""
    if c_cap <= n_nodes:
        raise ValueError("dense candidates need c_cap > n_nodes")
    is_seed = torch.zeros(c_cap + 1, dtype=torch.bool, device=seeds.device)
    is_seed.index_fill_(0, torch.where(seeds_mask, seeds, c_cap).long(), True)
    return Candidates(
        gids=_arange(c_cap, seeds), mask=None, n=None,
        src_cpos=frontier.src_gid,  # already zero on masked slots
        seed_cpos=torch.where(seeds_mask, seeds, 0),
        is_seed=is_seed[:c_cap],
    )


def compact_by_mask(mask: torch.Tensor, out_cap: int):
    """Stable compaction: the indices of True entries packed into
    ``out_cap`` slots, 0 on padded slots; past ``out_cap`` the first
    ``out_cap`` entries are kept. Returns (idx, out_mask, n)."""
    n_in = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    n = mask.sum(dtype=torch.int32)
    out_mask = _arange(out_cap, mask) < n
    slot = torch.where(mask & (pos < out_cap), pos, out_cap)
    idx = torch.zeros(out_cap + 1, dtype=torch.int32, device=mask.device)
    idx[slot] = _arange(n_in, mask)
    return idx[:out_cap], out_mask, n
