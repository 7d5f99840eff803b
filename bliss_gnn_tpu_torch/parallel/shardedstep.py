"""Edge-partitioned sampled training: the graph, features and EXP3 state
range-sharded over the mesh, for graphs beyond one card's memory
(counterpart of ``bliss_gnn_tpu/parallel/shardedstep.py``).

- rank s owns node range [s * npr, (s + 1) * npr) and, since canonical edge
  ids are CSC (dst-grouped) order, the edge range [s * epr, (s + 1) *
  epr): its ``csc_src`` slice, its normalised-weight slice, its EXP3 rows.
  Features and labels shard by the node range. Only ``csc_indptr`` ([N +
  1] int32) stays replicated, unless ``shard_indptr``;
- the seed batch shards over the same ranks, and every read of remote
  graph data goes through the distributed row gather of
  ``parallel/shards.py``, sized to the sampled working set;
- the EXP3 updates stay sparse: the (eid, exponent) lists are
  all-gathered and each rank applies the updates of the edges it owns
  (K4 on its flat shard).

With the same draws and seed slices this step is the replicated DP step of
``parallel/dp.py``: the row gather returns the same values, and exactly one
rank serves each row.

The EXP3 state of a rank is its flat ``[L * epr + 1]`` shard
(:func:`shard_exp3`); the canonical ``[L, E + EDGE_PAD]`` layout of the
port's replicated state is what :func:`unshard_exp3` gives back, for a
checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD
from bliss_gnn_tpu_torch.parallel.dp import (
    eval_over,
    multi_eval_over,
    multi_over,
    step_over,
)
from bliss_gnn_tpu_torch.parallel.shards import (
    EShard,
    NShard,
    ShardedExp3,
    apply_exp3_deltas_sharded,
    edges_per_shard,
    nodes_per_shard,
    normalize_exp3_sharded,
    sharded_node_rows,
)
from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
from bliss_gnn_tpu_torch.sampling.samplers import SamplerConfig
from bliss_gnn_tpu_torch.train.steps import (
    StepStorage,
    _make_eval_body,
    _make_step_body,
)


def _rank_slice(a, rank: int, per: int, dtype=None) -> np.ndarray:
    """Rows [rank * per, (rank + 1) * per) of ``a`` (a host array or
    memmap, read only there), zero past its end."""
    lo = min(rank * per, a.shape[0])
    hi = min((rank + 1) * per, a.shape[0])
    part = np.asarray(a[lo:hi], dtype=dtype)
    out = np.zeros((per,) + tuple(a.shape[1:]), dtype=part.dtype)
    out[:hi - lo] = part
    return out


@dataclasses.dataclass(frozen=True)
class ShardedDeviceGraph:
    """One rank's range shards of the graph (the per-rank slice of the JAX
    package's mesh-stacked arrays)."""

    csc_indptr: torch.Tensor  # [N + 1] replicated, or [npr] if shard_indptr
    csc_src_sh: torch.Tensor  # [epr] int32, zero-padded
    w_sh: torch.Tensor  # [epr] normalised edge weight, zero-padded
    features_sh: torch.Tensor  # [npr, F] (a [1, 1] placeholder under UVA)
    labels_sh: torch.Tensor  # [npr] or [npr, C]
    mesh: object
    n_nodes: int = 0
    n_edges: int = 0
    epr: int = 0
    npr: int = 0
    n_shards: int = 0
    shard_indptr: bool = False

    @staticmethod
    def build(g, mesh, feature_dtype=torch.bfloat16,
              shard_indptr: bool = False,
              include_features: bool = True) -> "ShardedDeviceGraph":
        """This rank's shards of the host graph ``g``: equal slices of the
        canonical edge order (contiguous dst ranges fall out of the same
        cut) and of the node order, uploaded to the mesh's device. With
        ``include_features`` False the features stay in host memory (graph
        sharding with UVA)."""
        S, r, dev = mesh.size, mesh.rank, mesh.device
        epr = edges_per_shard(g.n_edges, S)
        npr = nodes_per_shard(g.n_nodes, S)

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        indptr = np.asarray(g.csc_indptr, np.int32)
        feats = (up(_rank_slice(g.ndata["features"], r, npr, np.float32),
                     feature_dtype) if include_features
                 else torch.zeros((1, 1), dtype=feature_dtype, device=dev))
        return ShardedDeviceGraph(
            csc_indptr=up(_rank_slice(indptr, r, npr) if shard_indptr
                          else indptr),
            csc_src_sh=up(_rank_slice(np.asarray(g.csc_src), r, epr,
                                      np.int32)),
            w_sh=up(_rank_slice(np.asarray(g.edata["w"]), r, epr,
                                np.float32)),
            features_sh=feats,
            labels_sh=up(_rank_slice(np.asarray(g.ndata["labels"]), r, npr)),
            mesh=mesh, n_nodes=g.n_nodes, n_edges=g.n_edges, epr=epr,
            npr=npr, n_shards=S, shard_indptr=shard_indptr)

    @property
    def device(self) -> torch.device:
        return self.csc_src_sh.device


class _LocalView:
    """The sampler's graph surface over one rank's shards: ``csc_indptr``,
    ``csc_src``, ``edata``, ``n_nodes``, with edge-indexed arrays as
    ``EShard`` handles (and the indptr as an ``NShard`` when sharded), so
    ``frontier_gather`` and ``ptr_take`` serve them over the mesh."""

    def __init__(self, sg: ShardedDeviceGraph):
        mesh = sg.mesh
        self.csc_indptr = (NShard(sg.csc_indptr, mesh, sg.npr)
                           if sg.shard_indptr else sg.csc_indptr)
        self.csc_src = EShard(sg.csc_src_sh, mesh, sg.epr)
        self.edata = {"w": EShard(sg.w_sh, mesh, sg.epr)}
        self.features_local = sg.features_sh
        self.labels_local = sg.labels_sh
        self.n_nodes, self.n_edges = sg.n_nodes, sg.n_edges
        self.device = sg.device


class ShardedStorage(StepStorage):
    """StepStorage over range-sharded state (``parallel/shards.py``)."""

    def __init__(self, mesh, epr: int, npr: int, n_layers: int):
        self.mesh, self.epr, self.npr, self.n_layers = mesh, epr, npr, n_layers

    def node_rows(self, graph: _LocalView, name: str, gids: torch.Tensor):
        local = (graph.features_local if name == "features"
                 else graph.labels_local)
        return sharded_node_rows(local, gids, self.mesh, self.npr)

    def exp3_view(self, exp3):
        if exp3 is None:
            return None
        return ShardedExp3(exp3, self.mesh, self.epr, self.n_layers)

    def apply_deltas(self, exp3, deltas, normalize: bool,
                     distinct: bool = True) -> None:
        apply_exp3_deltas_sharded(exp3, deltas, self.mesh.rank, self.epr,
                                  self.n_layers, distinct=distinct)
        if normalize:
            normalize_exp3_sharded(exp3, self.n_layers, self.epr, self.mesh)


def sharded_storage(sgraph: ShardedDeviceGraph, n_layers: int
                    ) -> ShardedStorage:
    return ShardedStorage(sgraph.mesh, sgraph.epr, sgraph.npr, n_layers)


def make_sharded_train_step(mesh, sgraph: ShardedDeviceGraph,
                            sampler_cfg: SamplerConfig, plan: CapacityPlan,
                            multilabel: bool,
                            exp3_normalize: bool = False) -> Callable:
    """The fused step over sharded storage, with ``make_dp_train_step``'s
    signature: ``step(state, seeds[S * B], seeds_mask, draws=None) ->
    (state, metrics)``, ``state.exp3_weights`` this rank's flat shard."""
    return step_over(mesh, _make_step_body(
        _LocalView(sgraph), sampler_cfg, plan, multilabel, mesh=mesh,
        storage=sharded_storage(sgraph, sampler_cfg.n_layers),
        exp3_normalize=exp3_normalize))


def make_sharded_multi_train_step(mesh, sgraph: ShardedDeviceGraph,
                                  sampler_cfg: SamplerConfig,
                                  plan: CapacityPlan, multilabel: bool,
                                  n_steps: Optional[int] = None,
                                  exp3_normalize: bool = False) -> Callable:
    """K sharded steps per call on seeds/masks [K, S * B] (captured and
    replayed on the card under NCCL, a loop under gloo)."""
    return multi_over(mesh, _make_step_body(
        _LocalView(sgraph), sampler_cfg, plan, multilabel, mesh=mesh,
        storage=sharded_storage(sgraph, sampler_cfg.n_layers),
        exp3_normalize=exp3_normalize), n_steps)


def make_sharded_eval_step(mesh, sgraph: ShardedDeviceGraph,
                           sampler_cfg: SamplerConfig, plan: CapacityPlan,
                           multilabel: bool) -> Callable:
    """Sharded sampled validation, ``make_dp_eval_step``'s contract."""
    return eval_over(mesh, _make_eval_body(
        _LocalView(sgraph), sampler_cfg, plan, multilabel, mesh=mesh,
        storage=sharded_storage(sgraph, sampler_cfg.n_layers)))


def make_sharded_multi_eval_step(mesh, sgraph: ShardedDeviceGraph,
                                 sampler_cfg: SamplerConfig,
                                 plan: CapacityPlan, multilabel: bool
                                 ) -> Callable:
    """Chained sharded validation on seeds/masks [K, S * B]."""
    return multi_eval_over(mesh, _make_eval_body(
        _LocalView(sgraph), sampler_cfg, plan, multilabel, mesh=mesh,
        storage=sharded_storage(sgraph, sampler_cfg.n_layers)))


def make_sharded_renorm(mesh, n_layers: int, epr: int) -> Callable:
    """The periodic L1 renormalisation of a rank's shard, in place (the
    trainer's ``exp3_renorm_every`` under graph sharding)."""
    return lambda local: normalize_exp3_sharded(local, n_layers, epr, mesh)


def shard_exp3(state, n_layers: int, n_edges: int, n_shards: int,
               rank: Optional[int] = None) -> torch.Tensor:
    """The port's canonical arm weights ``[L, E + EDGE_PAD]`` as the
    ranks' flat shards ``[S, L * epr + 1]`` (each rank's layer rows, then
    the dump slot), or one rank's ``[L * epr + 1]``; on ``state``'s
    device."""
    S, L = n_shards, n_layers
    w = torch.as_tensor(state).reshape(L, -1)
    epr = edges_per_shard(n_edges, S)
    k = min(w.shape[1], S * epr)
    ranks = range(S) if rank is None else (rank,)
    out = torch.zeros((len(ranks), L * epr + 1), dtype=w.dtype,
                      device=w.device)
    for i, s in enumerate(ranks):
        lo, hi = s * epr, min((s + 1) * epr, k)
        if hi > lo:
            out[i, :L * epr].view(L, epr)[:, :hi - lo] = w[:, lo:hi]
    return out if rank is None else out[0]


def init_exp3_shard(n_layers: int, n_edges: int, mesh,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """This rank's shard of fresh arm weights (``init_exp3_weights`` then
    :func:`shard_exp3`, without the canonical state): ones on its edges."""
    epr = edges_per_shard(n_edges, mesh.size)
    out = torch.zeros(n_layers * epr + 1, dtype=dtype, device=mesh.device)
    k = min(max(n_edges - mesh.rank * epr, 0), epr)
    out[:n_layers * epr].view(n_layers, epr)[:, :k] = 1.0
    return out


def unshard_exp3(stacked, n_layers: int, n_edges: int) -> torch.Tensor:
    """The ranks' shards ``[S, L * epr + 1]`` as the canonical ``[L, E +
    EDGE_PAD]`` state (zero past E), for a checkpoint or a comparison."""
    st = torch.as_tensor(stacked)
    S, L = st.shape[0], n_layers
    epr = (st.shape[1] - 1) // L
    rows = st[:, :L * epr].reshape(S, L, epr).permute(1, 0, 2).reshape(
        L, S * epr)
    out = torch.zeros((L, n_edges + EDGE_PAD), dtype=st.dtype,
                      device=st.device)
    k = min(n_edges, S * epr)
    out[:, :k] = rows[:, :k]
    return out
