"""Capacity-padded message-flow blocks, static capacity planning
(counterpart of ``bliss_gnn_tpu/sampling/block.py``) and the policy that
refits and widens a plan from the steps' statistics.

A Block is a bipartite graph of static sizes: a src-node table whose first
``n_dst_cap`` slots are the dst (seed) nodes, and a padded edge list with
masks. It carries the side data the bandit needs: ``e_weight`` (the
debiased weight), ``e_q`` (edge sampling probability), ``src_node_prob``,
the canonical ``eid`` and ``e_alpha`` (the static normalised weight).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Block:
    src_gids: torch.Tensor  # [n_src_cap] int32 global node ids
    src_mask: torch.Tensor  # [n_src_cap] bool
    e_src: torch.Tensor  # [e_cap] int32 position in the src table
    e_dst: torch.Tensor  # [e_cap] int32 position in [0, n_dst_cap)
    e_mask: torch.Tensor  # [e_cap] bool
    eid: torch.Tensor  # [e_cap] int32 canonical edge ids
    e_weight: torch.Tensor  # [e_cap] f32 debiased aggregation weight
    e_q: torch.Tensor  # [e_cap] f32 edge sampling probability
    src_node_prob: torch.Tensor  # [n_src_cap] f32 node probability
    e_alpha: Optional[torch.Tensor] = None  # [e_cap] f32 static weight w_e
    n_dst_cap: int = 0
    # 0-dim int32, the Poisson kinds only: the iteration at which the
    # layer's fixed point hit eps (poisson_iters if never)
    fixed_point_iters: Optional[torch.Tensor] = None

    @property
    def n_src_cap(self) -> int:
        return self.src_gids.shape[0]

    @property
    def e_cap(self) -> int:
        return self.e_src.shape[0]

    @property
    def dst_gids(self) -> torch.Tensor:
        return self.src_gids[: self.n_dst_cap]

    @property
    def dst_mask(self) -> torch.Tensor:
        return self.src_mask[: self.n_dst_cap]

    def num_src(self) -> torch.Tensor:
        return self.src_mask.sum(dtype=torch.int32)

    def num_dst(self) -> torch.Tensor:
        return self.dst_mask.sum(dtype=torch.int32)

    def num_edges(self) -> torch.Tensor:
        return self.e_mask.sum(dtype=torch.int32)

    def n_valid_edges(self) -> torch.Tensor:
        """0-dim int32: last set e_mask position + 1, the contiguous-prefix
        bound the kernels use to skip the padded tail."""
        iota = torch.arange(1, self.e_cap + 1, dtype=torch.int32,
                            device=self.e_mask.device)
        return torch.where(self.e_mask, iota, 0).max()

    def in_degrees(self, dtype=torch.int32) -> torch.Tensor:
        """Kept-edge in-degree per dst slot (K1 through segment_count, by
        its sorted route: a block's edges are sorted by dst)."""
        from bliss_gnn_tpu_torch.ops.segment import segment_count

        return segment_count(self.e_dst, self.n_dst_cap, self.e_mask,
                             dtype=dtype, n_valid=self.n_valid_edges(),
                             ids_sorted=True)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Static per-layer capacities of one sampling configuration.

    Index 0 is the input-most layer; sampling walks the layers in reverse.
    For block l: ``dst_caps[l]`` seed-table capacity, ``extra_caps[l]``
    non-seed src capacity, ``frontier_caps[l]`` padded in-subgraph edge
    capacity, ``cand_caps[l]`` candidate capacity, ``block_e_caps[l]``
    kept-edge capacity, ``dense_cands[l]`` whether candidate positions are
    global node ids. Overflow truncates and is counted in the stats.
    """

    batch_size: int
    fanouts: Tuple[int, ...]
    dst_caps: Tuple[int, ...]
    extra_caps: Tuple[int, ...]
    frontier_caps: Tuple[int, ...]
    cand_caps: Tuple[int, ...]
    block_e_caps: Tuple[int, ...]
    dense_cands: Tuple[bool, ...] = ()

    @staticmethod
    def build(
        batch_size: int,
        fanouts: Sequence[int],
        n_nodes: int,
        n_edges: int,
        kind: str = "ladies",
        avg_degree: float | None = None,
        frontier_slack: float = 8.0,
        block_edge_slack: float = 4.0,
        max_frontier_edges: int | None = None,
        align: int = 128,
        deg_std: float | None = None,
        max_degree: int | None = None,
        dense_candidates: bool | None = None,
    ) -> "CapacityPlan":
        """A-priori capacities from degree statistics. With ``deg_std`` and
        ``max_degree`` the frontier cap is the concentration bound
        1.5*c*avg_degree + frontier_slack*sqrt(c)*deg_std + max_degree;
        otherwise c*avg_degree*frontier_slack."""
        fanouts = tuple(int(f) for f in fanouts)
        L = len(fanouts)
        if avg_degree is None:
            avg_degree = max(1.0, n_edges / max(1, n_nodes))
        layerwise = kind not in ("neighbor", "full")
        dst_caps, extra_caps = [0] * L, [0] * L
        frontier_caps, cand_caps = [0] * L, [0] * L
        block_e_caps, dense_cands = [0] * L, [False] * L
        cap = batch_size
        for l in reversed(range(L)):
            dst_caps[l] = cap
            if deg_std is not None and max_degree is not None:
                fcap = int(1.5 * cap * avg_degree
                           + frontier_slack * (cap ** 0.5) * max(deg_std, 1.0)
                           + max_degree)
            else:
                fcap = int(cap * avg_degree * frontier_slack)
            fcap = min(fcap, n_edges + 8 * cap)
            if max_frontier_edges is not None:
                fcap = min(fcap, max_frontier_edges)
            fcap = _round_up(max(fcap, cap * 8), align)
            frontier_caps[l] = fcap
            if layerwise:
                extra = fanouts[l]
                if "poisson" in kind:
                    extra += _round_up(int(4 * fanouts[l] ** 0.5), align)
                becap = int(min(fcap, max(
                    (cap + extra) * block_edge_slack
                    * max(1.0, avg_degree) ** 0.5,
                    4 * (cap + extra),
                )))
            elif kind == "neighbor":
                extra = min(cap * fanouts[l], n_nodes)
                becap = cap * fanouts[l]
            else:  # full
                extra = min(fcap, n_nodes)
                becap = fcap
            extra_caps[l] = extra
            block_e_caps[l] = min(_round_up(max(becap, cap), align), fcap)
            cand_caps[l] = _round_up(min(n_nodes + 1, cap + fcap + 1), align)
            dense = layerwise and (n_nodes + 1 <= cap + fcap + 1)
            if dense_candidates is not None:
                dense = layerwise and dense_candidates
                if dense:
                    cand_caps[l] = _round_up(n_nodes + 1, align)
            dense_cands[l] = dense
            cap = cap + extra
        return CapacityPlan(
            batch_size=batch_size, fanouts=fanouts,
            dst_caps=tuple(dst_caps), extra_caps=tuple(extra_caps),
            frontier_caps=tuple(frontier_caps), cand_caps=tuple(cand_caps),
            block_e_caps=tuple(block_e_caps), dense_cands=tuple(dense_cands),
        )

    def src_cap(self, l: int) -> int:
        return self.dst_caps[l] + self.extra_caps[l]

    def refit(
        self,
        frontier_edges: Sequence[int],
        block_edges: Sequence[int],
        block_edge_slack: float = 1.6,
        frontier_slack: float = 1.25,
        max_degree: int = 0,
        align: int = 128,
    ) -> "CapacityPlan":
        """Tighten the frontier and block-edge caps from measured per-layer
        maxima (the ``frontier_edges`` / ``n_block_edges_true`` stats of
        pilot steps). Never grows a cap; keeps the table shapes."""
        fr, be = list(self.frontier_caps), list(self.block_e_caps)
        for l in range(len(self.fanouts)):
            src_cap = self.dst_caps[l] + self.extra_caps[l]
            fcap = int(frontier_edges[l] * frontier_slack) + max_degree
            fcap = max(fcap, 8 * self.dst_caps[l])
            fr[l] = min(fr[l], _round_up(fcap, align))
            bcap = max(int(block_edges[l] * block_edge_slack), 2 * src_cap)
            be[l] = min(be[l], _round_up(bcap, align), fr[l])
        return dataclasses.replace(self, frontier_caps=tuple(fr),
                                   block_e_caps=tuple(be))

    def widen(self, factor: float = 1.5, align: int = 128,
              frontier: bool = False, blocks: bool = True
              ) -> "CapacityPlan":
        """Grow the block-edge caps (``blocks``, as the JAX package always
        does) and the frontier caps (``frontier``) by ``factor`` after
        post-refit overflow."""
        fr = (tuple(_round_up(int(c * factor), align)
                    for c in self.frontier_caps)
              if frontier else self.frontier_caps)
        be = (tuple(min(_round_up(int(c * factor), align), f)
                    for c, f in zip(self.block_e_caps, fr))
              if blocks else self.block_e_caps)
        return dataclasses.replace(self, frontier_caps=fr, block_e_caps=be)


# The per-layer statistics of ``sample_blocks`` (``layer{l}/<stat>``) the
# policy reads: the sizes the refit takes its maxima of, and the overflow
# counters with the kind of cap each widens (an extra-src overflow none:
# the src tables keep their shapes).
REFIT_MAXIMA = ("frontier_edges", "n_block_edges_true")
OVERFLOWS = {"frontier_overflow": "frontier",
             "block_edge_overflow": "blocks", "extra_overflow": None}
WIDEN_FACTOR = 1.5


@functools.lru_cache(maxsize=None)
def _stat(name: str) -> str:
    """``frontier_edges`` of ``layer0/frontier_edges``; cached, as a step's
    metric names repeat every step of the trainer's host loop."""
    return name.rpartition("/")[2]


def is_refit_size(name: str) -> bool:
    """Whether a step metric is a size the refit takes the maximum of."""
    return _stat(name) in REFIT_MAXIMA


def is_overflow(name: str) -> bool:
    """Whether a step metric is one of the sampler's overflow counters."""
    return _stat(name) in OVERFLOWS


def overflowed_kinds(metrics: Mapping[str, object]) -> Set[str]:
    """The kinds of cap a widen grows (``"frontier"``, ``"blocks"``) whose
    overflow counters in one step's metrics are above 0."""
    return {OVERFLOWS[_stat(k)] for k, v in metrics.items()
            if OVERFLOWS.get(_stat(k)) and float(v) > 0}


class CapacityPolicy:
    """When a sampled step's static buffers change size. Pilot steps run at
    the a-priori caps; at step ``refit_after`` (0: never, and no widen
    either) the plan is refit to the maxima of every observed step times
    the refit slacks, unless a layer's maximum is 0; after the refit, an
    overflow grows only the kind of cap that overflowed (frontier or block
    edges) by ``WIDEN_FACTOR``: an output seed's in-edges overflow the
    frontier while the kept edges stay in their caps, and every block-edge
    slot is padded work a step. Host floats only: :meth:`observe` each
    step's metrics, then :meth:`decide` once the steps launched together
    are observed."""

    def __init__(self, refit_after: int = 3, frontier_slack: float = 1.25,
                 block_edge_slack: float = 1.6, max_degree: int = 0):
        self.refit_after = refit_after
        self.frontier_slack = frontier_slack
        self.block_edge_slack = block_edge_slack
        self.max_degree = max_degree
        self.refit_done = False
        self._max: Dict[str, float] = {}
        self._grow: Set[str] = set()

    @property
    def piloting(self) -> bool:
        """Whether the refit is still to come."""
        return self.refit_after > 0 and not self.refit_done

    def observe(self, metrics: Mapping[str, object]) -> None:
        """One step's host metrics: the refit's maxima, and after the refit
        the kinds of cap that overflowed."""
        for k, v in metrics.items():
            stat = _stat(k)
            if stat in REFIT_MAXIMA:
                self._max[k] = max(self._max.get(k, 0.0), float(v))
            elif self.refit_done and OVERFLOWS.get(stat) and float(v) > 0:
                self._grow.add(OVERFLOWS[stat])

    def maxima(self, n_layers: int) -> Tuple[List[int], List[int]]:
        """Per layer, the largest frontier and kept-edge counts seen."""
        return tuple([int(self._max.get(f"layer{l}/{stat}", 0))
                      for l in range(n_layers)] for stat in REFIT_MAXIMA)

    def decide(self, plan: CapacityPlan, step: int
               ) -> Optional[Tuple[str, CapacityPlan]]:
        """After ``step`` steps on ``plan``: ``("refit", plan)``,
        ``("widen", plan)`` or None."""
        if self.refit_after <= 0:
            return None
        if not self.refit_done:
            if step < self.refit_after:
                return None
            self.refit_done = True
            fr, be = self.maxima(len(plan.fanouts))
            if min(fr) <= 0 or min(be) <= 0:
                return None
            new = plan.refit(fr, be, block_edge_slack=self.block_edge_slack,
                             frontier_slack=self.frontier_slack,
                             max_degree=self.max_degree)
            return None if new == plan else ("refit", new)
        if not self._grow:
            return None
        new = plan.widen(WIDEN_FACTOR, frontier="frontier" in self._grow,
                         blocks="blocks" in self._grow)
        self._grow = set()
        return "widen", new
