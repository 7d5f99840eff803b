"""Layer-wise importance samplers of the LADIES family, the per-dst
neighbor samplers and the EXP3 update (counterpart of
``bliss_gnn_tpu/sampling/samplers.py``).

Kinds: ``ladies``, ``poisson-ladies``, ``bandit`` and ``poisson-bandit``;
``neighbor`` (k uniform in-edges per dst) and ``full`` (every in-edge).
Everything has static shapes (see ``CapacityPlan``) and stays on the
device with no host sync: the Poisson fixed point is ``ops/poisson.py``
(one kernel launch on the card). The random draws are isolated in
:func:`_bernoulli_select`, :func:`_gumbel_topk_select` and
:func:`_segment_rank`; each takes an injected draw (uniforms, or Gumbel
noise), so a test can feed this package and the reference the same coin
flips.

The EXP3 state is ``[L, n_edges + EDGE_PAD]`` bf16, zero past ``n_edges``;
:func:`apply_exp3_deltas` updates it in place through K4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD, DeviceGraph
from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
from bliss_gnn_tpu_torch.ops.gather import lut_gather, lut_gather_multi
from bliss_gnn_tpu_torch.ops.poisson import poisson_scale
from bliss_gnn_tpu_torch.ops.segment import masked_segment_sum, segment_count
from bliss_gnn_tpu_torch.parallel.shards import ShardedExp3
from bliss_gnn_tpu_torch.sampling.block import Block, CapacityPlan
from bliss_gnn_tpu_torch.sampling.frontier import (
    Candidates,
    Frontier,
    compact_by_mask,
    compact_candidates,
    dense_candidates,
    frontier_gather,
    frontier_seed_broadcast,
    frontier_segment_sum,
    gather_in_edges,
    ptr_take,
)
from bliss_gnn_tpu_torch.utils import spans

LADIES_FAMILY = ("ladies", "poisson-ladies", "bandit", "poisson-bandit")
ALL_KINDS = LADIES_FAMILY + ("neighbor", "full")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler configuration (the reference samplers' knobs)."""

    kind: str = "poisson-bandit"
    fanouts: Tuple[int, ...] = (512, 256, 128)
    importance_sampling: bool = True
    eta: float = 0.1
    replace: bool = False
    poisson_eps: float = 0.9999
    poisson_iters: int = 50
    exp3_delta: float = 0.01
    # the paper's per-dst learning rate (off: constant exp3_delta)
    exp3_delta_formula: bool = False
    exp3_T: int = 5000
    model: str = "sage"
    # ablation: sample with the bandit, never apply its update
    exp3_freeze: bool = False

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}; the kinds "
                             f"are {ALL_KINDS}")
        if self.replace:
            raise NotImplementedError("replacement sampling is not implemented")
        if self.model not in ("sage", "gcn", "gat"):
            raise ValueError(f"EXP3 rewards for unknown model {self.model!r}")

    @property
    def is_bandit(self) -> bool:
        return "bandit" in self.kind

    @property
    def is_poisson(self) -> bool:
        return "poisson" in self.kind

    @property
    def n_layers(self) -> int:
        return len(self.fanouts)


def init_exp3_weights(n_layers: int, n_edges: int, device="cuda",
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Arm weights [L, n_edges + EDGE_PAD]: ones on the edges, zeros on the
    padding (never sampled, never updated)."""
    dev = resolve_device(device)
    state = torch.zeros((n_layers, n_edges + EDGE_PAD), dtype=dtype,
                        device=dev)
    state[:, :n_edges] = 1.0
    return state


def exp3_row(exp3_weights, layer: int):
    """One layer's arm-weight row (a view); of a ``ShardedExp3``, the
    rank's slice of it as an ``EShard``."""
    if isinstance(exp3_weights, ShardedExp3):
        return exp3_weights.layer_row(layer)
    return exp3_weights[layer]


# ---------------------------------------------------------------------------
# per-layer probabilities
# ---------------------------------------------------------------------------


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _full_in_degree(graph: DeviceGraph, nodes: torch.Tensor) -> torch.Tensor:
    n = nodes.shape[0]
    bounds = ptr_take(graph.csc_indptr, torch.cat([nodes + 1, nodes]))
    return (bounds[:n] - bounds[n:]).to(torch.float32)


def _exp3_edge_prob(graph: DeviceGraph, exp3_row: torch.Tensor, eta: float,
                    frontier: Frontier, seeds: torch.Tensor,
                    n_seed_cap: int) -> torch.Tensor:
    """q_ij = (1-eta) * w_ij / sum_j w_ij + eta / n_i over the frontier,
    n_i the full-graph in-degree of the dst; f32."""
    raw = frontier_gather(frontier, exp3_row)
    ew = torch.where(frontier.e_mask, raw.to(torch.float32), 0.0)
    sum_dst = frontier_segment_sum(frontier, ew, n_seed_cap)
    w_hat = _safe_div(ew, frontier_seed_broadcast(frontier, sum_dst))
    safe_seeds = torch.where(seeds >= 0, seeds, 0)
    n_i = frontier_seed_broadcast(frontier, _full_in_degree(graph, safe_seeds))
    q = (1.0 - eta) * w_hat + eta / torch.clamp(n_i, min=1.0)
    return torch.where(frontier.e_mask, q, 0.0)


def _importance_node_prob(edge_prob: torch.Tensor, frontier: Frontier,
                          cand: Candidates, n_seed_cap: int,
                          normalize_per_dst: bool) -> torch.Tensor:
    """q_j = sqrt(sum_i (q_ij / sum_k q_ik)^2) over candidates j (the
    per-dst normalisation only for the bandit)."""
    c_cap = cand.gids.shape[0]
    if normalize_per_dst:
        s_i = frontier_segment_sum(
            frontier, torch.where(frontier.e_mask, edge_prob, 0.0),
            n_seed_cap)
        r = _safe_div(edge_prob, frontier_seed_broadcast(frontier, s_i))
    else:
        r = edge_prob
    prob = torch.sqrt(masked_segment_sum(
        r * r, cand.src_cpos, c_cap, frontier.e_mask,
        n_valid=frontier.n_valid_slots()))
    if cand.mask is None:  # dense mode: the scatter's support is the mask
        return prob
    return torch.where(cand.mask, prob, 0.0)


def _uniform_node_prob(frontier: Frontier, cand: Candidates) -> torch.Tensor:
    """importance_sampling off: 1 for frontier sources, 0 otherwise."""
    c_cap = cand.gids.shape[0]
    out_deg = segment_count(cand.src_cpos, c_cap, frontier.e_mask,
                            n_valid=frontier.n_valid_slots())
    member = out_deg > 0
    if cand.mask is not None:
        member &= cand.mask
    return torch.where(member, 1.0, 0.0)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def _gumbel_topk_select(generator: Optional[torch.Generator],
                        prob: torch.Tensor, cand_mask: torch.Tensor, k: int,
                        gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k candidates weighted by ``prob`` without replacement, as Gumbel
    top-k; returns a selection mask. ``gumbel`` injects the noise."""
    c_cap = prob.shape[0]
    if gumbel is None:
        u = torch.rand(c_cap, generator=generator, device=prob.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    logp = torch.where(cand_mask & (prob > 0),
                       torch.log(prob.to(torch.float32)), -torch.inf)
    keys = torch.where(torch.isfinite(logp),
                       logp + gumbel.to(prob.device, torch.float32), -torch.inf)
    vals, idx = torch.topk(keys, min(k, c_cap))
    sel = torch.zeros(c_cap, dtype=torch.bool, device=prob.device)
    sel[idx] = torch.isfinite(vals)
    return sel


def _bernoulli_select(generator: Optional[torch.Generator], p: torch.Tensor,
                      cand_mask: torch.Tensor,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Independent per-candidate coin flips; ``u`` injects the uniforms."""
    if u is None:
        u = torch.rand(p.shape, generator=generator, device=p.device)
    return cand_mask & (u.to(p.device, torch.float32) < p)


# ---------------------------------------------------------------------------
# block construction
# ---------------------------------------------------------------------------


def _build_block(frontier: Frontier, cand: Candidates, sel: torch.Tensor,
                 node_prob: torch.Tensor, edge_w: torch.Tensor,
                 seeds: torch.Tensor, seeds_mask: torch.Tensor,
                 extra_cap: int, e_blk_cap: int, debias: str,
                 alpha_w: Optional[torch.Tensor] = None,
                 ) -> Tuple[Block, Dict[str, torch.Tensor]]:
    """Assemble the padded block: src table (seeds first, then the selected
    non-seed candidates), the kept edges (those whose src is selected) and
    the debiased weights W / P[src], scaled per dst by d (``ladies``) or by
    d / sum(W / P) (``bandit``), d the kept in-degree."""
    dev = seeds.device
    n_seed_cap = seeds.shape[0]
    c_cap = cand.gids.shape[0]

    extra_mask = sel & ~cand.is_seed & cand.mask
    extra_idx, extra_slot_mask, n_extra = compact_by_mask(extra_mask,
                                                          extra_cap)
    src_gids = torch.cat([
        torch.where(seeds_mask, seeds, 0),
        torch.where(extra_slot_mask, cand.gids[extra_idx.long()], 0),
    ])
    src_mask = torch.cat([seeds_mask, extra_slot_mask])

    # candidate position -> block src slot
    pos_c = torch.full((c_cap + 1,), -1, dtype=torch.int32, device=dev)
    # a seed repeated in the batch is one candidate with several slots: the
    # last slot takes it, as a sequential scatter gives, on the card too
    # (an index write there leaves the winner to the run)
    pos_c.scatter_reduce_(
        0, torch.where(seeds_mask, cand.seed_cpos, c_cap).long(),
        torch.arange(n_seed_cap, dtype=torch.int32, device=dev), "amax")
    pos_c[torch.where(extra_slot_mask, extra_idx, c_cap).long()] = (
        n_seed_cap + torch.arange(extra_cap, dtype=torch.int32, device=dev))
    pos_c = pos_c[:c_cap]

    keep = frontier.e_mask & lut_gather(sel, cand.src_cpos,
                                        n_valid=frontier.n_valid_slots())
    eidx, e_mask_b, n_kept = compact_by_mask(keep, e_blk_cap)
    nk = torch.clamp(n_kept, max=e_blk_cap)

    if alpha_w is None:
        alpha_w = edge_w
    e_src_cpos, e_dst_r, eid_r, w_r, alpha_r = lut_gather_multi(
        (cand.src_cpos, frontier.dst_spos, frontier.eid, edge_w, alpha_w),
        eidx, n_valid=nk)
    e_dst = torch.where(e_mask_b, e_dst_r, 0)
    eid = torch.where(e_mask_b, eid_r, 0)
    w = torch.where(e_mask_b, w_r.to(torch.float32), 0.0)
    e_alpha = torch.where(e_mask_b, alpha_r.to(torch.float32), 0.0)

    e_src_r, p_src_edge = lut_gather_multi((pos_c, node_prob), e_src_cpos,
                                           n_valid=nk)
    p_src_edge = p_src_edge.to(torch.float32)
    e_src = torch.where(e_mask_b, e_src_r, 0)
    wt = _safe_div(w, p_src_edge)
    # kept edges keep the frontier's slot order, so e_dst is sorted on the
    # first nk slots: the sorted route of K1
    d = segment_count(e_dst, n_seed_cap, e_mask_b, dtype=torch.float32,
                      n_valid=nk, ids_sorted=True)
    if debias == "ladies":
        wt = wt * lut_gather(d, e_dst, n_valid=nk)
    elif debias == "bandit":
        wt_sum = masked_segment_sum(wt, e_dst, n_seed_cap, e_mask_b,
                                    n_valid=nk, ids_sorted=True)
        wt = wt * lut_gather(_safe_div(d, wt_sum), e_dst, n_valid=nk)
    wt = torch.where(e_mask_b, wt, 0.0)

    p_seed = node_prob[cand.seed_cpos.long()].to(torch.float32)
    p_extra = node_prob[extra_idx.long()].to(torch.float32)
    src_node_prob = torch.cat([
        torch.where(seeds_mask, p_seed, 0.0),
        torch.where(extra_slot_mask, p_extra, 0.0),
    ])
    block = Block(
        src_gids=src_gids.to(torch.int32), src_mask=src_mask,
        e_src=e_src.to(torch.int32), e_dst=e_dst.to(torch.int32),
        e_mask=e_mask_b, eid=eid.to(torch.int32), e_weight=wt,
        e_q=torch.where(e_mask_b, w, 0.0), src_node_prob=src_node_prob,
        e_alpha=e_alpha, n_dst_cap=n_seed_cap,
    )
    stats = {
        "n_extra": n_extra,
        "n_block_edges_true": keep.sum(dtype=torch.int32),
        "n_block_edges": n_kept,
        "block_edge_overflow": torch.clamp(n_kept - e_blk_cap, min=0),
        "extra_overflow": torch.clamp(n_extra - extra_cap, min=0),
    }
    return block, stats


# ---------------------------------------------------------------------------
# per-layer and multi-layer sampling
# ---------------------------------------------------------------------------


def _sample_layer_ladies(graph: DeviceGraph, cfg: SamplerConfig,
                         plan: CapacityPlan, layer: int,
                         exp3_weights: Optional[torch.Tensor],
                         generator: Optional[torch.Generator],
                         seeds: torch.Tensor, seeds_mask: torch.Tensor,
                         draw: Optional[torch.Tensor] = None,
                         ) -> Tuple[Block, Dict[str, torch.Tensor]]:
    num = cfg.fanouts[layer]
    n_seed_cap = plan.dst_caps[layer]
    frontier = gather_in_edges(graph.csc_indptr, graph.csc_src, seeds,
                               seeds_mask, plan.frontier_caps[layer])
    dense = (bool(plan.dense_cands[layer]) if plan.dense_cands else False
             ) and plan.cand_caps[layer] > graph.n_nodes
    make_cand = dense_candidates if dense else compact_candidates
    cand = make_cand(seeds, seeds_mask, frontier, plan.cand_caps[layer],
                     graph.n_nodes)

    # the static normalised weight per slot: the LADIES sampling weight,
    # and the bandit's EXP3 alpha (carried into the block as e_alpha)
    w_static = torch.where(
        frontier.e_mask,
        frontier_gather(frontier, graph.edata["w"]).to(torch.float32), 0.0)
    if cfg.is_bandit:
        edge_w = _exp3_edge_prob(graph, exp3_row(exp3_weights, layer),
                                 cfg.eta, frontier, seeds, n_seed_cap)
    else:
        edge_w = w_static
    if cfg.importance_sampling:
        prob = _importance_node_prob(edge_w, frontier, cand, n_seed_cap,
                                     normalize_per_dst=cfg.is_bandit)
    else:
        prob = _uniform_node_prob(frontier, cand)
    if cand.mask is None:  # dense mode: membership == positive probability
        mask = (prob > 0) | cand.is_seed
        cand = cand._replace(mask=mask, n=mask.sum(dtype=torch.int32))
        prob = torch.where(mask, prob, 0.0)

    if cfg.is_poisson:
        with spans.device_span("sample.fixed_point"):
            p, n_iters = poisson_scale(prob, cand, num, cfg.poisson_eps,
                                       cfg.poisson_iters)
        sel = _bernoulli_select(generator, p, cand.mask, u=draw)
        node_prob = p
    else:
        sel = _gumbel_topk_select(generator, prob, cand.mask, num,
                                  gumbel=draw)
        node_prob = prob

    block, bstats = _build_block(
        frontier, cand, sel, node_prob, edge_w, seeds, seeds_mask,
        extra_cap=plan.extra_caps[layer], e_blk_cap=plan.block_e_caps[layer],
        debias="bandit" if cfg.is_bandit else "ladies", alpha_w=w_static,
    )
    stats = {
        "frontier_edges": frontier.total_edges,
        "frontier_overflow": frontier.total_edges
        - frontier.e_mask.sum(dtype=torch.int32),
        "n_candidates": cand.n,
        "n_selected": sel.sum(dtype=torch.int32),
        **bstats,
    }
    if cfg.is_poisson:
        block = dataclasses.replace(block, fixed_point_iters=n_iters)
    return block, stats


def _segment_rank(dst_spos: torch.Tensor, e_mask: torch.Tensor,
                  generator: Optional[torch.Generator],
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A uniformly random rank of each edge within its dst's edges (int32
    max on masked slots), from two stable sorts: by uniform ``u`` (the
    injectable draw, masked slots last), then by dst. An edge's rank is its
    position less the first position of its dst, found by binary search:
    the reference's cummax scan took 79 of the 98 device ms of a 10/10/10
    neighbor SAGE step on an H100 (27M frontier slots at layer 0;
    ``chip_smoke.py``'s ``neighbor_path`` profile)."""
    e_cap = dst_spos.shape[0]
    dev = dst_spos.device
    if u is None:
        u = torch.rand(e_cap, generator=generator, device=dev)
    big = torch.iinfo(torch.int32).max
    order1 = torch.argsort(torch.where(e_mask, u.to(dev, torch.float32), 2.0),
                           stable=True)
    key, order2 = torch.sort(torch.where(e_mask, dst_spos, big)[order1],
                             stable=True)
    order = order1[order2]  # by (dst, u), masked slots last
    first = torch.searchsorted(key, key)
    rank = torch.empty(e_cap, dtype=torch.int32, device=dev)
    rank[order] = (torch.arange(e_cap, device=dev) - first).to(torch.int32)
    return torch.where(e_mask, rank, big)


def _sample_layer_neighbor(graph: DeviceGraph, cfg: SamplerConfig,
                           plan: CapacityPlan, layer: int,
                           generator: Optional[torch.Generator],
                           seeds: torch.Tensor, seeds_mask: torch.Tensor,
                           full: bool, draw: Optional[torch.Tensor] = None,
                           ) -> Tuple[Block, Dict[str, torch.Tensor]]:
    """``fanouts[layer]`` uniform in-edges per dst (DGL's NeighborSampler),
    or every in-edge (``full``, MultiLayerFullNeighborSampler): the kept
    frontier's srcs are the candidates, all of them selected, with unit
    weights and no debiasing. The kept slots keep the frontier's order, so
    the block's edges stay sorted by dst. ``draw`` injects the rank's
    uniforms."""
    frontier = gather_in_edges(graph.csc_indptr, graph.csc_src, seeds,
                               seeds_mask, plan.frontier_caps[layer])
    if full:
        keep = frontier.e_mask
    else:
        rank = _segment_rank(frontier.dst_spos, frontier.e_mask, generator,
                             u=draw)
        keep = frontier.e_mask & (rank < cfg.fanouts[layer])
    kept = frontier._replace(src_gid=torch.where(keep, frontier.src_gid, 0),
                             e_mask=keep)
    cand = compact_candidates(seeds, seeds_mask, kept, plan.cand_caps[layer],
                              graph.n_nodes)
    ones = torch.where(cand.mask, 1.0, 0.0)
    edge_w = torch.where(keep, 1.0, 0.0)
    block, bstats = _build_block(
        kept, cand, cand.mask, ones, edge_w, seeds, seeds_mask,
        extra_cap=plan.extra_caps[layer], e_blk_cap=plan.block_e_caps[layer],
        debias="none")
    stats = {
        "frontier_edges": frontier.total_edges,
        "frontier_overflow": frontier.total_edges
        - frontier.e_mask.sum(dtype=torch.int32),
        "n_candidates": cand.n,
        "n_selected": cand.n,
        **bstats,
    }
    return block, stats


def sample_blocks(graph: DeviceGraph, cfg: SamplerConfig, plan: CapacityPlan,
                  generator: Optional[torch.Generator], seeds: torch.Tensor,
                  seeds_mask: torch.Tensor,
                  exp3_weights: Optional[torch.Tensor] = None,
                  draws: Optional[Sequence[torch.Tensor]] = None,
                  ) -> Tuple[List[Block], Dict[str, torch.Tensor]]:
    """Sample one block per layer, output layer first, growing the seed set
    with each block's src table. ``blocks[0]`` is the input-most layer.

    ``draws``: optional per-block injected draws (``draws[l]`` feeds block
    l: uniforms for the Poisson kinds and ``neighbor``'s rank, Gumbel noise
    for the top-k kinds; ``full`` draws nothing); without them the draws
    come from ``generator``."""
    L = cfg.n_layers
    if seeds.shape[0] != plan.dst_caps[L - 1]:
        raise ValueError(f"seed capacity {seeds.shape[0]} != plan "
                         f"{plan.dst_caps[L - 1]}")
    blocks: List[Optional[Block]] = [None] * L
    stats: Dict[str, torch.Tensor] = {}
    for block_id in reversed(range(L)):
        draw = None if draws is None else draws[block_id]
        if cfg.kind in LADIES_FAMILY:
            block, lstats = _sample_layer_ladies(
                graph, cfg, plan, block_id, exp3_weights, generator, seeds,
                seeds_mask, draw=draw)
        else:
            block, lstats = _sample_layer_neighbor(
                graph, cfg, plan, block_id, generator, seeds, seeds_mask,
                full=cfg.kind == "full", draw=draw)
        seeds, seeds_mask = block.src_gids, block.src_mask
        blocks[block_id] = block
        for k, v in lstats.items():
            stats[f"layer{block_id}/{k}"] = v
    return blocks, stats


# ---------------------------------------------------------------------------
# EXP3 reward and arm-weight update
# ---------------------------------------------------------------------------


def _calculate_alpha(graph: DeviceGraph, cfg: SamplerConfig, block: Block,
                     a_ij: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sage/gcn: alpha is the static normalised weight w_e of each kept
    edge (the block's ``e_alpha``). gat: alpha = nan_to_num(a_ij / sum_dst
    a_ij) * sum_dst q_ij, with a_ij the head-mean pre-softmax logit."""
    if cfg.model == "gat":
        if a_ij is None:
            raise ValueError("the GAT reward needs the per-edge logits a_ij")
        n = block.n_dst_cap
        nv = block.n_valid_edges()
        q_sum = masked_segment_sum(block.e_q, block.e_dst, n, block.e_mask,
                                   n_valid=nv, ids_sorted=True)
        a = a_ij.to(torch.float32)
        a_sum = masked_segment_sum(a, block.e_dst, n, block.e_mask,
                                   n_valid=nv, ids_sorted=True)
        a_dst, q_dst = lut_gather_multi((a_sum, q_sum), block.e_dst)
        ratio = torch.nan_to_num(a / a_dst)
        alpha = ratio * q_dst
    elif block.e_alpha is not None:
        alpha = block.e_alpha
    else:
        alpha = graph.edata["w"][block.eid.long()].to(torch.float32)
    return torch.where(block.e_mask, alpha, 0.0)


# a dst's head-mean logits cancel when |sum a_ij| is under this share of
# sum |a_ij|: a bf16 logit's rounding (2^-8 of it) can then flip the sign
# of the sum, and so of every alpha of the dst
ALPHA_CANCEL_SHARE = 2.0 ** -8


def gat_alpha_cancel(block: Block, a_ij: torch.Tensor) -> torch.Tensor:
    """The kept edges of ``block`` whose dst's GAT logits cancel
    (``ALPHA_CANCEL_SHARE``): an int32 count, on the device, no sync."""
    n = block.n_dst_cap
    nv = block.n_valid_edges()
    a = a_ij.to(torch.float32)
    a_sum, abs_sum = (masked_segment_sum(x, block.e_dst, n, block.e_mask,
                                         n_valid=nv, ids_sorted=True)
                      for x in (a, a.abs()))
    cancel = a_sum.abs() < ALPHA_CANCEL_SHARE * abs_sum
    on_edge = lut_gather(cancel, torch.clamp(block.e_dst, 0, n - 1),
                         n_valid=nv)
    return (on_edge & block.e_mask).sum(dtype=torch.int32)


def _rewards_and_delta(graph: DeviceGraph, cfg: SamplerConfig, block: Block,
                       alpha: torch.Tensor,
                       embed_norm: torch.Tensor) -> torch.Tensor:
    """r_ij = alpha^2 / k_i * ||h_j||^2 / q_ij^2 and the clipped exponent
    dr_e = min(delta * (r_e / P_src) / n_i, 1); 0 on masked edges."""
    k_i = block.in_degrees(dtype=torch.float32)
    safe_dst = torch.where(block.dst_mask, block.dst_gids, 0)
    n_i_seed = _full_in_degree(graph, safe_dst)
    if cfg.exp3_delta_formula:
        k_seed = torch.clamp(k_i, min=1.0)
        n_seed = torch.clamp(n_i_seed, min=1.0)
        nom = ((1.0 - cfg.eta) * cfg.eta ** 4 * k_seed ** 5
               * torch.log(torch.clamp(n_seed / k_seed, min=1.0)))
        delta_seed = torch.sqrt(nom / (cfg.exp3_T * n_seed ** 4))
    else:
        delta_seed = torch.full_like(n_i_seed, cfg.exp3_delta)
    inv_k = _safe_div(torch.ones_like(k_i), k_i)
    dst_fac_seed = inv_k * delta_seed / torch.clamp(n_i_seed, min=1.0)
    e_dst_c = torch.clamp(block.e_dst, 0, block.n_dst_cap - 1)
    dst_fac = lut_gather(dst_fac_seed, e_dst_c)
    h, p_src = lut_gather_multi(
        (embed_norm.to(torch.float32), block.src_node_prob), block.e_src)
    q = block.e_q
    h_div_q = (h * h) / torch.where(q > 0, q * q, 1.0)
    r_over_p = (torch.nan_to_num(alpha * alpha, posinf=0.0) * h_div_q
                / torch.where(p_src > 0, p_src, 1.0))
    dr = torch.clamp(r_over_p * dst_fac, max=1.0)
    return torch.where(block.e_mask, dr, 0.0)


def exp3_edge_deltas(graph: DeviceGraph, cfg: SamplerConfig,
                     blocks: Sequence[Block],
                     embed_norms: Sequence[torch.Tensor],
                     a_ijs: Optional[Sequence[torch.Tensor]] = None,
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer: (canonical eids [e_cap], exponents dr [e_cap]).
    ``a_ijs``: the GAT model's per-layer edge logits (None otherwise)."""
    out = []
    for l, (block, norm) in enumerate(zip(blocks, embed_norms)):
        alpha = _calculate_alpha(graph, cfg, block,
                                 None if a_ijs is None else a_ijs[l])
        out.append((block.eid, _rewards_and_delta(graph, cfg, block, alpha,
                                                  norm)))
    return out


def exp3_delta_slots(deltas: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     span: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K4's arguments for per-layer (eid, exponent) lists on a flat [L *
    span] state: (flat indices int32, factors exp(dr) f32, limit L * span).
    A zero exponent is a no-op slot (index = limit)."""
    limit = len(deltas) * span
    flat_idx = torch.cat([
        torch.where(dr.reshape(-1) != 0,
                    eid.reshape(-1).to(torch.int32) + l * span, limit)
        for l, (eid, dr) in enumerate(deltas)
    ]).to(torch.int32)
    mult = torch.cat([torch.exp(dr).reshape(-1).to(torch.float32)
                      for _, dr in deltas])
    return flat_idx, mult, limit


def apply_exp3_deltas(exp3_weights: torch.Tensor,
                      deltas: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      normalize: bool = True,
                      max_repeats: int = 1) -> torch.Tensor:
    """w[eid] *= exp(dr) IN PLACE (K4), then optionally L1-normalise each
    layer row. Zero exponents are no-op slots (index = limit).
    ``max_repeats`` S > 1 for S DP ranks' deltas gathered (an edge at most
    once a rank): K4's repeats route, the same bits on every replica.
    Returns the state."""
    flat_idx, mult, limit = exp3_delta_slots(deltas, exp3_weights.shape[1])
    exp3_apply(exp3_weights.view(-1), flat_idx, mult, limit,
               max_repeats=max_repeats)
    if normalize:
        normalize_exp3_weights(exp3_weights)
    return exp3_weights


def normalize_exp3_weights(exp3_weights: torch.Tensor) -> torch.Tensor:
    """L1-normalise every layer row, in place."""
    norm = exp3_weights.sum(dim=1, keepdim=True, dtype=torch.float32)
    inv = (1.0 / torch.clamp(norm, min=1e-12)).to(exp3_weights.dtype)
    return exp3_weights.mul_(inv)


def exp3_update(graph: DeviceGraph, cfg: SamplerConfig,
                exp3_weights: torch.Tensor, blocks: Sequence[Block],
                embed_norms: Sequence[torch.Tensor],
                a_ijs: Optional[Sequence[torch.Tensor]] = None,
                normalize: bool = True) -> torch.Tensor:
    """Rewards, exponents and the in-place arm-weight update, per block."""
    deltas = exp3_edge_deltas(graph, cfg, blocks, embed_norms, a_ijs)
    return apply_exp3_deltas(exp3_weights, deltas, normalize=normalize)
