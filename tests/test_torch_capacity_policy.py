"""The capacity policy (``sampling/block.py`` ``CapacityPolicy``): the rule
that sizes a sampled step's static buffers, driven with recorded step
dicts on host floats, through ``harness_torch.pilot_plan`` on a small CPU
graph, and inside the trainer.

- the refit fires at ``refit_after`` on the maxima of every observed step
  and equals ``CapacityPlan.refit`` on them; it is skipped when a layer's
  maximum is 0;
- after the refit a widen grows exactly the kinds that overflowed
  (frontier, block edges or both) by 1.5x; an extra-src overflow or an
  overflow before the refit grows nothing; the steps of one chain widen
  once;
- ``pilot_plan`` with one kind of cap cut to half its pilot maxima grows
  that kind alone;
- the trainer's rebuild for a new batch size starts a new pilot.
"""
import dataclasses

import numpy as np
import pytest
import torch

import harness_torch
from bliss_gnn_tpu_torch.sampling.block import CapacityPlan, CapacityPolicy

torch.set_num_threads(1)

FANOUTS = (32, 16)
MAX_DEGREE = 40


def _plan():
    return CapacityPlan.build(32, FANOUTS, 4000, 60000, kind="poisson-bandit",
                              deg_std=8.0, max_degree=MAX_DEGREE)


def _step(sizes, **overflows):
    """One step's host metrics: per layer (frontier edges, true block
    edges), the overflow counters (0 but for ``overflows``, e.g.
    ``layer1/frontier_overflow=5`` as ``layer1_frontier_overflow=5``), and
    the other metrics a step reports, which the policy must not read."""
    m = {"train_loss": 1.5, "f1": object(), "exp3_apply_overflow": 0}
    for l, (fr, be) in enumerate(sizes):
        m.update({f"layer{l}/frontier_edges": float(fr),
                  f"layer{l}/n_block_edges_true": float(be),
                  f"layer{l}/n_block_edges": float(be) + 7,
                  f"num_edges/{l}": float(be)})
        for k in ("frontier_overflow", "block_edge_overflow",
                  "extra_overflow"):
            m[f"layer{l}/{k}"] = float(overflows.get(f"layer{l}_{k}", 0))
    return m


PILOT = [[(900, 400), (300, 150)], [(1100, 350), (250, 170)],
         [(1000, 380), (280, 160)]]


def _half(maxima):
    """Caps of half the measured maxima (below the plans' alignment: the
    CPU's plain versions take any size)."""
    return tuple(max(1, m // 2) for m in maxima)


def _policy():
    return CapacityPolicy(3, frontier_slack=1.25, block_edge_slack=1.6,
                          max_degree=MAX_DEGREE)


def _refit(policy, plan):
    """The pilot through the policy: its refit plan."""
    for i, sizes in enumerate(PILOT):
        policy.observe(_step(sizes))
        change = policy.decide(plan, i + 1)
    why, tight = change
    assert why == "refit"
    return tight


def test_the_refit_fires_at_refit_after_on_every_steps_maxima():
    plan, policy = _plan(), _policy()
    for i, sizes in enumerate(PILOT[:2]):
        policy.observe(_step(sizes))
        assert policy.decide(plan, i + 1) is None
        assert policy.piloting
    policy.observe(_step(PILOT[2]))
    why, tight = policy.decide(plan, 3)
    assert why == "refit" and not policy.piloting
    assert policy.maxima(2) == ([1100, 300], [400, 170])
    assert tight == plan.refit([1100, 300], [400, 170],
                               block_edge_slack=1.6, frontier_slack=1.25,
                               max_degree=MAX_DEGREE)
    assert tight != plan
    policy.observe(_step(PILOT[0]))
    assert policy.decide(tight, 4) is None


def test_no_refit_when_a_layers_maximum_is_zero():
    plan, policy = _plan(), _policy()
    for i in range(3):
        policy.observe(_step([(900, 400), (0, 0)]))
        assert policy.decide(plan, i + 1) is None
    assert policy.refit_done and not policy.piloting
    # the refit is spent: a later overflow widens the a-priori plan
    policy.observe(_step([(900, 400), (0, 0)], layer0_frontier_overflow=3))
    why, wide = policy.decide(plan, 4)
    assert why == "widen" and wide == plan.widen(1.5, frontier=True,
                                                 blocks=False)


@pytest.mark.parametrize("case,frontier,blocks", [
    ("frontier", True, False),
    ("blocks", False, True),
    ("both", True, True),
    ("extra", False, False),
    ("before_refit", False, False),
])
def test_a_widen_grows_exactly_the_kinds_that_overflowed(case, frontier,
                                                         blocks):
    plan, policy = _plan(), _policy()
    if case == "before_refit":
        policy.observe(_step(PILOT[0], layer1_frontier_overflow=50,
                             layer0_block_edge_overflow=9))
        assert policy.decide(plan, 1) is None
        for i, sizes in enumerate(PILOT[1:]):
            policy.observe(_step(sizes))
            change = policy.decide(plan, i + 2)
        tight = change[1]
        policy.observe(_step(PILOT[0]))
    else:
        tight = _refit(policy, plan)
        over = {"frontier": dict(layer1_frontier_overflow=5),
                "blocks": dict(layer0_block_edge_overflow=3),
                "both": dict(layer1_frontier_overflow=5,
                             layer0_block_edge_overflow=3),
                "extra": dict(layer1_extra_overflow=7)}[case]
        policy.observe(_step(PILOT[0], **over))
    change = policy.decide(tight, 4)
    if not (frontier or blocks):
        assert change is None
        return
    why, wide = change
    assert why == "widen"
    assert wide == tight.widen(1.5, frontier=frontier, blocks=blocks)
    assert (wide.frontier_caps != tight.frontier_caps) == frontier
    assert (wide.block_e_caps != tight.block_e_caps) == blocks
    assert policy.decide(wide, 5) is None  # one widen per overflow seen


def test_the_steps_of_one_chain_widen_once():
    """The trainer observes every step of a chain, then asks once: three
    overflowing steps make one widen of the kinds they overflowed."""
    plan, policy = _plan(), _policy()
    tight = _refit(policy, plan)
    policy.observe(_step(PILOT[0], layer1_frontier_overflow=5))
    policy.observe(_step(PILOT[1]))
    policy.observe(_step(PILOT[2], layer0_block_edge_overflow=2))
    why, wide = policy.decide(tight, 6)
    assert why == "widen"
    assert wide == tight.widen(1.5, frontier=True, blocks=True)
    assert policy.decide(wide, 6) is None


@pytest.mark.parametrize("kind", ["frontier", "blocks"])
def test_pilot_plan_grows_only_the_kind_that_overflowed(monkeypatch, kind):
    """``harness_torch.pilot_plan`` on a CPU graph, its refit cutting one
    kind of cap to half the pilot's maxima (the other kind keeps its
    a-priori caps): the counted run overflows that kind, and its widens
    grow it alone."""
    cfg = dict(n_feats=16, hidden=16, n_classes=4, gat_heads=(2, 1),
               batch=16, pilot_steps=3)
    dev = torch.device("cpu")
    indptr, csc_src = harness_torch.reddit_shaped_csc(2000, 30000)
    graph = harness_torch.graph_from_csc(dev, indptr, csc_src,
                                         cfg["n_feats"], cfg["n_classes"])
    from bliss_gnn_tpu_torch.sampling.samplers import SamplerConfig

    scfg = SamplerConfig(kind="poisson-bandit", fanouts=FANOUTS)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, graph.n_nodes, cfg["batch"]).astype(np.int32))
    smask = torch.ones(cfg["batch"], dtype=torch.bool)

    def tight_refit(self, frontier_edges, block_edges, **kw):
        if kind == "frontier":
            return dataclasses.replace(self,
                                       frontier_caps=_half(frontier_edges))
        return dataclasses.replace(self, block_e_caps=_half(block_edges))

    monkeypatch.setattr(CapacityPlan, "refit", tight_refit)
    final, info = harness_torch.pilot_plan(graph, scfg, cfg, indptr, seeds,
                                           smask)
    assert info["widened"] >= 1
    prior = CapacityPlan.build(
        cfg["batch"], FANOUTS, graph.n_nodes, graph.n_edges,
        kind=scfg.kind, deg_std=float(np.diff(indptr).std()),
        max_degree=int(np.diff(indptr).max()))
    if kind == "frontier":
        assert final.block_e_caps == prior.block_e_caps
        assert all(a > b for a, b in zip(
            final.frontier_caps, _half(info["pilot_frontier_edges"])))
    else:
        assert final.frontier_caps == prior.frontier_caps
        assert any(a > b for a, b in zip(
            final.block_e_caps, _half(info["pilot_block_edges"])))


def test_a_rebuild_for_a_new_batch_size_starts_a_new_pilot(tmp_path):
    from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
    from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    g, nc, ml = synthetic_graph(400, 3000, 16, 4, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    tr = Trainer(TrainConfig(dataset="synth", fan_out=(32, 16), batch_size=32,
                             num_hidden=16, num_layers=2, num_steps=3,
                             refit_after=2, logdir=str(tmp_path),
                             disable_checkpoint=True),
                 graph=g, n_classes=nc, multilabel=ml, device="cpu")
    assert tr._eager_steps()
    tr.fit()
    assert tr.capacity.refit_done and not tr._eager_steps()
    tr._build_for_batch_size(16, init_state=False)
    assert tr.capacity.piloting and tr._eager_steps()
    assert tr.capacity.maxima(2) == ([0, 0], [0, 0])
