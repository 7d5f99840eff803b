"""GATv2 training under the poisson-bandit sampler against the benchmark's
plain reference (``benchmark/reference/gatv2_train.py``) on the CPU at a
toy size, with the model's seeded random weights: three eager steps of the
port followed by the reference on the port's own draws (the blocks' src
tables, each dropout's keep mask); the GAT reward's alpha on a block built
to cancel, against ``_calculate_alpha``, and the count of such edges; the
marks ``gat.attend`` and ``model.backward`` and the counter
``bandit.alpha_cancel/<l>`` recorded in a trainer's steps; and the
configuration's dropout and residual equal to ``TrainConfig``'s
defaults, which the benchmark's trainer takes."""
import contextlib
import importlib.util
import json
import os
import sys
import types

import pytest
import torch

from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata
from bliss_gnn_tpu_torch.models import layers as layers_mod
from bliss_gnn_tpu_torch.sampling import samplers as samplers_mod
from bliss_gnn_tpu_torch.sampling.block import Block
from bliss_gnn_tpu_torch.sampling.samplers import (
    ALPHA_CANCEL_SHARE,
    SamplerConfig,
    _calculate_alpha,
    gat_alpha_cancel,
)
from bliss_gnn_tpu_torch.train import steps as steps_mod
from bliss_gnn_tpu_torch.train.steps import _pack
from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer
from bliss_gnn_tpu_torch.utils import spans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "benchmark", "reference")
CONFIG = os.path.join(ROOT, "benchmark", "configs", "gatv2-bandit-reddit.json")
FANOUTS, HIDDEN, HEADS, BATCH = (48, 24, 12), 8, (2, 2, 1), 16
STEPS = 3


def _reference():
    """The reference module, loaded by path with its directory on the path
    (it imports ``precision`` and ``sage_train`` beside it)."""
    if REF_DIR not in sys.path:
        sys.path.insert(0, REF_DIR)
    spec = importlib.util.spec_from_file_location(
        "gatv2_train_reference", os.path.join(REF_DIR, "gatv2_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _trainer(tmp_path, precision, **kw):
    g, nc, ml = synthetic_graph(400, 6000, 12, 4, seed=5)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    dt = "float32" if precision == "f32" else "bfloat16"
    cfg = TrainConfig(dataset="synth", model="gat", sampler="poisson-bandit",
                      fan_out=FANOUTS, batch_size=BATCH, num_hidden=HIDDEN,
                      num_layers=3, num_in_heads=HEADS[0],
                      num_out_heads=HEADS[-1], lr=0.01, lr_step_size=100,
                      logdir=str(tmp_path), disable_checkpoint=True, seed=11,
                      compute_dtype=dt, exp3_dtype=dt, **kw)
    return Trainer(cfg, graph=g, n_classes=nc, multilabel=ml, device="cpu")


def _ref_cfg(tr):
    c = tr.cfg
    return {"graph": {"split": [len(tr.train_nid), 0, 0],
                      "n_classes": tr.n_classes},
            "model": {"layers": c.num_layers, "hidden": c.num_hidden,
                      "heads": list(HEADS), "lr": c.lr,
                      "lr_gamma": c.lr_gamma,
                      "lr_step_epochs": c.lr_step_size,
                      "dropout": c.dropout, "attn_dropout": c.attn_dropout,
                      "negative_slope": c.negative_slope},
            "sampler": {"batch_size": c.batch_size,
                        "fanouts": list(c.fan_out), "eta": c.eta,
                        "exp3_delta": c.exp3_delta,
                        "poisson_eps": c.poisson_eps, "poisson_iters": 50}}


def _ref_graph(tr):
    """What the reference reads of the graph: the CSC, the in-degrees,
    the normalised weights, the features as the port holds them (f32
    values) and the labels."""
    dg = tr.graph
    e = dg.n_edges
    indptr = dg.csc_indptr.long()
    return types.SimpleNamespace(
        indptr=indptr, src=dg.csc_src[:e].long(),
        in_deg=indptr[1:] - indptr[:-1], w=dg.edata["w"][:e].float(),
        features=dg.ndata["features"].float(), labels=dg.ndata["labels"])


@contextlib.contextmanager
def _recorded(monkeypatch):
    """The port's draws in each train step, as the benchmark's recorder
    reads them: the blocks and each dropout's keep mask, in draw order."""
    recs = []
    sample, drop = steps_mod.sample_blocks, layers_mod.dropout

    def sample_blocks(*a, **k):
        out = sample(*a, **k)
        recs.append({"blocks": out[0], "keep": []})
        return out

    def dropout(h, p, generator):
        out = drop(h, p, generator)
        if p > 0 and torch.is_grad_enabled():
            recs[-1]["keep"].append((out != 0) | (h == 0))
        return out

    with monkeypatch.context() as m:
        m.setattr(steps_mod, "sample_blocks", sample_blocks)
        m.setattr(layers_mod, "dropout", dropout)
        yield recs


def _as_rec(rec):
    fields = ("src_gids", "src_mask", "e_src", "e_dst", "e_mask", "eid",
              "src_node_prob")
    return {"blocks": [{f: getattr(b, f) for f in fields}
                       | {"n_dst_cap": b.n_dst_cap} for b in rec["blocks"]],
            "keep": rec["keep"]}


def _ref_probs(ref_mod, ref, rec):
    """The node probability of every src slot of each block of ``rec``,
    worked out by the reference's sampler side from its arms now."""
    out = []
    for l, b in enumerate(rec["blocks"]):
        n = b["n_dst_cap"]
        spec = dict(ref.spec, fanout=ref.fanouts[l])
        out.append(ref_mod.derive_block(
            ref.g, ref_mod.sampling_arms(ref.arms[l]), spec,
            b["src_gids"][:n], b["src_mask"][:n], b["src_gids"],
            b["src_mask"])["p_slot"])
    return out


def _leaf_gap(got, want):
    """The worst leaf's ||got - want|| / ||want||."""
    return max(float(torch.linalg.vector_norm(got[k].float() - v)
                     / torch.linalg.vector_norm(v)) for k, v in want.items())


def _run_both(tmp_path, monkeypatch, precision):
    """Three eager port steps and the reference on their draws, from the
    model's seeded weights, Adam unstarted and the arms at one."""
    ref_mod = _reference()
    tr = _trainer(tmp_path, precision)
    named = dict(tr.state.model.named_parameters())
    p0 = {k: v.detach().float().clone() for k, v in named.items()}
    prog = {"loss": [], "grads": [], "p_slots": []}
    with _recorded(monkeypatch) as recs:
        for i in range(STEPS):
            seeds = tr._to_device(tr.train_nid[i * BATCH:(i + 1) * BATCH])
            mask = torch.ones(BATCH, dtype=torch.bool)
            tr.state, m = tr.train_step(tr.state, seeds, mask)
            prog["loss"].append(float(m["train_loss"]))
            prog["grads"].append({k: p.grad.detach().float().clone()
                                  for k, p in named.items()})
            prog["p_slots"].append([b.src_node_prob.float()
                                    for b in recs[-1]["blocks"]])
    assert len(recs) == STEPS
    assert all(len(r["keep"]) == 2 * 3 for r in recs)  # feature, attention
    ref = ref_mod.Train(_ref_cfg(tr), _ref_graph(tr), p0)
    outs = []
    for r in recs:
        rec = _as_rec(r)
        p_all = _ref_probs(ref_mod, ref, rec)  # from the arms before it
        outs.append(dict(ref.step(rec), p_all=p_all))
    e = tr.graph.n_edges
    return tr, named, p0, prog, ref, outs, e


def test_f32_steps_follow_the_reference(tmp_path, monkeypatch):
    """At f32 compute and arms both sides compute the same sums in other
    orders, so every number agrees to f32 round-off: the loss to 1e-5
    relative; each step's gradient, worst leaf, to 1e-4 of its norm (the
    softmax's and the segment sums' orders, through three layers); the
    change of the parameters over the three steps to 1e-3 of its norm
    (Adam divides each gradient by its own root mean square, so an entry
    with a near-zero gradient moves by up to 2 lr on rounding alone); the
    arms to 1e-4 of their change from one (the reward squares alpha, whose
    dst sum can cancel and so amplify round-off); the node probabilities
    to 1e-5 relative; and no block fault."""
    tr, named, p0, prog, ref, outs, e = _run_both(tmp_path, monkeypatch,
                                                  "f32")
    for o, loss in zip(outs, prog["loss"]):
        assert o["faults"] == 0 and o["edges_differ"] == 0
        assert loss == pytest.approx(o["loss"], rel=1e-5)
    # the reference reports the probabilities of a group's first step alone
    assert [len(o["p_slots"]) for o in outs] == [3, 0, 0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0]["p_slots"],
                                                 outs[0]["p_all"]))
    assert outs[1]["prob_gap"] == outs[2]["prob_gap"] == 0.0
    for o, grads in zip(outs, prog["grads"]):
        assert _leaf_gap(grads, o["grads"]) < 1e-4
    dp = {k: named[k].detach().float() - p0[k] for k in p0}
    dr = {k: ref.params[k] - p0[k] for k in p0}
    assert _leaf_gap(dp, dr) < 1e-3
    arms = tr.state.exp3_weights[:, :e].float()
    moved = ref.arms - 1.0
    assert float(moved.abs().max()) > 0.01  # the reward moved arms
    gap = torch.linalg.vector_norm(arms - ref.arms) / torch.linalg.vector_norm(
        moved)
    assert float(gap) < 1e-4
    for o, p_prog in zip(outs, prog["p_slots"]):
        for pr, pp in zip(o["p_all"], p_prog):
            live = pr > 0
            assert torch.allclose(pp[live], pr[live], rtol=1e-5, atol=0)


def test_bf16_steps_follow_the_reference(tmp_path, monkeypatch):
    """At the configuration's precisions (bf16 compute and arms, f32
    parameters) against the f32 reference, at this toy width (8 columns a
    head, 16 seeds), where one bf16 rounding (2^-8) weighs more than at
    256: the loss to 1e-2 relative (read 0.006); each step's gradient,
    the worst leaf's difference over the larger of its norm and the
    median leaf's (the benchmark's floor), to 0.15 (read 0.06: the
    activations, logits, softmax and messages round once a layer, through
    three layers); the node probabilities to 0.1 relative (read 0.02 at
    the third step: they read the bf16 arms the steps before moved); no
    block fault. The arms are held in the f32 test: in bf16 a dst whose
    logits cancel turns their rounding into an alpha of any size."""
    tr, named, p0, prog, ref, outs, e = _run_both(tmp_path, monkeypatch,
                                                  "bf16")
    for o, loss in zip(outs, prog["loss"]):
        assert o["faults"] == 0 and o["edges_differ"] == 0
        assert loss == pytest.approx(o["loss"], rel=1e-2)
    for o, grads in zip(outs, prog["grads"]):
        norms = [float(torch.linalg.vector_norm(v))
                 for v in o["grads"].values()]
        floor = float(torch.tensor(norms).median())
        for k, v in o["grads"].items():
            diff = float(torch.linalg.vector_norm(grads[k] - v))
            assert diff / max(float(torch.linalg.vector_norm(v)),
                              floor) < 0.15, k
    for o, p_prog in zip(outs, prog["p_slots"]):
        for pr, pp in zip(o["p_all"], p_prog):
            live = pr > 0
            assert torch.allclose(pp[live], pr[live], rtol=0.1, atol=0)


def _cancel_block(a):
    """A block of two dsts of three kept edges each (one padded slot):
    dst 0's head-mean logits ``a[:3]``, dst 1's ``a[3:6]``."""
    e_dst = torch.tensor([0, 0, 0, 1, 1, 1, 0], dtype=torch.int32)
    e_mask = torch.tensor([True] * 6 + [False])
    q = torch.tensor([0.5, 0.25, 0.25, 0.125, 0.5, 0.375, 0.0])
    z32 = torch.zeros(7, dtype=torch.int32)
    return Block(src_gids=torch.arange(8, dtype=torch.int32),
                 src_mask=torch.ones(8, dtype=torch.bool), e_src=z32 + 2,
                 e_dst=e_dst, e_mask=e_mask, eid=torch.arange(
                     7, dtype=torch.int32), e_weight=q, e_q=q,
                 src_node_prob=torch.ones(8), e_alpha=q, n_dst_cap=2)


def test_gat_alpha_on_a_cancelling_block():
    """dst 0's logits sum to 2^-12 of their absolute sum: the reference's
    alpha equals ``_calculate_alpha``'s (both f32, sums of multiples of
    2^-12, exact in any order); one logit moved by a bf16 rounding (2^-8
    of it) flips the sign of every alpha of dst 0 and moves dst 1's by
    about 2^-8; ``gat_alpha_cancel`` counts dst 0's three edges."""
    ref = _reference()
    a = torch.tensor([1.5, -1.0, -0.5 + 2.0 ** -12, 0.75, 0.5, -0.25, 9.0])
    block = _cancel_block(a)
    cfg = SamplerConfig(model="gat")
    want = _calculate_alpha(None, cfg, block, a)
    e = 6
    got = ref.gat_alpha(a[:e], block.e_q[:e], block.e_dst[:e].long(), 2)
    assert torch.equal(got, want[:e])
    assert float(want[6]) == 0.0  # a padded slot
    assert int(gat_alpha_cancel(block, a)) == 3

    a2 = a.clone()
    a2[0] = a[0] * (1 - 2.0 ** -8)
    alpha2 = _calculate_alpha(None, cfg, block, a2)
    assert bool((alpha2[:3] * want[:3] < 0).all())  # every sign flipped
    moved = (alpha2 - want)[:e].abs()
    assert bool((moved[3:] < 2.0 ** -6 * want[3:e].abs()).all())
    # dst 1 sums to 1.0 of 1.5: far from cancelling
    assert abs(float(a[3:6].sum())) > ALPHA_CANCEL_SHARE * float(
        a[3:6].abs().sum())


def test_marks_and_alpha_cancel_counter_in_the_steps(tmp_path):
    """A GATv2 trainer's steps with spans and marks on: in each step unit
    ``model.backward`` once and ``gat.attend`` (its layers summed) inside
    ``step.model``; validation units hold ``gat.attend`` too; the counter
    ``bandit.alpha_cancel/<l>`` is the steps' ``gat_alpha_cancel/<l>``
    (a step metric while marks are on) summed."""
    tr = _trainer(tmp_path, "bf16", num_steps=6)
    seen = [0.0] * 3
    log = tr._log_train_step

    def counting(metrics, prev_t, fb_time):
        for l in range(3):
            seen[l] += float(metrics[f"gat_alpha_cancel/{l}"])
        return log(metrics, prev_t, fb_time)

    tr._log_train_step = counting
    spans.enable(marks=True)
    tr.fit()
    snap = spans.snapshot()
    dev = [r for r in snap["records"] if r["clock"] == "device"]
    by_id = {r["id"]: r for r in dev}
    units = [r for r in dev if r["name"] == "step"]
    assert len(units) == 6
    for name in ("model.backward", "gat.attend"):
        rows = [r for r in dev if r["name"] == name]
        parents = {by_id[r["parent"]]["name"] for r in rows}
        assert parents == ({"step.model"} if name == "model.backward"
                           else {"step.model", "eval.model"}), name
    assert len([r for r in dev if r["name"] == "model.backward"]) == 6
    # three layers' attention a step: one sample a unit, the pairs summed
    assert len([r for r in dev if r["name"] == "gat.attend"
                and by_id[r["parent"]]["name"] == "step.model"]) == 3 * 6
    assert snap["spans"]["gat.attend"]["count"] == 6 + len(
        [r for r in dev if r["name"] == "eval"])
    c = snap["counters"]
    assert [c[f"bandit.alpha_cancel/{l}"] for l in range(3)] == seen


def test_off_leaves_the_gat_step_as_without_spans(tmp_path, monkeypatch):
    """Tracing off: a GATv2 step's packed metrics (layout and values) are
    those of the same step with the spans module stubbed out of the step,
    the sampler and the layers, and hold no alpha-cancel count."""
    seeds_of = lambda tr: tr._to_device(tr.train_nid[:BATCH])  # noqa: E731

    def one_step(tr):
        _, m = tr.train_step(tr.state, seeds_of(tr),
                             torch.ones(BATCH, dtype=torch.bool))
        return _pack(m, tr.device)

    vec_off, layout_off = one_step(_trainer(tmp_path / "a", "bf16"))
    stub = types.SimpleNamespace(
        open_marks=lambda unit, device: None, mark=lambda name: None,
        device_span=lambda name: contextlib.nullcontext(),
        finish=lambda m: m, defer=lambda *a: None,
        take_pending=lambda: None, counter=lambda name, n=1: None,
        marks_enabled=lambda: False)
    with monkeypatch.context() as m:
        for mod in (steps_mod, samplers_mod, layers_mod):
            m.setattr(mod, "spans", stub)
        vec_bare, layout_bare = one_step(_trainer(tmp_path / "b", "bf16"))
    assert layout_off == layout_bare
    assert torch.equal(vec_off, vec_bare)
    assert not any(name.startswith("gat_alpha_cancel/")
                   for name, _ in layout_off)


@pytest.mark.parametrize("kind", ["frontier_overflow", "block_edge_overflow"])
def test_a_widen_grows_only_the_caps_that_overflowed(tmp_path, kind):
    """After the refit, a step whose output layer overflows its frontier
    (a hub seed's in-edges, every widen of the Reddit cell's set-up) widens
    the frontier caps and leaves the block-edge caps, whose every slot is
    padded work in GATv2's [E, H*O] passes; a block-edge overflow widens
    the block-edge caps alone."""
    import time

    from bliss_gnn_tpu_torch.train.trainer import _metrics_to_host

    tr = _trainer(tmp_path, "bf16", num_steps=3, refit_after=3)
    tr.fit()
    assert tr.capacity.refit_done
    before = tr.plan
    seeds = tr._to_device(tr.train_nid[:BATCH])
    tr.state, m = tr.train_step(tr.state, seeds,
                                torch.ones(BATCH, dtype=torch.bool))
    m, = _metrics_to_host(m, tr.device, chained=False)
    m[f"layer2/{kind}"] = 100.0
    tr.global_step += 1
    tr._log_train_step(m, time.perf_counter(), 0.0)
    tr.capacity.observe(m)
    tr._follow_capacity_policy()
    assert tr.n_widens == 1
    grew_frontier = kind == "frontier_overflow"
    assert (tr.plan.frontier_caps != before.frontier_caps) == grew_frontier
    assert (tr.plan.block_e_caps != before.block_e_caps) != grew_frontier
    assert all(a >= b for a, b in zip(tr.plan.frontier_caps,
                                      before.frontier_caps))


def test_configuration_states_the_trainers_defaults():
    """The benchmark's trainer passes neither the attention dropout nor
    the residual, so the configuration must state ``TrainConfig``'s."""
    with open(CONFIG) as f:
        model = json.load(f)["model"]
    d = TrainConfig()
    assert model["attn_dropout"] == d.attn_dropout
    assert model["residual"] == d.residual
    assert model["name"] == "gat"
