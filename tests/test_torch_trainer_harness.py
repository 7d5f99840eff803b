"""The port's harness behaviour on the CPU, mirroring the JAX package's
``tests/test_metrics_and_harness.py`` (the counters, the checkpoint round
trip, the CLI, the k-runs reduction, the evaluation helpers),
``tests/test_tensorboard_events.py``, ``tests/test_exp3_renorm.py`` and
``tests/test_bandit_ablation.py``, at their sizes and thresholds.

Tolerances are the reference tests': the renormalised trajectories agree
to rtol 2e-4 (parameters) and 1e-3 (f32 arm weights), the renormalised
edge probabilities to rtol 2^-7 (one bf16 rounding), the event values to
rtol 1e-6."""
import csv
import math
import os
import sys

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
from bliss_gnn_tpu_torch.graph.structure import (
    DeviceGraph,
    Graph,
    normalized_edata,
)
from bliss_gnn_tpu_torch.models.gnn import build_model
from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
from bliss_gnn_tpu_torch.sampling.frontier import gather_in_edges
from bliss_gnn_tpu_torch.sampling.samplers import (
    SamplerConfig,
    _exp3_edge_prob,
    exp3_row,
    init_exp3_weights,
    normalize_exp3_weights,
)
from bliss_gnn_tpu_torch.train import cli
from bliss_gnn_tpu_torch.train.metrics import EmaCounter, Welford
from bliss_gnn_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer
from bliss_gnn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_synth(n=200, e=1200, seed=7):
    g, nc, ml = synthetic_graph(n, e, 16, 4, seed=seed)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    return g, nc, ml


# -- counters ---------------------------------------------------------------------


def test_ema_counter_matches_reference_formula():
    """cum = cum * w + x, value = cum * (1 - w) / (1 - w^n)."""
    c = EmaCounter(0.99)
    cum = 0.0
    for i, x in enumerate([10, 20, 30, 40], 1):
        got = c.push(x)
        cum = cum * 0.99 + x
        assert np.isclose(got, cum * (1 - 0.99) / (1 - 0.99 ** i))


def test_welford():
    w = Welford()
    xs = [3.0, 7.0, 11.0, 5.0]
    for x in xs:
        w.push(x)
    assert np.isclose(w.m, np.mean(xs))
    assert np.isclose(w.std, np.std(xs, ddof=1))


# -- checkpoint, CLI, evaluation --------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    g, nc, ml = synthetic_graph(200, 1500, 8, 3, seed=11)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    cfg = TrainConfig(
        dataset="synth", model="sage", sampler="poisson-bandit",
        fan_out=(16, 8), batch_size=16, num_hidden=16, num_layers=2,
        lr=0.01, num_epochs=2, logdir=str(tmp_path), lr_step_size=100)
    tr = Trainer(cfg, graph=g, n_classes=nc, multilabel=ml, device="cpu")
    tr.fit()
    step_before = tr.state.step
    params_before = tr.best_state["params"]
    exp3_before = tr.best_state["exp3_weights"]

    tr2 = Trainer(cfg, graph=g, n_classes=nc, multilabel=ml, device="cpu")
    tr2.load_checkpoint(os.path.join(os.path.abspath(tr.run_dir),
                                     "checkpoints", "best"))
    for name, p in tr2.state.model.named_parameters():
        assert torch.equal(p.detach(), params_before[name]), name
    assert torch.equal(tr2.state.exp3_weights, exp3_before)
    assert 0 < tr2.state.step <= step_before
    # Adam's state came back too
    for i, q in enumerate(tr2.state.model.parameters()):
        saved = tr.best_state["adam"][i]
        assert saved.keys() == tr2.state.optimizer.state[q].keys()
        for k, v in saved.items():
            assert torch.equal(tr2.state.optimizer.state[q][k], v), k


def test_cli_end_to_end(tmp_path):
    """synth-small, one run, a few steps: argparse, Trainer, fit,
    final_eval."""
    results = cli.main([
        "--platform", "cpu", "--dataset", "synth-small", "--model", "sage",
        "--sampler", "poisson-bandit", "--num-layers", "2",
        "--fan-out", "32,16", "--batch-size", "64", "--num-steps", "12",
        "--logdir", str(tmp_path), "--disable-checkpoint",
    ])
    assert len(results) == 1
    assert 0 <= results[0]["Test"] <= 1


def test_kruns_reduction(tmp_path):
    results = cli.main([
        "--platform", "cpu", "--dataset", "synth-small", "--model", "sage",
        "--sampler", "ladies", "--num-layers", "2",
        "--fan-out", "16,8", "--batch-size", "64", "--num-steps", "4",
        "--k-runs", "2", "--logdir", str(tmp_path), "--disable-checkpoint",
    ])
    assert len(results) == 2
    files = os.listdir(f"{tmp_path}_reduced")
    assert any(f.endswith(".csv") for f in files)


def test_evaluation_helpers():
    from bliss_gnn_tpu_torch.train.evaluation import (
        compute_acc_unsupervised,
        inductive_split,
    )

    g, nc, _ = _small_synth()
    emb = np.asarray(g.ndata["features"], np.float32)
    labels = np.asarray(g.ndata["labels"])
    tr, va, te = (np.where(g.ndata[m])[0]
                  for m in ("train_mask", "val_mask", "test_mask"))
    f1v, f1t = compute_acc_unsupervised(emb, labels, tr, va, te)
    assert 0 <= f1v <= 1 and 0 <= f1t <= 1
    assert f1t > 1.0 / nc  # noisy class prototypes: the probe beats chance
    train_g, val_g, test_g = inductive_split(g)
    assert train_g.n_nodes == g.ndata["train_mask"].sum()
    assert val_g.n_nodes == (g.ndata["train_mask"]
                             | g.ndata["val_mask"]).sum()
    assert test_g.n_nodes == g.n_nodes
    assert train_g.n_edges <= g.n_edges


# -- TensorBoard events -------------------------------------------------------


def _events(logdir):
    tb = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    pytest.importorskip("torch.utils.tensorboard")
    ea = tb.EventAccumulator(logdir)
    ea.Reload()
    return ea


def test_metric_logger_emits_tb_events(tmp_path):
    _events(str(tmp_path))  # skips without TensorBoard
    d = str(tmp_path / "run")
    lg = MetricLogger(d)
    lg.log(1, {"train_acc": 0.25, "train_loss": 2.0, "num_nodes/0": 10.0,
               "num_edges/0": 40.0, "iter_time": 0.01,
               "forward_backward_time": 0.005})
    lg.log(2, {"train_acc": 0.5})
    lg.log(2, {"val_acc": 0.4, "val_loss": 1.5})
    lg.close()
    ea = _events(d)
    assert {"train_acc", "train_loss", "num_nodes/0", "num_edges/0",
            "iter_time", "forward_backward_time", "val_acc",
            "val_loss"} <= set(ea.Tags()["scalars"])
    pts = ea.Scalars("train_acc")
    assert [(p.step, round(p.value, 6)) for p in pts] == [(1, 0.25),
                                                         (2, 0.5)]


def test_reduce_runs_emits_mean_std_event_streams(tmp_path):
    _events(str(tmp_path))
    logdir = str(tmp_path / "tb")
    run_name = "exp"
    vals = {0: [0.2, 0.4], 1: [0.6, 1.0]}  # version -> per-step train_acc
    for v in (0, 1):
        d = os.path.join(logdir, run_name, f"version_{v}")
        os.makedirs(d)
        with open(os.path.join(d, "metrics.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "name", "value", "wall_time"])
            for step, val in enumerate(vals[v]):
                w.writerow([step, "train_acc", val, 0.0])
    cli.reduce_runs(logdir, run_name, 2)
    out = f"{logdir}_reduced"
    m = {p.step: p.value for p in _events(
        os.path.join(out, f"{run_name}_2-mean")).Scalars("train_acc")}
    s = {p.step: p.value for p in _events(
        os.path.join(out, f"{run_name}_2-std")).Scalars("train_acc")}
    np.testing.assert_allclose([m[0], m[1]], [0.4, 0.7], rtol=1e-6)
    np.testing.assert_allclose(
        [s[0], s[1]], [np.std([0.2, 0.6]), np.std([0.4, 1.0])], rtol=1e-6)


# -- deferred EXP3 renormalisation ---------------------------------------------


def _renorm_setup(**cfg_kw):
    g, nc, ml = _small_synth()
    dg = DeviceGraph.from_graph(g, device="cpu")
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(16, 8), eta=0.1,
                        **cfg_kw)
    plan = CapacityPlan.build(4, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind)
    return g, dg, cfg, plan, nc, ml


def _state(g, nc, exp3_dtype):
    model = build_model("sage", 16, 16, nc, 2, device="cpu", seed=1)
    opt, sched = make_optimizer(model.parameters(), 0.01, 10, gamma=0.5,
                                step_size=1000)
    return TrainState(model, opt, sched,
                      init_exp3_weights(2, g.n_edges, device="cpu",
                                        dtype=exp3_dtype),
                      torch.Generator().manual_seed(2))


def _run(step, state, g, renorm_every, n_steps=128):
    rng = np.random.default_rng(0)
    train_ids = np.where(g.ndata["train_mask"])[0]
    for it in range(n_steps):
        seeds = torch.from_numpy(
            rng.choice(train_ids, 4, replace=False).astype(np.int32))
        state, _ = step(state, seeds, torch.ones(4, dtype=torch.bool))
        if (it + 1) % renorm_every == 0:
            normalize_exp3_weights(state.exp3_weights)
    normalize_exp3_weights(state.exp3_weights)
    return state


def test_renorm_every_64_matches_every_1_f32():
    """128-step trajectories (parameters and normalised arm weights) agree
    between a renormalisation every 64 steps and every step: the deferred
    renormalisation preserves the semantics (f32 arm weights keep bf16
    rounding out of the argument)."""
    g, dg, cfg, plan, nc, ml = _renorm_setup()
    step = make_train_step(dg, cfg, plan, ml, device="cpu")
    s64 = _run(step, _state(g, nc, torch.float32), g, renorm_every=64)
    s1 = _run(step, _state(g, nc, torch.float32), g, renorm_every=1)
    for p, q in zip(s64.model.parameters(), s1.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(s64.exp3_weights.numpy(),
                               s1.exp3_weights.numpy(), rtol=1e-3,
                               atol=1e-9)


def test_renorm_invariance_of_sampling_probs_bf16():
    """The per-dst renormalised edge probabilities the sampler sees do not
    move under an L1 row renormalisation, within bf16 rounding."""
    g, dg, cfg, plan, nc, ml = _renorm_setup()
    step = make_train_step(dg, cfg, plan, ml, device="cpu")
    state = _run(step, _state(g, nc, torch.bfloat16), g, renorm_every=1000,
                 n_steps=8)
    w_raw = state.exp3_weights
    w_norm = normalize_exp3_weights(w_raw.clone())
    seeds = torch.arange(8, dtype=torch.int32)
    smask = torch.ones(8, dtype=torch.bool)
    frontier = gather_in_edges(dg.csc_indptr, dg.csc_src, seeds, smask, 512)
    q_raw = _exp3_edge_prob(dg, exp3_row(w_raw, 0), 0.1, frontier, seeds, 8)
    q_norm = _exp3_edge_prob(dg, exp3_row(w_norm, 0), 0.1, frontier, seeds,
                             8)
    np.testing.assert_allclose(q_raw.numpy(), q_norm.numpy(), rtol=2 ** -7,
                               atol=1e-9)


def test_delta_formula_runs_and_differs():
    """The paper's per-dst EXP3 learning rate gives a valid update that
    differs from the constant delta's."""
    import dataclasses

    g, dg, cfg, plan, nc, ml = _renorm_setup()
    cfg_f = dataclasses.replace(cfg, exp3_delta_formula=True, exp3_T=100)
    seeds = torch.arange(4, dtype=torch.int32)
    out = []
    for c in (cfg, cfg_f):
        state = _state(g, nc, torch.float32)
        state, _ = make_train_step(dg, c, plan, ml, device="cpu")(
            state, seeds, torch.ones(4, dtype=torch.bool))
        out.append(state.exp3_weights.numpy())
    wc, wf = out
    assert np.all(np.isfinite(wf)) and np.all(wf >= 0)  # 0: padding
    assert not np.allclose(wc, wf)
    assert np.all(wf[wf != 0] <= np.exp(1.0) + 1e-3)


# -- the bandit ablation --------------------------------------------------------


@pytest.mark.slow
def test_frozen_bandit_needs_more_steps():
    """``bench.py``'s time-to-val-F1 protocol through the port
    (``harness_torch.time_to_val_f1``), live bandit then frozen (sampling from
    the arm weights, never updating them): the frozen arm needs at least
    1.3x the live arm's steps to val micro-F1 0.90, and is capped just past
    that bound. Marked slow: on one CPU thread the live arm alone runs up
    to 25 chains (85 s) and the frozen arm up to 34 more. The 0.90 target
    lies on the plateau of the validation curve (0.892-0.900 for the
    reference package at other seeds), so whether the live arm reaches it
    depends on the draws."""
    sys.path.insert(0, ROOT)
    import harness_torch

    cpu = torch.device("cpu")
    live = harness_torch.time_to_val_f1(cpu, max_chains=25)
    assert live["reached"], f"live bandit never reached target: {live}"
    K = harness_torch.TTVF1_K
    cap = math.ceil(1.3 * live["steps"] / K) + 1
    frozen = harness_torch.time_to_val_f1(cpu, max_chains=cap,
                                          freeze=True)
    if frozen["reached"]:
        assert frozen["steps"] >= 1.3 * live["steps"], (live, frozen)
    else:
        assert frozen["steps"] >= 1.3 * live["steps"] - K, (live, frozen)
