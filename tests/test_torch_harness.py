"""The port's harness against the JAX package on the same inputs: the EMA
and Welford counters, the metric logger and run directories, the dataset
generators and dispatch, the evaluation helpers, the CLI's flags and
config, the trainer's hparams record, its epoch and validation batches,
its learning-rate schedule after a resize, and the final eval on the JAX
trainer's parameters.

Tolerances: counters, CSV rows, dataset arrays, split graphs, configs,
hparams and batches exactly; the unsupervised probe to 1e-12 (the same
float64 sklearn fit); the rate to rtol 1e-6 against optax's staircase
schedule at the same count; final-eval logits rtol and atol 5e-3, as
``tests/test_torch_inference.py`` holds ``layerwise_inference``, and the
split F1s equal but for nodes whose two largest logits lie within that
tolerance of each other (counted)."""
import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import optax

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import structure as jstruct
from bliss_gnn_tpu.models import inference as jinf
from bliss_gnn_tpu.train import cli as jcli
from bliss_gnn_tpu.train import evaluation as jeval
from bliss_gnn_tpu.train import metrics as jmetrics
from bliss_gnn_tpu.train import trainer as jtrainer
from bliss_gnn_tpu.utils import logging as jlog

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.train import cli as tcli
from bliss_gnn_tpu_torch.train import evaluation as teval
from bliss_gnn_tpu_torch.train import metrics as tmetrics
from bliss_gnn_tpu_torch.train import trainer as ttrainer
from bliss_gnn_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)

INFERENCE_TOL = 5e-3
CONVERT = {"sage": convert.sage_params_from_jax,
           "gcn": convert.gcn_params_from_jax,
           "gat": convert.gat_params_from_jax}


def _graphs(n=400, e=3000, f=16, c=4, seed=3):
    """Both packages' canonicalised synthetic graph with its weights."""
    out = []
    for data, struct in ((jdata, jstruct), (tdata, tstruct)):
        g, nc, ml = data.synthetic_graph(n, e, f, c, seed=seed)
        g = struct.Graph.canonicalize(g)
        g.edata["w"] = struct.normalized_edata(g)
        out.append(g)
    return out[0], out[1], nc, ml


def _cfgs(tmp_path, **kw):
    args = dict(dataset="synth", model="sage", sampler="poisson-bandit",
                fan_out=(32, 16), batch_size=32, num_hidden=32,
                num_layers=2, lr=0.01, num_epochs=2, lr_step_size=100,
                disable_checkpoint=True)
    args.update(kw)
    return (jtrainer.TrainConfig(logdir=str(tmp_path / "jax"), **args),
            ttrainer.TrainConfig(logdir=str(tmp_path / "torch"), **args))


def _trainers(tmp_path, graphs=None, **kw):
    gj, gt, nc, ml = graphs or _graphs()
    cj, ct = _cfgs(tmp_path, **kw)
    return (jtrainer.Trainer(cj, graph=gj, n_classes=nc, multilabel=ml),
            ttrainer.Trainer(ct, graph=gt, n_classes=nc, multilabel=ml,
                             device="cpu"))


def _same_graph(a, b):
    assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)
    for k in ("csc_indptr", "csc_src", "csr_indptr", "csr_dst", "csr_eid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k), err_msg=k)
    assert a.ndata.keys() == b.ndata.keys()
    for k in a.ndata:
        np.testing.assert_array_equal(np.asarray(a.ndata[k]), b.ndata[k],
                                      err_msg=k)
    assert a.edata.keys() == b.edata.keys()
    for k in a.edata:
        np.testing.assert_array_equal(np.asarray(a.edata[k]), b.edata[k],
                                      err_msg=k)


# -- counters and logging -------------------------------------------------------


@pytest.mark.parametrize("w", [0.99, 0.5, 1.0])
def test_ema_counter_and_welford_match_reference(w):
    xs = np.random.default_rng(0).normal(10.0, 3.0, 50).tolist()
    ej, et = jmetrics.EmaCounter(w), tmetrics.EmaCounter(w)
    wj, wt = jmetrics.Welford(), tmetrics.Welford()
    assert ej.value == et.value == 0.0
    for x in xs:
        assert ej.push(x) == et.push(x)
        wj.push(x)
        wt.push(x)
        assert (wj.n, wj.m, wj.s, wj.var, wj.std) == \
            (wt.n, wt.m, wt.s, wt.var, wt.std)
    wj.clear()
    wt.clear()
    assert (wj.n, wj.m, wj.s) == (wt.n, wt.m, wt.s) == (0, 0.0, 0.0)


def test_metric_logger_rows_and_version_dirs_match_reference(tmp_path):
    def rows(logger_mod, d):
        lg = logger_mod.MetricLogger(str(d), use_tensorboard=False)
        lg.log(1, {"train_acc": 0.25, "train_loss": 2, "num_nodes/0": 10})
        lg.log(2, {"val_acc": 0.5})
        lg.log(0, {"Final Accuracy/Test": 0.75})
        lg.close()
        lg = logger_mod.MetricLogger(str(d), use_tensorboard=False)
        lg.log(3, {"train_acc": 1.0})  # appends under the one header
        lg.close()
        with open(d / "metrics.csv") as f:
            return [r[:3] for r in csv.reader(f)]

    got_j, got_t = rows(jlog, tmp_path / "j"), rows(tlog, tmp_path / "t")
    assert got_j == got_t
    assert got_t[0] == ["step", "name", "value"]
    assert len(got_t) == 7

    names = {}
    for tag, mod in (("j", jlog), ("t", tlog)):
        base = tmp_path / f"runs_{tag}"
        os.makedirs(base / "version_7")
        os.makedirs(base / "version_x")
        names[tag] = [os.path.basename(mod.next_version_dir(str(base)))
                      for _ in range(3)]
        names[tag].append(os.path.basename(
            mod.next_version_dir(str(tmp_path / f"fresh_{tag}"))))
    assert names["j"] == names["t"] == ["version_8", "version_9",
                                        "version_10", "version_0"]


# -- datasets -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["toy", "synth-small", "synth-sbm-small",
                                  "synth-pubmed-hard"])
def test_load_dataset_matches_reference(name):
    gj, cj, mj = jdata.load_dataset(name)
    gt, ct, mt = tdata.load_dataset(name)
    assert (cj, mj) == (ct, mt)
    _same_graph(gj, gt)


def test_bandit_bench_graph_and_stats_match_reference():
    args = dict(n_nodes=2000, n_edges=20000, n_feats=8, n_classes=3,
                n_dead=200, seed=1)
    gj, cj, mj = jdata.bandit_bench_graph(**args)
    gt, ct, mt = tdata.bandit_bench_graph(**args)
    assert (cj, mj) == (ct, mt)
    _same_graph(gj, gt)
    assert jdata.DATASET_STATS == tdata.DATASET_STATS


def test_on_disk_and_unknown_datasets_raise(tmp_path, monkeypatch):
    # on-disk names with no files under the data root raise as the JAX
    # loader does, naming the path looked for
    monkeypatch.setattr(tdata, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jdata, "DATA_ROOT", str(tmp_path))
    monkeypatch.delenv("BLISS_ALLOW_DOWNLOAD", raising=False)
    for name in ("cora", "reddit", "ogbn-arxiv", "ogbn-papers100m"):
        with pytest.raises(FileNotFoundError, match=str(tmp_path)):
            tdata.load_dataset(name)
        with pytest.raises(FileNotFoundError):
            jdata.load_dataset(name)
    for name in ("no-such-set", "synth-no-such-set", "synth-sbm-nope"):
        with pytest.raises(ValueError):
            tdata.load_dataset(name)
        with pytest.raises(ValueError):
            jdata.load_dataset(name)


def test_graph_from_csc_equals_the_graph_it_came_from():
    _, g, _, _ = _graphs()
    h = tstruct.Graph.from_csc(g.csc_indptr, g.csc_src, g.n_nodes,
                               ndata=g.ndata, edata=g.edata)
    _same_graph(g, h)
    csr = (g.csr_indptr, g.csr_dst, g.csr_eid)
    _same_graph(g, tstruct.Graph.from_csc(g.csc_indptr, g.csc_src,
                                          g.n_nodes, ndata=g.ndata,
                                          edata=g.edata, csr=csr))


# -- evaluation helpers ---------------------------------------------------------


def test_inductive_split_matches_reference():
    gj, gt, _, _ = _graphs(200, 1200, 16, 4, seed=7)
    for a, b in zip(jeval.inductive_split(gj), teval.inductive_split(gt)):
        _same_graph(a, b)
    train_g = teval.inductive_split(gt)[0]
    assert train_g.n_nodes == gt.ndata["train_mask"].sum()


def test_compute_acc_unsupervised_matches_reference():
    _, g, nc, _ = _graphs(200, 1200, 16, 4, seed=7)
    rng = np.random.default_rng(2)
    emb = (g.ndata["features"]
           + rng.normal(size=g.ndata["features"].shape)).astype(np.float32)
    labels = g.ndata["labels"]
    nids = [np.where(g.ndata[m])[0]
            for m in ("train_mask", "val_mask", "test_mask")]
    want = jeval.compute_acc_unsupervised(emb, labels, *nids)
    got = teval.compute_acc_unsupervised(emb, labels, *nids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[1] > 1.0 / nc


# -- CLI ------------------------------------------------------------------------

ARGVS = [
    [],
    ["--dataset", "synth-pubmed", "--model", "gat", "--fan-out", "64,32",
     "--num-layers", "2", "--batch-size", "128", "--lr", "0.01",
     "--num-steps", "100", "--residual", "--undirected", "--seed", "3"],
    ["--sampler", "neighbor", "--max-frontier-edges", "5000",
     "--refit-after", "0", "--steps-per-call", "4",
     "--eval-steps-per-call", "1", "--precision", "highest",
     "--shard-indptr", "1", "--dp", "2", "--shard-graph", "--use-uva",
     "--cache-size", "10", "--exp3-delta-formula",
     "--importance-sampling", "0", "--vertex-limit", "300",
     "--profile-steps", "2", "--resume", "x/checkpoints/best",
     "--inference-backend", "hybrid", "--val-acc-target", "0.5",
     "--early-stopping-patience", "3", "--min-steps", "7",
     "--exp3-renorm-every", "1", "--ema-w", "0.5", "--poisson-eps", "0.5",
     "--lr-gamma", "0.5", "--lr-step-size", "2", "--frontier-slack", "3",
     "--block-edge-slack", "2", "--refit-block-edge-slack", "2",
     "--refit-frontier-slack", "2", "--gpu", "1", "--num-workers", "4",
     "--data-cpu", "--download", "--k-runs", "3", "--num-epochs", "9"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "gat", "all_flags"])
def test_config_from_args_matches_reference(argv):
    pj, pt = jcli.build_argparser(), tcli.build_argparser()
    assert sorted(a.dest for a in pj._actions) == \
        sorted(a.dest for a in pt._actions)
    aj, at = pj.parse_args(argv), pt.parse_args(argv)
    assert vars(aj) == vars(at)
    cj, ct = jcli.config_from_args(aj), tcli.config_from_args(at)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert cj.run_name == ct.run_name
    assert tcli.dataclasses_replace_seed(ct, 11).seed == 11


# -- trainer --------------------------------------------------------------------


def _hparams(tr):
    with open(os.path.join(tr.run_dir, "hparams.json")) as f:
        payload = json.load(f)
    return {k: payload[k] for k in ("config", "capacity_plan", "batch_size",
                                    "n_classes", "multilabel", "dp")}


def _without_logdir(h):
    return dict(h, config={k: v for k, v in h["config"].items()
                           if k != "logdir"})


def test_hparams_match_reference_before_and_after_a_refit(tmp_path):
    tj, tt = _trainers(tmp_path, refit_after=2)
    assert _without_logdir(_hparams(tj)) == _without_logdir(_hparams(tt))
    plan0 = tt.plan
    maxima = {"layer0/frontier_edges": 900.0, "layer1/frontier_edges": 300.0,
              "layer0/n_block_edges_true": 400.0,
              "layer1/n_block_edges_true": 150.0}
    tj._refit_max = dict(maxima)
    tt.capacity.observe(maxima)
    tj.global_step = tt.global_step = 2
    tj._maybe_capacity_refit()
    tt._follow_capacity_policy()
    assert tj._refit_done and tt.capacity.refit_done
    assert tt.n_refits == 1
    assert tt.plan != plan0
    assert dataclasses.asdict(tj.plan) == dataclasses.asdict(tt.plan)
    assert _without_logdir(_hparams(tj)) == _without_logdir(_hparams(tt))


def test_epoch_and_validation_batches_match_reference(tmp_path):
    tj, tt = _trainers(tmp_path, batch_size=4, eval_steps_per_call=3)
    for seed in (1, 5):
        np.testing.assert_array_equal(
            tj._epoch_batches(np.random.default_rng(seed)),
            tt._epoch_batches(np.random.default_rng(seed)))
    seen = {"j": [], "t": []}

    def jax_multi(state, key, seeds, masks, graph):
        seen["j"].append(("chain", np.asarray(seeds), np.asarray(masks)))
        return jmetrics.F1State.zero(), 0.0, 0.0, key

    def jax_one(state, key, seeds, masks, graph):
        seen["j"].append(("one", np.asarray(seeds)[None],
                          np.asarray(masks)[None]))
        return jmetrics.F1State.zero(), 0.0, 0.0

    def torch_multi(state, gen, seeds, masks):
        seen["t"].append(("chain", seeds.numpy(), masks.numpy()))
        return tmetrics.F1State.zero(), torch.zeros(()), torch.zeros(
            (), dtype=torch.int32)

    def torch_one(state, gen, seeds, masks):
        seen["t"].append(("one", seeds.numpy()[None], masks.numpy()[None]))
        return tmetrics.F1State.zero(), torch.zeros(()), torch.zeros(
            (), dtype=torch.int32)

    tj.multi_eval, tj.eval_step = jax_multi, jax_one
    tt.multi_eval, tt.eval_step = torch_multi, torch_one
    tj._validate(1)
    tt._validate(1)
    assert [k for k, *_ in seen["t"]] == ["chain"] * 3 + ["one"]
    assert len(seen["j"]) == len(seen["t"])
    for (kj, sj, mj), (kt, st, mt) in zip(seen["j"], seen["t"]):
        assert kj == kt
        np.testing.assert_array_equal(sj, st)
        np.testing.assert_array_equal(mj, mt)


def test_rate_after_steps_and_a_resize_matches_optax(tmp_path):
    """The rate after N steps is optax's staircase schedule at count N;
    after the vertex-limit controller resizes the batch, it is the
    schedule of the new epoch length at the same count."""
    tj, tt = _trainers(tmp_path, lr_step_size=1, lr_gamma=0.5,
                       num_steps=20, num_epochs=-1, refit_after=0)
    cfg = tt.cfg
    tt.fit()
    n = tt.state.step
    assert n == 20

    def want(spe):
        sched = optax.exponential_decay(cfg.lr, cfg.lr_step_size * spe,
                                        cfg.lr_gamma, staircase=True)
        return float(sched(n))

    spe0 = tt.steps_per_epoch
    assert spe0 == tj.steps_per_epoch and n // spe0 >= 1
    assert tt.state.optimizer.param_groups[0]["lr"] == pytest.approx(
        want(spe0), rel=1e-6)
    for tr in (tj, tt):
        tr.cfg.vertex_limit = 20
        tr.welford.clear()
        for x in (100.0, 101.0, 103.0):
            tr.welford.push(x)
        tr._vertex_limit_controller()
    assert tt.batch_size == tj.batch_size < 32
    assert tt.steps_per_epoch == tj.steps_per_epoch != spe0
    assert tt.state.optimizer.param_groups[0]["lr"] == pytest.approx(
        want(tj.steps_per_epoch), rel=1e-6)


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_final_eval_on_converted_parameters_matches_reference(tmp_path,
                                                              model):
    tj, tt = _trainers(tmp_path, model=model, num_hidden=16)
    params = jax.tree.map(np.asarray, jax.device_get(tj.state.params))
    tt.state.model.load_state_dict(CONVERT[model](params))
    cfg = tj.cfg
    heads = tuple([cfg.num_in_heads] * (cfg.num_layers - 1)
                  + [cfg.num_out_heads])
    want = np.asarray(jinf.layerwise_inference(
        cfg.model, tj.state.params, tj.graph, cfg.num_layers, heads=heads,
        negative_slope=cfg.negative_slope, residual=cfg.residual,
        dtype=tj.dtype), np.float32)
    got = tt.final_logits().numpy()
    np.testing.assert_allclose(got, want, rtol=INFERENCE_TOL,
                               atol=INFERENCE_TOL)
    res_j, res_t = tj.final_eval(), tt.final_eval()
    top2 = np.sort(got, axis=1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= INFERENCE_TOL * (
        2 + np.abs(top2[:, 1]) + np.abs(top2[:, 0]))
    same = got.argmax(1) == want.argmax(1)
    assert same[~tie].all()
    for split, mask in (("Train", "train_mask"), ("Validation", "val_mask"),
                        ("Test", "test_mask")):
        nid = np.where(tt.host_graph.ndata[mask])[0]
        n_ties = int(tie[nid].sum())
        assert abs(res_j[split] - res_t[split]) * len(nid) <= n_ties + 1e-6, (
            split, res_j, res_t, n_ties)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """The precision settings are ported: the trainer builds with each, in
    the reference's dtypes, and ``--precision highest`` trains; a platform
    the port does not run on still raises."""
    _, gt, nc, ml = _graphs()
    for kw, want in ((dict(compute_dtype="float32"),
                      (torch.float32, torch.float32, torch.bfloat16)),
                     (dict(param_dtype="bfloat16"),
                      (torch.bfloat16, torch.bfloat16, torch.bfloat16)),
                     (dict(exp3_dtype="float32"),
                      (torch.bfloat16, torch.float32, torch.float32))):
        cfg = _cfgs(tmp_path, **kw)[1]
        tr = ttrainer.Trainer(cfg, graph=gt, n_classes=nc, multilabel=ml,
                              device="cpu")
        dtype, pdtype, edtype = want
        assert tr.graph.ndata["features"].dtype == dtype
        assert {p.dtype for p in tr.state.model.parameters()} == {pdtype}
        assert tr.state.exp3_weights.dtype == edtype
    (res,) = tcli.main(["--platform", "cpu", "--dataset", "toy", "--precision",
                        "highest", "--num-layers", "2", "--fan-out", "4,4",
                        "--batch-size", "4", "--num-steps", "3",
                        "--num-hidden", "8", "--disable-checkpoint",
                        "--logdir", str(tmp_path / "cli")])
    assert all(0.0 <= v <= 1.0 for v in res.values() if not np.isnan(v))
    with pytest.raises(ValueError, match="platform"):
        tcli.main(["--platform", "tpu", "--dataset", "toy"])
