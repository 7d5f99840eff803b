"""The port's trainer end to end on the CPU (the plain versions of the
kernels), mirroring the JAX package's ``tests/test_train_e2e.py`` case by
case, at its sizes and thresholds: a small model trained with each sampler
on a synthetic graph of noisy class prototypes must beat chance by the
same margins, and the pipeline (fused steps, validation, checkpoint,
restore, resume, refit, the vertex-limit controller, profiling, final
full-graph eval) must run. Checkpoint failures are injected by replacing
``torch.save``."""
import csv
import json
import os

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph.datasets import load_dataset, synthetic_graph
from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata
from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)


def _graph(seed=3, multilabel=False):
    g, nc, ml = synthetic_graph(400, 3000, 16, 4, seed=seed,
                                multilabel=multilabel)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    return g, nc, ml


def _cfg(tmp_path, **kw):
    return TrainConfig(
        dataset=kw.pop("dataset", "synth"), model=kw.pop("model", "sage"),
        sampler=kw.pop("sampler", "poisson-bandit"),
        fan_out=(32, 16), batch_size=32, num_hidden=32, num_layers=2,
        lr=0.01, num_epochs=kw.pop("num_epochs", 6),
        logdir=str(tmp_path), lr_step_size=100,
        disable_checkpoint=kw.pop("disable_checkpoint", True), **kw)


def _mk(tmp_path, **kw):
    g, nc, ml = _graph()
    return Trainer(_cfg(tmp_path, **kw), graph=g, n_classes=nc,
                   multilabel=ml, device="cpu")


@pytest.mark.parametrize("sampler", ["poisson-bandit", "ladies", "neighbor"])
def test_training_learns(tmp_path, sampler):
    tr = _mk(tmp_path, sampler=sampler)
    tr.fit()
    tr.restore_best()
    res = tr.final_eval()
    assert res["Train"] > 0.55, res  # 4 classes: chance 0.25
    assert res["Test"] > 0.45, res


def test_training_gat(tmp_path):
    tr = _mk(tmp_path, model="gat", num_epochs=5)
    tr.fit()
    res = tr.final_eval()
    assert res["Train"] > 0.4, res


def test_exp3_state_evolves_and_stays_normalized(tmp_path):
    tr = _mk(tmp_path, num_epochs=2)
    w0 = tr.state.exp3_weights.float().clone()
    tr.fit()
    w1 = tr.state.exp3_weights.float()
    assert not torch.equal(w0, w1)
    sums = w1.abs().sum(dim=1).numpy()
    np.testing.assert_allclose(sums, 1.0, rtol=0.02)
    assert tr.state.step == tr.global_step > 0


def test_val_metrics_and_early_stop_target(tmp_path):
    tr = _mk(tmp_path, num_epochs=50, val_acc_target=0.3)
    tr.fit()
    assert tr._stop  # an easy target stops long before 50 epochs
    assert tr.best_val_acc >= 0.3


def test_vertex_limit_batch_controller(tmp_path):
    """With a vertex limit far below the sampled input nodes the controller
    shrinks the batch (rebuilding the plan) at an epoch's end."""
    tr = _mk(tmp_path, num_epochs=3, vertex_limit=20)
    bs0 = tr.batch_size
    tr.fit()
    assert tr.batch_size < bs0, (bs0, tr.batch_size)


def test_profile_trace_capture(tmp_path):
    """--profile-steps writes a torch.profiler trace directory."""
    tr = _mk(tmp_path, num_epochs=1, profile_steps=2)
    tr.fit()
    prof = os.path.join(tr.run_dir, "profile")
    assert os.path.isdir(prof) and len(os.listdir(prof)) > 0
    name = os.listdir(prof)[0]
    assert os.path.getsize(os.path.join(prof, name)) > 0


def test_capacity_refit_tightens_and_training_still_learns(tmp_path):
    tr = _mk(tmp_path, refit_after=2, num_epochs=6)
    formula_caps = tr.plan.block_e_caps
    tr.fit()
    assert tr._refit_done
    assert all(a <= b for a, b in zip(tr.plan.block_e_caps, formula_caps))
    assert any(a < b for a, b in zip(tr.plan.block_e_caps, formula_caps))
    res = tr.final_eval()
    assert res["Train"] > 0.55, res


def test_training_gcn_with_ladies(tmp_path):
    tr = _mk(tmp_path, model="gcn", sampler="ladies", num_epochs=6)
    tr.fit()
    res = tr.final_eval()
    assert res["Train"] > 0.5, res


def test_multilabel_yelp_config_end_to_end(tmp_path):
    """A multilabel graph through the trainer: BCE loss, multilabel
    micro-F1 validation and final eval. Labels are the class prototype's
    plus one random extra, so predicting the primary alone caps micro-F1
    near 0.727 and degenerate strategies sit near 2/3."""
    g, nc, ml = _graph(seed=5, multilabel=True)
    assert ml and g.ndata["labels"].ndim == 2
    tr = Trainer(_cfg(tmp_path, dataset="synth-yelp-test"), graph=g,
                 n_classes=nc, multilabel=ml, device="cpu")
    tr.fit()
    assert tr.multilabel
    res = tr.final_eval()
    assert res["Train"] > 0.68, res
    assert res["Test"] > 0.5, res
    assert np.isfinite(tr.best_val_acc)


def test_hparams_persisted_and_refit_updates(tmp_path):
    """hparams.json holds the resolved config and the capacity plan, and is
    rewritten when the refit changes the plan."""
    tr = _mk(tmp_path, refit_after=2, num_epochs=3)
    path = os.path.join(tr.run_dir, "hparams.json")
    assert os.path.exists(path)
    with open(path) as f:
        before = json.load(f)
    assert before["config"]["sampler"] == "poisson-bandit"
    assert before["config"]["fan_out"] == [32, 16]
    assert tuple(before["capacity_plan"]["block_e_caps"]) == \
        tr.plan.block_e_caps
    tr.fit()
    assert tr._refit_done
    with open(path) as f:
        after = json.load(f)
    assert tuple(after["capacity_plan"]["block_e_caps"]) == \
        tr.plan.block_e_caps
    assert after["capacity_plan"] != before["capacity_plan"]


def test_resume_from_checkpoint(tmp_path):
    """--resume restores the whole state (arm weights and step included)
    and training continues from the checkpointed step."""
    g0, nc0, ml0 = _graph()
    tr = Trainer(_cfg(tmp_path, num_epochs=3, disable_checkpoint=False),
                 graph=g0, n_classes=nc0, multilabel=ml0, device="cpu")
    tr.fit()
    ckpt = os.path.join(tr.run_dir, "checkpoints", "best")
    assert os.path.exists(ckpt)
    saved_step = int(tr.best_state["step"])
    assert saved_step > 0

    g, nc, ml = _graph()
    cfg = _cfg(tmp_path, num_epochs=4, resume=ckpt)
    # num_epochs differs from the checkpointed run: a warning
    with pytest.warns(RuntimeWarning, match="hparams"):
        tr2 = Trainer(cfg, graph=g, n_classes=nc, multilabel=ml,
                      device="cpu")
    assert tr2.global_step == saved_step
    assert torch.equal(tr2.state.exp3_weights,
                       tr.best_state["exp3_weights"])
    tr2.fit()
    assert tr2.global_step > saved_step


def test_checkpoint_failure_is_loud(tmp_path, monkeypatch):
    """A run whose checkpoint writes all fail must not report success: the
    first failure warns, every failure is counted into the
    ``checkpoint_failures`` series, and final_eval raises."""
    def broken(*a, **k):
        raise IOError("disk on fire")

    monkeypatch.setattr(torch, "save", broken)
    tr = _mk(tmp_path, num_epochs=2, disable_checkpoint=False)
    with pytest.warns(UserWarning, match="checkpoint"):
        tr.fit()
    assert tr.checkpoint_failures > 0
    assert not tr._checkpoint_saved
    with pytest.raises(RuntimeError, match="never persisted"):
        tr.final_eval()
    tr.logger.flush()
    with open(os.path.join(tr.run_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert any(r["name"] == "checkpoint_failures" for r in rows)


def test_checkpoint_failure_tolerated_once_one_save_landed(tmp_path,
                                                           monkeypatch):
    """Failures after a save landed degrade (a stale best on disk) but do
    not raise: only a run with no saved checkpoint is refused."""
    real = torch.save
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise IOError("disk on fire")
        return real(*a, **k)

    monkeypatch.setattr(torch, "save", flaky)
    tr = _mk(tmp_path, num_epochs=4, disable_checkpoint=False)
    tr.fit()
    assert tr._checkpoint_saved
    res = tr.final_eval()  # must not raise
    assert "Train" in res


def test_training_on_sbm_community_family(tmp_path):
    """End to end on the SBM community generator: its homophilous
    structure makes aggregation informative, so accuracy beats chance."""
    g, nc, ml = load_dataset("synth-sbm-small")
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    tr = Trainer(_cfg(tmp_path, dataset="synth-sbm-small", num_epochs=4),
                 graph=g, n_classes=nc, multilabel=ml, device="cpu")
    tr.fit()
    res = tr.final_eval()
    assert res["Train"] > 0.4, res  # 7 classes: chance 0.14
    assert res["Test"] > 0.3, res
