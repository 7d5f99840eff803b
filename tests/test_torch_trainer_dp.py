"""Trainer-level data parallelism on gloo ranks: the mirror of
``test_trainer_dp.py`` (the mesh, the DP step, sharded validation, the
capacity refit from the maxed stats, checkpoint and restore), plus the
checkpoint's round trip and the rank-0-only logging.

The ranks are spawned processes joined through a ``FileStore`` under
pytest's temporary directory and import the port only; the scenarios of
the module run in one launch of two ranks."""
import os

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)


def _cfg(logdir, **kw):
    base = dict(
        dataset="synth-small", model="sage", sampler="poisson-bandit",
        fan_out=(16, 8), num_layers=2, num_hidden=16, batch_size=32,
        num_steps=4, num_epochs=1, disable_checkpoint=True, logdir=logdir,
        refit_after=2,
    )
    base.update(kw)
    return TrainConfig(**base)


def _worker(logdir):
    out = {}
    t = Trainer(_cfg(logdir, dp=2, disable_checkpoint=False,
                     steps_per_call=2), device="cpu")
    t.fit()
    snap = t.best_state
    t.load_checkpoint()
    loaded = t._snapshot()
    out["e2e"] = dict(
        dp=t.dp, batch=t.batch_size, local=t.plan.batch_size,
        step=t.global_step, refit=t.capacity.refit_done, final=t.final_eval(),
        run_dir=t.run_dir, ckpt=os.path.exists(t.checkpoint_path()),
        same=all(torch.equal(snap["params"][k], v)
                 for k, v in loaded["params"].items())
        and torch.equal(snap["exp3_weights"], loaded["exp3_weights"]),
        n_gens=len(snap["generators"]),
        gens_differ=not torch.equal(snap["generators"][0],
                                    snap["generators"][1]),
        params={k: v.detach().clone()
                for k, v in t.state.model.state_dict().items()})
    t = Trainer(_cfg(logdir, dp=0, batch_size=34, num_steps=1), device="cpu")
    out["auto"] = dict(dp=t.dp, batch=t.batch_size)
    t = Trainer(_cfg(logdir, dp=2, num_steps=2, refit_after=0), device="cpu")
    t.fit()
    out["ema"] = t.ema_nodes[2].value
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_dp")
    return multihost.run_ranks(_worker, 2, (str(tmp),), device="cpu",
                               workdir=str(tmp / "ranks"))


def test_trainer_dp_end_to_end(runs):
    for o in runs:
        e = o["e2e"]
        assert e["dp"] == 2 and e["batch"] == 32
        assert e["local"] == 16  # the plan holds the local batch
        assert e["step"] == 4
        assert e["refit"]  # the refit read the maxed stats
        assert np.isfinite(e["final"]["Test"])
        assert e["ckpt"] and e["same"]
        # every rank's generator state is in the checkpoint, and differs
        assert e["n_gens"] == 2 and e["gens_differ"]
    # one run directory, written by rank 0; the same state on every rank
    assert runs[0]["e2e"]["run_dir"] == runs[1]["e2e"]["run_dir"]
    assert runs[0]["e2e"]["final"] == runs[1]["e2e"]["final"]
    for k, v in runs[0]["e2e"]["params"].items():
        assert torch.equal(v, runs[1]["e2e"]["params"][k]), k
    assert os.path.exists(os.path.join(runs[0]["e2e"]["run_dir"],
                                       "metrics.csv"))


def test_trainer_dp_auto_and_batch_rounding(runs):
    for o in runs:
        assert o["auto"]["dp"] == 2  # every rank the launcher placed
        assert o["auto"]["batch"] % 2 == 0


def test_trainer_dp_metrics_match_global_batch(runs):
    """The summed dst count of the top layer is the global batch."""
    for o in runs:
        assert o["ema"] == pytest.approx(32, rel=0.01)


def test_trainer_dp_rejects_oversubscription(tmp_path):
    with pytest.raises(ValueError, match="exceeds"):
        Trainer(_cfg(str(tmp_path), dp=1024), device="cpu")
    with pytest.raises(ValueError, match="shard-graph"):
        Trainer(_cfg(str(tmp_path), shard_graph=True), device="cpu")
