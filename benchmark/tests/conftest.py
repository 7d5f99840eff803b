"""The benchmark's own tests, on the CPU at a toy size. ``tiny_root``
makes a checkout-shaped directory: a copy of ``benchmark/`` with toy
configurations and a ``BENCHMARK.json`` of toy cells, so a test drives
``run.main`` the way the command does, minus the look for a card."""
import copy
import io
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path[:0] = [BENCH, os.path.join(BENCH, "reference")]
if ROOT not in sys.path:
    sys.path.append(ROOT)

TINY_GRAPH = {"generator": "reddit_shaped_csc", "n_nodes": 1500,
              "n_rand_edges": 30000, "degree_cap": 400, "exponent": 0.8,
              "n_feats": 24, "n_classes": 5, "split": [975, 150, 375]}
TINY_SAMPLER = {"kind": "poisson-bandit", "batch_size": 32,
                "fanouts": [96, 48, 24], "eta": 0.1, "exp3_delta": 0.01,
                "poisson_eps": 0.9999, "poisson_iters": 50}


def _load(name):
    with open(os.path.join(BENCH, "configs", name)) as f:
        return json.load(f)


def tiny_configs():
    """The two configurations cut to a toy size (every width too: CPU
    tests only)."""
    sage = _load("sage3-reddit.json")
    sage.update(name="tiny-sage", graph=dict(TINY_GRAPH),
                sampler=dict(TINY_SAMPLER))
    sage["model"] = dict(sage["model"], hidden=16)
    # a toy batch of 32 rounds its loss more coarsely than the card's 256
    # at full width, for which the replayed steps' limits were read: the
    # toy holds its replayed steps to the start's limits where those are
    # wider
    lim = sage["limits"]["train"]
    for k in list(lim):
        if k.startswith("replay.") and k[7:] in lim:
            lim[k] = max(lim[k], lim[k[7:]])
    gat = _load("gatv2-reddit.json")
    gat.update(name="tiny-gat", graph=dict(TINY_GRAPH),
               sampler=dict(TINY_SAMPLER))
    gat["model"] = dict(gat["model"], hidden=8, heads=[2, 2, 1])
    return sage, gat


def make_root(tmp, sage, gat, train_traffic=None):
    """A directory shaped as a checkout with the toy cells."""
    shutil.copytree(BENCH, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg in (sage, gat):
        with open(os.path.join(tmp, "benchmark", "configs",
                               cfg["name"] + ".json"), "w") as f:
            json.dump(cfg, f)
    if train_traffic is not None:
        with open(os.path.join(tmp, "benchmark", "traffic",
                               "train-epochs.json"), "w") as f:
            json.dump(train_traffic, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [
        {"name": c["name"], "source": "toy", "file":
         f"benchmark/configs/{c['name']}.json", "reduced": [], "why": "toy"}
        for c in (sage, gat)]
    bench["workloads"] = [
        {"name": "sage-reddit-train", "config": "tiny-sage",
         "traffic": "train-epochs", "chips": 1, "why": "toy"},
        {"name": "gatv2-reddit-infer", "config": "tiny-gat",
         "traffic": "infer-passes", "chips": 1, "why": "toy"}]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(tmp)


TINY_TRAIN_TRAFFIC = {"mode": "train", "why": "toy", "steps_per_call": 1,
                      "eval_steps_per_call": 8, "refit_after": 3,
                      "exp3_renorm_every": 16, "setup_epochs": 1,
                      "traced_steps": 4,
                      "nominal_epoch_s": 0.5}


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    sage, gat = tiny_configs()
    return make_root(tmp_path, sage, gat, copy.deepcopy(TINY_TRAIN_TRAFFIC))


def run_cell(root, workload, seed=7, seconds=0.5, trace=0):
    """``run.main`` on the CPU: (exit code, the result line or None, the
    standard error)."""
    import run

    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], chip_check=False,
                  device="cpu", root=root, out=out, log=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
