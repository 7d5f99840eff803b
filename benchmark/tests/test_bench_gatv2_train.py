"""The GATv2 training cell (``gatv2-bandit-reddit`` on
``train-epochs-gatv2``) at a toy size on the CPU: the port's steps held to
``reference/gatv2_train.py`` (``correct``), the cell's metrics in both
modes, the control failing, and the K5 roofline and FLOP counts against
numbers worked by hand."""
import copy
import json
import os
import types

import pytest
import torch

import calibrate
from bmk.check import judge
from bmk.spec import Cell, load_module
from conftest import (BENCH, TINY_GRAPH, TINY_SAMPLER, TINY_TRAIN_TRAFFIC,
                      run_cell)
from precision import lowered

CELL = "gatv2-reddit-train"
PER_LAYER = ["step.mfu.gat_train", "gat_train.model_ms",
             "gat_train.bandit_ms"]
TRACE_ONLY = ["device.idle_pct.gat_train", "k5_roofline"]  # the card's trace


def _costs():
    return load_module(os.path.join(BENCH, "metrics",
                                    "costs_gatv2_train.py"), "costs_gat_test")


@pytest.fixture
def gat_root(tiny_root):
    """``tiny_root`` with the cell on a toy GATv2 configuration (every width
    cut: CPU tests only), its replayed steps held to the start's limits
    where those are wider, as the toy SAGE cell is."""
    b = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(b, "configs", "gatv2-bandit-reddit.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-gat-train", graph=dict(TINY_GRAPH),
               sampler=dict(TINY_SAMPLER))
    cfg["model"] = dict(cfg["model"], hidden=8, heads=[2, 2, 1])
    lim = cfg["limits"]["train"]
    for k in list(lim):
        if k.startswith("replay.") and k[7:] in lim:
            lim[k] = max(lim[k], lim[k[7:]])
    with open(os.path.join(b, "configs", "tiny-gat-train.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "train-epochs-gatv2.json"),
              "w") as f:
        json.dump(copy.deepcopy(TINY_TRAIN_TRAFFIC), f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-gat-train", "source": "toy",
                             "file": "benchmark/configs/tiny-gat-train.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": CELL, "config": "tiny-gat-train",
                               "traffic": "train-epochs-gatv2", "chips": 1,
                               "why": "toy"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return tiny_root


def test_cell_is_correct_and_reports_its_rate(gat_root):
    rc, line, err = run_cell(gat_root, CELL)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert sorted(line["metrics"]) == ["setup_s", "train_seeds_per_s"]
    assert len(line["checks"]) == 15


def test_traced_cell_reports_its_metrics(gat_root, capsys):
    rc, line, err = run_cell(gat_root, CELL, trace=1)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    for m in PER_LAYER:
        assert line["metrics"][m]["value"] > 0, m
    # no device trace on the CPU: the trace's readers find nothing
    assert not set(TRACE_ONLY) & set(line["metrics"])
    said = capsys.readouterr().err
    spans = [json.loads(s[len("bench: spans "):]) for s in said.splitlines()
             if s.startswith("bench: spans ")]
    assert spans and "failed" not in spans[-1]
    summary, counters = spans[-1]["summary"], spans[-1]["counters"]
    assert {"gat.attend", "model.backward"} <= set(summary)
    assert {f"bandit.alpha_cancel/{l}" for l in range(3)} <= set(counters)


def test_control_fails(gat_root):
    cell = Cell(gat_root, CELL)
    nums, = calibrate.readings(cell, 5, torch.device("cpu"),
                               [lowered(cell.cfg)])
    ok, checks = judge(nums, cell.limits())
    assert not ok, checks


def test_step_flops_by_hand():
    c = _costs()
    cfg = {"model": {"layers": 3, "hidden": 256, "heads": [4, 4, 1]},
           "graph": {"n_feats": 602, "n_classes": 41}}
    counts = [8000, 3000, 250, 256, 60000, 9000, 1800]
    # layer 0: 2*8000*602*1024 + 4*60000*1024 + 5*60000*4 + 2*60000*1024
    l0 = 9_863_168_000 + 245_760_000 + 1_200_000 + 122_880_000
    assert c.gat_layer_flops(8000, 60000, 602, 4, 256) == l0
    l1 = c.gat_layer_flops(3000, 9000, 1024, 4, 256)
    l2 = c.gat_layer_flops(250, 1800, 1024, 1, 41)
    assert l2 == 2 * 250 * 1024 * 41 + 6 * 1800 * 41 + 5 * 1800
    assert c.gat_step_flops(cfg, counts) == 3 * (l0 + l1 + l2)


def test_k5_bytes_and_roofline_by_hand():
    c = _costs()
    cfg = {"model": {"layers": 3, "hidden": 256, "heads": [4, 4, 1]},
           "graph": {"n_feats": 602, "n_classes": 41}}
    # layer 0 alone reaches K5's route: 59,000 valid edges of 1024 bf16
    # columns, read three times with their ids; the dsts written twice, the
    # srcs once
    counts = [8000, 3000, 250, 256, 59000, 20000, 1800]
    want = 3 * 59000 * (1024 * 2 + 4) + (2 * 3000 + 8000) * 1024 * 2
    assert c.k5_step_bytes(cfg, counts) == want
    reader = load_module(os.path.join(BENCH, "metrics", "k5_roofline.py"),
                         "k5_roofline_test")
    run = types.SimpleNamespace(counts=[[0] * 7, counts, counts],
                                traced_steps=2)
    k5_s = 2 * want / c.HBM_BYTES_PER_S * 4  # a quarter of the bound
    trace = {"by_name": {
        "void (anonymous namespace)::rowsum_tiles_kernel<__nv_bfloat16>("
        "__nv_bfloat16 const*)": k5_s / 2,
        "void (anonymous namespace)::place_kernel(int const*)": k5_s / 2,
        "void (anonymous namespace)::gat_attention_kernel<float>()": 1.0}}
    ctx = types.SimpleNamespace(trace=trace, run=run, cfg=cfg,
                                cell=types.SimpleNamespace(dir=BENCH))
    assert reader.read(ctx) == pytest.approx(25.0)
    ctx.trace = {"by_name": {"other_kernel": 1.0}}
    assert reader.read(ctx) is None


def test_sampling_arms_keep_one_dsts_ratios_exact():
    """The reference's sampler side reads its arms scaled by one power of
    two: ratios stay exact, the smallest bf16 subnormal becomes a normal
    f32, the largest arm lands at 2^100 or just under."""
    import gatv2_train

    tiny = torch.tensor([1], dtype=torch.int16).view(torch.bfloat16)
    row = torch.cat([tiny.float(), torch.tensor([1e-39, 3e-8, 0.75, 0.0])])
    out = gatv2_train.sampling_arms(row)
    assert float(out[0]) > torch.finfo(torch.float32).tiny
    assert float(out.max()) <= 2.0 ** 100
    assert float(out.max()) > 2.0 ** 99
    k = round(float(torch.log2(out[2] / row[2])))
    assert torch.equal(out, row * 2.0 ** k)
    assert float(out[4]) == 0.0
    zeros = torch.zeros(3)
    assert torch.equal(gatv2_train.sampling_arms(zeros), zeros)
    # all subnormal: a factor past f32's range, applied in two halves
    sub = torch.tensor([1, 5, 127], dtype=torch.int16).view(torch.bfloat16)
    out = gatv2_train.sampling_arms(sub.float())
    assert bool(torch.isfinite(out).all()) and float(out.max()) > 2.0 ** 99
    assert torch.equal(out / out[0], torch.tensor([1.0, 5.0, 127.0]))
