"""A run's result line, on the CPU at a toy size: exactly the contract's
keys with ``checks`` last, each check printed last on standard error, and
the plain reference agreeing with the port's CPU path."""
import json
import os

import pytest

from conftest import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", ["sage-reddit-train",
                                      "gatv2-reddit-infer"])
def test_line_and_reference_agree(tiny_root, workload):
    rc, line, err = run_cell(tiny_root, workload)
    assert rc == 0, err
    assert list(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    assert sorted(line["metrics"]) == sorted(e2e)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text.startswith(f"bench: check {name} ") and "limit" in text
        assert c["value"] <= c["limit"]


def test_no_card_no_result(tiny_root, monkeypatch):
    import io

    import run
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "gatv2-reddit-infer", "--seed", "1",
                   "--seconds", "1"], root=tiny_root, out=out, log=err)
    assert rc != 0 and out.getvalue() == ""


def test_jax_loaded_no_result(tiny_root, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_cell(tiny_root, "gatv2-reddit-infer")
    assert rc != 0 and line is None and "jax" in err
