"""The readers of the program's spans (``bmk/spans_slice.py`` and the six
metrics that read it): on a stub context each returns its median of the
slice, None where the slice found nothing, and nothing is built on a
program without spans; a traced toy run of each cell reports them."""
import os
import types

import pytest

from bmk import spans_slice
from bmk.spec import load_module
from conftest import BENCH, run_cell

TRAIN = {"step.sample_ms": "step.sample",
         "sampler.fixed_point_ms": "sample.fixed_point",
         "step.model_ms": "step.model", "step.bandit_ms": "step.bandit",
         "trainer.host_gap_ms": "host_gap"}
INFER = {"infer.attend_ms": "infer.attend"}


def _reader(name):
    return load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                       "test_metric_" + name.replace(".", "_"))


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"the reader touched the run's {name}")


@pytest.mark.parametrize("metric", sorted(TRAIN) + sorted(INFER))
def test_reader_returns_its_median(metric):
    key, attr = ((TRAIN[metric], "spans_train") if metric in TRAIN
                 else (INFER[metric], "spans_infer"))
    ctx = types.SimpleNamespace(run=_Untouchable(), **{attr: {key: 1.25}})
    assert _reader(metric).read(ctx) == 1.25
    setattr(ctx, attr, None)
    assert _reader(metric).read(ctx) is None


@pytest.mark.parametrize("metric", sorted(TRAIN) + sorted(INFER))
def test_reader_without_program_spans_builds_nothing(metric, monkeypatch):
    monkeypatch.setattr(spans_slice, "PROGRAM_SPANS",
                        "bliss_gnn_tpu_torch.utils.no_such_module")
    ctx = types.SimpleNamespace(run=_Untouchable())
    assert _reader(metric).read(ctx) is None


def test_phases_count_only_the_marks_steps():
    spans = types.SimpleNamespace(calls=[])
    for name in ("disable", "reset", "snapshot"):
        setattr(spans, name, lambda name=name: spans.calls.append(name))
    spans.enable = lambda marks=False: spans.calls.append(("enable", marks))
    d = spans_slice._Driver(spans, first_step=10)
    assert len(d.marks) == spans_slice.SLICE_STEPS
    modes = [d.mode[s] for s in range(11, d.last + 1)]
    first = modes.index("marks")
    assert modes[first - 1] == "capture marks"
    assert modes.count("capture marks") == spans_slice.CAPTURE_STEPS - 1
    for s in range(10, d.last + 1):
        d(s)
    assert spans.calls.count("reset") == 1 and spans.calls.count(
        "snapshot") == 1


@pytest.mark.parametrize("workload,metrics", [
    ("sage-reddit-train", sorted(TRAIN)),
    ("gatv2-reddit-infer", sorted(INFER))])
def test_traced_toy_run_reports_the_span_metrics(tiny_root, workload,
                                                 metrics, capsys):
    rc, line, err = run_cell(tiny_root, workload, trace=1)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    said = capsys.readouterr().err  # the slice's line, on standard error
    for m in metrics:
        assert line["metrics"][m]["value"] > 0, (m, said[-3000:])
    assert "bench: spans {" in said and '"failed"' not in said
