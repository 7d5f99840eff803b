"""The port's spans, device marks and counters (``utils/spans.py``) on the
CPU, where a mark writes ``perf_counter_ns`` differences in the card's
place: off, they leave no record and the step's packed metrics as they
are without the module; on, a toy ``Trainer.fit`` records each step's
``trainer.iteration`` with its children, the loop's validation, snapshot,
renormalisation and rebuild, counters that agree with the steps run, and
each step's marks nested as the step runs (sample, model, bandit). The
last test (marker ``cuda``) runs a replayed chain on the card."""
import contextlib
import types

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata
from bliss_gnn_tpu_torch.sampling import samplers as samplers_mod
from bliss_gnn_tpu_torch.train import steps as steps_mod
from bliss_gnn_tpu_torch.train.steps import _Replay, _pack
from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer
from bliss_gnn_tpu_torch.utils import spans

torch.set_num_threads(1)

STEP_CHILDREN = {"trainer.batch", "trainer.launch", "trainer.metrics_read",
                 "trainer.log"}


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _trainer(tmp_path, device="cpu", **kw):
    g, nc, ml = synthetic_graph(400, 3000, 16, 4, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    cfg = TrainConfig(dataset="synth", model="sage", sampler="poisson-bandit",
                      fan_out=(32, 16), batch_size=32, num_hidden=32,
                      num_layers=2, lr=0.01, logdir=str(tmp_path),
                      lr_step_size=100, disable_checkpoint=True, **kw)
    return Trainer(cfg, graph=g, n_classes=nc, multilabel=ml, device=device)


def _one_step(tr):
    seeds = tr._to_device(tr.train_nid[:tr.batch_size])
    mask = torch.ones(tr.batch_size, dtype=torch.bool)
    _, metrics = tr.train_step(tr.state, seeds, mask)
    return _pack(metrics, tr.device)


def _without_spans(monkeypatch):
    """The step bodies and the sampler with the module's calls replaced by
    nothing: the step as it runs without the module."""
    stub = types.SimpleNamespace(
        open_marks=lambda unit, device: None, mark=lambda name: None,
        device_span=lambda name: contextlib.nullcontext(),
        finish=lambda m: m, defer=lambda *a: None,
        take_pending=lambda: None, counter=lambda name, n=1: None,
        marks_enabled=lambda: False)
    monkeypatch.setattr(steps_mod, "spans", stub)
    monkeypatch.setattr(samplers_mod, "spans", stub)


def test_off_leaves_no_record_and_the_packed_step_as_without_it(
        tmp_path, monkeypatch):
    """Tracing off: nothing recorded, and one step's ``_pack`` layout and
    values are those of the same step with the module's calls stubbed
    out. With marks on, the layout gains only the ``@`` stamp columns,
    after the others, and every other value stays as it was."""
    vec_off, layout_off = _one_step(_trainer(tmp_path / "a"))
    snap = spans.snapshot()
    assert snap == {"spans": {}, "counters": {}, "records": []}
    with monkeypatch.context() as m:
        _without_spans(m)
        vec_bare, layout_bare = _one_step(_trainer(tmp_path / "b"))
    assert layout_off == layout_bare
    assert torch.equal(vec_off, vec_bare)
    assert not any(name.startswith("@") for name, _ in layout_off)

    spans.enable(marks=True)
    vec_on, layout_on = _one_step(_trainer(tmp_path / "c"))
    n = len(layout_off)
    assert layout_on[:n] == layout_off
    assert all(name.startswith("@") for name, _ in layout_on[n:])
    assert torch.equal(vec_on[:n], vec_off)


def _records(snap, clock, name=None):
    return [r for r in snap["records"] if r["clock"] == clock
            and (name is None or r["name"] == name)]


def test_fit_records_each_step_with_its_children(tmp_path):
    """Two epochs of ``fit`` with spans and marks on: each step one
    ``trainer.iteration`` (no parent, its step id) whose children are the
    batch, launch, metrics read and log of that step; a span's self time
    is its duration less its children's; the loop's validation, snapshot,
    renormalisation and rebuild are recorded; the counters agree with the
    steps run and the captures made."""
    tr = _trainer(tmp_path, num_epochs=2, exp3_renorm_every=4)
    captures0 = _Replay.captures
    spans.enable(marks=True)
    tr.fit()
    snap = spans.snapshot()
    assert len(snap["records"]) < spans.RING
    host = _records(snap, "host")
    iters = [r for r in host if r["name"] == "trainer.iteration"]
    assert [r["step"] for r in iters] == list(range(1, tr.global_step + 1))
    assert all(r["parent"] is None for r in iters)
    by_id = {r["id"]: r for r in host}
    for it in iters:
        kids = [r for r in host if r["parent"] == it["id"]]
        assert STEP_CHILDREN <= {r["name"] for r in kids}
        assert all(r["step"] == it["step"] for r in kids)
        assert all(it["start_ns"] <= r["start_ns"] <= r["end_ns"]
                   <= it["end_ns"] for r in kids)
    for name, stat in snap["spans"].items():
        rows = [r for r in host if r["name"] == name]
        if not rows:
            continue
        total = sum(r["end_ns"] - r["start_ns"] for r in rows)
        kids = sum(r["end_ns"] - r["start_ns"] for r in host
                   if r["parent"] is not None
                   and by_id[r["parent"]]["name"] == name)
        assert stat["count"] == len(rows)
        assert stat["total_ms"] == pytest.approx(total * 1e-6, abs=1e-9)
        assert stat["self_ms"] == pytest.approx((total - kids) * 1e-6,
                                                abs=1e-9)
    names = {r["name"] for r in host}
    assert {"trainer.validate", "trainer.snapshot",
            "trainer.renorm"} <= names
    assert tr.n_refits > 0 and "trainer.rebuild" in names
    assert snap["spans"]["trainer.validate"]["count"] == 2
    c = snap["counters"]
    assert c["steps.eager/train"] == tr.global_step
    assert sum(v for k, v in c.items()
               if k.startswith("steps.captures/")) == (
        _Replay.captures - captures0)
    assert c["trainer.refits"] == tr.n_refits
    for i in range(3):
        assert c[f"sampler.nodes/{i}"] > 0
    for i in range(2):
        assert c[f"sampler.edges/{i}"] > 0
    # the validations' batches, summed into one unit each
    evals = _records(snap, "device", "eval")
    assert len(evals) == 2
    for u in evals:
        kids = [r["name"] for r in _records(snap, "device")
                if r["parent"] == u["id"]]
        assert kids == ["eval.sample", "eval.model"]


def test_marks_nest_in_the_step_as_it_runs(tmp_path):
    """Each step's device unit: ``step.sample`` from its start, then
    ``step.model``, then ``step.bandit``, back to back; each layer's
    ``sample.fixed_point`` inside ``step.sample``; ``trainer.iteration``
    and the unit share the step id."""
    tr = _trainer(tmp_path, num_steps=6)
    spans.enable(marks=True)
    tr.fit()
    snap = spans.snapshot()
    dev = _records(snap, "device")
    units = [r for r in dev if r["name"] == "step"]
    assert [u["step"] for u in units] == list(range(1, 7))
    for u in units:
        kids = [r for r in dev if r["parent"] == u["id"]]
        assert [r["name"] for r in kids] == ["step.sample", "step.model",
                                            "step.bandit"]
        sample, model, bandit = kids
        assert sample["start_ns"] == 0
        assert sample["end_ns"] == model["start_ns"]
        assert model["end_ns"] == bandit["start_ns"]
        assert bandit["end_ns"] <= u["end_ns"]
        fps = [r for r in dev if r["parent"] == sample["id"]]
        assert [r["name"] for r in fps] == ["sample.fixed_point"] * 2
        assert all(sample["start_ns"] <= r["start_ns"] <= r["end_ns"]
                   <= sample["end_ns"] for r in fps)
        assert all(r["step"] == u["step"] for r in kids + fps)
    # one sample a unit (a step, a validation): its layers summed
    assert snap["spans"]["sample.fixed_point"]["count"] == (
        len(units) + len(_records(snap, "device", "eval")))


def test_inference_pass_marks_each_layer(tmp_path):
    """``layerwise_inference`` with marks on: one ``infer.layer`` host span
    a layer, and one ``infer`` unit a pass whose ``infer.project`` and
    ``infer.attend`` pairs are summed over the layers."""
    tr = _trainer(tmp_path, num_steps=1)
    spans.enable(marks=True)
    tr.final_logits()
    snap = spans.snapshot()
    assert snap["spans"]["infer.layer"]["count"] == 2
    unit, = _records(snap, "device", "infer")
    attends = _records(snap, "device", "infer.attend")
    assert len(attends) == 2
    assert all(r["parent"] == unit["id"] for r in attends)
    assert snap["spans"]["infer.attend"]["count"] == 1
    assert snap["spans"]["infer.attend"]["total_ms"] == pytest.approx(
        sum(r["end_ns"] - r["start_ns"] for r in attends) * 1e-6)


def test_the_rings_stay_bounded():
    spans.enable()
    n = spans.RING + 100
    for _ in range(n):
        with spans.span("x"):
            pass
    snap = spans.snapshot()
    assert len(snap["records"]) == spans.RING
    assert snap["spans"]["x"]["count"] == n
    assert len(snap["spans"]["x"]["durations_ms"]) == spans.RING
    assert snap["records"][-1]["id"] == n


def test_host_spans_follow_the_profiler():
    """Off by default, host spans turn on while a profiler records, as a
    ``record_function`` range in its trace, and off after it."""
    spans.follow_profiler()
    assert not spans.enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans.follow_profiler()
        with spans.span("probe.span"):
            torch.ones(3).sum()
    spans.follow_profiler()
    assert not spans.enabled()
    assert snap_names() == {"probe.span"}
    assert any(e.key == "probe.span" for e in prof.key_averages())


def snap_names():
    return set(spans.snapshot()["spans"])


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mark kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_chain_returns_each_steps_stamps(card, tmp_path):
    """Marks on, a chain of K = 3 (the first call warms up and captures)
    replayed: three stamp sets, each ordered as the step runs and each its
    own; marks off again: the step captures anew, launches no mark, and
    packs the layout of a step without marks."""
    from bliss_gnn_tpu_torch.ops.marks import stamp

    tr = _trainer(tmp_path, device=card, steps_per_call=3, refit_after=0)
    batches = tr._epoch_batches(np.random.default_rng(0))
    seeds = tr._to_device(batches[:3])
    masks = torch.ones((3, tr.batch_size), dtype=torch.bool, device=card)
    _, bare = tr.multi_step(tr.state, seeds, masks)
    bare_keys = list(bare)
    spans.enable(marks=True)
    tr.multi_step(tr.state, seeds, masks)  # two warm-ups, the capture
    captures = _Replay.captures
    launches = stamp.launches
    _, metrics = tr.multi_step(tr.state, seeds, masks)
    assert _Replay.captures == captures and stamp.launches == launches
    cols = sorted((k for k in metrics if k.startswith("@")),
                  key=spans._slot)
    stamps = torch.stack([metrics[k] for k in cols], 1).cpu()  # [3, n]
    assert stamps.shape[0] == 3
    assert bool((stamps[:, 1:] >= stamps[:, :-1]).all())
    assert bool((stamps > 0).all())
    assert len({tuple(r) for r in stamps.tolist()}) == 3
    assert [k[len(str(spans._slot(k))) + 1:] for k in cols][-1] == "$step"

    spans.disable()
    launches = stamp.launches
    _, metrics = tr.multi_step(tr.state, seeds, masks)
    assert _Replay.captures == captures + 1
    assert stamp.launches == launches
    assert list(metrics) == bare_keys
