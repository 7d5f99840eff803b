"""The program's own spans and device marks over a slice of its work, for
the per-layer metrics that read them (``utils/spans.py`` of the port).

A reader runs after the cell's trainer or models were freed and the check
made, so the slice builds its own from the run's cell, seed and device,
in the run's way (``bmk/train.py``'s and ``bmk/infer.py``'s ``Run``), once
a run: the first reader that asks runs it, the others read the result.
The measured window and the profiler's slice are over by then, so the
slice costs them nothing. On a program without spans (the module is
missing) it returns None at once.

Training: ``build``, then the set-up's fit (pilot, refit, captures,
``setup_epochs`` epochs, so that the same widens fall there and not in
the slice), then one fit by ``_phases``: tracing off and host spans alone
in alternate blocks, then host spans with device marks (turning them on
recaptures the step; the warm-ups and the capture are not counted, so
only replayed steps are), then off again. Inference: ``build``, one warm
pass of each weight set, then ``SLICE_PASSES`` passes off, with host
spans and with marks, in turn, twice.

Each slice prints ``bench: spans {...}`` on standard error: the span
summary (count, median, total and self time by name), the counters, the
tracing-on cost against the untraced window and against the same
trainer's untraced steps, and the cross-checks of the marks (their parts
against their whole, the sampler against ``sampler.ms``, K7 against the
trace).
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
import traceback

import numpy as np
import torch

PROGRAM_SPANS = "bliss_gnn_tpu_torch.utils.spans"
SLICE_STEPS = 128
BLOCK = 16  # steps a block while off and host spans alternate
CAPTURE_STEPS = 4  # two eager warm-ups, the capture, one replay
SLICE_PASSES = 2


def available() -> bool:
    try:
        return importlib.util.find_spec(PROGRAM_SPANS) is not None
    except ModuleNotFoundError:
        return False


def train(ctx):
    """The training slice's medians in ms (None without the program's
    spans)."""
    if not hasattr(ctx, "spans_train"):
        ctx.spans_train = _guarded(_train, ctx)
    return ctx.spans_train


def infer(ctx):
    """The inference slice's medians in ms (None without the program's
    spans)."""
    if not hasattr(ctx, "spans_infer"):
        ctx.spans_infer = _guarded(_infer, ctx)
    return ctx.spans_infer


def _guarded(fn, ctx):
    """``fn(ctx)``, or None on a program without spans; a slice that
    raises is reported with its traceback and reads as None, so the run's
    other metrics still make their line."""
    if not available():
        return None
    try:
        return fn(ctx)
    except Exception:  # noqa: BLE001 - a reader's boundary
        _say({"failed": traceback.format_exc()})
        return None


def _summary(snap):
    return {name: {"count": s["count"], "median_ms": s["median_ms"],
                   "total_ms": s["total_ms"], "self_ms": s["self_ms"]}
            for name, s in snap["spans"].items()}


def _say(obj):
    print(f"bench: spans {json.dumps(obj, default=str)}", file=sys.stderr,
          flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _per_step(records, clock, name):
    """{step: summed duration in ms} of the records ``name`` on ``clock``."""
    out = {}
    for r in records:
        if r["clock"] == clock and r["name"] == name:
            out[r["step"]] = (out.get(r["step"], 0.0)
                              + (r["end_ns"] - r["start_ns"]) * 1e-6)
    return out


def _median(xs):
    return float(np.median(xs)) if len(xs) else None


def _phases():
    """[(mode, steps)] of the training slice after the set-up: tracing off
    and host spans alone interleaved in blocks of ``BLOCK`` steps, then
    marks (their first ``CAPTURE_STEPS`` - 1 steps the warm-ups and the
    capture, which are not counted), then off again (after its own
    recapture)."""
    out = [("off" if i % 2 == 0 else "host", BLOCK)
           for i in range(2 * SLICE_STEPS // BLOCK)]
    return out + [("capture marks", CAPTURE_STEPS - 1),
                  ("marks", SLICE_STEPS),
                  ("capture off", CAPTURE_STEPS - 1),
                  ("off", SLICE_STEPS // 2)]


class _Driver:
    """The logger's hook over the slice's one fit: after each step it sets
    the tracing of the next step by ``_phases``, clears the registry
    before the first counted marks step and takes the snapshot after the
    last (from the hook of the step after it, once that step's spans have
    closed)."""

    def __init__(self, spans, first_step):
        self.spans = spans
        self.mode = {}  # step -> mode
        step = first_step
        for mode, n in _phases():
            for _ in range(n):
                step += 1
                self.mode[step] = mode
        self.last = step
        self.marks = [s for s, m in self.mode.items() if m == "marks"]
        self.snap = None

    def __call__(self, step):
        nxt = self.mode.get(step + 1)
        sp = self.spans
        if nxt in ("off", "capture off"):
            sp.disable()
        elif nxt == "host":
            sp.enable(marks=False)
        elif nxt == "capture marks":
            sp.enable(marks=True)
        elif nxt == "marks" and self.mode.get(step) != "marks":
            sp.reset()
        if step == self.marks[-1] + 1:
            self.snap = sp.snapshot()


def _train(ctx):
    from bliss_gnn_tpu_torch.utils import spans

    from bmk import train as btrain

    run0 = ctx.run
    r = btrain.Run(run0.cell, run0.seed, run0.dev)
    dev = r.dev
    r.build()
    tr = r.tr
    try:
        spans.disable()
        spans.reset()
        tr.cfg.num_steps = max(CAPTURE_STEPS,
                               r.traffic["setup_epochs"] * r.spe)
        tr.fit()
        driver = _Driver(spans, tr.global_step)
        i0, g0 = len(tr.logger.iter_time), tr.global_step
        tr.logger.on_step = driver
        tr.cfg.num_steps = driver.last
        _sync(dev)
        tr.fit()
        _sync(dev)
        iters = tr.logger.iter_time[i0:i0 + driver.last - g0]
    finally:
        spans.disable()
        spans.reset()
        tr = None
        r.free()
    snap = driver.snap
    by_mode = {}
    for i, t in enumerate(iters):
        by_mode.setdefault(driver.mode[g0 + 1 + i], []).append(1e3 * t)
    step_ms = {m: _median(v) for m, v in by_mode.items()
               if not m.startswith("capture")}
    keep = set(driver.marks)

    def per_step(clock, name):
        return {s: v for s, v in _per_step(snap["records"], clock,
                                           name).items() if s in keep}

    it = per_step("host", "trainer.iteration")
    busy = [per_step("host", n) for n in ("trainer.launch",
                                          "trainer.metrics_read")]
    out = {name: _median(list(per_step("device", name).values()))
           for name in ("step", "step.sample", "step.model", "step.bandit",
                        "sample.fixed_point")}
    # the launch of a replay overlaps the card's work: its first nodes run
    # while cudaGraphLaunch is still submitting the rest
    out["host_gap"] = _median([it[s] - sum(b[s] for b in busy) for s in it
                               if all(s in b for b in busy)])
    out["iteration"] = _median(list(it.values()))
    window_ms = (1e3 * float(np.median(run0.win_iter))
                 if getattr(run0, "win_iter", None) else None)
    checks = {}
    parts = [out[k] for k in ("step.sample", "step.model", "step.bandit")]
    if None not in parts and out["step"]:
        checks["parts_over_step_pct"] = 100.0 * sum(parts) / out["step"]
    if out["step.sample"] is not None and ctx.sampler_ms:
        checks["sample_over_sampler_ms_pct"] = (100.0 * out["step.sample"]
                                                / ctx.sampler_ms)
    if None not in (out["host_gap"], out["step"], out["iteration"]):
        checks["gap_plus_step_less_iteration_ms"] = (
            out["host_gap"] + out["step"] - out["iteration"])
    _say({"cell": run0.cell.name, "counted_steps": len(keep),
          "summary": _summary(snap), "counters": snap["counters"],
          # the marks slice's median trainer.iteration against the
          # window's median step (the trainer's iter_time, untraced)
          "spans_overhead_pct": (None if not window_ms or out["iteration"]
                                 is None else 100.0 * (out["iteration"]
                                                       / window_ms - 1.0)),
          # the trainer's own iter_time by the tracing its steps ran under
          "slice_step_ms": step_ms,
          "slice_overhead_pct": {
              m: 100.0 * (v / step_ms["off"] - 1.0)
              for m, v in step_ms.items() if m != "off" and step_ms["off"]},
          "window_step_ms_median": window_ms, "checks": checks,
          "medians_ms": out})
    return out


def _infer(ctx):
    from bliss_gnn_tpu_torch.utils import spans

    from bmk import infer as binfer

    run0 = ctx.run
    r = binfer.Run(run0.cell, run0.seed, run0.dev)
    dev = r.dev
    r.build()
    try:
        spans.disable()
        spans.reset()
        r.warm()
        times = {"off": [], "host": [], "marks": []}
        for _ in range(2):
            for mode, got in times.items():
                if mode == "off":
                    spans.disable()
                else:
                    spans.enable(marks=mode == "marks")
                for i in range(SLICE_PASSES):
                    _sync(dev)
                    t0 = time.perf_counter()
                    r.one_pass(i)
                    _sync(dev)
                    got.append(1e3 * (time.perf_counter() - t0))
        medians = {m: float(np.median(v)) for m, v in times.items()}
        snap = spans.snapshot()
    finally:
        spans.disable()
        spans.reset()
        r.models = r.graph = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    span = snap["spans"]

    def med(name):
        return span[name]["median_ms"] if name in span else None

    out = {"infer": med("infer"), "infer.attend": med("infer.attend"),
           "infer.project": med("infer.project")}
    window_ms = 1e3 * run0.window_s / run0.passes
    checks = {}
    tr = ctx.trace
    if tr is not None and out["infer.attend"] is not None:
        k7 = sum(s for name, s in tr["by_name"].items()
                 if "gat_attention_kernel" in name)
        if k7 > 0:
            checks["attend_over_k7_trace_pct"] = (
                100.0 * out["infer.attend"] / (1e3 * k7 / run0.traced_passes))
    _say({"cell": run0.cell.name, "passes": SLICE_PASSES,
          "summary": _summary(snap), "counters": snap["counters"],
          "spans_overhead_pct": (None if out["infer"] is None else
                                 100.0 * (medians["marks"] / window_ms - 1.0)),
          "same_models_pass_ms": medians,
          "same_models_overhead_pct": {
              k: 100.0 * (v / medians["off"] - 1.0)
              for k, v in medians.items() if k != "off"},
          "window_pass_ms": window_ms, "checks": checks, "medians_ms": out})
    return out
