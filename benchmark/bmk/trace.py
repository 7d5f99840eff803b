"""The device's timeline from ``torch.profiler`` over a bounded slice of
the window: busy seconds (the union of kernel, copy and set intervals),
the traced slice's length, device time by kernel name, and the idle gaps
labelled by what the host was doing (the innermost host event that covers
each gap's middle). The slice runs after the measured window, so the
profiler costs the window nothing."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
SMALL_GAP_US = 10.0
SLICE = "bench.slice"


class Tracer:
    """The profiler over a slice: make one (the profiler starts), run a
    few warm-up units (its own start-up lands there), ``begin`` the slice,
    run it, ``end`` it; ``result`` is the trace reduced over the slice."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.span = None
        self.result = None

    def begin(self):
        self.span = torch.profiler.record_function(SLICE)
        self.span.__enter__()

    def end(self):
        self.span.__exit__(None, None, None)
        self.result = stop(self.prof)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(host, starts, t):
    """The name of the shortest host event covering time ``t``."""
    best, best_len = "host idle", float("inf")
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        ts, te, name = host[j]
        if te >= t and te - ts < best_len:
            best, best_len = name, te - ts
    return best


def stop(prof, top=10):
    """Stops ``prof`` and reduces its trace, over the ``SLICE`` annotation
    where there is one."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, host, span = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("name") == SLICE and e.get("cat") == "user_annotation":
            span = (ts, te)
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((ts, te, e.get("name", "")))
        elif e.get("cat") in HOST_CATS:
            host.append((ts, te, e.get("name", "")))
    if span is not None:  # the slice alone, the device's work clipped to it
        t0, t1 = span
        dev = [(max(a, t0), min(b, t1), n) for a, b, n in dev
               if b > t0 and a < t1]
    elif dev:
        t0 = min([d[0] for d in dev] + [h[0] for h in host])
        t1 = max([d[1] for d in dev] + [h[1] for h in host])
    if not dev:
        return None
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        name = (f"gaps under {SMALL_GAP_US:g} us" if b - a < SMALL_GAP_US
                else _label(host, starts, 0.5 * (a + b)))
        gaps[name] += (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "by_name": dict(by_name),
        "device_ops": [[n[:160], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n[:160], s] for n, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
    }
