"""Inference cells: back-to-back full-graph ``layerwise_inference`` passes.

Set-up builds the device graph with the seed's features, and
``variants`` models with weights drawn from the seed (pass i runs variant
i mod ``variants``, so no two neighbouring passes compute the same
thing), then warms every variant once: the kernels build at their first
call. The window runs ``--seconds`` over the traffic's ``nominal_pass_s``
passes, rounded, so every run of a cell does the same work;
``infer_nodes_per_s`` is the nodes whose logits the passes produced over
the window's seconds.

After the window one pass drawn from the seed is judged: its logits
against the plain reference of its variant's weights, computed in blocks
of edges on the card once the program's state is freed
(``reference/gatv2_infer.py``).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from bmk import graph as bgraph
from bmk import trace as btrace
from bmk import weights as bweights
from bmk.check import infer_numbers, judge

class Run:
    def __init__(self, cell, seed, dev):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.seed, self.dev = seed, dev
        self.setup = {}
        self.trace = None

    def build(self):
        from bliss_gnn_tpu_torch.models.gnn import build_model

        cfg, dev = self.cfg, self.dev
        m, g = cfg["model"], cfg["graph"]
        with bgraph.timed(self.setup, "graph_load"):
            indptr, src, built = bgraph.load_csc(
                cfg, os.path.join(self.cell.root, bgraph.CACHE_DIR))
        self.setup["graph_built_now"] = built
        with bgraph.timed(self.setup, "inputs"):
            self.inp = bgraph.Inputs(cfg, self.seed, dev, indptr, src)
            self.weights = [bweights.make(cfg, self.inp.gen)
                            for _ in range(self.traffic["variants"])]
        with bgraph.timed(self.setup, "device_graph"):
            self.graph = self.inp.device_graph()
        self.inp.to("cpu")
        self.weights = [{k: v.cpu() for k, v in w.items()}
                        for w in self.weights]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        dtype = getattr(torch, m["compute_dtype"])
        pdtype = getattr(torch, m["param_dtype"])
        self.models = []
        with bgraph.timed(self.setup, "models"):
            for w in self.weights:
                model = build_model(
                    m["name"], g["n_feats"], m["hidden"], g["n_classes"],
                    m["layers"], num_in_heads=m["heads"][0],
                    num_out_heads=m["heads"][-1],
                    negative_slope=m["negative_slope"], device=dev,
                    dtype=dtype, param_dtype=pdtype)
                bweights.load_into(model, w)
                model.eval()
                self.models.append(model)
        self.dtype = dtype

    def one_pass(self, i):
        from bliss_gnn_tpu_torch.models.inference import layerwise_inference

        m = self.cfg["model"]
        return layerwise_inference(
            m["name"], self.models[i % len(self.models)], self.graph,
            m["layers"], heads=tuple(m["heads"]),
            negative_slope=m["negative_slope"], dtype=self.dtype)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def warm(self):
        with bgraph.timed(self.setup, "warm_passes"):
            for i in range(len(self.models)):
                self.one_pass(i)
            self._sync()

    def window(self, seconds):
        n = max(1, round(seconds / self.traffic["nominal_pass_s"]))
        keep = int(np.random.default_rng(self.seed).integers(n))
        self._sync()
        t0 = time.perf_counter()
        for i in range(n):
            out = self.one_pass(i)
            if i == keep:
                self.kept = (i, out)
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.passes = n
        self.memory_peak = (torch.cuda.max_memory_allocated()
                            if self.dev.type == "cuda" else 0)

    def traced(self):
        """``traced_passes`` more passes after the window under the
        profiler, one warm-up pass before the slice."""
        t = btrace.Tracer()
        self.one_pass(0)
        self._sync()
        t.begin()
        self.traced_passes = self.traffic["traced_passes"]
        for i in range(self.traced_passes):
            self.one_pass(i)
        self._sync()
        t.end()
        self.trace = t.result

    def free(self):
        """Frees the models and the device graph; the judged pass's logits
        go to host memory."""
        i, out = self.kept
        self.kept = (i, out.cpu())
        self.models = self.graph = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, rounding=None):
        """The judged pass against the reference of its weights (or the
        control, ``rounding``, in the program's place). Returns (numbers,
        reference seconds)."""
        from precision import Rounding, exact_f32

        exact_f32()
        ref_mod = self.cell.reference()
        t0 = time.perf_counter()
        i, prog = self.kept
        self.inp.to(self.dev)
        w = {k: v.to(self.dev) for k, v in
             self.weights[i % len(self.weights)].items()}
        ref = ref_mod.logits(self.cfg, self.inp, w, Rounding())
        if rounding is not None:
            prog = ref_mod.logits(self.cfg, self.inp, w, rounding)
        nums = infer_numbers(prog.to(self.dev), ref)
        self.finite = bool(torch.isfinite(prog).all())
        self.inp.to("cpu")
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return nums, time.perf_counter() - t0


def run(cell, seed, seconds, trace, dev, t_start):
    """One run of an inference cell: the result's parts."""
    r = Run(cell, seed, dev)
    r.build()
    r.warm()
    setup_s = time.time() - t_start
    r.window(seconds)
    if trace:
        r.traced()
    r.free()
    nums, ref_s = r.check()
    correct, checks = judge(nums, cell.limits())
    return {
        "setup_s": setup_s, "setup": r.setup, "window_s": r.window_s,
        "attempted": r.passes, "failed": 0 if r.finite else 1,
        "e2e": {"infer_nodes_per_s": r.passes * r.inp.n_nodes / r.window_s},
        "memory_peak_bytes": r.memory_peak, "trace": r.trace,
        "correct": correct, "checks": checks, "ref_s": ref_s,
        "ctx": {"run": r},
        "notes": {"passes": r.passes,
                  "pass_ms_window": r.window_s / r.passes * 1e3,
                  "judged_pass": r.kept[0]},
    }
