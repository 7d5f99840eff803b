"""Training cells: ``Trainer.fit`` on the CLI's default path.

Set-up builds one trainer on the configuration's graph with the seed's
features, labels and weights, and drives it through a first ``fit`` of
``setup_epochs`` epochs: the eager pilot steps, the capacity refit, the
capture of the chained step (a chain of one, replayed) and of the chained
validation, a validation, and any widening of the plan that the epoch's
batches force (a widen recaptures the step, which the window must not
hold).

The window is one more ``fit`` of whole epochs (each with its validation,
its best-state snapshot and the renormalisation every
``exp3_renorm_every`` steps): ``--seconds`` over the traffic's
``nominal_epoch_s``, rounded, so every run of a cell does the same work.
``train_seeds_per_s`` is the seeds of the steps that ran over the
window's seconds.

Two groups of three steps are checked against the plain reference
(``reference/sage_train.py``), which follows each on the program's own
draws (``Recorder``):
- the start: the first three steps from the seed's weights (the trainer's
  eager pilot), which the reference follows from the same start;
- the window's path: three replayed steps at the window's final plan, run
  right after the window closes through the window's own call, which the
  reference follows from a copy of the program's state taken before them
  (parameters, Adam's moments and count, arm weights). What lies between
  is checked by itself: Adam's count equals the steps run, and every
  parameter and arm weight is finite (arms not negative).
The reference runs after the trainer is freed.
"""
from __future__ import annotations

import math
import os
import resource
import shutil
import tempfile
import time

import numpy as np
import torch

from bmk import graph as bgraph
from bmk import trace as btrace
from bmk import weights as bweights
from bmk.check import BETA1, judge, train_numbers

CHECK_STEPS = 3
# tries at three clean replayed steps after the window (a try is spoilt by
# a reported overflow or a recapture, which the trainer answers by widening)
CHECK_TRIES = 3
REPLAY = "replay."  # the prefix of the window path's numbers


def _host(t):
    return t.detach().to("cpu", copy=True)


class Logger:
    """Stands in for the trainer's ``MetricLogger``: keeps each train
    step's ``iter_time`` in memory and calls ``on_step`` after it."""

    def __init__(self, on_step):
        self.iter_time = []
        self.on_step = on_step

    def log(self, step, scalars):
        if "iter_time" in scalars:
            self.iter_time.append(scalars["iter_time"])
            self.on_step(step)

    def flush(self):
        pass

    def close(self):
        pass


class Recorder:
    """The program's random draws in its last train step, where the step
    makes them: the blocks that ``sample_blocks`` returned (which src nodes
    the Bernoulli draws selected) and each dropout's input and output. An
    eager step makes these tensors anew; a captured step makes them once,
    in its CUDA graph's memory, and every replay writes its values into
    them. The recorder keeps them referenced, so the capture cannot give
    their memory to another of its tensors: after a replay they hold that
    replay's draws. Calls under ``no_grad`` (validation) are left out.
    It wraps the port's functions by reference, for the whole run."""

    def __init__(self):
        import bliss_gnn_tpu_torch.models.gnn as gnn
        import bliss_gnn_tpu_torch.models.layers as layers
        import bliss_gnn_tpu_torch.train.steps as steps

        self.targets = [(steps, "sample_blocks"), (gnn, "dropout"),
                        (layers, "dropout")]
        self.saved = [getattr(m, n) for m, n in self.targets]
        self.blocks, self.drops, self.calls = None, [], 0
        sample, drop = self.saved[0], self.saved[1]

        def sample_blocks(*a, **k):
            out = sample(*a, **k)
            if torch.is_grad_enabled():
                self.blocks, self.drops = out[0], []
                self.calls += 1
            return out

        def dropout(h, p, generator):
            out = drop(h, p, generator)
            if p > 0 and torch.is_grad_enabled():
                self.drops.append((h, out))
            return out

        for (m, n), fn in zip(self.targets,
                              (sample_blocks, dropout, dropout)):
            setattr(m, n, fn)

    def uninstall(self):
        for (m, n), fn in zip(self.targets, self.saved):
            setattr(m, n, fn)
        self.blocks, self.drops = None, []

    def take(self):
        """Host copies of the last train step's blocks and keep masks."""
        blocks = [{f: _host(getattr(b, f)) for f in (
            "src_gids", "src_mask", "e_src", "e_dst", "e_mask", "eid",
            "src_node_prob")} | {"n_dst_cap": b.n_dst_cap}
            for b in self.blocks]
        keep = [_host((out != 0) | (h == 0)) for h, out in self.drops]
        return {"blocks": blocks, "keep": keep}


def _changed_arms(exp3, n_edges, base):
    """Per layer (eids int32, values f32) of the arm weights that differ
    from ``base`` (the same layout; None: from one)."""
    arms = exp3[:, :n_edges]
    out = []
    for l in range(arms.shape[0]):
        ref = 1 if base is None else base[l, :n_edges]
        eids = torch.nonzero(arms[l] != ref).squeeze(1)
        out.append((_host(eids.to(torch.int32)), _host(arms[l][eids].float())))
    return out


class Checked:
    """``CHECK_STEPS`` consecutive steps of the program from step
    ``first``: each step's draws and loss, whether it reported an overflow
    or drew outside a replay, the first gradient as Adam got it (its first
    moment after the step, less beta1 times the one before, over
    1 - beta1), and after the last step the parameters and the arm weights
    that changed. ``start``: the state before the first step (None: the
    seed's weights, Adam unstarted, arms at one)."""

    def __init__(self, first, start=None):
        self.first, self.start = first, start
        self.steps, self.losses = [], []
        self.spoilt = 0
        self.grad1 = self.params3 = self.arms3 = None

    def done(self):
        return self.params3 is not None

    def on_step(self, tr, step, metrics, recorder, replayed):
        i = step - self.first
        if not 0 <= i < CHECK_STEPS:
            return
        self.steps.append(recorder.take())
        self.losses.append(float(metrics["train_loss"]))
        self.spoilt += sum(float(v) > 0 for k, v in metrics.items()
                           if "overflow" in k) + (not replayed)
        state = tr.state
        named = dict(state.model.named_parameters())
        if i == 0:
            m0 = (self.start or {}).get("m", {})
            self.grad1 = {}
            for k, p in named.items():
                m1 = _host(state.optimizer.state[p].get(
                    "exp_avg", torch.zeros_like(p))).float()
                before = m0.get(k)
                if before is not None:
                    m1 = m1 - BETA1 * before
                self.grad1[k] = m1 / (1.0 - BETA1)
        if i == CHECK_STEPS - 1:
            self.params3 = {k: _host(p).float() for k, p in named.items()}
            base = None if self.start is None else self.start["arms_dev"]
            self.arms3 = _changed_arms(state.exp3_weights,
                                       tr.host_graph.n_edges, base)
            if self.start is not None:
                del self.start["arms_dev"]

    def program_side(self):
        if not self.done():
            raise RuntimeError(f"{len(self.steps)} of {CHECK_STEPS} checked "
                               f"steps ran")
        return {"losses": self.losses, "grad1": self.grad1,
                "params3": self.params3, "arms3": self.arms3}


def _trainer_class():
    from bliss_gnn_tpu_torch.train.trainer import Trainer

    class BenchTrainer(Trainer):
        """The trainer with the benchmark's spans: each step's raw metrics
        (the sampled node and edge counts, the loss), and the host seconds
        of each validation and each best-state snapshot."""

        bench = None

        def _log_train_step(self, metrics, prev_t, fb_time):
            if self.bench is not None:
                self.bench.step_metrics(self, metrics)
            super()._log_train_step(metrics, prev_t, fb_time)

        def _rebuild_steps(self):
            super()._rebuild_steps()
            if self.bench is not None:  # a refit or a widen: a new capture
                self.bench.rebuilds.append(self.global_step)

        def _validate(self, epoch):
            t0 = time.perf_counter()
            out = super()._validate(epoch)
            if self.bench is not None:
                self.bench.val_spans.append(time.perf_counter() - t0)
            return out

        def _snapshot(self):
            t0 = time.perf_counter()
            out = super()._snapshot()
            if self.bench is not None:
                self.bench.snap_spans.append(time.perf_counter() - t0)
            return out

    return BenchTrainer


class Run:
    def __init__(self, cell, seed, dev):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.seed, self.dev = seed, dev
        self.setup = {}
        self.val_spans, self.snap_spans = [], []
        self.counts = []  # per step: [num_nodes/0..L, num_edges/0..L-1]
        self.losses = []
        self.rebuilds = []  # the steps at which the plan was rebuilt
        self.recorder = None
        self.groups = []  # the Checked groups, the start first
        self.calls_seen = 0
        self.prof_steps = None
        self.trace = None
        self.replay_tries = 0

    # -- the trainer's hooks ---------------------------------------------
    def step_metrics(self, tr, metrics):
        L = self.cfg["model"]["layers"]
        self.counts.append([float(metrics[f"num_nodes/{i}"])
                            for i in range(L + 1)]
                           + [float(metrics[f"num_edges/{i}"])
                              for i in range(L)])
        self.losses.append(float(metrics["train_loss"]))
        rec = self.recorder
        if rec is None:
            return
        # a step drew through the wrapper: eager, a warm-up or a capture
        replayed = rec.calls == self.calls_seen
        self.calls_seen = rec.calls
        if self.groups and not self.groups[-1].done():
            self.groups[-1].on_step(tr, tr.global_step, metrics, rec,
                                    replayed or not tr._replays)

    def _on_logged(self, step):
        if self.prof_steps is None:
            return
        first, begin, end = self.prof_steps
        if step == first:
            self.tracer = btrace.Tracer()
        elif step == begin:
            self.tracer.begin()
        elif step == end:
            self.tracer.end()
            self.trace = self.tracer.result

    # -- set-up ----------------------------------------------------------
    def build(self):
        cfg, t, dev = self.cfg, self.traffic, self.dev
        with bgraph.timed(self.setup, "graph_load"):
            indptr, src, built = bgraph.load_csc(
                cfg, os.path.join(self.cell.root, bgraph.CACHE_DIR))
        self.setup["graph_built_now"] = built
        with bgraph.timed(self.setup, "inputs"):
            self.inp = bgraph.Inputs(cfg, self.seed, dev, indptr, src)
            self.w0 = bweights.make(cfg, self.inp.gen)
        with bgraph.timed(self.setup, "host_graph"):
            hg = self.inp.host_graph()
        self.inp.to("cpu")
        self.w0 = {k: v.cpu() for k, v in self.w0.items()}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        m, s = cfg["model"], cfg["sampler"]
        from bliss_gnn_tpu_torch.train.trainer import TrainConfig

        self.logdir = tempfile.mkdtemp(prefix="bench_train_")
        tcfg = TrainConfig(
            dataset=cfg["name"], model=m["name"], sampler=s["kind"],
            fan_out=tuple(s["fanouts"]), batch_size=s["batch_size"],
            num_hidden=m["hidden"], num_layers=m["layers"], lr=m["lr"],
            lr_gamma=m["lr_gamma"], lr_step_size=m["lr_step_epochs"],
            dropout=m["dropout"], eta=s["eta"],
            num_in_heads=m.get("heads", [4])[0],
            num_out_heads=m.get("heads", [1])[-1],
            negative_slope=m.get("negative_slope", 0.2),
            exp3_delta=s["exp3_delta"], poisson_eps=s["poisson_eps"],
            compute_dtype=m["compute_dtype"], param_dtype=m["param_dtype"],
            exp3_dtype=m["exp3_dtype"], seed=self.seed % (1 << 62),
            disable_checkpoint=True, logdir=self.logdir,
            steps_per_call=t["steps_per_call"],
            eval_steps_per_call=t["eval_steps_per_call"],
            refit_after=t["refit_after"],
            exp3_renorm_every=t["exp3_renorm_every"], num_steps=1)
        import bliss_gnn_tpu_torch.train.trainer as trainer_mod

        # the trainer logs through the benchmark's logger (its own would
        # write a CSV and load TensorBoard)
        logger = Logger(self._on_logged)
        saved, trainer_mod.MetricLogger = (trainer_mod.MetricLogger,
                                           lambda run_dir: logger)
        try:
            with bgraph.timed(self.setup, "trainer_init"):
                tr = _trainer_class()(tcfg, graph=hg, n_classes=cfg["graph"][
                    "n_classes"], multilabel=False, device=dev)
        finally:
            trainer_mod.MetricLogger = saved
        with bgraph.timed(self.setup, "trainer_init"):
            tr.bench = self
            bweights.load_into(tr.state.model, self.w0)
        self.tr = tr
        self.spe = tr.steps_per_epoch

    def warm(self):
        """The set-up's ``fit``: pilot, refit, captures, ``setup_epochs``
        epochs with their validation; the first three steps checked."""
        tr = self.tr
        self.recorder = Recorder()
        self.groups.append(Checked(first=1))
        tr.cfg.num_steps = max(CHECK_STEPS,
                               self.traffic["setup_epochs"] * self.spe)
        with bgraph.timed(self.setup, "pilot_capture_validation"):
            tr.fit()
        self._sync()
        self.val_s = self.val_spans[-1]

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # -- the window --------------------------------------------------------
    def window(self, seconds):
        tr = self.tr
        # a fixed amount of work for a given --seconds: whole epochs at the
        # traffic's nominal epoch length
        epochs = max(1, round(seconds / self.traffic["nominal_epoch_s"]))
        n = epochs * self.spe
        s0 = len(self.counts)
        g0 = tr.global_step
        widens0 = tr.n_widens
        self.setup_widens = tr.n_widens
        v0, p0 = len(self.val_spans), len(self.snap_spans)
        i0 = len(tr.logger.iter_time)
        tr.cfg.num_steps = g0 + n
        self._sync()
        host0 = _host_usage()
        t0 = time.perf_counter()
        tr.fit()
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.host = {k: v - host0[k] for k, v in _host_usage().items()}
        self.steps = tr.global_step - g0
        self.win_counts = self.counts[s0:]
        self.win_val = self.val_spans[v0:]
        self.win_snap = self.snap_spans[p0:]
        self.win_iter = tr.logger.iter_time[i0:]
        if self.steps != n or len(self.win_iter) != n:
            raise RuntimeError(f"the window ran {self.steps} steps "
                               f"({len(self.win_iter)} logged) of {n}")
        self.seeds = self.steps * tr.batch_size
        self.epochs = epochs
        self.failed = sum(not math.isfinite(x) for x in self.losses[s0:])
        self.widens = tr.n_widens - widens0
        self.memory_peak = (torch.cuda.max_memory_allocated()
                            if self.dev.type == "cuda" else 0)

    def _state_copy(self):
        """A host copy of the program's state before a checked group, and
        the faults found in it by itself: leaves whose Adam count is not
        the number of steps run, non-finite parameters, arm weights that
        are not finite or are negative."""
        tr = self.tr
        s = tr.state
        steps = len(self.counts)
        named = dict(s.model.named_parameters())
        faults = 0
        m, v = {}, {}
        for k, p in named.items():
            st = s.optimizer.state[p]
            faults += int("step" not in st or float(st["step"]) != steps)
            faults += int((~torch.isfinite(p)).sum())
            zero = torch.zeros_like(p)
            m[k] = _host(st.get("exp_avg", zero))
            v[k] = _host(st.get("exp_avg_sq", zero))
        arms = s.exp3_weights[:, :tr.host_graph.n_edges]
        faults += int((~(torch.isfinite(arms) & (arms >= 0))).sum())
        # an arm that underflowed to zero stays there (a finding, no fault)
        self.zero_arms = (arms == 0).sum(dim=1).tolist()
        return {"params": {k: _host(p).float() for k, p in named.items()},
                "m": m, "v": v, "t": steps,
                "arms": _host(arms), "arms_dev": s.exp3_weights.clone(),
                "stage_faults": float(faults)}

    def replay_check(self):
        """Three steps of the window's own call at its final plan, after
        the window, each a replay of the captured step; a try that
        reports an overflow or recaptures is run again."""
        tr = self.tr
        for _ in range(CHECK_TRIES):
            self.replay_tries += 1
            group = Checked(first=tr.global_step + 1,
                            start=self._state_copy())
            self.groups[1:] = [group]
            self.calls_seen = self.recorder.calls
            tr.cfg.num_steps = tr.global_step + CHECK_STEPS
            tr.fit()
            if group.done() and not group.spoilt:
                return

    def traced(self):
        """``traced_steps`` more steps after the window under the profiler,
        four warm-up steps before the slice."""
        tr, k = self.tr, self.traffic["traced_steps"]
        g = tr.global_step
        self.prof_steps = (g + 1, g + 5, g + 5 + k)
        self.traced_steps = k
        tr.cfg.num_steps = g + 5 + k
        tr.fit()
        self.prof_steps = None

    def sampler_ms(self):
        """The sampler alone at the trainer's final plan, replayed from a
        CUDA graph after two eager calls: the median of 20 synced replays
        (a copy of ``bench_torch.py``'s ``sampler_ms``)."""
        from bliss_gnn_tpu_torch.sampling.samplers import sample_blocks

        tr, dev = self.tr, self.dev
        gen = torch.Generator(device=dev).manual_seed(self.seed % (1 << 62))
        ids = torch.from_numpy(tr.train_nid[:tr.batch_size].copy()).to(dev)
        smask = torch.ones(tr.batch_size, dtype=torch.bool, device=dev)

        def sample():
            return sample_blocks(tr.graph, tr.sampler_cfg, tr.plan, gen, ids,
                                 smask, tr.state.exp3_weights)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                sample()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(gen)
        with torch.cuda.graph(g):
            sample()
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.replay()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del g
        return float(np.median(times))

    def free(self):
        """Frees the trainer and its captured graphs before the reference
        runs."""
        if self.recorder is not None:
            self.recorder.uninstall()
        self.tr = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        shutil.rmtree(self.logdir, ignore_errors=True)

    # -- the check -----------------------------------------------------------
    def check(self, rounding=None):
        """The reference over each checked group, on the device, and the
        numbers against the program's (or, with ``rounding``, against the
        control's: the reference in that rounding in the program's place).
        Returns (numbers, reference seconds)."""
        from precision import Rounding, exact_f32

        exact_f32()
        t0 = time.perf_counter()
        dev = self.dev
        self.inp.to(dev)
        ref_mod = self.cell.reference()
        min_change = self.cfg["check"]["exp3_min_change"]
        nums = {}
        self.worst_leaves = []
        if len(self.groups) < 2:
            raise RuntimeError("no replayed steps were checked")
        for i, group in enumerate(self.groups):
            start = None if group.start is None else _to(
                {k: group.start[k] for k in ("params", "m", "v", "t",
                                             "arms")}, dev)
            p0 = (start or {}).get("params") or {
                k: v.to(dev) for k, v in self.w0.items()}
            recs = [_to(r, dev) for r in group.steps]
            ref_side = _follow(ref_mod, self.cfg, self.inp, p0, recs,
                               Rounding(), start)
            side = group.program_side()
            base = None if start is None else start["arms"].float()
            if rounding is not None:  # the control in the program's place
                ctl = _follow(ref_mod, self.cfg, self.inp, p0, recs,
                              rounding, start)
                cbase = (torch.ones_like(ctl["arms_full"]) if base is None
                         else rounding.a(base))
                side = {**ctl, "arms3": [
                    (torch.nonzero(a != b).squeeze(1), a[a != b])
                    for a, b in zip(ctl["arms_full"], cbase)]}
                base = cbase
                ref_side["prob_gap"] = max(
                    float(((pc - pr).abs() / pr)[pr > 0].max())
                    for pc, pr in zip(ctl["p_slots"], ref_side["p_slots"]))
                ref_side["block_faults"] = 0
            worst = []
            out = train_numbers(_to(side, dev), ref_side, p0, min_change,
                                base, worst)
            self.worst_leaves.append(worst)
            if start is not None:
                out["stage_faults"] = (0.0 if rounding is not None
                                       else group.start["stage_faults"])
            prefix = "" if i == 0 else REPLAY
            nums.update({prefix + k: v for k, v in out.items()})
            del ref_side, side, start, base
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        self.inp.to("cpu")
        return nums, time.perf_counter() - t0


def _host_usage():
    """This process's CPU seconds and context switches so far: whether the
    host's share of a window was slow because the process waited for a
    core (involuntary switches) or worked longer."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "voluntary_switches": ru.ru_nvcsw,
            "involuntary_switches": ru.ru_nivcsw}


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _follow(ref_mod, cfg, inp, p0, recs, rounding, start):
    """The reference (or the control) through the recorded steps of a
    group, from the seed's weights or from ``start``."""
    ref = ref_mod.Train(cfg, inp, p0, rounding, start)
    losses, touched, faults, p_gap, p_slots = [], [], 0, 0.0, []
    grad1 = None
    for i, rec in enumerate(recs):
        out = ref.step(rec)
        losses.append(out["loss"])
        if i == 0:
            grad1 = out["grads"]
        touched.append(out["touched"])
        faults += out["faults"] + out["edges_differ"]
        p_gap = max(p_gap, out["prob_gap"])
        p_slots += out["p_slots"]
    L = len(touched[0])
    return {"losses": losses, "grad1": grad1, "params3": ref.params,
            "arms_full": ref.arms,
            "touched": [[t[l] for t in touched] for l in range(L)],
            "block_faults": faults, "prob_gap": p_gap, "p_slots": p_slots}


def run(cell, seed, seconds, trace, dev, t_start):
    """One run of a training cell: the result's parts."""
    r = Run(cell, seed, dev)
    r.build()
    r.warm()
    setup_s = time.time() - t_start
    r.window(seconds)
    r.replay_check()
    ctx = {"run": r}
    if trace:
        r.traced()
        if dev.type == "cuda":
            ctx["sampler_ms"] = r.sampler_ms()
    r.free()
    nums, ref_s = r.check()
    correct, checks = judge(nums, cell.limits())
    L = cell.cfg["model"]["layers"]
    return {
        "setup_s": setup_s, "setup": r.setup, "window_s": r.window_s,
        "attempted": r.steps, "failed": r.failed,
        "e2e": {"train_seeds_per_s": r.seeds / r.window_s},
        "memory_peak_bytes": r.memory_peak, "trace": r.trace,
        "correct": correct, "checks": checks, "ref_s": ref_s, "ctx": ctx,
        "notes": {"epochs": r.epochs, "steps": r.steps,
                  "val_s_setup": r.val_s, "widens_in_setup": r.setup_widens,
                  "widens_in_window": r.widens, "rebuild_steps": r.rebuilds,
                  "replay_check_tries": r.replay_tries,
                  "check_worst_leaves": r.worst_leaves,
                  "zero_arms_by_layer": r.zero_arms,
                  "window_epoch_step_ms_median": [
                      1e3 * float(np.median(r.win_iter[e * r.spe:
                                                       (e + 1) * r.spe]))
                      for e in range(r.epochs)],
                  # the sampled nodes and edges a step, all layers, by epoch
                  "window_epoch_nodes_edges_mean": [
                      [float(np.mean([sum(c[:L + 1]) for c in part])),
                       float(np.mean([sum(c[L + 1:]) for c in part]))]
                      for part in (r.win_counts[e * r.spe:(e + 1) * r.spe]
                                   for e in range(r.epochs))],
                  "window_steps_s": sum(r.win_iter),
                  "window_val_s": sum(r.win_val),
                  "window_snapshot_s": sum(r.win_snap),
                  "window_host": r.host,
                  "window_step_ms_quartiles": [
                      1e3 * float(q) for q in np.percentile(
                          r.win_iter, [10, 25, 50, 75, 90])],
                  "window_step_ms_median": 1e3 * float(np.median(r.win_iter)),
                  "window_step_ms_max": 1e3 * max(r.win_iter)},
    }
