"""The training harness for one device (counterpart of ``TrainConfig`` and
``Trainer`` in ``bliss_gnn_tpu/train/trainer.py``):

- graph preparation: load, canonicalise, per-dst normalised edge weights,
  splits, the capacity plan, the upload;
- per-step training with EMA'd sampled node and edge counts, iteration and
  forward/backward timers and train micro-F1; the first ``refit_after``
  steps eager, then chains of ``steps_per_call`` (on the card one captured
  step replayed per batch);
- capacity refit from the pilot steps' maxima, widened 1.5x after an
  overflow;
- sampled validation each epoch, in chains of ``eval_steps_per_call``;
- Adam with a staircase decay, the deferred EXP3 row renormalisation;
- checkpoint of the best state, restore and resume, early stopping, the
  vertex-limit batch controller;
- full-graph layerwise inference and micro-F1 per split (K6 for SAGE and
  GCN, K7 for GATv2 on the card).

Checkpoints are ``torch.save`` files at ``<run_dir>/checkpoints/best``. A
state is restored by copying into the live tensors (parameters, Adam's
moments and counts, the arm weights) and the generator's state, never by
replacing them: a step captured in a CUDA graph keeps reading the tensors
it was captured with.

Not ported (each raises ``NotImplementedError``): data parallelism and the
sharded graph (ROADMAP Queue 1 item 6), the host-resident feature cache
(item 5), f32 compute and bf16 parameters.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph.datasets import load_dataset
from bliss_gnn_tpu_torch.graph.structure import (
    DeviceGraph,
    Graph,
    normalized_edata,
)
from bliss_gnn_tpu_torch.models.gnn import build_model
from bliss_gnn_tpu_torch.models.inference import layerwise_inference
from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
from bliss_gnn_tpu_torch.sampling.samplers import (
    SamplerConfig,
    init_exp3_weights,
    normalize_exp3_weights,
)
from bliss_gnn_tpu_torch.train.metrics import (
    EmaCounter,
    F1State,
    Welford,
    f1_compute,
    f1_update,
)
from bliss_gnn_tpu_torch.train.steps import (
    TrainState,
    _pack,
    _unpack,
    make_eval_step,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
)
from bliss_gnn_tpu_torch.utils.logging import MetricLogger, next_version_dir

@dataclasses.dataclass
class TrainConfig:
    """The CLI's flag surface plus the reference's buried constants, with
    the reference package's fields and defaults."""

    dataset: str = "cora"
    model: str = "sage"
    sampler: str = "poisson-bandit"
    fan_out: Tuple[int, ...] = (16384, 8192, 4096)
    batch_size: int = 1024
    num_hidden: int = 256
    num_layers: int = 3
    lr: float = 0.002
    dropout: float = 0.1
    eta: float = 0.1
    importance_sampling: bool = True
    num_epochs: int = -1
    num_steps: int = -1
    min_steps: int = 0
    num_in_heads: int = 4
    num_out_heads: int = 1
    attn_dropout: float = 0.1
    negative_slope: float = 0.2
    residual: bool = False
    undirected: bool = False
    val_acc_target: float = 1.0
    early_stopping_patience: int = 1000
    disable_checkpoint: bool = False
    logdir: str = "tb_logs"
    vertex_limit: int = -1
    seed: int = 0
    ema_w: float = 0.99
    exp3_delta: float = 0.01
    # the paper's per-dst EXP3 learning rate instead of the constant (T =
    # num_steps when positive, else 5000)
    exp3_delta_formula: bool = False
    # the step leaves the arm weights unnormalised (every consumer
    # renormalises per dst); renormalise the rows every this many steps
    exp3_renorm_every: int = 64
    poisson_eps: float = 0.9999
    lr_gamma: float = 0.01
    lr_step_size: int = 5
    frontier_slack: float = 8.0
    block_edge_slack: float = 4.0
    max_frontier_edges: Optional[int] = None
    # after this many measured steps, tighten the frontier and kept-edge
    # caps to the measured maxima times the refit slacks (0 disables); an
    # overflow after that widens the plan by 1.5x
    refit_after: int = 3
    refit_block_edge_slack: float = 1.6
    refit_frontier_slack: float = 1.25
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    exp3_dtype: str = "bfloat16"
    # torch.profiler trace of the steps from step 2 into <run_dir>/profile
    profile_steps: int = 0
    resume: str = ""  # checkpoint file to restore before training
    use_uva: bool = False
    cache_size: int = 0
    # train steps per chained call (on the card: replays of one captured
    # step); 1 runs every step eagerly
    steps_per_call: int = 1
    # validation batches per chained call; 1 runs each eagerly
    eval_steps_per_call: int = 8
    # the reference's choice of TPU layout for the final eval; every value
    # runs K6 (SAGE, GCN) or K7 (GATv2) on the card here
    inference_backend: str = "auto"
    dp: int = 1
    shard_graph: bool = False
    shard_indptr: Optional[bool] = None

    @property
    def run_name(self) -> str:
        return (
            f"paper_{self.model}_{self.dataset}_{self.sampler}_"
            f"{int(self.importance_sampling)}_steps_{self.num_steps}_bs_"
            f"{self.batch_size}_layers_{self.num_layers}_lr_{self.lr}_"
            f"eta_{self.eta}"
        )


def _check_supported(cfg: TrainConfig, device: torch.device) -> None:
    if cfg.dp != 1 or cfg.shard_graph:
        raise NotImplementedError(
            "data parallelism and the sharded graph (--dp, --shard-graph) "
            "are not ported yet (ROADMAP Queue 1 item 6)")
    if cfg.use_uva:
        raise NotImplementedError(
            "the host-resident feature cache (--use-uva) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if cfg.compute_dtype != "bfloat16" or cfg.param_dtype != "float32":
        raise NotImplementedError(
            "the port's models compute in bf16 with f32 parameters; f32 "
            "compute (--precision highest) and bf16 parameters are not "
            "ported yet (ROADMAP Queue 1 item 7)")
    if cfg.exp3_dtype != "bfloat16" and device.type == "cuda":
        raise NotImplementedError(
            "K4 updates bf16 arm weights only (ROADMAP Queue 1 item 7)")


def _metrics_to_host(metrics: Dict[str, object], device: torch.device,
                     chained: bool) -> List[Dict[str, object]]:
    """A step's metrics, or a chain's stacked over K, copied to the host in
    one transfer: one dict per step, each value a float and ``f1`` an
    ``F1State`` of CPU scalars."""
    vec, layout = _pack(metrics, device)
    rows = vec.cpu().T if chained else vec.cpu()[None]  # [K, n]
    cols = _unpack(rows, layout)
    return [{name: (F1State(*(t[k] for t in vars(v).values()))
                    if isinstance(v, F1State) else float(v[k]))
             for name, v in cols.items()} for k in range(rows.shape[0])]


class Trainer:
    """Trains ``cfg`` on ``graph`` (a canonicalised host ``Graph`` with the
    normalised weights in ``edata["w"]``), or on ``cfg.dataset`` when no
    graph is given, on ``device``: the card by default (raises without
    one), ``"cpu"`` for the plain PyTorch path."""

    def __init__(self, cfg: TrainConfig, graph: Optional[Graph] = None,
                 n_classes: Optional[int] = None,
                 multilabel: Optional[bool] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        _check_supported(cfg, self.device)
        self.dp = 1
        if graph is None:
            graph, n_classes, multilabel = load_dataset(cfg.dataset)
            graph = Graph.canonicalize(graph, undirected=cfg.undirected)
            graph.edata["w"] = normalized_edata(graph)
        self.host_graph = graph
        self.n_classes = n_classes
        self.multilabel = multilabel
        self.graph = DeviceGraph.from_graph(graph, device=self.device,
                                            feature_dtype=torch.bfloat16)
        self.train_nid = np.where(graph.ndata["train_mask"])[0].astype(
            np.int32)
        self.val_nid = np.where(graph.ndata["val_mask"])[0].astype(np.int32)
        self.test_nid = np.where(graph.ndata["test_mask"])[0].astype(
            np.int32)

        fanouts = tuple(cfg.fan_out[:cfg.num_layers])
        assert len(fanouts) == cfg.num_layers, (
            f"need {cfg.num_layers} fan-outs, got {fanouts}")
        self.sampler_cfg = SamplerConfig(
            kind=cfg.sampler, fanouts=fanouts,
            importance_sampling=cfg.importance_sampling, eta=cfg.eta,
            poisson_eps=cfg.poisson_eps, exp3_delta=cfg.exp3_delta,
            exp3_delta_formula=cfg.exp3_delta_formula,
            exp3_T=cfg.num_steps if cfg.num_steps > 0 else 5000,
            model=cfg.model)
        self.model = build_model(
            cfg.model, int(graph.ndata["features"].shape[1]), cfg.num_hidden,
            n_classes, cfg.num_layers, dropout=cfg.dropout,
            num_in_heads=cfg.num_in_heads, num_out_heads=cfg.num_out_heads,
            attn_drop=cfg.attn_dropout, negative_slope=cfg.negative_slope,
            residual=cfg.residual, device=self.device, seed=cfg.seed)
        self.batch_size = min(cfg.batch_size, max(1, len(self.train_nid)))
        self.steps_per_epoch = max(1, len(self.train_nid) // self.batch_size)
        self.n_refits = self.n_widens = 0
        self._build_for_batch_size(self.batch_size, init_state=True)

        base = os.path.join(cfg.logdir, cfg.run_name)
        self.run_dir = next_version_dir(base)
        self.logger = MetricLogger(self.run_dir)
        self.ema_nodes = [EmaCounter(cfg.ema_w)
                          for _ in range(cfg.num_layers + 1)]
        self.ema_edges = [EmaCounter(cfg.ema_w)
                          for _ in range(cfg.num_layers)]
        self.welford = Welford()
        self.best_val_acc = -1.0
        self.best_state = None
        self.global_step = 0
        self._stop = False
        self._epochs_since_improve = 0
        self._last_renorm_step = 0
        self.checkpoint_failures = 0
        self._checkpoint_saved = False
        self._profiler = None
        # validation draws: reseeded from seed + 1000 + epoch before each
        # validation, so one captured chained eval serves every epoch
        self._eval_gen = torch.Generator(device=self.device)
        self._save_hparams()
        if cfg.resume:
            self._check_resume_hparams(cfg.resume)
            self.load_checkpoint(cfg.resume)
            self.global_step = self.state.step
            print(f"[resume] restored step {self.global_step} from "
                  f"{cfg.resume}")

    # -- hyperparameter record -------------------------------------------
    def _save_hparams(self):
        """The resolved config and the current capacity plan as
        ``<run_dir>/hparams.json``, rewritten whenever the plan changes."""
        if not hasattr(self, "run_dir"):
            return
        payload = {
            "config": dataclasses.asdict(self.cfg),
            "capacity_plan": dataclasses.asdict(self.plan),
            "batch_size": self.batch_size,
            "dp": self.dp,
            "n_classes": self.n_classes,
            "multilabel": bool(self.multilabel),
        }
        with open(os.path.join(self.run_dir, "hparams.json"), "w") as f:
            json.dump(payload, f, indent=1, default=str)

    def _check_resume_hparams(self, ckpt_path: str):
        """Warns about config keys that differ from the resumed run's
        ``hparams.json`` (a larger ``num_steps`` is legitimate)."""
        run_dir = os.path.dirname(os.path.dirname(os.path.abspath(ckpt_path)))
        path = os.path.join(run_dir, "hparams.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            saved = json.load(f).get("config", {})
        cur = json.loads(json.dumps(dataclasses.asdict(self.cfg),
                                    default=str))
        diffs = {k: (saved[k], cur[k]) for k in saved
                 if k in cur and saved[k] != cur[k]
                 and k not in ("resume", "logdir")}
        if diffs:
            warnings.warn(
                f"[resume] config differs from the checkpointed run's "
                f"hparams.json: {diffs}", RuntimeWarning, stacklevel=2)

    # -- static-shape (re)build ------------------------------------------
    def _build_for_batch_size(self, batch_size: int, init_state: bool):
        cfg = self.cfg
        g = self.host_graph
        self.batch_size = batch_size
        indeg = g.in_degrees()
        self._max_degree = int(indeg.max())
        self.plan = CapacityPlan.build(
            batch_size, self.sampler_cfg.fanouts, g.n_nodes, g.n_edges,
            kind=cfg.sampler, frontier_slack=cfg.frontier_slack,
            block_edge_slack=cfg.block_edge_slack,
            max_frontier_edges=cfg.max_frontier_edges,
            deg_std=float(indeg.std()), max_degree=self._max_degree)
        self._refit_done = False
        self._refit_max: Dict[str, float] = {}
        self._overflow_after_refit = False
        self._frontier_overflow_after_refit = False
        if init_state:
            opt, sched = make_optimizer(
                self.model.parameters(), cfg.lr, self.steps_per_epoch,
                cfg.lr_gamma, cfg.lr_step_size,
                capturable=self.device.type == "cuda")
            exp3 = (init_exp3_weights(
                cfg.num_layers, g.n_edges, device=self.device,
                dtype=getattr(torch, cfg.exp3_dtype))
                if self.sampler_cfg.is_bandit else None)
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.state = TrainState(self.model, opt, sched, exp3, gen)
        else:
            # the schedule's period follows the epoch length, at Adam's count
            self.state.scheduler.reset(
                max(1, cfg.lr_step_size * self.steps_per_epoch),
                self.state.step)
        self._rebuild_steps()

    def _rebuild_steps(self):
        """The step functions for the current ``self.plan``. The chained
        steps are dropped first: each holds a captured CUDA graph and its
        memory pool, which the caching allocator then releases."""
        cfg = self.cfg
        self._save_hparams()
        self.multi_step = self.multi_eval = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        args = (self.graph, self.sampler_cfg, self.plan, self.multilabel)
        self.train_step = make_train_step(*args, device=self.device)
        self.eval_step = make_eval_step(*args, device=self.device)
        if cfg.steps_per_call > 1:
            # chains of any length replay the one captured step
            self.multi_step = make_multi_train_step(*args,
                                                    device=self.device)
        if cfg.eval_steps_per_call > 1:
            self.multi_eval = make_multi_eval_step(*args, device=self.device)

    # -- epoch loops -----------------------------------------------------
    def _epoch_batches(self, rng: np.random.Generator) -> np.ndarray:
        ids = rng.permutation(self.train_nid)
        n_full = len(ids) // self.batch_size  # drop_last=True
        return ids[:n_full * self.batch_size].reshape(n_full,
                                                      self.batch_size)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def fit(self):
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        max_steps = cfg.num_steps if cfg.num_steps > 0 else math.inf
        max_epochs = cfg.num_epochs if cfg.num_epochs > 0 else math.inf
        if max_steps is math.inf and max_epochs is math.inf:
            max_epochs = 1000
        epoch = 0
        prev_t = time.time()
        while (epoch < max_epochs and self.global_step < max_steps
               and not self._stop):
            batches = self._epoch_batches(rng)
            smask = torch.ones(self.batch_size, dtype=torch.bool,
                               device=self.device)
            K = cfg.steps_per_call if self.multi_step is not None else 1
            b = 0
            while b < batches.shape[0]:
                # the pilot steps run unchained: the refit replaces their
                # plan a moment later
                pilot = cfg.refit_after > 0 and not self._refit_done
                chain = (K > 1 and not pilot and b + K <= batches.shape[0]
                         and self.global_step + K <= max_steps
                         and cfg.profile_steps == 0)
                if chain:
                    seeds = self._to_device(batches[b:b + K])
                    masks = torch.ones((K, self.batch_size),
                                       dtype=torch.bool, device=self.device)
                    st = time.time()
                    self.state, mstack = self.multi_step(self.state, seeds,
                                                         masks)
                    mstack = _metrics_to_host(mstack, self.device, True)
                    fb_time = (time.time() - st) / K
                    for metrics in mstack:
                        self.global_step += 1
                        self._log_train_step(metrics, prev_t, fb_time)
                        prev_t = time.time()
                        self.welford.push(float(metrics["num_nodes/0"]))
                    b += K
                else:
                    seeds = self._to_device(batches[b])
                    if cfg.profile_steps > 0 and self.global_step == 2:
                        self._start_profile()
                    st = time.time()
                    self.state, metrics = self.train_step(self.state, seeds,
                                                          smask)
                    metrics, = _metrics_to_host(metrics, self.device,
                                                False)
                    fb_time = time.time() - st
                    if (cfg.profile_steps > 0
                            and self.global_step == 2 + cfg.profile_steps):
                        self._stop_profile()
                    self.global_step += 1
                    self._log_train_step(metrics, prev_t, fb_time)
                    prev_t = time.time()
                    self.welford.push(float(metrics["num_nodes/0"]))
                    b += 1
                self._maybe_renorm_exp3()
                self._maybe_capacity_refit()
                if self.global_step >= max_steps:
                    break
            epoch += 1
            val_acc = self._validate(epoch)
            self._maybe_checkpoint(val_acc)
            self._early_stopping(val_acc)
            self._vertex_limit_controller()
        self._stop_profile()
        self.logger.flush()
        return self

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self):
        """Ends a running trace and writes it to ``<run_dir>/profile``."""
        if self._profiler is None:
            return
        self._profiler.stop()
        out = os.path.join(self.run_dir, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(
            os.path.join(out, f"trace_step{self.global_step}.json"))
        self._profiler = None

    def _log_train_step(self, metrics, prev_t, fb_time):
        cfg = self.cfg
        scalars = {}
        for i in range(cfg.num_layers):
            scalars[f"num_nodes/{i}"] = self.ema_nodes[i].push(
                float(metrics[f"num_nodes/{i}"]))
            scalars[f"num_edges/{i}"] = self.ema_edges[i].push(
                float(metrics[f"num_edges/{i}"]))
        scalars[f"num_nodes/{cfg.num_layers}"] = self.ema_nodes[
            cfg.num_layers].push(float(metrics[f"num_nodes/{cfg.num_layers}"]))
        scalars["train_acc"] = float(f1_compute(metrics["f1"],
                                                self.multilabel))
        scalars["train_loss"] = float(metrics["train_loss"])
        scalars["iter_time"] = time.time() - prev_t
        scalars["forward_backward_time"] = fb_time
        for k, v in metrics.items():
            if "overflow" in k and float(v) > 0:
                scalars[k] = float(v)
                # widen only the caps widen() can grow
                if self._refit_done and ("frontier_overflow" in k
                                         or "block_edge_overflow" in k):
                    self._overflow_after_refit = True
                    if "frontier_overflow" in k:
                        self._frontier_overflow_after_refit = True
            elif "frontier_edges" in k or "n_block_edges_true" in k:
                self._refit_max[k] = max(self._refit_max.get(k, 0.0),
                                         float(v))
        self.logger.log(self.global_step, scalars)

    def _maybe_capacity_refit(self):
        """Tightens the plan to the measured maxima after ``refit_after``
        steps; widens it by 1.5x if a tightened cap overflows later."""
        cfg = self.cfg
        if cfg.refit_after <= 0:
            return
        L = cfg.num_layers
        if not self._refit_done:
            if self.global_step < cfg.refit_after:
                return
            fr = [int(self._refit_max.get(f"layer{l}/frontier_edges", 0))
                  for l in range(L)]
            be = [int(self._refit_max.get(f"layer{l}/n_block_edges_true", 0))
                  for l in range(L)]
            self._refit_done = True
            if min(fr) <= 0 or min(be) <= 0:
                return
            new = self.plan.refit(
                fr, be, block_edge_slack=cfg.refit_block_edge_slack,
                frontier_slack=cfg.refit_frontier_slack,
                max_degree=self._max_degree)
            if new != self.plan:
                self.plan = new
                self.n_refits += 1
                self._rebuild_steps()
        elif self._overflow_after_refit:
            self.plan = self.plan.widen(
                1.5, frontier=self._frontier_overflow_after_refit)
            self._overflow_after_refit = False
            self._frontier_overflow_after_refit = False
            self.n_widens += 1
            self._rebuild_steps()

    def _val_batches(self, b0: int, k: int):
        """k validation batches from batch b0, zero-padded: seeds and masks
        [k, B]."""
        B = self.batch_size
        seeds = np.zeros((k, B), np.int32)
        masks = np.zeros((k, B), bool)
        for j in range(k):
            chunk = self.val_nid[(b0 + j) * B:(b0 + j + 1) * B]
            seeds[j, :len(chunk)] = chunk
            masks[j, :len(chunk)] = True
        return seeds, masks

    def _validate(self, epoch: int) -> float:
        if len(self.val_nid) == 0:
            return float("nan")
        gen = self._eval_gen.manual_seed(self.cfg.seed + 1000 + epoch)
        dev = self.device
        acc = torch.zeros(5, dtype=torch.float32, device=dev)
        n_sum = torch.zeros((), dtype=torch.int32, device=dev)
        n_batches = -(-len(self.val_nid) // self.batch_size)
        K = self.cfg.eval_steps_per_call
        b = 0
        while b < n_batches:
            if self.multi_eval is not None and b + K <= n_batches:
                seeds, masks = self._val_batches(b, K)
                f1, loss_n, n = self.multi_eval(
                    self.state, gen, self._to_device(seeds),
                    self._to_device(masks))
                b += K
            else:
                seeds, masks = self._val_batches(b, 1)
                f1, loss_n, n = self.eval_step(
                    self.state, gen, self._to_device(seeds[0]),
                    self._to_device(masks[0]))
                b += 1
            acc = acc + torch.stack([f1.tp, f1.fp, f1.fn, f1.total, loss_n])
            n_sum = n_sum + n
        f1 = f1_compute(F1State(*acc[:4].unbind()), self.multilabel)
        val_acc, loss_sum, n = torch.stack(
            [f1.double(), acc[4].double(), n_sum.double()]).cpu().tolist()
        val_loss = loss_sum / max(n, 1)
        self.logger.log(self.global_step,
                        {"val_acc": val_acc, "val_loss": val_loss})
        return val_acc

    def _maybe_renorm_exp3(self, force: bool = False):
        """The deferred L1 row renormalisation of the arm weights, in place
        (a captured step keeps reading the same storage): every
        ``exp3_renorm_every`` steps, and before each checkpoint."""
        if self.state.exp3_weights is None:
            return
        since = self.global_step - self._last_renorm_step
        if force or since >= max(1, self.cfg.exp3_renorm_every):
            normalize_exp3_weights(self.state.exp3_weights)
            self._last_renorm_step = self.global_step

    # -- checkpoints -----------------------------------------------------
    def _snapshot(self) -> Dict[str, object]:
        """A host copy of the whole state: parameters, Adam's per-parameter
        state, the schedule, the arm weights, the generator and the step."""
        s = self.state

        def host(t):
            return t.detach().to("cpu", copy=True)

        return {
            "params": {n: host(p) for n, p in s.model.named_parameters()},
            "adam": [{k: host(v) for k, v in s.optimizer.state[p].items()}
                     for p in s.model.parameters()],
            "scheduler": s.scheduler.state_dict(),
            "exp3_weights": (None if s.exp3_weights is None
                             else host(s.exp3_weights)),
            "generator": s.generator.get_state(),
            "step": s.step,
        }

    @torch.no_grad()
    def _load_state(self, snap: Dict[str, object]):
        """Copies a snapshot into the live state's tensors."""
        s = self.state
        named = dict(s.model.named_parameters())
        for n, v in snap["params"].items():
            named[n].copy_(v)
        capturable = s.optimizer.param_groups[0].get("capturable", False)
        for p, saved in zip(s.model.parameters(), snap["adam"]):
            cur = s.optimizer.state[p]
            if not saved:  # a state from before the first step
                for v in cur.values():
                    v.zero_()
                continue
            for k, v in saved.items():
                if k in cur:
                    cur[k].copy_(v)
                else:  # Adam has not stepped: nothing captured reads it
                    where = p.device if k != "step" or capturable else "cpu"
                    cur[k] = v.to(where, copy=True)
        s.scheduler.load_state_dict(snap["scheduler"])
        if s.exp3_weights is not None:
            s.exp3_weights.copy_(snap["exp3_weights"])
        s.generator.set_state(snap["generator"])
        s.step = int(snap["step"])

    def _maybe_checkpoint(self, val_acc: float):
        self._maybe_renorm_exp3(force=True)
        if math.isnan(val_acc):
            self.best_state = self._snapshot()
            return
        if val_acc > self.best_val_acc:
            self.best_val_acc = val_acc
            self._epochs_since_improve = 0
            self.best_state = self._snapshot()
            if not self.cfg.disable_checkpoint:
                self._save_checkpoint()
        else:
            self._epochs_since_improve += 1

    def checkpoint_path(self) -> str:
        return os.path.join(os.path.abspath(self.run_dir), "checkpoints",
                            "best")

    def _save_checkpoint(self):
        """Writes the best state. A failure warns once, is counted into the
        ``checkpoint_failures`` series, and makes ``final_eval`` refuse if
        no save ever landed."""
        try:
            path = self.checkpoint_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(self.best_state, path + ".tmp")
            os.replace(path + ".tmp", path)
            self._checkpoint_saved = True
        except Exception as e:
            self.checkpoint_failures += 1
            if self.checkpoint_failures == 1:
                warnings.warn(
                    f"[checkpoint] save failed (will keep training; "
                    f"final_eval raises if no checkpoint ever lands): {e}")
            self.logger.log(
                self.global_step,
                {"checkpoint_failures": float(self.checkpoint_failures)})

    def restore_best(self):
        """Loads the best-val_acc state for the final eval."""
        if self.best_state is not None:
            self._load_state(self.best_state)

    def load_checkpoint(self, path: Optional[str] = None):
        """Restores the whole state (parameters, Adam's state, the schedule,
        the arm weights, the generator, the step) from a checkpoint file."""
        snap = torch.load(path or self.checkpoint_path(), map_location="cpu",
                          weights_only=True)
        self._load_state(snap)
        self.best_state = snap
        return self

    def _early_stopping(self, val_acc: float):
        if math.isnan(val_acc):
            return
        if self.global_step < self.cfg.min_steps:
            return
        if val_acc >= self.cfg.val_acc_target:
            self._stop = True
        if self._epochs_since_improve >= self.cfg.early_stopping_patience:
            self._stop = True

    def _vertex_limit_controller(self):
        """Resizes the batch toward ``vertex_limit`` sampled input nodes when
        the running mean is three deviations off; rebuilds the plan."""
        w, limit = self.welford, self.cfg.vertex_limit
        if limit > 0 and w.n >= 2 and abs(limit - w.m) * w.n >= w.std * 3:
            new_bs = max(1, int(self.batch_size * limit / max(w.m, 1)))
            if new_bs != self.batch_size:
                self.batch_size = new_bs
                self.steps_per_epoch = max(
                    1, len(self.train_nid) // self.batch_size)
                self._build_for_batch_size(new_bs, init_state=False)
            self.welford.clear()

    # -- final eval ------------------------------------------------------
    def final_logits(self) -> torch.Tensor:
        """Full-graph layerwise inference of the current model: [N,
        n_classes] f32 logits (K6 for SAGE and GCN, K7 for GATv2 on the
        card, whatever ``inference_backend`` says)."""
        cfg = self.cfg
        heads = tuple([cfg.num_in_heads] * (cfg.num_layers - 1)
                      + [cfg.num_out_heads])
        return layerwise_inference(
            cfg.model, self.state.model, self.graph, cfg.num_layers,
            heads=heads, negative_slope=cfg.negative_slope,
            residual=cfg.residual, dtype=torch.bfloat16)

    def final_eval(self) -> Dict[str, float]:
        """Full-graph inference and micro-F1 per split."""
        cfg = self.cfg
        if (not cfg.disable_checkpoint and self.checkpoint_failures > 0
                and not self._checkpoint_saved):
            raise RuntimeError(
                f"checkpointing was enabled but every save failed "
                f"({self.checkpoint_failures} failures) — the best state "
                f"was never persisted; refusing to report a successful "
                f"run (pass disable_checkpoint to train without "
                f"persistence)")
        return self._split_f1(self.final_logits(),
                              self.graph.ndata["labels"])

    def _split_f1(self, logits: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, float]:
        """Micro-F1 of the full-graph logits on each split, logged as
        ``Final Accuracy/<split>``; one copy to the host."""
        splits = [(self.train_nid, "Train"), (self.val_nid, "Validation"),
                  (self.test_nid, "Test")]
        accs = []
        for nid, _ in splits:
            if len(nid) == 0:
                continue
            idx = self._to_device(nid).long()
            f1 = f1_update(F1State.zero(self.device), logits[idx],
                           labels[idx],
                           torch.ones(len(nid), dtype=torch.bool,
                                      device=self.device), self.multilabel)
            accs.append(f1_compute(f1, self.multilabel))
        host = iter(torch.stack(accs).cpu().tolist() if accs else [])
        out = {}
        for nid, split in splits:
            if len(nid) == 0:
                out[split] = float("nan")
                continue
            acc = next(host)
            out[split] = acc
            self.logger.log(0, {f"Final Accuracy/{split}": acc})
            print(f"{split} accuracy: {acc}")
        self.logger.flush()
        return out
