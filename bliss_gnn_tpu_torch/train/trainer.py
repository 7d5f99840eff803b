"""The training harness for one device (counterpart of ``TrainConfig`` and
``Trainer`` in ``bliss_gnn_tpu/train/trainer.py``):

- graph preparation: load, canonicalise, per-dst normalised edge weights,
  splits, the capacity plan, the upload;
- per-step training with EMA'd sampled node and edge counts, iteration and
  forward/backward timers and train micro-F1; the first ``refit_after``
  steps eager, then chains of ``steps_per_call`` (on the card one captured
  step replayed per batch, a chain of one included, and an epoch's or the
  run's last batches as a shorter chain);
- the capacity policy (``sampling/block.py`` ``CapacityPolicy``): a refit
  from the pilot steps' maxima, then a 1.5x widen of the kind of cap that
  overflowed;
- sampled validation each epoch, in chains of ``eval_steps_per_call`` (on
  the card the epoch's last batches as a shorter chain);
- Adam with a staircase decay, the deferred EXP3 row renormalisation;
- checkpoint of the best state, restore and resume, early stopping, the
  vertex-limit batch controller;
- full-graph layerwise inference and micro-F1 per split (K6 for SAGE and
  GCN, K7 for GATv2 on the card);
- with ``use_uva``, features left in host memory behind a device
  ``FeatureCache`` of ``cache_size`` rows: split steps around the host
  fetch (no chains; on the card, after the pilot steps, each half replays
  its captured CUDA graph and the fetch runs between them),
  ``cache_miss`` logged each step, and the final eval chunked from host
  memory (``layerwise_inference_uva``);
- with ``dp`` (0: every rank the launcher placed) seed-batch data
  parallelism over a mesh of ranks (``parallel/dp.py``): the batch is
  global, rounded to a multiple of dp, and the plan holds the local batch;
  every rank runs this trainer on the same config and the same batches,
  and rank 0 alone logs and writes the checkpoint. With ``shard_graph``
  (dp > 1) the graph, features and arm weights are range-sharded over the
  ranks (``parallel/shardedstep.py``), ``shard_indptr`` shards the indptr
  too (by default past 32M nodes), and the final eval runs node-sharded
  (``layerwise_inference_sharded``), as it does under dp > 1 with UVA.

Checkpoints are ``torch.save`` files at ``<run_dir>/checkpoints/best``. A
state is restored by copying into the live tensors (parameters, Adam's
moments and counts, the arm weights) and the generator's state, never by
replacing them: a step captured in a CUDA graph keeps reading the tensors
it was captured with. A checkpoint holds the canonical (unsharded) arm
weights and every rank's generator state; loading it re-shards them.
Every tensor keeps its dtype through a save and a load.

Precision (the reference's): ``compute_dtype`` is the models' compute and
the device features' dtype, and final inference's (bf16, or f32 for
``--precision highest``); ``param_dtype`` the parameters' and Adam's
moments' (f32, or bf16); ``exp3_dtype`` the arm weights' (bf16, or f32,
which K4's 32-bit route updates on the card).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph.datasets import load_dataset
from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
from bliss_gnn_tpu_torch.graph.structure import (
    DeviceGraph,
    Graph,
    normalized_edata,
)
from bliss_gnn_tpu_torch.models.gnn import build_model
from bliss_gnn_tpu_torch.models.inference import (
    layerwise_inference,
    layerwise_inference_sharded,
    layerwise_inference_uva,
)
from bliss_gnn_tpu_torch.parallel import dp as pdp
from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.parallel import shardedstep as pss
from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
from bliss_gnn_tpu_torch.parallel.shards import normalize_exp3_sharded
from bliss_gnn_tpu_torch.sampling.block import (
    CapacityPlan,
    CapacityPolicy,
    is_overflow,
)
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
    CAPTURE_WARMUP_STEPS,
    TrainState,
    _pack,
    _sampler_stats,
    _unpack,
    make_eval_step,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    make_uva_steps,
    replays,
)
from bliss_gnn_tpu_torch.utils import spans
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
    # overflow after that widens the caps of its kind by 1.5x
    refit_after: int = 3
    refit_block_edge_slack: float = 1.6
    refit_frontier_slack: float = 1.25
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    exp3_dtype: str = "bfloat16"
    # torch.profiler trace of this many train steps from the first replayed
    # one (after the pilot and the capture) into <run_dir>/profile, with the
    # trainer's host spans
    profile_steps: int = 0
    resume: str = ""  # checkpoint file to restore before training
    use_uva: bool = False
    cache_size: int = 0
    # train steps per chained call (on the card: replays of one captured
    # step, a chain of one included); on the CPU 1 runs every step alone
    steps_per_call: int = 1
    # validation batches per chained call (on the card replayed, 1 too); on
    # the CPU 1 runs each alone
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


def _metrics_to_host(metrics: Dict[str, object], device: torch.device,
                     chained: bool) -> List[Dict[str, object]]:
    """A step's metrics, or a chain's stacked over K, copied to the host in
    one transfer (the span ``trainer.metrics_read``: the host's wait on the
    card): one dict per step, each value a float and ``f1`` an ``F1State``
    of CPU scalars."""
    vec, layout = _pack(metrics, device)
    with spans.span("trainer.metrics_read"):
        vec = vec.cpu()
    rows = vec.T if chained else vec[None]  # [K, n]
    cols = _unpack(rows, layout)
    return [{name: (F1State(*(t[k] for t in vars(v).values()))
                    if isinstance(v, F1State) else float(v[k]))
             for name, v in cols.items()} for k in range(rows.shape[0])]


class _NullLogger:
    """The logger of a rank other than 0: rank 0 logs the run."""

    def log(self, step, scalars):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class Trainer:
    """Trains ``cfg`` on ``graph`` (a canonicalised host ``Graph`` with the
    normalised weights in ``edata["w"]``), or on ``cfg.dataset`` when no
    graph is given, on ``device``: the card by default (raises without
    one), ``"cpu"`` for the plain PyTorch path. With ``cfg.dp`` other than
    1 it joins the process group the launcher described (torchrun's, or
    ``cli.main``'s own ranks) and runs on this rank's device."""

    def __init__(self, cfg: TrainConfig, graph: Optional[Graph] = None,
                 n_classes: Optional[int] = None,
                 multilabel: Optional[bool] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # each field its default's name, or else the other of bf16 and
        # f32, as the reference reads them
        bf16, f32 = torch.bfloat16, torch.float32
        self.dtype = bf16 if cfg.compute_dtype == "bfloat16" else f32
        self.pdtype = f32 if cfg.param_dtype == "float32" else bf16
        self.exp3_dtype = bf16 if cfg.exp3_dtype == "bfloat16" else f32
        self.mesh = None
        self.dp = 1
        if cfg.dp != 1:
            multihost.initialize(self.device)
            world = dist.get_world_size() if dist.is_initialized() else 1
            n = cfg.dp if cfg.dp > 0 else world
            if n > world:
                raise ValueError(f"--dp {n} exceeds the {world} rank(s) the "
                                 f"launcher placed")
            if n > 1:
                self.mesh = make_mesh(n, device=self.device)
                self.dp = n
                self.device = self.mesh.device
        # steps replayed from captured CUDA graphs
        self._replays = replays(self.device, self.mesh)
        if cfg.shard_graph and self.dp <= 1:
            raise ValueError(
                "--shard-graph partitions the graph over the dp ranks; it "
                "requires --dp N with N > 1 (or 0 = every rank)")
        self.is_main = self.mesh is None or self.mesh.rank == 0
        if graph is None:
            graph, n_classes, multilabel = load_dataset(cfg.dataset)
            graph = Graph.canonicalize(graph, undirected=cfg.undirected)
            graph.edata["w"] = normalized_edata(graph)
        self.host_graph = graph
        self.n_classes = n_classes
        self.multilabel = multilabel
        self.feature_cache = None
        if cfg.use_uva:
            # the features stay in host memory (a memmap stays unread);
            # the device graph holds everything else
            self.feature_cache = FeatureCache(
                graph.ndata["features"],
                cfg.cache_size or min(graph.n_nodes, 1 << 21),
                dtype=self.dtype, device=self.device)
        self.sharded_graph = None
        if cfg.shard_graph:
            # no replicated device graph: each rank holds its ranges
            shard_indptr = (cfg.shard_indptr if cfg.shard_indptr is not None
                            else graph.n_nodes > 32_000_000)
            self.sharded_graph = pss.ShardedDeviceGraph.build(
                graph, self.mesh, feature_dtype=self.dtype,
                shard_indptr=shard_indptr, include_features=not cfg.use_uva)
            self.graph = None
        else:
            self.graph = DeviceGraph.from_graph(
                graph, device=self.device, feature_dtype=self.dtype,
                exclude=("features",) if cfg.use_uva else ())
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
            residual=cfg.residual, device=self.device, seed=cfg.seed,
            dtype=self.dtype, param_dtype=self.pdtype)
        # the GLOBAL batch; under dp a multiple of dp, batch / dp a rank
        self.batch_size = min(cfg.batch_size, max(1, len(self.train_nid)))
        self.batch_size = max(self.dp,
                              (self.batch_size // self.dp) * self.dp)
        self.steps_per_epoch = max(1, len(self.train_nid) // self.batch_size)
        self.n_refits = self.n_widens = 0
        self._build_for_batch_size(self.batch_size, init_state=True)

        base = os.path.join(cfg.logdir, cfg.run_name)
        run_dir = [next_version_dir(base) if self.is_main else None]
        if self.mesh is not None:
            dist.broadcast_object_list(run_dir, src=0)
        self.run_dir = run_dir[0]
        self.logger = (MetricLogger(self.run_dir) if self.is_main
                       else _NullLogger())
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
        self._profile_from: Optional[int] = None
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
        if not hasattr(self, "run_dir") or not self.is_main:
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
        max_degree = int(indeg.max())
        self.plan = CapacityPlan.build(
            batch_size // self.dp, self.sampler_cfg.fanouts, g.n_nodes, g.n_edges,
            kind=cfg.sampler, frontier_slack=cfg.frontier_slack,
            block_edge_slack=cfg.block_edge_slack,
            max_frontier_edges=cfg.max_frontier_edges,
            deg_std=float(indeg.std()), max_degree=max_degree)
        self.capacity = CapacityPolicy(
            cfg.refit_after, frontier_slack=cfg.refit_frontier_slack,
            block_edge_slack=cfg.refit_block_edge_slack,
            max_degree=max_degree)
        if init_state:
            opt, sched = make_optimizer(
                self.model.parameters(), cfg.lr, self.steps_per_epoch,
                cfg.lr_gamma, cfg.lr_step_size,
                capturable=self.device.type == "cuda")
            exp3 = None
            if self.sampler_cfg.is_bandit and cfg.shard_graph:
                exp3 = pss.init_exp3_shard(
                    cfg.num_layers, g.n_edges, self.mesh,
                    dtype=self.exp3_dtype)
            elif self.sampler_cfg.is_bandit:
                exp3 = init_exp3_weights(
                    cfg.num_layers, g.n_edges, device=self.device,
                    dtype=self.exp3_dtype)
            gen = (self.mesh.generator(cfg.seed) if self.mesh is not None
                   else torch.Generator(device=self.device).manual_seed(
                       cfg.seed))
            self.state = TrainState(self.model, opt, sched, exp3, gen)
        else:
            # the schedule's period follows the epoch length, at Adam's count
            self.state.scheduler.reset(
                max(1, cfg.lr_step_size * self.steps_per_epoch),
                self.state.step)
        self._rebuild_steps()

    def _rebuild_steps(self):
        """The step functions for the current ``self.plan``. The replayed
        steps are dropped first: each holds a captured CUDA graph and its
        memory pool, which the caching allocator then releases. The
        chained steps are built for chains of more than one step, and on
        the card for every length (one captured step serves them all)."""
        cfg = self.cfg
        self._save_hparams()
        self.multi_step = self.multi_eval = None
        self._uva_fns = self._uva_eager = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        args = (self.graph, self.sampler_cfg, self.plan, self.multilabel)
        mesh, sg = self.mesh, self.sharded_graph
        chain = cfg.steps_per_call > 1 or self._replays
        chain_eval = cfg.eval_steps_per_call > 1 or self._replays
        if self.feature_cache is not None:
            # the host fetch sits between the halves: no chains; on the
            # card the halves replay after the pilot steps
            storage = None
            graph = self.graph
            if sg is not None:
                graph = pss._LocalView(sg)
                storage = pss.sharded_storage(sg, cfg.num_layers)

            def halves(capture=None):
                return make_uva_steps(
                    graph, self.sampler_cfg, self.plan, self.multilabel,
                    device=self.device, mesh=mesh, storage=storage,
                    capture=capture)

            self._uva_eager = halves(False)
            self._uva_fns = halves() if self._replays else self._uva_eager
            # bound to a weak proxy: a trainer holding its own bound methods
            # would outlive its last reference in a cycle, and its captured
            # graphs with it, past the end of the group whose NCCL
            # collectives they hold
            me = weakref.proxy(self)
            self.train_step = functools.partial(type(self)._uva_train_step,
                                                me)
            self.eval_step = functools.partial(type(self)._uva_eval_step, me)
            return
        if sg is not None:
            sargs = (mesh, sg, self.sampler_cfg, self.plan, self.multilabel)
            self.train_step = pss.make_sharded_train_step(*sargs)
            self.eval_step = pss.make_sharded_eval_step(*sargs)
            if chain:
                self.multi_step = pss.make_sharded_multi_train_step(*sargs)
            if chain_eval:
                self.multi_eval = pss.make_sharded_multi_eval_step(*sargs)
            return
        if mesh is not None:
            dargs = (mesh,) + args
            self.train_step = pdp.make_dp_train_step(
                *dargs, exp3_normalize=False)
            self.eval_step = pdp.make_dp_eval_step(*dargs)
            if chain:
                self.multi_step = pdp.make_dp_multi_train_step(
                    *dargs, exp3_normalize=False)
            if chain_eval:
                self.multi_eval = pdp.make_dp_multi_eval_step(*dargs)
            return
        self.train_step = make_train_step(*args, device=self.device)
        self.eval_step = make_eval_step(*args, device=self.device)
        if chain:
            # chains of any length replay the one captured step
            self.multi_step = make_multi_train_step(*args,
                                                    device=self.device)
        if chain_eval:
            self.multi_eval = make_multi_eval_step(*args, device=self.device)

    # -- host-resident features -----------------------------------------
    def _uva_train_step(self, state: TrainState, seeds: torch.Tensor,
                        smask: torch.Tensor):
        """Sample, fetch the input rows through the cache, train (the pilot
        steps eagerly); the batch's miss rate is the ``cache_miss``
        metric."""
        sample_fn, train_fn, _ = (self._uva_eager if self._eager_steps()
                                  else self._uva_fns)
        seeds, smask = self._local(seeds), self._local(smask)
        blocks, samp_stats = sample_fn(state, seeds, smask)
        with spans.span("trainer.fetch"):
            x, miss = self.feature_cache.gather(blocks[0].src_gids,
                                                blocks[0].src_mask)
        state, metrics = train_fn(state, blocks, x)
        return state, {**metrics, "cache_miss": miss,
                       **_sampler_stats(samp_stats)}

    def _uva_eval_step(self, state: TrainState, generator, seeds, smask):
        """Sample, fetch, evaluate: replayed on the card in the pilot too,
        as the chained eval step is."""
        sample_fn, _, eval_fn = self._uva_fns
        seeds, smask = self._local(seeds), self._local(smask)
        blocks, _ = sample_fn(state, seeds, smask, generator=generator)
        x, _ = self.feature_cache.gather(blocks[0].src_gids,
                                         blocks[0].src_mask)
        return eval_fn(state, blocks, x)

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a global batch (all of it on one device)."""
        return t if self.mesh is None else pdp.local_slice(self.mesh, t)

    def _eager_steps(self) -> bool:
        """Whether train steps run eagerly now: the pilot steps (the refit
        replaces their plan a moment later). It does not hold for
        validation, which replays whenever steps replay."""
        return self.capacity.piloting

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
        prev_t = time.perf_counter()
        while (epoch < max_epochs and self.global_step < max_steps
               and not self._stop):
            batches = self._epoch_batches(rng)
            smask = torch.ones(self.batch_size, dtype=torch.bool,
                               device=self.device)
            K = max(1, cfg.steps_per_call)
            b = 0
            while b < batches.shape[0]:
                self._profile_window()
                spans.follow_profiler()
                spans.set_step(self.global_step + 1)
                with spans.span("trainer.iteration"):
                    # a full chain; on the card the last batches as a
                    # shorter one
                    k = min(K, batches.shape[0] - b,
                            max_steps - self.global_step)
                    chain = (self.multi_step is not None
                             and not self._eager_steps()
                             and (k == K or self._replays))
                    with spans.span("trainer.batch"):
                        if chain:
                            seeds = self._to_device(batches[b:b + k])
                            masks = torch.ones((k, self.batch_size),
                                               dtype=torch.bool,
                                               device=self.device)
                        else:
                            k = 1
                            seeds = self._to_device(batches[b])
                    st = time.perf_counter()
                    with spans.span("trainer.launch"):
                        if chain:
                            self.state, metrics = self.multi_step(
                                self.state, seeds, masks)
                        else:
                            self.state, metrics = self.train_step(
                                self.state, seeds, smask)
                            if self.feature_cache is None:
                                spans.counter("steps.eager/train")
                    mstack = _metrics_to_host(metrics, self.device, chain)
                    fb_time = (time.perf_counter() - st) / k
                    for metrics in mstack:
                        self.global_step += 1
                        spans.take_marks(metrics, "step", self.global_step)
                        with spans.span("trainer.log"):
                            self._log_train_step(metrics, prev_t, fb_time)
                        self.capacity.observe(metrics)
                        prev_t = time.perf_counter()
                        self.welford.push(float(metrics["num_nodes/0"]))
                    b += k
                    self._maybe_renorm_exp3()
                    self._follow_capacity_policy()
                if self.global_step >= max_steps:
                    break
            epoch += 1
            with spans.span("trainer.validate"):
                val_acc = self._validate(epoch)
            self._maybe_checkpoint(val_acc)
            self._early_stopping(val_acc)
            self._vertex_limit_controller()
        self._stop_profile()
        self.logger.flush()
        return self

    def _profile_window(self):
        """``profile_steps``: the profiler over that many train steps from
        the first replayed one (after the pilot steps, the refit and the
        capture's warm-ups and capture; on the CPU the same steps), once a
        run; host spans follow it into the trace."""
        n = self.cfg.profile_steps
        if n <= 0:
            return
        if self._profiler is None and self._profile_from is None:
            first = max(self.cfg.refit_after, 0) + CAPTURE_WARMUP_STEPS + 1
            if self.global_step >= first:
                self._profile_from = self.global_step
                self._start_profile()
        elif (self._profiler is not None
              and self.global_step >= self._profile_from + n):
            self._stop_profile()

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
        spans.follow_profiler()
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
        if spans.enabled():  # the raw sampled counts, summed
            for i in range(cfg.num_layers + 1):
                spans.counter(f"sampler.nodes/{i}",
                              float(metrics[f"num_nodes/{i}"]))
            for i in range(cfg.num_layers):
                spans.counter(f"sampler.edges/{i}",
                              float(metrics[f"num_edges/{i}"]))
                if f"poisson_iters/{i}" in metrics:
                    spans.counter(f"sampler.fixed_point_iters/{i}",
                                  float(metrics[f"poisson_iters/{i}"]))
                if f"gat_alpha_cancel/{i}" in metrics:
                    spans.counter(f"bandit.alpha_cancel/{i}",
                                  float(metrics[f"gat_alpha_cancel/{i}"]))
        scalars["iter_time"] = time.perf_counter() - prev_t
        scalars["forward_backward_time"] = fb_time
        if "cache_miss" in metrics:
            scalars["cache_miss"] = float(metrics["cache_miss"])
        for k, v in metrics.items():
            if is_overflow(k) and float(v) > 0:
                scalars[k] = float(v)
        self.logger.log(self.global_step, scalars)

    def _follow_capacity_policy(self):
        """Rebuilds the steps on the plan the capacity policy answers with
        after the steps observed so far (a refit or a widen)."""
        change = self.capacity.decide(self.plan, self.global_step)
        if change is None:
            return
        why, self.plan = change
        if why == "refit":
            self.n_refits += 1
            spans.counter("trainer.refits")
        else:
            self.n_widens += 1
            spans.counter("trainer.widens")
        with spans.span("trainer.rebuild"):
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
        seed = self.cfg.seed + 1000 + epoch
        gen = self._eval_gen.manual_seed(
            seed if self.mesh is None else self.mesh.fold_seed(seed))
        dev = self.device
        acc = torch.zeros(5, dtype=torch.float32, device=dev)
        n_sum = torch.zeros((), dtype=torch.int32, device=dev)
        n_batches = -(-len(self.val_nid) // self.batch_size)
        K = max(1, self.cfg.eval_steps_per_call)
        b = 0
        while b < n_batches:
            # a full chain; on the card the last batches as a shorter one
            k = min(K, n_batches - b)
            if self.multi_eval is not None and (k == K or self._replays):
                seeds, masks = self._val_batches(b, k)
                f1, loss_n, n = self.multi_eval(
                    self.state, gen, self._to_device(seeds),
                    self._to_device(masks))
                b += k
            else:
                seeds, masks = self._val_batches(b, 1)
                f1, loss_n, n = self.eval_step(
                    self.state, gen, self._to_device(seeds[0]),
                    self._to_device(masks[0]))
                if self.feature_cache is None:
                    spans.counter("steps.eager/eval")
                b += 1
            acc = acc + torch.stack([f1.tp, f1.fp, f1.fn, f1.total, loss_n])
            n_sum = n_sum + n
        f1 = f1_compute(F1State(*acc[:4].unbind()), self.multilabel)
        val_acc, loss_sum, n = torch.stack(
            [f1.double(), acc[4].double(), n_sum.double()]).cpu().tolist()
        val_loss = loss_sum / max(n, 1)
        spans.record_pending(self.global_step)  # the batches' eval marks
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
            sg = self.sharded_graph
            with spans.span("trainer.renorm"):
                if sg is not None:
                    normalize_exp3_sharded(self.state.exp3_weights,
                                           self.cfg.num_layers, sg.epr,
                                           self.mesh)
                else:
                    normalize_exp3_weights(self.state.exp3_weights)
            self._last_renorm_step = self.global_step

    # -- checkpoints -----------------------------------------------------
    def _snapshot(self) -> Dict[str, object]:
        """A host copy of the whole state: parameters, Adam's per-parameter
        state, the schedule, the arm weights, the generator and the step.
        Under dp every rank calls it (it gathers): the arm weights in the
        canonical ``[L, E + EDGE_PAD]`` layout, unsharded, and every rank's
        generator state, in rank order."""
        s = self.state

        def host(t):
            return t.detach().to("cpu", copy=True)

        exp3 = s.exp3_weights
        if exp3 is not None and self.sharded_graph is not None:
            exp3 = pss.unshard_exp3(self.mesh.all_gather(exp3),
                                    self.cfg.num_layers,
                                    self.host_graph.n_edges)
        snap = {
            "params": {n: host(p) for n, p in s.model.named_parameters()},
            "adam": [{k: host(v) for k, v in s.optimizer.state[p].items()}
                     for p in s.model.parameters()],
            "scheduler": s.scheduler.state_dict(),
            "exp3_weights": None if exp3 is None else host(exp3),
            "generator": s.generator.get_state(),
            "step": s.step,
        }
        if self.mesh is not None:
            states = self.mesh.all_gather(
                snap["generator"].to(self.mesh.device)).cpu()
            # set_state reads a tensor's storage from its start: copies
            snap["generators"] = [t.clone() for t in states.unbind()]
        return snap

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
            exp3 = snap["exp3_weights"]
            if self.sharded_graph is not None:
                exp3 = pss.shard_exp3(exp3, self.cfg.num_layers,
                                      self.host_graph.n_edges, self.dp,
                                      rank=self.mesh.rank)
            s.exp3_weights.copy_(exp3)
        gens = snap.get("generators")
        if self.mesh is not None and gens is not None and len(gens) == self.dp:
            s.generator.set_state(gens[self.mesh.rank])
        elif self.mesh is None or self.mesh.rank == 0:
            s.generator.set_state(snap["generator"])
        s.step = int(snap["step"])

    def _maybe_checkpoint(self, val_acc: float):
        self._maybe_renorm_exp3(force=True)
        if math.isnan(val_acc):
            with spans.span("trainer.snapshot"):
                self.best_state = self._snapshot()
            return
        if val_acc > self.best_val_acc:
            self.best_val_acc = val_acc
            self._epochs_since_improve = 0
            with spans.span("trainer.snapshot"):
                self.best_state = self._snapshot()
            if not self.cfg.disable_checkpoint:
                with spans.span("trainer.checkpoint"):
                    self._save_checkpoint()
        else:
            self._epochs_since_improve += 1

    def checkpoint_path(self) -> str:
        return os.path.join(os.path.abspath(self.run_dir), "checkpoints",
                            "best")

    def _save_checkpoint(self):
        """Writes the best state. A failure warns once, is counted into the
        ``checkpoint_failures`` series, and makes ``final_eval`` refuse if
        no save ever landed. Under dp rank 0 writes, and every rank waits
        for it."""
        if not self.is_main:
            self.mesh.barrier()
            self._checkpoint_saved = True
            return
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
        if self.mesh is not None:
            self.mesh.barrier()

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
                new_bs = max(self.dp, (new_bs // self.dp) * self.dp)
                self.batch_size = new_bs
                self.steps_per_epoch = max(
                    1, len(self.train_nid) // self.batch_size)
                self._build_for_batch_size(new_bs, init_state=False)
            self.welford.clear()

    # -- final eval ------------------------------------------------------
    def final_logits(self) -> torch.Tensor:
        """Full-graph layerwise inference of the current model: [N,
        n_classes] f32 logits (K6 for SAGE and GCN, K7 for GATv2 on the
        card, whatever ``inference_backend`` says). Under ``shard_graph``,
        and under dp > 1 with ``use_uva``, it runs node-sharded over the
        ranks (``layerwise_inference_sharded``) and every rank gets the
        logits. Under ``use_uva`` on one device the pass runs chunk by
        chunk from the host features and the logits stay in host memory (a
        CPU tensor)."""
        cfg = self.cfg
        heads = tuple([cfg.num_in_heads] * (cfg.num_layers - 1)
                      + [cfg.num_out_heads])
        if self.sharded_graph is not None or (
                self.feature_cache is not None and self.dp > 1):
            # node-sharded over the ranks: no replicated upload
            return layerwise_inference_sharded(
                cfg.model, self.state.model, self.host_graph, self.mesh,
                cfg.num_layers, heads=heads,
                negative_slope=cfg.negative_slope, residual=cfg.residual,
                dtype=self.dtype,
                features=(None if self.feature_cache is None
                          else self.feature_cache.host))
        if self.feature_cache is not None:
            return torch.from_numpy(layerwise_inference_uva(
                cfg.model, self.state.model, self.host_graph, cfg.num_layers,
                heads=heads, negative_slope=cfg.negative_slope,
                residual=cfg.residual, dtype=self.dtype,
                features=self.feature_cache.host, device=self.device))
        return layerwise_inference(
            cfg.model, self.state.model, self.graph, cfg.num_layers,
            heads=heads, negative_slope=cfg.negative_slope,
            residual=cfg.residual, dtype=self.dtype)

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
        labels = (self.graph.ndata["labels"] if self.graph is not None
                  else self._to_device(self.host_graph.ndata["labels"]))
        return self._split_f1(self.final_logits(), labels)

    def _split_f1(self, logits: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, float]:
        """Micro-F1 of the full-graph logits on each split, logged as
        ``Final Accuracy/<split>``; one copy to the host. Logits in host
        memory go to the device a split's rows at a time."""
        splits = [(self.train_nid, "Train"), (self.val_nid, "Validation"),
                  (self.test_nid, "Test")]
        accs = []
        for nid, _ in splits:
            if len(nid) == 0:
                continue
            idx = self._to_device(nid).long()
            rows = (logits[idx] if logits.device.type == self.device.type
                    else logits[torch.from_numpy(nid).long()].to(self.device))
            f1 = f1_update(F1State.zero(self.device), rows, labels[idx],
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
            if self.is_main:
                print(f"{split} accuracy: {acc}")
        self.logger.flush()
        return out
