"""The fused training step and the sampled evaluation step (counterparts of
the single-device step bodies of ``bliss_gnn_tpu/train/steps.py``):

    sample_blocks -> gather features and labels -> model forward/backward
    -> CE loss -> Adam (staircase decay) -> EXP3 rewards + arm-weight update

The sampler reads the current arm weights; the update runs after the
backward, in place. One step runs eagerly. The chained steps run K batches:
a plain loop on the CPU; on the card the step is captured once as a
``torch.cuda.CUDAGraph`` after eager warm-up steps and replayed once per
batch, the counterpart of the reference's one ``lax.scan`` dispatch. For
features left in host memory, :func:`make_uva_steps` splits the step
around the host's feature fetch; on the card each half is captured and
replayed the same way, the fetch between the replays.

The bodies take a ``mesh`` (``parallel/mesh.py``) for seed-batch data
parallelism, the per-rank half of ``parallel/dp.py``: each rank samples
its slice of the batch with its own generator, the gradients are averaged
over the ranks before Adam (which then runs replicated), the EXP3 deltas
are all-gathered and every rank applies all of them (K4; at S > 1 on its
repeats route, so the replicas keep the same bits), and the metrics
are summed, the refit's maxima maxed. A :class:`StepStorage` says where
node rows and the arm weights live: the default reads the device graph;
``parallel/shardedstep.py`` serves them from range shards.

What capture asks of the step, and where it is met:
- no host sync and no host-to-device copy inside it: every ``n_valid``
  bound reaches the kernels as a tensor on the card (``ops/_args.py``
  ``valid_arg`` raises on a Python int under capture); a sync raises;
- Adam with ``capturable=True`` and a tensor rate (``make_optimizer``),
  which :class:`StaircaseLR` fills between replays;
- the state's generator registered with the graph, so that each replay
  advances it by one step's draws, as an eager step does;
- the kernels built before capture (the warm-up steps build them). K1's
  and K3's routes depend on ``data_ptr()`` alignment, read at capture: the
  graph's private pool gives every replay the same addresses, so the
  route taken holds;
- the wrappers' launch counters are Python: they count the captured
  launches once, and no replay. :class:`_Replay` counts the replays,
  captures and eager warm-ups by role (``steps.replays/<role>`` and so on
  in ``utils/spans.py``, while spans are on).

Device marks (``utils/spans.py``, off by default) time a train step's
phases on the card inside the graph: ``step.sample`` (``sample_blocks``),
``step.model`` (the feature and label gathers, forward, loss, backward,
the gradient mean, Adam), ``step.bandit`` (the EXP3 rewards, the delta
sync, K4), with ``step.collective`` around the mesh's collectives,
``model.backward`` around the backward pass and, in a GATv2 model,
``gat.attend`` around each layer's attention (``models/layers.py``); a
validation batch's ``eval.sample`` and ``eval.model``. With marks on, a
GATv2 bandit step also returns ``gat_alpha_cancel/<l>``, the kept edges
of layer l whose reward's logit sum cancels
(``samplers.gat_alpha_cancel``). A train step's
stamps join its metrics vector (``_pack``); off, the step and its graph
are as they were without them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
from bliss_gnn_tpu_torch.sampling.block import (
    Block,
    CapacityPlan,
    is_overflow,
    is_refit_size,
)
from bliss_gnn_tpu_torch.sampling.samplers import (
    SamplerConfig,
    apply_exp3_deltas,
    exp3_edge_deltas,
    gat_alpha_cancel,
    sample_blocks,
)
from bliss_gnn_tpu_torch.train.metrics import F1State, f1_update
from bliss_gnn_tpu_torch.utils import spans


class StepStorage:
    """How the step body reads node rows and owns the EXP3 state. The
    default reads the replicated device graph and updates the replicated
    ``[L, E + EDGE_PAD]`` arm weights in place."""

    def node_rows(self, graph, name: str, gids: torch.Tensor
                  ) -> torch.Tensor:
        return graph.ndata[name][gids.long()]

    def exp3_view(self, exp3):
        """What ``sample_blocks`` and ``exp3_row`` read as the arm weights."""
        return exp3

    def sync_deltas(self, deltas, mesh):
        """Under a mesh, every rank's sparse (eid, exponent) lists, so that
        every holder of the state applies every rank's update."""
        if mesh is None:
            return deltas
        return all_gather_deltas(deltas, mesh)

    def apply_deltas(self, exp3, deltas, normalize: bool,
                     max_repeats: int = 1) -> None:
        """``max_repeats`` S when ``deltas`` are S ranks' lists, which can
        repeat an edge once a rank: K4's repeats route keeps every replica
        of the state on the same bits."""
        apply_exp3_deltas(exp3, deltas, normalize=normalize,
                          max_repeats=max_repeats)


_DEFAULT_STORAGE = StepStorage()


def all_gather_deltas(deltas, mesh):
    """Every rank's per-layer (eid int32, exponent f32) lists in one int32
    all-gather (the exponents travel as their bits): per layer
    ([S * e_cap] eids, [S * e_cap] exponents), rank by rank."""
    packed = torch.cat([t for eid, dr in deltas for t in (
        eid.reshape(-1).to(torch.int32),
        dr.reshape(-1).to(torch.float32).contiguous().view(torch.int32))])
    rows = mesh.all_gather(packed)  # [S, sum of 2 * e_cap]
    out, o = [], 0
    for eid, _ in deltas:
        n = eid.numel()
        out.append((rows[:, o:o + n].reshape(-1),
                    rows[:, o + n:o + 2 * n].contiguous().view(
                        torch.float32).reshape(-1)))
        o += 2 * n
    return out


def pmean_grads(params, mesh) -> None:
    """The gradients averaged over the ranks in place: one all-reduce of
    the flattened gradients (exact at one rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = mesh.pmean(torch.cat([g.reshape(-1) for g in grads]))
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view_as(g))
        o += g.numel()


def reduce_metrics(metrics: Dict[str, object], mesh,
                   mean_keys=("train_loss",)) -> Dict[str, object]:
    """The JAX step's metric reductions in two all-reduces of f64 vectors
    (exact for int32 counts and f32 values): the refit's maxima (frontier
    edges, true block edges) maxed, ``mean_keys`` averaged, every other
    tensor (counts, overflow counters, the F1 state) summed. Host scalars
    stay as they are."""
    if mesh is None:
        return metrics
    sums, maxs = [], []  # (name, field or None, dtype, value)
    for name, v in metrics.items():
        if isinstance(v, F1State):
            sums += [(name, f, torch.float32, getattr(v, f))
                     for f in _F1_FIELDS]
        elif isinstance(v, torch.Tensor):
            (maxs if is_refit_size(name) else sums).append(
                (name, None, v.dtype, v))
    out = dict(metrics)
    f1_parts: Dict[str, Dict[str, torch.Tensor]] = {}
    for entries, reduce in ((sums, mesh.psum), (maxs, mesh.pmax)):
        if not entries:
            continue
        vec = reduce(torch.stack([v.reshape(()).to(torch.float64)
                                  for *_, v in entries]))
        for (name, field, dtype, _), r in zip(entries, vec.unbind()):
            if name in mean_keys:
                r = r / mesh.size
            if field is None:
                out[name] = r.to(dtype)
            else:
                f1_parts.setdefault(name, {})[field] = r.to(dtype)
    for name, fields in f1_parts.items():
        out[name] = F1State(*(fields[f] for f in _F1_FIELDS))
    return out


@dataclasses.dataclass
class TrainState:
    """Per-run state: the model (its parameters), the optimizer and its
    schedule, the EXP3 arm weights, the generator of every draw, the step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: StaircaseLR
    exp3_weights: Optional[torch.Tensor]
    generator: torch.Generator
    step: int = 0


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, multilabel: bool) -> torch.Tensor:
    """CE for multiclass, class-mean BCE-with-logits for multilabel, masked
    over padded dst slots and averaged over the valid ones."""
    logits = logits.to(torch.float32)
    if multilabel:
        per = F.binary_cross_entropy_with_logits(
            logits, labels.to(torch.float32), reduction="none").mean(dim=-1)
    else:
        # a masked slot's label may be -1 (an unlabelled node, as in
        # papers100M): it must not reach the class gather
        per = F.cross_entropy(logits, torch.where(mask, labels.long(), 0),
                              reduction="none")
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, per, 0.0).sum() / denom


def _block_count_metrics(blocks) -> Dict[str, torch.Tensor]:
    """Per-layer sampled node and edge counts."""
    out = {}
    for i, b in enumerate(blocks):
        out[f"num_nodes/{i}"] = b.num_src()
        out[f"num_edges/{i}"] = b.num_edges()
    out[f"num_nodes/{len(blocks)}"] = blocks[-1].num_dst()
    return out


class StaircaseLR:
    """``StepLR``'s staircase decay, stepped once per training step: the
    rate is multiplied by ``gamma`` every ``period`` steps on the host, in
    StepLR's float arithmetic, and written into the optimizer only then: a
    float rate is set, the 0-dim tensor rate of a capturable Adam filled in
    place (no host sync; StepLR reads a tensor rate back with ``.item()``
    on every step)."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr: float,
                 period: int, gamma: float):
        self.optimizer, self.period, self.gamma = optimizer, period, gamma
        self.base_lr = self.lr = lr
        self.last_epoch = 0

    def _write(self) -> None:
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(self.lr)
            else:
                group["lr"] = self.lr

    def step(self) -> None:
        self.last_epoch += 1
        if self.last_epoch % self.period == 0:
            self.lr *= self.gamma
            self._write()

    def reset(self, period: int, count: int) -> None:
        """A new period at step ``count``: the rate becomes base_lr *
        gamma^floor(count / period), what the schedule with this period
        gives at this count (the reference evaluates its schedule on Adam's
        count, so a new period takes effect at once)."""
        self.period, self.last_epoch = period, count
        self.lr = self.base_lr * self.gamma ** (count // period)
        self._write()

    def state_dict(self) -> Dict[str, float]:
        return {"lr": self.lr, "last_epoch": self.last_epoch,
                "period": self.period}

    def load_state_dict(self, d: Dict[str, float]) -> None:
        self.lr, self.last_epoch = d["lr"], d["last_epoch"]
        self.period = d["period"]
        self._write()

    def get_last_lr(self) -> List[float]:
        return [self.lr] * len(self.optimizer.param_groups)


def make_optimizer(params, lr: float, steps_per_epoch: int,
                   gamma: float = 0.01, step_size: int = 5,
                   capturable: bool = False):
    """Adam with the rate multiplied by ``gamma`` every ``step_size``
    epochs (a :class:`StaircaseLR`). With ``capturable`` (what the chained
    step on the card needs) Adam keeps its step counts and its rate as
    tensors beside the parameters, so that a CUDA graph of the step
    replays it."""
    params = list(params)
    rate = (torch.tensor(lr, dtype=torch.float32, device=params[0].device)
            if capturable else lr)
    opt = torch.optim.Adam(params, lr=rate, capturable=capturable)
    return opt, StaircaseLR(opt, lr, max(1, step_size * steps_per_epoch),
                            gamma)


def _resolve(graph: DeviceGraph, device) -> torch.device:
    dev = resolve_device(device)
    if graph.device.type != dev.type:
        raise ValueError(f"graph is on {graph.device}, step asked for {dev}")
    return dev


def _make_train_fn(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                   multilabel: bool, mesh=None,
                   storage: Optional[StepStorage] = None,
                   exp3_normalize: bool = False) -> Callable:
    """The step's work after sampling, ``train_fn(state, blocks, x) ->
    metrics``: labels, model forward and backward with dropout drawn from
    the state's generator, CE loss, Adam, the EXP3 update; ``x`` the input
    block's src rows. Under ``mesh`` the gradients are averaged and the
    deltas all-gathered before they are applied; the metrics come back
    unreduced."""
    storage = storage or _DEFAULT_STORAGE

    def train_fn(state: TrainState, blocks, x: torch.Tensor
                 ) -> Dict[str, object]:
        labels = storage.node_rows(graph, "labels", blocks[-1].dst_gids)
        dst_mask = blocks[-1].dst_mask
        model = state.model
        model.train()
        logits, aux = model(blocks, x, generator=state.generator)
        loss = cross_entropy_loss(logits, labels, dst_mask, multilabel)
        state.optimizer.zero_grad(set_to_none=True)
        with spans.device_span("model.backward"):
            loss.backward()
        if mesh is not None:
            with spans.device_span("step.collective"):
                pmean_grads(model.parameters(), mesh)
        state.optimizer.step()
        spans.mark("step.model")

        cancel = {}
        if sampler_cfg.is_bandit and not sampler_cfg.exp3_freeze:
            # unnormalised by default: every consumer renormalises per dst
            deltas = exp3_edge_deltas(graph, sampler_cfg, blocks,
                                      aux["embed_norms"], aux["a_ijs"])
            with (spans.device_span("step.collective") if mesh is not None
                  else contextlib.nullcontext()):
                deltas = storage.sync_deltas(deltas, mesh)
            storage.apply_deltas(state.exp3_weights, deltas, exp3_normalize,
                                 max_repeats=1 if mesh is None else mesh.size)
            spans.mark("step.bandit")
            if sampler_cfg.model == "gat" and spans.marks_enabled():
                # tracing's own work, after the bandit's interval
                cancel = {f"gat_alpha_cancel/{l}": gat_alpha_cancel(b, a)
                          for l, (b, a) in enumerate(zip(blocks,
                                                         aux["a_ijs"]))}
        f1 = f1_update(F1State.zero(x.device), logits.detach(), labels,
                       dst_mask, multilabel)
        return {
            "train_loss": loss.detach(),
            "f1": f1,
            # the JAX step's key; K4 skips no update, so it is always 0
            "exp3_apply_overflow": 0,
            **_block_count_metrics(blocks),
            **cancel,
        }

    return train_fn


def _sampler_stats(samp_stats: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The sampler's overflow counters, the sizes the refit reads and the
    fixed-point counts of :func:`_fixed_point_iters`."""
    return {k: v for k, v in samp_stats.items()
            if is_overflow(k) or is_refit_size(k)
            or k.startswith("poisson_iters/")}


def _fixed_point_iters(blocks) -> Dict[str, torch.Tensor]:
    """Of the Poisson kinds, each layer's fixed-point iteration count
    (``Block.fixed_point_iters``) as ``poisson_iters/<l>``; summed over
    the ranks under a mesh."""
    return {f"poisson_iters/{l}": b.fixed_point_iters
            for l, b in enumerate(blocks) if b.fixed_point_iters is not None}


def _make_step_body(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                    plan: CapacityPlan, multilabel: bool, mesh=None,
                    storage: Optional[StepStorage] = None,
                    exp3_normalize: bool = False) -> Callable:
    """The device work of one train step, ``body(state, seeds, seeds_mask,
    draws) -> metrics``: everything but the host's schedule and step count,
    so that a CUDA graph can hold it. The sampler draws from the state's
    generator before dropout does. Under ``mesh`` (the JAX ``dp_axis``)
    ``seeds`` is this rank's slice and the metrics come back reduced; with
    device marks on, the step's stamps are among them, unreduced."""
    storage = storage or _DEFAULT_STORAGE
    train_fn = _make_train_fn(graph, sampler_cfg, multilabel, mesh, storage,
                              exp3_normalize)

    def body(state: TrainState, seeds: torch.Tensor,
             seeds_mask: torch.Tensor,
             draws: Optional[Sequence[torch.Tensor]] = None,
             ) -> Dict[str, object]:
        marks = spans.open_marks("step", seeds.device)
        blocks, samp_stats = sample_blocks(
            graph, sampler_cfg, plan, state.generator, seeds, seeds_mask,
            storage.exp3_view(state.exp3_weights), draws=draws)
        spans.mark("step.sample")
        x = storage.node_rows(graph, "features", blocks[0].src_gids)
        out = reduce_metrics({**train_fn(state, blocks, x),
                              **_sampler_stats(samp_stats),
                              **_fixed_point_iters(blocks)}, mesh)
        if marks is not None:
            out.update(spans.finish(marks).columns())
        return out

    return body


def make_train_step(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                    plan: CapacityPlan, multilabel: bool,
                    device="cuda") -> Callable:
    """The fused step ``step(state, seeds, seeds_mask, draws=None) ->
    (state, metrics)``. ``device`` (default CUDA, which raises without a
    card) must be where ``graph`` lives; ``draws`` injects the sampler's
    per-block draws (see ``sample_blocks``)."""
    _resolve(graph, device)
    body = _make_step_body(graph, sampler_cfg, plan, multilabel)

    def step(state: TrainState, seeds: torch.Tensor,
             seeds_mask: torch.Tensor,
             draws: Optional[Sequence[torch.Tensor]] = None,
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics = body(state, seeds, seeds_mask, draws)
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return step


def _psum_eval(out, mesh):
    """(f1, loss * n, n) summed over the ranks in one all-reduce."""
    if mesh is None:
        return out
    f1, loss_n, n = out
    vec = mesh.psum(torch.stack([t.to(torch.float64) for t in (
        f1.tp, f1.fp, f1.fn, f1.total, loss_n, n)]))
    tp, fp, fn, total, ln, nn = vec.unbind()
    f32 = torch.float32
    return (F1State(tp.to(f32), fp.to(f32), fn.to(f32), total.to(f32)),
            ln.to(loss_n.dtype), nn.to(n.dtype))


def _make_eval_fn(graph: DeviceGraph, multilabel: bool, mesh=None,
                  storage: Optional[StepStorage] = None) -> Callable:
    """One validation batch on sampled blocks, ``eval_fn(state, blocks, x)
    -> (f1, loss * n, n)``: the model in eval mode (no dropout), no
    gradient, no EXP3 update; under ``mesh`` summed over the ranks."""
    storage = storage or _DEFAULT_STORAGE

    @torch.no_grad()
    def eval_fn(state: TrainState, blocks, x: torch.Tensor):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            labels = storage.node_rows(graph, "labels", blocks[-1].dst_gids)
            dst_mask = blocks[-1].dst_mask
            logits, _ = model(blocks, x)
            loss = cross_entropy_loss(logits, labels, dst_mask, multilabel)
            f1 = f1_update(F1State.zero(x.device), logits, labels, dst_mask,
                           multilabel)
            n = dst_mask.sum(dtype=torch.int32)
        finally:
            model.train(was_training)
        return _psum_eval((f1, loss * n, n), mesh)

    return eval_fn


def _make_eval_body(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                    plan: CapacityPlan, multilabel: bool, mesh=None,
                    storage: Optional[StepStorage] = None) -> Callable:
    """One sampled validation batch (the JAX ``_make_eval_fn`` body):
    ``body(state, generator, seeds, seeds_mask, draws) -> (f1, loss * n,
    n)``; under ``mesh`` ``seeds`` is this rank's slice, ``generator``
    this rank's, and the sums are over the ranks."""
    storage = storage or _DEFAULT_STORAGE
    eval_fn = _make_eval_fn(graph, multilabel, mesh, storage)

    def body(state: TrainState, generator: Optional[torch.Generator],
             seeds: torch.Tensor, seeds_mask: torch.Tensor,
             draws: Optional[Sequence[torch.Tensor]] = None):
        marks = spans.open_marks("eval", seeds.device)
        with torch.no_grad():
            blocks, _ = sample_blocks(
                graph, sampler_cfg, plan, generator, seeds, seeds_mask,
                storage.exp3_view(state.exp3_weights), draws=draws)
            spans.mark("eval.sample")
            x = storage.node_rows(graph, "features", blocks[0].src_gids)
        out = eval_fn(state, blocks, x)
        if marks is not None:
            spans.mark("eval.model")
            m = spans.finish(marks)
            spans.defer(m.unit, m.names, m.rel)
        return out

    return body


def make_eval_step(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                   plan: CapacityPlan, multilabel: bool,
                   device="cuda") -> Callable:
    """The sampled validation step ``eval_step(state, generator, seeds,
    seeds_mask, draws=None) -> (f1, loss * n, n)`` on the device: it
    samples with the current arm weights, its draws from ``generator``
    (the JAX step's key) or from ``draws``, and leaves the state as it
    was."""
    _resolve(graph, device)
    return _make_eval_body(graph, sampler_cfg, plan, multilabel)


def make_uva_steps(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                   plan: CapacityPlan, multilabel: bool, device="cuda",
                   mesh=None, storage: Optional[StepStorage] = None,
                   capture: Optional[bool] = None
                   ) -> Tuple[Callable, Callable, Callable]:
    """The step split at the host boundary for host-resident features
    (the counterpart of the JAX ``make_uva_steps``; ``graph/featurecache.py``
    fetches the rows between the parts). ``graph`` holds no features:

        sample_fn(state, seeds, seeds_mask, draws=None, generator=None)
            -> (blocks, sampler stats)
        train_fn(state, blocks, x) -> (state, metrics)
        eval_fn(state, blocks, x) -> (f1, loss * n, n)

    ``x`` is the input block's src rows. ``sample_fn`` draws from
    ``generator``, or from the state's generator for a train step; then
    ``train_fn``'s dropout draws from the state's generator, in the fused
    step's order, so sample, fetch and train from a state give the fused
    step's blocks, loss and update. ``train_fn`` steps the schedule and the
    count. Under ``mesh`` each rank samples its slice of the batch (the
    caller passes the slice) and fetches its own rows; the sampler stats,
    the metrics and the eval sums come back reduced, as in the fused DP
    step. ``storage`` serves labels and arm weights from range shards
    (``parallel/shardedstep.py``: graph sharding with UVA).

    With ``capture`` (the default on the card, unless ``mesh`` runs gloo:
    the counterpart of the reference's three ``jax.jit`` programs) each
    half is a CUDA graph captured after ``CAPTURE_WARMUP_STEPS`` eager
    calls and replayed (:class:`_Replay`): the train sample, the
    validation sample (a ``generator`` given), the train half and the eval
    half each their own graph, so that alternating them recaptures
    nothing; a new state, generator or draws setting starts that half
    over. The train half needs a capturable Adam. A replay returns the
    graph's own tensors: read the blocks (the host fetch) and the metrics
    before the next call of the same half overwrites them. The train and
    eval halves copy the blocks and ``x`` into their own inputs. Without
    ``capture`` (and always on the CPU) the halves run eagerly."""
    dev = _resolve(graph, device)
    if capture is None:
        capture = replays(dev, mesh)
    storage = storage or _DEFAULT_STORAGE
    train_body = _make_train_fn(graph, sampler_cfg, multilabel, mesh, storage)
    eval_body = _make_eval_fn(graph, multilabel, mesh, storage)
    graphs = {role: _Replay("uva." + role)
              for role in ("sample", "sample_eval", "train", "eval")}

    def run(role: str, bound: tuple, generator, fn: Callable, inputs):
        if not capture:
            spans.counter("steps.eager/uva." + role)
            return fn(*inputs)
        return graphs[role].run(bound, generator, fn, inputs)

    def sample_fn(state: TrainState, seeds: torch.Tensor,
                  seeds_mask: torch.Tensor,
                  draws: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
        gen = state.generator if generator is None else generator

        def sample(seeds, seeds_mask, *draws):
            blocks, stats = sample_blocks(
                graph, sampler_cfg, plan, gen, seeds, seeds_mask,
                storage.exp3_view(state.exp3_weights),
                draws=list(draws) or None)
            return blocks, reduce_metrics(
                {**stats, **_fixed_point_iters(blocks)}, mesh, mean_keys=())

        return run("sample" if generator is None else "sample_eval",
                   (state, gen, draws is not None), gen, sample,
                   (seeds, seeds_mask, *(draws or ())))

    def train_fn(state: TrainState, blocks, x: torch.Tensor):
        if capture:
            _require_capturable(state)

        def train(x, *tensors):
            return reduce_metrics(
                train_body(state, _with_block_tensors(blocks, tensors), x),
                mesh)

        metrics = run("train", (state, state.generator), state.generator,
                      train, (x, *_block_tensors(blocks)))
        state.scheduler.step()
        state.step += 1
        return state, metrics

    def eval_fn(state: TrainState, blocks, x: torch.Tensor):
        def evaluate(x, *tensors):
            return eval_body(state, _with_block_tensors(blocks, tensors), x)

        return run("eval", (state,), None, evaluate,
                   (x, *_block_tensors(blocks)))

    return sample_fn, train_fn, eval_fn


# what the model and the bandit read of a block (not the sampler's count)
_BLOCK_TENSORS = tuple(f.name for f in dataclasses.fields(Block)
                       if f.name not in ("n_dst_cap", "fixed_point_iters"))


def _block_tensors(blocks) -> List[torch.Tensor]:
    """Every tensor of ``blocks``, block by block, field by field."""
    return [t for b in blocks for t in (getattr(b, f) for f in _BLOCK_TENSORS)
            if t is not None]


def _with_block_tensors(blocks, tensors) -> list:
    """``blocks`` with their tensors replaced, in ``_block_tensors``'
    order, by ``tensors``."""
    it = iter(tensors)
    return [dataclasses.replace(b, **{f: next(it) for f in _BLOCK_TENSORS
                                      if getattr(b, f) is not None})
            for b in blocks]


def replays(dev: torch.device, mesh=None) -> bool:
    """Whether steps on ``dev`` replay captured CUDA graphs: on the card,
    unless ``mesh``'s collectives run on the host (gloo)."""
    return dev.type == "cuda" and (mesh is None or mesh.capturable)


def _require_capturable(state: TrainState) -> None:
    if not state.optimizer.param_groups[0].get("capturable"):
        raise ValueError("a replayed train step runs Adam in a CUDA graph: "
                         "make_optimizer(capturable=True)")


# eager steps before capture: after them the lazy state (Adam's moments,
# the kernels' builds, the library handles) exists
CAPTURE_WARMUP_STEPS = 2


class _Replay:
    """A step captured once in a CUDA graph and replayed per batch.

    ``run(bound, generator, fn, inputs)`` runs ``fn(*inputs)`` on one
    batch's input tensors: the first ``CAPTURE_WARMUP_STEPS`` times eagerly
    on a side stream (real steps), then it captures ``fn`` once, reading
    static copies of the inputs, and replays it; later batches are copied
    into those copies before each replay. ``bound`` holds what the graph
    reads (the state, the generator, whether draws were injected), and
    whether device marks are on (``utils/spans.py``, read at capture):
    another set starts over. A replay returns the graph's own output
    tensors, which the next replay overwrites. A failed capture raises.
    ``captures`` counts the captures of every instance; while spans are on
    the counters ``steps.replays/<role>``, ``steps.captures/<role>`` and
    ``steps.eager/<role>`` (the warm-ups) count this instance's calls."""

    captures = 0

    def __init__(self, role: str):
        self.bound: tuple = ()
        self.warm = 0
        self.graph = self.inputs = self.outputs = self.side = None
        self.counts = tuple(f"steps.{kind}/{role}"
                            for kind in ("replays", "captures", "eager"))

    def run(self, bound: tuple, generator: Optional[torch.Generator],
            fn: Callable, inputs: Sequence[torch.Tensor]):
        bound = (*bound, spans.marks_enabled())
        if (len(bound) != len(self.bound)
                or any(a is not b for a, b in zip(bound, self.bound))):
            self.bound, self.warm, self.graph = bound, 0, None
        if self.graph is not None:
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            self.graph.replay()
            spans.counter(self.counts[0])
            return self.outputs
        if self.warm < CAPTURE_WARMUP_STEPS:
            self.warm += 1
            spans.counter(self.counts[2])
            if self.side is None:
                self.side = torch.cuda.Stream()
            self.side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.side):
                out = fn(*inputs)
            torch.cuda.current_stream().wait_stream(self.side)
            return out
        self.inputs = tuple(x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
            self.outputs = fn(*self.inputs)
        self.graph = graph
        _Replay.captures += 1
        spans.counter(self.counts[1])
        graph.replay()
        return self.outputs


_F1_FIELDS = ("tp", "fp", "fn", "total")


def _pack(metrics: Dict[str, object], device: torch.device):
    """A step's metrics, every one a scalar, as one f64 vector (exact for
    int32 counts and f32 values) and its layout, [(name, dtype)]."""
    layout, vals = [], []
    for name, v in metrics.items():
        if isinstance(v, F1State):
            layout += [(f"{name}.{f}", torch.float32) for f in _F1_FIELDS]
            vals += [getattr(v, f) for f in _F1_FIELDS]
        elif isinstance(v, torch.Tensor):
            layout.append((name, v.dtype))
            vals.append(v)
        else:  # a host scalar: an int count, or a float (cache_miss)
            layout.append((name, torch.float64 if isinstance(v, float)
                           else torch.int32))
            vals.append(torch.full((), v, dtype=torch.float64, device=device))
    return torch.stack([v.to(torch.float64) for v in vals]), layout


def _unpack(rows: torch.Tensor, layout) -> Dict[str, object]:
    """``_pack``'s vectors of K steps, [K, n], as metrics stacked over K."""
    cols = {name: col.to(dtype)
            for (name, dtype), col in zip(layout, rows.unbind(1))}
    out: Dict[str, object] = {}
    for name, col in cols.items():
        head, _, field = name.partition(".")
        if field in _F1_FIELDS:
            out.setdefault(head, F1State(*(cols[f"{head}.{f}"]
                                           for f in _F1_FIELDS)))
        else:
            out[name] = col
    return out


def _check_chain(seeds: torch.Tensor, seeds_mask: torch.Tensor,
                 draws, n_steps: Optional[int]) -> int:
    if seeds.dim() != 2 or tuple(seeds_mask.shape) != tuple(seeds.shape):
        raise ValueError("seeds and seeds_mask must both be [K, B]")
    k = seeds.shape[0]
    if n_steps is not None and k != n_steps:
        raise ValueError(f"{k} batches for a chain of {n_steps} steps")
    if draws is not None and len(draws) != k:
        raise ValueError(f"{len(draws)} draws for {k} batches")
    return k


def chain_train(body: Callable, dev: torch.device,
                n_steps: Optional[int], capture: bool) -> Callable:
    """K steps of ``body`` per call, ``multi(state, seeds[K, B],
    seeds_mask[K, B], draws=None) -> (state, metrics stacked over K)``:
    with ``capture`` one step captured in a CUDA graph and replayed per
    batch (:class:`_Replay`), else a plain loop."""
    replay, layout = _Replay("train"), {}

    def multi(state: TrainState, seeds: torch.Tensor,
              seeds_mask: torch.Tensor, draws=None):
        k = _check_chain(seeds, seeds_mask, draws, n_steps)
        if capture:
            _require_capturable(state)

        def packed(seeds, seeds_mask, *draws):
            vec, layout["train"] = _pack(
                body(state, seeds, seeds_mask, list(draws) or None), dev)
            return vec

        rows = None
        for i in range(k):
            inputs = (seeds[i], seeds_mask[i],
                      *(() if draws is None else draws[i]))
            if capture:
                vec = replay.run((state, state.generator, draws is not None),
                                 state.generator, packed, inputs)
            else:
                spans.counter("steps.eager/train")
                vec = packed(*inputs)
            state.scheduler.step()
            state.step += 1
            if rows is None:
                rows = torch.empty((k, vec.shape[0]), dtype=torch.float64,
                                   device=dev)
            rows[i].copy_(vec)
        return state, _unpack(rows, layout["train"])

    return multi


def make_multi_train_step(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                          plan: CapacityPlan, multilabel: bool,
                          n_steps: Optional[int] = None,
                          device="cuda") -> Callable:
    """K fused train steps per call: ``multi(state, seeds[K, B],
    seeds_mask[K, B], draws=None) -> (state, metrics stacked over K)``,
    ``draws[k]`` batch k's per-block draws: the steps of K calls of
    :func:`make_train_step`'s step, the generator advancing as they would
    advance it. K is ``seeds.shape[0]``, which must equal ``n_steps`` where
    that is given.

    On the CPU a plain loop of those steps. On the card the step is
    captured once as a CUDA graph after ``CAPTURE_WARMUP_STEPS`` eager
    steps and replayed once per batch (:class:`_Replay`), by every later
    call whatever its K; the state's Adam must be capturable
    (``make_optimizer(capturable=True)``). After the capture a chain issues
    no host sync; the metrics stay on the card."""
    dev = _resolve(graph, device)
    return chain_train(_make_step_body(graph, sampler_cfg, plan, multilabel),
                       dev, n_steps, capture=replays(dev))


def chain_eval(body: Callable, dev: torch.device, capture: bool
               ) -> Callable:
    """K sampled validation batches of ``body`` per call, summed in batch
    order (see :func:`make_multi_eval_step`); with ``capture`` one batch
    captured in a CUDA graph and replayed, else a plain loop. With device
    marks on, the batches' stamps are summed too and deferred as one
    ``eval`` unit (``spans.record_pending`` reads them)."""
    replay, unit = _Replay("eval"), {}

    def multi(state: TrainState, generator: Optional[torch.Generator],
              seeds: torch.Tensor, seeds_mask: torch.Tensor, draws=None):
        k = _check_chain(seeds, seeds_mask, draws, None)

        def packed(seeds, seeds_mask, *draws):
            f1, loss_n, n = body(state, generator, seeds, seeds_mask,
                                 list(draws) or None)
            out = (torch.stack([f1.tp, f1.fp, f1.fn, f1.total, loss_n]), n)
            marks = spans.take_pending()  # the body's, with marks on
            if marks is not None:
                _, unit["names"], rel = marks
                out += (rel[:len(unit["names"])],)
            return out

        acc = torch.zeros(5, dtype=torch.float32, device=dev)
        n_sum = torch.zeros((), dtype=torch.int32, device=dev)
        stamps = None
        for i in range(k):
            inputs = (seeds[i], seeds_mask[i],
                      *(() if draws is None else draws[i]))
            if capture:
                out = replay.run((state, generator, draws is not None),
                                 generator, packed, inputs)
            else:
                spans.counter("steps.eager/eval")
                out = packed(*inputs)
            acc = acc + out[0]
            n_sum = n_sum + out[1]
            if len(out) > 2:  # a replay overwrites its outputs: a copy
                stamps = (out[2].clone() if stamps is None
                          else stamps + out[2])
        if stamps is not None:
            spans.defer("eval", unit["names"], stamps)
        return F1State(*acc[:4].unbind()), acc[4], n_sum

    return multi


def make_multi_eval_step(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                         plan: CapacityPlan, multilabel: bool,
                         device="cuda") -> Callable:
    """Chained validation: ``multi(state, generator, seeds[K, B],
    seeds_mask[K, B], draws=None) -> (f1, loss * n, n)``, each the sum over
    the K batches of :func:`make_eval_step`'s outputs, added in batch order
    in their own dtypes, the generator advancing as K single calls would
    advance it: the sums of the unchained loop, bit for bit. On the card
    the eval step is captured once as a CUDA graph and replayed per batch,
    as in :func:`make_multi_train_step`."""
    dev = _resolve(graph, device)
    return chain_eval(_make_eval_body(graph, sampler_cfg, plan, multilabel),
                      dev, capture=replays(dev))
