"""Seed-batch data-parallel train and eval steps over a mesh of ranks
(counterpart of ``bliss_gnn_tpu/parallel/dp.py``).

- each caller passes the GLOBAL seed batch ([S * local batch], or [K, S *
  local batch] for a chain) and each rank takes its contiguous slice; the
  plan's batch is the local batch;
- each rank samples its own blocks from the replicated graph with its own
  generator (``Mesh.generator``: the JAX step's key folded by the axis
  index; rank 0's is the one-device step's);
- the gradients are averaged over the ranks before Adam, which runs
  replicated (identical inputs give identical parameters);
- the replicated arm weights stay consistent: every rank's sparse (eid,
  exponent) lists are all-gathered and every rank applies all of them with
  K4. Multiplicative updates compose, so ranks touching one edge compose as
  a sequential stream would;
- the metrics are summed over the ranks, the loss averaged, the refit's
  maxima maxed, with the JAX step's key sets.

The per-rank body is ``train.steps``' fused step body with ``mesh=``: the
same code as the one-device step, so at one rank the DP step is the fused
step: the same blocks, and the same loss, update and arm weights up to the
unsorted scatter routes' atomic order, as two runs of the fused step are.
The chained steps capture the step, its collectives
included, in a CUDA graph when the mesh runs NCCL on the card
(``Mesh.capturable``); under gloo (host collectives) they are a plain loop.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
from bliss_gnn_tpu_torch.sampling.samplers import SamplerConfig
from bliss_gnn_tpu_torch.train.steps import (
    TrainState,
    _make_eval_body,
    _make_step_body,
    chain_eval,
    chain_train,
    replays,
)


def local_slice(mesh, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous slice of a global batch along ``dim``."""
    per = t.shape[dim] // mesh.size
    if per * mesh.size != t.shape[dim]:
        raise ValueError(f"a global batch of {t.shape[dim]} does not split "
                         f"over {mesh.size} ranks")
    return t.narrow(dim, mesh.rank * per, per)


def step_over(mesh, body: Callable) -> Callable:
    """``step(state, seeds, seeds_mask, draws=None) -> (state, metrics)``
    of a per-rank body on the global batch."""

    def step(state: TrainState, seeds: torch.Tensor,
             seeds_mask: torch.Tensor, draws=None):
        metrics = body(state, local_slice(mesh, seeds),
                       local_slice(mesh, seeds_mask), draws)
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return step


def multi_over(mesh, body: Callable, n_steps: Optional[int]) -> Callable:
    """K steps of a per-rank body per call on [K, S * B] batches."""
    multi = chain_train(body, mesh.device, n_steps,
                        capture=replays(mesh.device, mesh))

    def run(state: TrainState, seeds: torch.Tensor,
            seeds_mask: torch.Tensor, draws=None):
        return multi(state, local_slice(mesh, seeds, 1),
                     local_slice(mesh, seeds_mask, 1), draws)

    return run


def eval_over(mesh, body: Callable) -> Callable:
    def ev(state: TrainState, generator, seeds: torch.Tensor,
           seeds_mask: torch.Tensor, draws=None):
        return body(state, generator, local_slice(mesh, seeds),
                    local_slice(mesh, seeds_mask), draws)

    return ev


def multi_eval_over(mesh, body: Callable) -> Callable:
    multi = chain_eval(body, mesh.device,
                       capture=replays(mesh.device, mesh))

    def run(state: TrainState, generator, seeds: torch.Tensor,
            seeds_mask: torch.Tensor, draws=None):
        return multi(state, generator, local_slice(mesh, seeds, 1),
                     local_slice(mesh, seeds_mask, 1), draws)

    return run


def _check(mesh, graph):
    if graph.device.type != mesh.device.type:
        raise ValueError(f"graph is on {graph.device}, the mesh's ranks on "
                         f"{mesh.device}")


def make_dp_train_step(mesh, graph, sampler_cfg: SamplerConfig,
                       plan: CapacityPlan, multilabel: bool,
                       exp3_normalize: bool = True) -> Callable:
    """The DP fused step: ``step(state, seeds[S * B], seeds_mask, draws=None)
    -> (state, metrics)``; ``plan.batch_size`` is the local batch B,
    ``state`` this rank's (its generator this rank's), ``draws`` this
    rank's injected draws."""
    _check(mesh, graph)
    return step_over(mesh, _make_step_body(
        graph, sampler_cfg, plan, multilabel, mesh=mesh,
        exp3_normalize=exp3_normalize))


def make_dp_multi_train_step(mesh, graph, sampler_cfg: SamplerConfig,
                             plan: CapacityPlan, multilabel: bool,
                             n_steps: Optional[int] = None,
                             exp3_normalize: bool = True) -> Callable:
    """K DP steps per call on seeds/masks [K, S * B]; metrics stacked over
    K. Captured and replayed on the card under NCCL (the state's Adam must
    be capturable), a plain loop under gloo."""
    _check(mesh, graph)
    return multi_over(mesh, _make_step_body(
        graph, sampler_cfg, plan, multilabel, mesh=mesh,
        exp3_normalize=exp3_normalize), n_steps)


def make_dp_eval_step(mesh, graph, sampler_cfg: SamplerConfig,
                      plan: CapacityPlan, multilabel: bool) -> Callable:
    """``eval_step(state, generator, seeds[S * B], seeds_mask) -> (f1,
    loss * n, n)`` summed over the ranks; ``generator`` this rank's."""
    _check(mesh, graph)
    return eval_over(mesh, _make_eval_body(graph, sampler_cfg, plan,
                                           multilabel, mesh=mesh))


def make_dp_multi_eval_step(mesh, graph, sampler_cfg: SamplerConfig,
                            plan: CapacityPlan, multilabel: bool
                            ) -> Callable:
    """Chained DP validation on seeds/masks [K, S * B]."""
    _check(mesh, graph)
    return multi_eval_over(mesh, _make_eval_body(graph, sampler_cfg, plan,
                                                 multilabel, mesh=mesh))
