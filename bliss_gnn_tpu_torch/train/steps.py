"""The fused training step (counterpart of the single-device step body of
``bliss_gnn_tpu/train/steps.py``):

    sample_blocks -> gather features and labels -> model forward/backward
    -> CE loss -> Adam (staircase decay) -> EXP3 rewards + arm-weight update

The sampler reads the current arm weights; the update runs after the
backward, in place. PyTorch runs eagerly, so the step is a plain function.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
from bliss_gnn_tpu_torch.sampling.samplers import (
    SamplerConfig,
    apply_exp3_deltas,
    exp3_edge_deltas,
    sample_blocks,
)
from bliss_gnn_tpu_torch.train.metrics import F1State, f1_update


@dataclasses.dataclass
class TrainState:
    """Per-run state: the model (its parameters), the optimizer and its
    schedule, the EXP3 arm weights, the generator of every draw, the step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
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
        per = F.cross_entropy(logits, labels.long(), reduction="none")
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


def make_optimizer(params, lr: float, steps_per_epoch: int,
                   gamma: float = 0.01, step_size: int = 5):
    """Adam with the rate multiplied by ``gamma`` every ``step_size``
    epochs (a staircase decay, stepped once per training step)."""
    opt = torch.optim.Adam(params, lr=lr)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=max(1, step_size * steps_per_epoch), gamma=gamma)
    return opt, sched


def make_train_step(graph: DeviceGraph, sampler_cfg: SamplerConfig,
                    plan: CapacityPlan, multilabel: bool,
                    device="cuda") -> Callable:
    """The fused step ``step(state, seeds, seeds_mask, draws=None) ->
    (state, metrics)``. ``device`` (default CUDA, which raises without a
    card) must be where ``graph`` lives; ``draws`` injects the sampler's
    per-block draws (see ``sample_blocks``)."""
    dev = resolve_device(device)
    if graph.device.type != dev.type:
        raise ValueError(f"graph is on {graph.device}, step asked for {dev}")

    def step(state: TrainState, seeds: torch.Tensor,
             seeds_mask: torch.Tensor,
             draws: Optional[Sequence[torch.Tensor]] = None,
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gen = state.generator
        blocks, samp_stats = sample_blocks(
            graph, sampler_cfg, plan, gen, seeds, seeds_mask,
            state.exp3_weights, draws=draws)
        x = graph.ndata["features"][blocks[0].src_gids.long()]
        labels = graph.ndata["labels"][blocks[-1].dst_gids.long()]
        dst_mask = blocks[-1].dst_mask

        model = state.model
        model.train()
        logits, aux = model(blocks, x, generator=gen)
        loss = cross_entropy_loss(logits, labels, dst_mask, multilabel)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()

        if sampler_cfg.is_bandit and not sampler_cfg.exp3_freeze:
            # unnormalised: every consumer renormalises per dst
            deltas = exp3_edge_deltas(graph, sampler_cfg, blocks,
                                      aux["embed_norms"], aux["a_ijs"])
            apply_exp3_deltas(state.exp3_weights, deltas, normalize=False)
        f1 = f1_update(F1State.zero(dev), logits.detach(), labels, dst_mask,
                       multilabel)
        metrics = {
            "train_loss": loss.detach(),
            "f1": f1,
            # the JAX step's key; K4 skips no update, so it is always 0
            "exp3_apply_overflow": 0,
            **_block_count_metrics(blocks),
            **{k: v for k, v in samp_stats.items()
               if "overflow" in k or "frontier_edges" in k
               or "n_block_edges_true" in k},
        }
        state.step += 1
        return state, metrics

    return step
