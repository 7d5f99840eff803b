"""Streaming micro-F1 counts (counterpart of ``F1State``, ``f1_update`` and
``f1_compute`` in ``bliss_gnn_tpu/train/metrics.py``).

Multiclass micro-F1 equals accuracy: track (correct, total). Multilabel
micro-F1 is 2TP / (2TP + FP + FN) with a positive logit as a positive.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class F1State:
    tp: torch.Tensor  # multiclass: correct; multilabel: true positives
    fp: torch.Tensor
    fn: torch.Tensor
    total: torch.Tensor  # multiclass: samples

    @staticmethod
    def zero(device="cpu") -> "F1State":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return F1State(tp=z, fp=z, fn=z, total=z)


def f1_update(state: F1State, logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, multilabel: bool) -> F1State:
    if multilabel:
        pred, lab, m = logits > 0, labels > 0.5, mask[:, None]
        tp = (pred & lab & m).sum().to(torch.float32)
        fp = (pred & ~lab & m).sum().to(torch.float32)
        fn = (~pred & lab & m).sum().to(torch.float32)
        return F1State(state.tp + tp, state.fp + fp, state.fn + fn,
                       state.total)
    correct = ((logits.argmax(dim=-1) == labels) & mask).sum().to(torch.float32)
    total = mask.sum().to(torch.float32)
    return F1State(state.tp + correct, state.fp, state.fn, state.total + total)


def f1_compute(state: F1State, multilabel: bool) -> torch.Tensor:
    if multilabel:
        denom = 2 * state.tp + state.fp + state.fn
        return torch.where(denom > 0, 2 * state.tp / denom.clamp(min=1), 0.0)
    return torch.where(state.total > 0, state.tp / state.total.clamp(min=1),
                       0.0)
