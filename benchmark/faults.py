"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false and for the readings that set a training
cell's upper limits. Each is a context manager that patches the port's
modules for its duration.

- ``state_unchanged``: Adam's step does nothing, so the step leaves the
  parameters as they were;
- ``window_state_unchanged``: the same from the fourth step on, so the
  set-up's first three steps are sound and the window's are not;
- ``half_batch``: the loss leaves out the second half of the batch and
  takes the mean over the rest;
- ``answer_altered``: training reports a loss 5 % off; inference returns
  one node's logits doubled;
- ``half_nodes``: inference leaves the second half of the nodes' logits
  at zero.
"""
from __future__ import annotations

import contextlib

import torch

TRAIN = ("state_unchanged", "window_state_unchanged", "half_batch",
         "answer_altered")
INFER = ("answer_altered", "half_nodes")


@contextlib.contextmanager
def _patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def plant(mode, name):
    import bliss_gnn_tpu_torch.models.inference as inference
    import bliss_gnn_tpu_torch.train.steps as steps

    if mode == "train" and name == "state_unchanged":
        return _patched(torch.optim.Adam, "step",
                        lambda step: lambda self, closure=None: None)
    if mode == "train" and name == "window_state_unchanged":
        def after_three(step):
            calls = [0]

            def maybe(self, closure=None):
                calls[0] += 1
                return step(self, closure) if calls[0] <= 3 else None
            return maybe
        return _patched(torch.optim.Adam, "step", after_three)
    if mode == "train" and name == "half_batch":
        def loss(orig):
            def half(logits, labels, mask, multilabel):
                keep = torch.arange(mask.shape[0], device=mask.device)
                return orig(logits, labels, mask & (keep < mask.shape[0] // 2),
                            multilabel)
            return half
        return _patched(steps, "cross_entropy_loss", loss)
    if mode == "train" and name == "answer_altered":
        return _patched(steps, "cross_entropy_loss", lambda orig: (
            lambda *a: orig(*a) * 1.05))
    if mode == "infer" and name == "answer_altered":
        def doubled(orig):
            def run(*a, **k):
                out = orig(*a, **k)
                out[out.shape[0] // 3] *= 2.0
                return out
            return run
        return _patched(inference, "layerwise_inference", doubled)
    if mode == "infer" and name == "half_nodes":
        def half(orig):
            def run(*a, **k):
                out = orig(*a, **k)
                out[out.shape[0] // 2:] = 0.0
                return out
            return run
        return _patched(inference, "layerwise_inference", half)
    raise ValueError(f"no fault {name!r} for {mode}")
