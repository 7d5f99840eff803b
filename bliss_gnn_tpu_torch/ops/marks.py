"""Device marks: the clock of the device that a unit of work runs on,
written into the unit's stamp tensors (``utils/spans.py``'s ``Marks``).

A CUDA tensor goes to the hand-written kernel ``csrc/marks.cu`` (one
thread reads ``%globaltimer``, in ns); a CPU tensor goes to
:func:`stamp_plain`, which writes ``time.perf_counter_ns`` instead, so the
CPU path has the same structure. ``slot < 0`` writes the unit's base (the
absolute clock) into ``base[0]``; ``slot >= 0`` writes the clock less the
base into ``rel[slot]`` (f64, exact: the differences stay far below 2^53).
"""
from __future__ import annotations

import time

import torch

from bliss_gnn_tpu_torch.ops import _build


def stamp_plain(base: torch.Tensor, rel: torch.Tensor, slot: int) -> None:
    """The kernel's function on the host's clock."""
    now = time.perf_counter_ns()
    if slot < 0:
        base[0] = now
    else:
        rel[slot] = float(now - int(base[0]))


def stamp(base: torch.Tensor, rel: torch.Tensor, slot: int) -> None:
    """``base`` int64 [1], ``rel`` f64 [n], ``slot`` < n. On the card one
    launch on the current stream (under capture: a node of the graph)."""
    if base.device.type == "cpu":
        return stamp_plain(base, rel, slot)
    if (base.dtype != torch.int64 or rel.dtype != torch.float64
            or rel.device != base.device or slot >= rel.shape[0]):
        raise ValueError("stamp: base int64 [1] and rel f64 [n] on one card, "
                         "slot < n")
    err = _build.load("marks").bliss_mark(base.data_ptr(), rel.data_ptr(),
                                          slot, _build.stream_of(base))
    stamp.launches += 1
    _build.check(err, "stamp")


stamp.launches = 0
