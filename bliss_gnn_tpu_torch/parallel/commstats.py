"""Communication accounting of the parallel steps (counterpart of
``bliss_gnn_tpu/parallel/commstats.py``).

The design's contract per step (``parallel/dp.py``): the collectives are
- the gradient and metric all-reduces: O(|params| + a few scalars);
- the EXP3 sparse-delta all-gather: O(sum of the block edge caps), the
  per-rank (eid, exponent) lists, NOT O(E) (a dense arm-weight sync would
  be 2 bytes x L x E, ~690 MB at Reddit scale).

The JAX package reads the collectives out of the lowered HLO text. The
port has no compiled program to read, so every collective of
``parallel/mesh.py`` reports its kind, shape, dtype and bytes to the
recorders open at the time (:func:`recording`): run one eager step inside
one and the entries are that step's collectives.

Analytic model (the JAX package's): a ring all-reduce of B bytes over n
ranks moves 2B(n-1)/n per rank; an all-gather whose output is B bytes
B(n-1)/n; a reduce-scatter of output B bytes B(n-1); a permute or
all-to-all its payload once. t_comm = bytes / link rate, with no overlap
of compute and communication; predicted weak-scaling efficiency = t_step
/ (t_step + t_comm). The default link rate is the H100 SXM's NVLink, 900
GB/s in both directions (its data sheet), taken as 450 GB/s one way.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List

import torch

NVLINK_BYTES_PER_S = 450e9

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred",
}


@dataclasses.dataclass(frozen=True)
class Collective:
    # all_reduce | all_gather | reduce_scatter | all_to_all |
    # collective_permute
    kind: str
    shape: tuple
    dtype: str
    out_bytes: int

    def bytes_moved_per_device(self, n_dev: int) -> float:
        """Ring-algorithm bytes each rank sends (see the module note)."""
        b = self.out_bytes
        if self.kind == "all_reduce":
            return 2.0 * b * (n_dev - 1) / n_dev
        if self.kind == "all_gather":
            return b * (n_dev - 1) / n_dev
        if self.kind == "reduce_scatter":
            # out is the scattered shard; the input was n_dev x larger
            return b * (n_dev - 1)
        return float(b)  # permute / all_to_all: the payload crosses once


class Recorder:
    """The collectives issued while it was open, in order."""

    def __init__(self):
        self.entries: List[Collective] = []


_OPEN: List[Recorder] = []


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Records every collective of the mesh issued inside the block."""
    rec = Recorder()
    _OPEN.append(rec)
    try:
        yield rec
    finally:
        _OPEN.remove(rec)


def record(kind: str, out: torch.Tensor) -> None:
    """Called by each collective of ``parallel/mesh.py`` with its output."""
    if not _OPEN:
        return
    c = Collective(kind, tuple(out.shape),
                   _DTYPE_NAMES.get(out.dtype, str(out.dtype)),
                   out.numel() * out.element_size())
    for rec in _OPEN:
        rec.entries.append(c)


def comm_summary(entries: List[Collective], n_dev: int) -> dict:
    per_kind: dict = {}
    total_out = 0
    total_moved = 0.0
    largest = 0
    for c in entries:
        k = per_kind.setdefault(
            c.kind, {"count": 0, "out_bytes": 0, "moved_bytes": 0.0})
        k["count"] += 1
        k["out_bytes"] += c.out_bytes
        k["moved_bytes"] += c.bytes_moved_per_device(n_dev)
        total_out += c.out_bytes
        total_moved += c.bytes_moved_per_device(n_dev)
        largest = max(largest, c.out_bytes)
    return {
        "per_kind": per_kind,
        "total_out_bytes": total_out,
        "moved_bytes_per_device": total_moved,
        "largest_collective_bytes": largest,
        "n_collectives": len(entries),
    }


def predicted_scaling_pct(step_time_s: float, moved_bytes_per_device: float,
                          link_bytes_per_s: float = NVLINK_BYTES_PER_S
                          ) -> float:
    """Weak-scaling efficiency prediction: t / (t + comm), no overlap."""
    t_comm = moved_bytes_per_device / link_bytes_per_s
    return 100.0 * step_time_s / (step_time_s + t_comm)
