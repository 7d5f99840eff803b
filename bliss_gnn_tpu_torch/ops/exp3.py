"""K4: sparse multiplicative update of the bf16 EXP3 arm-weight state.

Counterpart of ``bliss_gnn_tpu/ops/exp3_pallas.py``. The state is flat
(``[L * (n_edges + EDGE_PAD)]`` viewed from the sampler's ``[L, E']``), and
is updated IN PLACE: the sparse update touches ~10^5 of ~3.4*10^8 entries,
so a functional copy would move the whole 690 MB state at Reddit scale.

The wrapper sorts the flat indices (``torch.sort``) and permutes the factors
through K2; the hand-written kernel ``csrc/exp3_apply.cu`` then multiplies
each run of equal indices in f32 and writes its bf16 entry once. Slots with
an index outside [0, limit) are no-ops. Nothing is ever skipped, so the
returned overflow count is always 0.
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32
from bliss_gnn_tpu_torch.ops.gather import lut_gather


def exp3_apply_plain(state: torch.Tensor, flat_idx: torch.Tensor,
                     mult: torch.Tensor, limit: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per distinct index, the f32
    product of its factors, applied to the bf16 entry with one rounding."""
    s_idx, order = torch.sort(flat_idx.long(), stable=True)
    s_mult = mult.to(torch.float32)[order]
    uniq, inverse = torch.unique_consecutive(s_idx, return_inverse=True)
    prod = torch.ones(uniq.shape[0], dtype=torch.float32, device=state.device)
    prod.scatter_reduce_(0, inverse, s_mult, "prod")
    live = (uniq >= 0) & (uniq < limit)
    target, factor = uniq[live], prod[live]
    state[target] = (state[target].to(torch.float32) * factor).to(state.dtype)
    return torch.zeros((), dtype=torch.int32, device=state.device)


def exp3_apply(state: torch.Tensor, flat_idx: torch.Tensor,
               mult: torch.Tensor, limit: int) -> torch.Tensor:
    """state[flat_idx] *= mult in place on a flat bf16 ``state``; returns
    the 0-dim int32 count of skipped updates (always 0)."""
    if state.device.type == "cpu":
        return exp3_apply_plain(state, flat_idx, mult, limit)
    if state.device.type != "cuda" or flat_idx.device != state.device:
        raise ValueError(f"exp3_apply: no kernel for {state.device}")
    if state.dtype != torch.bfloat16 or state.dim() != 1:
        raise TypeError("exp3_apply: the state must be a flat bf16 tensor")
    if not state.is_contiguous():
        raise ValueError("exp3_apply: the state must be contiguous")
    if flat_idx.shape != mult.shape:
        raise ValueError("exp3_apply: flat_idx and mult must match")
    s_idx, order = torch.sort(index_i32(flat_idx, "exp3_apply flat_idx"),
                              stable=True)
    s_mult = lut_gather(mult.to(torch.float32).contiguous(), order)
    lib = _build.load("exp3_apply")
    err = lib.bliss_exp3_apply(
        state.data_ptr(), s_idx.data_ptr(), s_mult.data_ptr(),
        s_idx.shape[0], int(limit), _build.stream_of(state))
    exp3_apply.launches += 1
    _build.check(err, "exp3_apply")
    return torch.zeros((), dtype=torch.int32, device=state.device)


exp3_apply.launches = 0
