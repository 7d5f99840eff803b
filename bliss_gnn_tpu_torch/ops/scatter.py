"""K1: scatter-add of a 1-D float payload, out[keys[i]] += vals[i].

Counterpart of ``bliss_gnn_tpu/ops/scatter_pallas.py``. A CUDA tensor goes
to the hand-written kernel ``csrc/scatter_add.cu``; a CPU tensor goes to
:func:`scatter_add_plain`. Two routes, one launch each (the design notes
are in the source): keys sorted on the valid prefix (``ids_sorted=True``)
take a reduce by key, with no atomics and the same bits on every call;
other keys take f32 atomics after a memset.

Callers are the 1-D float segment sums of the sampler: the importance
probability's sum of r_ij^2 by src (unsorted), the block-build counts and
debias sums, the per-dst frontier sums and ``Block.in_degrees`` (sorted).
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import (
    check_sorted,
    index_i32,
    prefix_mask,
    sorted_valid_arg,
    valid_arg,
)


def scatter_add_plain(keys: torch.Tensor, vals: torch.Tensor, n_out: int,
                      n_valid=None, ids_sorted: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [n_out], keys outside
    [0, n_out) and slots at or past ``n_valid`` add nothing. With
    ``ids_sorted`` on a CPU tensor it checks the caller's promise."""
    if ids_sorted:
        check_sorted(keys, n_valid, "scatter_add")
    vals = vals.to(torch.float32)
    keep = (keys >= 0) & (keys < n_out)
    live = prefix_mask(keys.shape[0], n_valid, keys.device)
    if live is not None:
        keep &= live
    out = torch.zeros(n_out, dtype=torch.float32, device=vals.device)
    out.index_put_((torch.where(keep, keys, 0).long(),),
                   torch.where(keep, vals, 0.0), accumulate=True)
    return out


def scatter_add(keys: torch.Tensor, vals: torch.Tensor, n_out: int,
                n_valid=None, ids_sorted: bool = False) -> torch.Tensor:
    """out[n_out] f32 with out[keys[i]] += vals[i] for i < n_valid.

    ``n_valid`` (None, int or 0-dim tensor) bounds the contiguous prefix
    that holds every non-zero value; the kernel skips the rest.
    ``ids_sorted`` promises keys non-decreasing on that prefix (it needs
    ``n_valid``); nothing on the card checks the promise."""
    if vals.device.type == "cpu":
        return scatter_add_plain(keys, vals, n_out, n_valid, ids_sorted)
    if vals.device.type != "cuda" or keys.device != vals.device:
        raise ValueError(f"scatter_add: no kernel for {vals.device}/{keys.device}")
    if vals.dim() != 1 or keys.shape != vals.shape:
        raise ValueError("scatter_add: keys and vals must be 1-D of one length")
    keys = index_i32(keys, "scatter_add keys")
    vals = vals.to(torch.float32).contiguous()
    out = torch.empty(n_out, dtype=torch.float32, device=vals.device)
    lib = _build.load("scatter_add")
    stream = _build.stream_of(vals)
    n = keys.shape[0]
    if ids_sorted:
        nv = sorted_valid_arg(n_valid, vals.device, "scatter_add")
        vec = int(keys.data_ptr() % 16 == 0 and vals.data_ptr() % 16 == 0)
        err = lib.bliss_scatter_add_sorted_f32(
            keys.data_ptr(), vals.data_ptr(), out.data_ptr(), n,
            nv.data_ptr(), n_out, vec, stream)
    else:
        nv = valid_arg(n_valid, vals.device)
        err = lib.bliss_scatter_add_f32(
            keys.data_ptr(), vals.data_ptr(), out.data_ptr(), n,
            _build.ptr(nv), n_out, stream)
    scatter_add.launches += 1
    _count(f"{'sorted' if ids_sorted else 'unsorted'} n={n}")
    _build.check(err, "scatter_add")
    return out


def _count(key: str) -> None:
    by = scatter_add.launches_by_shape
    by[key] = by.get(key, 0) + 1


scatter_add.launches = 0
# the same launches by route and key count, e.g. "sorted n=150016"
scatter_add.launches_by_shape = {}


class _ScatterAdd(torch.autograd.Function):
    """Differentiable in ``vals``: the gradient of out[k] += v is g[k]."""

    @staticmethod
    def forward(ctx, keys, vals, n_out, n_valid, ids_sorted):
        ctx.save_for_backward(keys)
        ctx.n_out = n_out
        return scatter_add(keys, vals, n_out, n_valid, ids_sorted)

    @staticmethod
    def backward(ctx, g):
        (keys,) = ctx.saved_tensors
        keep = (keys >= 0) & (keys < ctx.n_out)
        dv = g[torch.where(keep, keys, 0).long()].masked_fill(~keep, 0.0)
        return None, dv, None, None, None


def scatter_add_diff(keys, vals, n_out: int, n_valid=None,
                     ids_sorted: bool = False) -> torch.Tensor:
    if vals.requires_grad:
        return _ScatterAdd.apply(keys, vals, n_out, n_valid, ids_sorted)
    return scatter_add(keys, vals, n_out, n_valid, ids_sorted)
