"""K1: scatter-add of a 1-D float payload, out[keys[i]] += vals[i].

Counterpart of ``bliss_gnn_tpu/ops/scatter_pallas.py``. A CUDA tensor goes
to the hand-written kernel ``csrc/scatter_add.cu`` (f32 atomics; the design
note is in the source); a CPU tensor goes to :func:`scatter_add_plain`.

Callers are the 1-D float segment sums of the sampler: the importance
probability's sum of r_ij^2 by src, the block-build counts and debias sums,
the per-dst frontier sums and ``Block.in_degrees``.
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32, prefix_mask, valid_arg


def scatter_add_plain(keys: torch.Tensor, vals: torch.Tensor, n_out: int,
                      n_valid=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [n_out], keys outside
    [0, n_out) and slots at or past ``n_valid`` add nothing."""
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
                n_valid=None) -> torch.Tensor:
    """out[n_out] f32 with out[keys[i]] += vals[i] for i < n_valid.

    ``n_valid`` (None, int or 0-dim tensor) bounds the contiguous prefix
    that holds every non-zero value; the kernel skips the rest."""
    if vals.device.type == "cpu":
        return scatter_add_plain(keys, vals, n_out, n_valid)
    if vals.device.type != "cuda" or keys.device != vals.device:
        raise ValueError(f"scatter_add: no kernel for {vals.device}/{keys.device}")
    if vals.dim() != 1 or keys.shape != vals.shape:
        raise ValueError("scatter_add: keys and vals must be 1-D of one length")
    keys = index_i32(keys, "scatter_add keys")
    vals = vals.to(torch.float32).contiguous()
    nv = valid_arg(n_valid, vals.device)
    out = torch.empty(n_out, dtype=torch.float32, device=vals.device)
    lib = _build.load("scatter_add")
    err = lib.bliss_scatter_add_f32(
        keys.data_ptr(), vals.data_ptr(), out.data_ptr(), keys.shape[0],
        _build.ptr(nv), n_out, _build.stream_of(vals))
    scatter_add.launches += 1
    _build.check(err, "scatter_add")
    return out


scatter_add.launches = 0


class _ScatterAdd(torch.autograd.Function):
    """Differentiable in ``vals``: the gradient of out[k] += v is g[k]."""

    @staticmethod
    def forward(ctx, keys, vals, n_out, n_valid):
        ctx.save_for_backward(keys)
        ctx.n_out = n_out
        return scatter_add(keys, vals, n_out, n_valid)

    @staticmethod
    def backward(ctx, g):
        (keys,) = ctx.saved_tensors
        keep = (keys >= 0) & (keys < ctx.n_out)
        dv = g[torch.where(keep, keys, 0).long()].masked_fill(~keep, 0.0)
        return None, dv, None, None


def scatter_add_diff(keys, vals, n_out: int, n_valid=None) -> torch.Tensor:
    if vals.requires_grad:
        return _ScatterAdd.apply(keys, vals, n_out, n_valid)
    return scatter_add(keys, vals, n_out, n_valid)
