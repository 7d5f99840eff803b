"""K5: wide-row scatter-add, out[S, F] f32 with out[ids[e], :] += data[e, :].

Counterpart of ``bliss_gnn_tpu/ops/rowscatter_pallas.py``. A CUDA tensor
goes to the hand-written kernel ``csrc/row_scatter.cu`` (warp per edge row,
four columns and one float4 atomic per lane; the design note is in the
source); a CPU tensor goes to :func:`row_scatter_add_plain`. The output is
f32 whatever the payload's dtype; ``ops.segment.masked_segment_sum`` casts
it back.

Callers are the wide 2-D segment sums (F % 128 == 0, F >= 512, at least
2^15 rows): the GATv2 message aggregation over [E, H*O = 1024] and the two
gather backwards of ``GATv2Conv``.
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32, prefix_mask, valid_arg

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def row_scatter_add_plain(data: torch.Tensor, ids: torch.Tensor,
                          num_segments: int, n_valid=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [num_segments, F]; ids
    outside [0, S) and rows at or past ``n_valid`` add nothing."""
    keep = (ids >= 0) & (ids < num_segments)
    live = prefix_mask(ids.shape[0], n_valid, ids.device)
    if live is not None:
        keep &= live
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    out.index_put_((torch.where(keep, ids, 0).long(),),
                   data.to(torch.float32).masked_fill(~keep[:, None], 0.0),
                   accumulate=True)
    return out


def row_scatter_add(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                    n_valid=None) -> torch.Tensor:
    """[num_segments, F] f32 sum of ``data`` [E, F] rows by ``ids`` [E]."""
    if data.device.type == "cpu":
        return row_scatter_add_plain(data, ids, num_segments, n_valid)
    if data.device.type != "cuda" or ids.device != data.device:
        raise ValueError(
            f"row_scatter_add: no kernel for {data.device}/{ids.device}")
    if data.dim() != 2 or ids.shape[0] != data.shape[0]:
        raise ValueError("row_scatter_add: data must be [E, F] with ids [E]")
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_scatter_add: no kernel for {data.dtype}")
    e, f = data.shape
    if f % 4 != 0:
        raise ValueError(f"row_scatter_add: F = {f} is not a multiple of 4")
    data = data.contiguous()
    if data.data_ptr() % 16 != 0:  # the kernel loads aligned vectors
        data = data.clone()
    ids = index_i32(ids, "row_scatter_add ids")
    nv = valid_arg(n_valid, data.device)
    out = torch.empty((num_segments, f), dtype=torch.float32,
                      device=data.device)
    lib = _build.load("row_scatter")
    err = lib.bliss_row_scatter_add(
        data.data_ptr(), _DTYPE_CODE[data.dtype], ids.data_ptr(), e, f,
        _build.ptr(nv), num_segments, out.data_ptr(), _build.stream_of(data))
    row_scatter_add.launches += 1
    _build.check(err, "row_scatter_add")
    return out


row_scatter_add.launches = 0


class _RowScatter(torch.autograd.Function):
    """Differentiable in ``data``: the gradient is the row gather g[ids] in
    the payload's dtype, zero for ids outside [0, S)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, n_valid):
        ctx.save_for_backward(ids)
        ctx.num_segments, ctx.dtype = num_segments, data.dtype
        return row_scatter_add(data, ids, num_segments, n_valid)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        keep = (ids >= 0) & (ids < ctx.num_segments)
        dd = g[torch.where(keep, ids, 0).long()].masked_fill(~keep[:, None], 0)
        return dd.to(ctx.dtype), None, None, None


def row_scatter_add_diff(data, ids, num_segments: int, n_valid=None):
    if data.requires_grad:
        return _RowScatter.apply(data, ids, num_segments, n_valid)
    return row_scatter_add(data, ids, num_segments, n_valid)
