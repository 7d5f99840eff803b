"""K3: row segment-sum, out[S, F] = sum of data[e, :] into row ids[e].

Counterpart of ``bliss_gnn_tpu/ops/segsum_pallas.py``. A CUDA tensor goes to
the hand-written kernel ``csrc/segment_sum.cu`` (warp per edge row, f32
atomics into a scratch, one cast pass); a CPU tensor goes to
:func:`segment_sum_plain`. bf16 and f32 payloads accumulate in f32 and come
back in their own dtype.

Callers are the SAGE block aggregation and, through the backward of
``segment.gather_rows``, the message gradient into the src table.
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32, prefix_mask, valid_arg

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def segment_sum_plain(data: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, n_valid=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 accumulation, output in
    data's dtype; ids outside [0, S) and rows past ``n_valid`` add 0."""
    keep = (ids >= 0) & (ids < num_segments)
    live = prefix_mask(ids.shape[0], n_valid, ids.device)
    if live is not None:
        keep &= live
    acc = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    acc.index_put_((torch.where(keep, ids, 0).long(),),
                   data.to(torch.float32).masked_fill(~keep[:, None], 0.0),
                   accumulate=True)
    return acc.to(data.dtype)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                n_valid=None) -> torch.Tensor:
    """[num_segments, F] sum of ``data`` [E, F] rows by ``ids`` [E]."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, num_segments, n_valid)
    if data.device.type != "cuda" or ids.device != data.device:
        raise ValueError(f"segment_sum: no kernel for {data.device}/{ids.device}")
    if data.dim() != 2 or ids.shape[0] != data.shape[0]:
        raise ValueError("segment_sum: data must be [E, F] with ids [E]")
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_sum: no kernel for {data.dtype}")
    data = data.contiguous()
    ids = index_i32(ids, "segment_sum ids")
    e, f = data.shape
    nv = valid_arg(n_valid, data.device)
    out = torch.empty((num_segments, f), dtype=data.dtype, device=data.device)
    acc = (torch.empty((num_segments, f), dtype=torch.float32,
                       device=data.device)
           if data.dtype != torch.float32 else None)
    lib = _build.load("segment_sum")
    err = lib.bliss_segment_sum(
        data.data_ptr(), _DTYPE_CODE[data.dtype], ids.data_ptr(), e, f,
        _build.ptr(nv), num_segments, _build.ptr(acc), out.data_ptr(),
        _build.stream_of(data))
    segment_sum.launches += 1
    _build.check(err, "segment_sum")
    return out


segment_sum.launches = 0


class _SegmentSum(torch.autograd.Function):
    """Differentiable in ``data``: the gradient is the row gather g[ids],
    zero for ids outside [0, S) (they added nothing forward)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, n_valid):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return segment_sum(data, ids, num_segments, n_valid)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        keep = (ids >= 0) & (ids < ctx.num_segments)
        dmsg = g[torch.where(keep, ids, 0).long()]
        return dmsg.masked_fill(~keep[:, None], 0), None, None, None


def segment_sum_diff(data, ids, num_segments: int, n_valid=None):
    if data.requires_grad:
        return _SegmentSum.apply(data, ids, num_segments, n_valid)
    return segment_sum(data, ids, num_segments, n_valid)
