"""K3: row segment-sum, out[S, F] = sum of data[e, :] into row ids[e].

Counterpart of ``bliss_gnn_tpu/ops/segsum_pallas.py``. A CUDA tensor goes to
the hand-written kernel ``csrc/segment_sum.cu``; a CPU tensor goes to
:func:`segment_sum_plain`. bf16 and f32 payloads accumulate in f32 and come
back in their own dtype. Two routes (the design notes are in the source):
ids sorted on the valid prefix (``ids_sorted=True``) take a reduce by key
with no atomics, no scratch of the output's size and the same bits on every
call, in two launches (tiles, then a fold of the runs that cross tiles) for
rows of whole 16-byte vectors and in one for narrow rows (F = 41); other
ids take a memset and float4 atomics into an f32 scratch, then a cast
kernel: two launches (one for f32 rows of whole float4s, which accumulate
straight into the output). Float atomics add in the order the rows arrive,
so where a sum is inexact its last bits vary from call to call; with
``deterministic=True`` unsorted ids take the stable route instead: K5's
counting sort of the keys (``rowscatter.counting_sort``, three launches),
then the sorted route reading each position's row through the permutation,
the same bits on every call. ``segment_sum.launches`` adds one per kernel
launched; memsets are not counted.

Callers are the block aggregations by dst (sorted), through the backward
of ``segment.gather_rows`` the message gradient into the src table
(unsorted), and GATv2's d_el rows into the src table (``ops/gat_edge.py``;
stable).
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
from bliss_gnn_tpu_torch.ops.rowscatter import counting_sort

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# edge rows per warp tile of the sorted route with rows of whole 16-byte
# vectors (csrc tile_rows)
SORTED_TILE_ROWS = 64


def segment_sum_plain(data: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, n_valid=None,
                      ids_sorted: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 accumulation (f64 for f64
    rows, which the kernel does not take), output in data's dtype; ids
    outside [0, S) and rows past ``n_valid`` add 0. With ``ids_sorted`` on
    a CPU tensor it checks the caller's promise."""
    if ids_sorted:
        check_sorted(ids, n_valid, "segment_sum")
    keep = (ids >= 0) & (ids < num_segments)
    live = prefix_mask(ids.shape[0], n_valid, ids.device)
    if live is not None:
        keep &= live
    dtype = torch.promote_types(data.dtype, torch.float32)
    acc = torch.zeros((num_segments, data.shape[1]), dtype=dtype,
                      device=data.device)
    acc.index_put_((torch.where(keep, ids, 0).long(),),
                   data.to(dtype).masked_fill(~keep[:, None], 0.0),
                   accumulate=True)
    return acc.to(data.dtype)


def _sorted_vec(data: torch.Tensor) -> int:
    """Columns per lane on the sorted route: one 16-byte vector when rows
    are whole aligned vectors, else one column."""
    vec = 16 // data.element_size()
    aligned = data.shape[1] % vec == 0 and data.data_ptr() % 16 == 0
    return vec if aligned else 1


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                n_valid=None, ids_sorted: bool = False,
                deterministic: bool = False) -> torch.Tensor:
    """[num_segments, F] sum of ``data`` [E, F] rows by ``ids`` [E].

    ``ids_sorted`` promises ids non-decreasing on the valid prefix (it
    needs ``n_valid``); nothing on the card checks the promise.
    ``deterministic``: unsorted ids take the stable route (the same bits on
    every call) instead of the atomics; the plain version is unchanged."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, num_segments, n_valid, ids_sorted)
    if data.device.type != "cuda" or ids.device != data.device:
        raise ValueError(f"segment_sum: no kernel for {data.device}/{ids.device}")
    if data.dim() != 2 or ids.shape[0] != data.shape[0]:
        raise ValueError("segment_sum: data must be [E, F] with ids [E]")
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_sum: no kernel for {data.dtype}")
    data = data.contiguous()
    ids = index_i32(ids, "segment_sum ids")
    e, f = data.shape
    code = _DTYPE_CODE[data.dtype]
    out = torch.empty((num_segments, f), dtype=data.dtype, device=data.device)
    lib = _build.load("segment_sum")
    stream = _build.stream_of(data)
    perm = None
    if ids_sorted or deterministic:
        key = f"{'sorted' if ids_sorted else 'stable'} {e}x{f}"
        if ids_sorted:
            nv = sorted_valid_arg(n_valid, data.device, "segment_sum")
        elif num_segments < 1:
            return out
        else:
            ids, perm, nv = counting_sort(ids, num_segments, n_valid,
                                          lambda: _count(key))
        vec = _sorted_vec(data)
        # rows of 16-byte vectors carry runs across tiles to a second
        # launch; narrow rows have no carries and no scratch
        n_tiles = max(1, -(-e // SORTED_TILE_ROWS)) if vec > 1 else 0
        c_int = c_val = None
        if vec > 1:
            c_int = torch.empty(3 * n_tiles, dtype=torch.int32,
                                device=data.device)
            c_val = torch.empty((2 * n_tiles, f), dtype=torch.float32,
                                device=data.device)
        err = lib.bliss_segment_sum_sorted(
            data.data_ptr(), code, ids.data_ptr(), _build.ptr(perm), e, f,
            nv.data_ptr(), num_segments, out.data_ptr(), _build.ptr(c_int),
            _build.ptr(c_val), n_tiles, vec, stream)
        _count(key)
        _build.check(err, "segment_sum (sorted tiles)")
        if vec > 1:
            err = lib.bliss_segment_sum_fold(
                c_int.data_ptr(), c_val.data_ptr(), code, e, f, nv.data_ptr(),
                out.data_ptr(), vec, stream)
            _count(key)
            _build.check(err, "segment_sum (sorted fold)")
        return out
    nv = valid_arg(n_valid, data.device)
    fp = -(-f // 4) * 4  # scratch rows padded to whole float4 atomics
    align = 16 if data.dtype == torch.float32 else 8
    vec4 = int(f % 4 == 0 and data.data_ptr() % align == 0)
    acc = (torch.empty((num_segments, fp), dtype=torch.float32,
                       device=data.device)
           if data.dtype != torch.float32 or fp != f else None)
    err = lib.bliss_segment_sum(
        data.data_ptr(), code, ids.data_ptr(), e, f, _build.ptr(nv),
        num_segments, _build.ptr(acc), fp, out.data_ptr(), vec4, stream)
    _count(f"unsorted {e}x{f}")
    _build.check(err, "segment_sum")
    if acc is not None:
        err = lib.bliss_segment_sum_cast(acc.data_ptr(), fp, out.data_ptr(),
                                         code, num_segments, f, stream)
        _count(f"unsorted {e}x{f}")
        _build.check(err, "segment_sum (cast)")
    return out


def _count(key: str) -> None:
    """One kernel launched: the total and its route and shape's count."""
    segment_sum.launches += 1
    by = segment_sum.launches_by_shape
    by[key] = by.get(key, 0) + 1


segment_sum.launches = 0
# the same launches by route and input shape, e.g. "sorted 150016x256"
# (routes sorted, unsorted and stable)
segment_sum.launches_by_shape = {}


class _SegmentSum(torch.autograd.Function):
    """Differentiable in ``data``: the gradient is the row gather g[ids],
    zero for ids outside [0, S) (they added nothing forward)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, n_valid, ids_sorted,
                deterministic):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return segment_sum(data, ids, num_segments, n_valid, ids_sorted,
                           deterministic)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        keep = (ids >= 0) & (ids < ctx.num_segments)
        dmsg = g[torch.where(keep, ids, 0).long()]
        return (dmsg.masked_fill(~keep[:, None], 0), None, None, None, None,
                None)


def segment_sum_diff(data, ids, num_segments: int, n_valid=None,
                     ids_sorted: bool = False, deterministic: bool = False):
    if data.requires_grad:
        return _SegmentSum.apply(data, ids, num_segments, n_valid, ids_sorted,
                                 deterministic)
    return segment_sum(data, ids, num_segments, n_valid, ids_sorted,
                       deterministic)
