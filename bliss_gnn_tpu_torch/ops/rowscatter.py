"""K5: wide-row scatter-add, out[S, F] with out[ids[e], :] += data[e, :].

Counterpart of ``bliss_gnn_tpu/ops/rowscatter_pallas.py``. A CUDA tensor
goes to the hand-written kernels of ``csrc/row_scatter.cu`` (the design
note is in the source); a CPU tensor goes to :func:`row_scatter_add_plain`.
Sums are taken in f32 and written in ``out_dtype`` (f32, as the JAX
function returns, or bf16), each value rounded once. Both routes are a
reduce by key with no atomics on the payload, and give the same bits on
every call:

- ids sorted on the valid prefix (``ids_sorted=True``, which needs
  ``n_valid``): two launches, the tiles and a fold of the runs that cross
  tiles;
- other ids: a counting sort of the keys first (count with the scan,
  place, order: three launches), then the same two launches reading the
  payload rows in the sorted order.

``row_scatter_add.launches`` adds one per kernel launched (memsets are not
counted), ``launches_by_shape`` the same by route and input shape, e.g.
``"sorted 150016x1024"``.

Callers are the wide 2-D segment sums (F % 128 == 0, F >= 512, at least
2^15 rows): the GATv2 message aggregation over [E, H*O = 1024] and the er
gather backward (sorted, by dst), and the el gather backward (unsorted,
into the src table).
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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# edge rows per block tile of the reduce (csrc tile_rows, at most 256). On
# a sampled GATv2 layer-0 block on an H100, tiles of 32, 64, 128 and 256
# rows took 0.0676, 0.0652, 0.0602 and 0.0754 ms on the sorted route,
# 0.0857, 0.0959, 0.0828 and 0.1001 on the unsorted one
# (tools/kernel_probe.py k5)
TILE_ROWS = 128


def row_scatter_add_plain(data: torch.Tensor, ids: torch.Tensor,
                          num_segments: int, n_valid=None,
                          ids_sorted: bool = False,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernels: [num_segments, F] summed in
    f32 and returned in ``out_dtype``; ids outside [0, S) and rows at or
    past ``n_valid`` add nothing. With ``ids_sorted`` on a CPU tensor it
    checks the caller's promise."""
    if ids_sorted:
        check_sorted(ids, n_valid, "row_scatter_add")
    keep = (ids >= 0) & (ids < num_segments)
    live = prefix_mask(ids.shape[0], n_valid, ids.device)
    if live is not None:
        keep &= live
    acc = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    acc.index_put_((torch.where(keep, ids, 0).long(),),
                   data.to(torch.float32).masked_fill(~keep[:, None], 0.0),
                   accumulate=True)
    return acc.to(out_dtype)


def row_scatter_add(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                    n_valid=None, ids_sorted: bool = False,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[num_segments, F] sum of ``data`` [E, F] rows by ``ids`` [E], in
    ``out_dtype``.

    ``ids_sorted`` promises ids non-decreasing on the valid prefix (it
    needs ``n_valid``); nothing on the card checks the promise."""
    if data.device.type == "cpu":
        return row_scatter_add_plain(data, ids, num_segments, n_valid,
                                     ids_sorted, out_dtype)
    if data.device.type != "cuda" or ids.device != data.device:
        raise ValueError(
            f"row_scatter_add: no kernel for {data.device}/{ids.device}")
    if data.dim() != 2 or ids.shape[0] != data.shape[0]:
        raise ValueError("row_scatter_add: data must be [E, F] with ids [E]")
    if data.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"row_scatter_add: no kernel for {data.dtype} -> "
                        f"{out_dtype}")
    e, f = data.shape
    if f % 8 != 0:
        raise ValueError(f"row_scatter_add: F = {f} is not a multiple of 8")
    if num_segments < 1:
        raise ValueError("row_scatter_add: num_segments must be positive")
    data = data.contiguous()
    if data.data_ptr() % 16 != 0:  # the kernels load aligned 16-byte vectors
        data = data.clone()
    ids = index_i32(ids, "row_scatter_add ids")
    dev = data.device
    lib = _build.load("row_scatter")
    stream = _build.stream_of(data)
    route = "sorted" if ids_sorted else "unsorted"
    key = f"{route} {e}x{f}"
    perm = None
    if ids_sorted:
        nv = sorted_valid_arg(n_valid, dev, "row_scatter_add")
    else:
        ids, perm, nv = counting_sort(ids, num_segments, n_valid,
                                      lambda: _count(key))
    tile_rows = TILE_ROWS
    n_tiles = max(1, -(-e // tile_rows))
    c_int = torch.empty(3 * n_tiles, dtype=torch.int32, device=dev)
    c_val = torch.empty((2 * n_tiles, f), dtype=torch.float32, device=dev)
    out = torch.empty((num_segments, f), dtype=out_dtype, device=dev)
    code = _DTYPE_CODE[out_dtype]
    _build.check(lib.bliss_row_scatter_tiles(
        data.data_ptr(), _DTYPE_CODE[data.dtype], ids.data_ptr(),
        _build.ptr(perm), e, f, nv.data_ptr(), num_segments, out.data_ptr(),
        code, c_int.data_ptr(), c_val.data_ptr(), n_tiles, tile_rows, stream),
        "row_scatter_add (tiles)")
    _count(key)
    _build.check(lib.bliss_row_scatter_fold(
        c_int.data_ptr(), c_val.data_ptr(), e, f, nv.data_ptr(),
        out.data_ptr(), code, tile_rows, stream), "row_scatter_add (fold)")
    _count(key)
    return out


def counting_sort(ids: torch.Tensor, num_segments: int, n_valid, count):
    """The unsorted route's counting sort of int32 ``ids`` [E] on a card:
    (keys, perm, nv). Of the valid prefix's ids, those in [0,
    ``num_segments``) are placed in key order, stably: position r holds
    edge perm[r], whose id is keys[r], for r < nv (int32 [1], on the card:
    no host read). Every size is the static cap's. Three launches, each
    reported to ``count()``; K3's stable route takes it too."""
    if num_segments < 1:
        raise ValueError("counting_sort: num_segments must be positive")
    dev, e, s = ids.device, ids.shape[0], num_segments
    lib = _build.load("row_scatter")
    stream = _build.stream_of(ids)
    nv_in = valid_arg(n_valid, dev)
    counts, offsets = torch.empty((2, s + 1), dtype=torch.int32,
                                  device=dev).unbind(0)
    slots, keys, perm = torch.empty((3, e), dtype=torch.int32,
                                    device=dev).unbind(0)
    _build.check(lib.bliss_row_scatter_count(
        ids.data_ptr(), e, _build.ptr(nv_in), s, counts.data_ptr(),
        offsets.data_ptr(), stream), "counting sort (count, scan)")
    count()
    _build.check(lib.bliss_row_scatter_place(
        ids.data_ptr(), e, _build.ptr(nv_in), s, offsets.data_ptr(),
        counts.data_ptr(), slots.data_ptr(), keys.data_ptr(), stream),
        "counting sort (place)")
    count()
    _build.check(lib.bliss_row_scatter_order(
        offsets.data_ptr(), s, slots.data_ptr(), perm.data_ptr(), stream),
        "counting sort (order)")
    count()
    return keys, perm, offsets[s:]


def _count(key: str) -> None:
    """One kernel launched: the total and its route and shape's count."""
    row_scatter_add.launches += 1
    by = row_scatter_add.launches_by_shape
    by[key] = by.get(key, 0) + 1


row_scatter_add.launches = 0
row_scatter_add.launches_by_shape = {}


class _RowScatter(torch.autograd.Function):
    """Differentiable in ``data``: the gradient is the row gather g[ids] in
    the payload's dtype, zero for ids outside [0, S)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, n_valid, ids_sorted, out_dtype):
        ctx.save_for_backward(ids)
        ctx.num_segments, ctx.dtype = num_segments, data.dtype
        return row_scatter_add(data, ids, num_segments, n_valid, ids_sorted,
                               out_dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        keep = (ids >= 0) & (ids < ctx.num_segments)
        dd = g[torch.where(keep, ids, 0).long()].masked_fill(~keep[:, None], 0)
        return dd.to(ctx.dtype), None, None, None, None, None


def row_scatter_add_diff(data, ids, num_segments: int, n_valid=None,
                         ids_sorted: bool = False,
                         out_dtype: torch.dtype = torch.float32):
    if data.requires_grad:
        return _RowScatter.apply(data, ids, num_segments, n_valid, ids_sorted,
                                 out_dtype)
    return row_scatter_add(data, ids, num_segments, n_valid, ids_sorted,
                           out_dtype)
