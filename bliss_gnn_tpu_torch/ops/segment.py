"""Masked segment ops over padded edge lists (counterpart of
``bliss_gnn_tpu/ops/segment.py``).

A padded edge list is a set of parallel arrays of static length whose
masked slots are ignored: their data is zeroed and their ids set to 0.
Float segment sums route by shape: a 1-D payload to K1 (``scatter``), a
wide 2-D payload (F % 128 == 0, F >= 512, at least 2^15 rows: the GATv2
[E, H*O] aggregations) to K5 (``rowscatter``), every other 2-D payload to
K3 (``segsum``). On a CUDA tensor that is the kernel; on a CPU tensor it is
the kernel's plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from bliss_gnn_tpu_torch.ops.rowscatter import row_scatter_add_diff
from bliss_gnn_tpu_torch.ops.scatter import scatter_add_diff
from bliss_gnn_tpu_torch.ops.segsum import segment_sum_diff

# the wide-row route (the JAX package's maybe_row_scatter_add profile)
ROW_SCATTER_MIN_ROWS = 1 << 15
ROW_SCATTER_MIN_FEATS = 512


def _mask_data(data: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
    return torch.where(m, data, torch.zeros((), dtype=data.dtype,
                                            device=data.device))


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, mask: Optional[torch.Tensor] = None,
                       n_valid=None, ids_sorted: bool = False,
                       deterministic: bool = False) -> torch.Tensor:
    """Sum of ``data`` [E, ...] over segments; masked slots add zero.

    ``n_valid``: optional bound on the contiguous prefix holding every
    unmasked slot; the kernels skip the rest. ``ids_sorted``: the ids are
    non-decreasing on that prefix (a block's edges by dst, frontier chunks
    by owner), so K1, K3 and K5 take their sorted route (a reduce by key
    with no sort first); it needs ``n_valid``. ``deterministic``: a 2-D sum
    gives the same bits on every call (K5's routes always do; K3 takes its
    stable route for unsorted ids)."""
    if ids_sorted and n_valid is None:
        raise ValueError("masked_segment_sum: ids_sorted=True needs n_valid")
    data = _mask_data(data, mask)
    ids = segment_ids if mask is None else torch.where(mask, segment_ids, 0)
    if not data.is_floating_point() or data.dim() > 2:
        raise TypeError(f"masked_segment_sum: no route for {data.dtype} "
                        f"of rank {data.dim()}")
    if data.dim() == 1:
        if deterministic and not ids_sorted:
            raise ValueError("masked_segment_sum: no deterministic route for "
                             "unsorted 1-D sums")
        return scatter_add_diff(ids, data, num_segments, n_valid,
                                ids_sorted).to(data.dtype)
    e, f = data.shape
    if (f % 128 == 0 and f >= ROW_SCATTER_MIN_FEATS
            and e >= ROW_SCATTER_MIN_ROWS):
        return row_scatter_add_diff(data, ids, num_segments, n_valid,
                                    ids_sorted, data.dtype)
    return segment_sum_diff(data, ids, num_segments, n_valid, ids_sorted,
                            deterministic)


def masked_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, mask: Optional[torch.Tensor] = None,
                       initial: float = -float("inf")) -> torch.Tensor:
    """Per-segment max of ``data`` [E, ...]; masked slots read ``initial``,
    ids outside [0, num_segments) are dropped and an empty segment gives
    the dtype's lowest value (-inf for floats)."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
        data = torch.where(m, data, torch.full((), initial, dtype=data.dtype,
                                               device=data.device))
        segment_ids = torch.where(mask, segment_ids, 0)
    lowest = (-float("inf") if data.is_floating_point()
              else torch.iinfo(data.dtype).min)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(keep, segment_ids, num_segments).long()  # dump row
    ids = ids.reshape(ids.shape + (1,) * (data.dim() - 1)).expand_as(data)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), lowest,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, ids, data, "amax")[:num_segments]


def copy_e_sum(e_vals, e_dst, n_dst: int, mask=None):
    """Per-dst sum of edge values."""
    return masked_segment_sum(e_vals, e_dst, n_dst, mask)


def _take_fill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as the JAX package's ``jnp.take`` reads it: ids in
    [-len(x), 0) count from the end, ids past either end read NaN (0 for
    integers)."""
    n = x.shape[0]
    keep = (idx >= -n) & (idx < n)
    out = x[torch.where(keep, idx, 0).long()]
    fill = float("nan") if x.is_floating_point() else 0
    return out.masked_fill(
        ~keep.reshape(keep.shape + (1,) * (x.dim() - 1)), fill)


def gather_u(x_src, e_src, mask=None):
    """Per-edge gather of the src-node operand (the 'u' side)."""
    return _mask_data(_take_fill(x_src, e_src), mask)


def gather_v(x_dst, e_dst, mask=None):
    """Per-edge gather of the dst-node operand (the 'v' side)."""
    return _mask_data(_take_fill(x_dst, e_dst), mask)


class _GatherRows(torch.autograd.Function):
    """Row take that reads zero for out-of-range ids; its backward is the
    segment sum of the cotangent rows into ``n_rows`` (K3, or K5 for wide
    rows, on the card), bounded by ``n_valid``, by the sorted route when
    ``ids_sorted``."""

    @staticmethod
    def forward(ctx, x, idx, n_rows, n_valid, ids_sorted):
        keep = (idx >= 0) & (idx < x.shape[0])
        out = x[torch.where(keep, idx, 0).long()]
        out = out.masked_fill(
            ~keep.reshape(keep.shape + (1,) * (x.dim() - 1)), 0)
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.n_valid, ctx.ids_sorted = n_rows, n_valid, ids_sorted
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dx = masked_segment_sum(g, idx, ctx.n_rows, n_valid=ctx.n_valid,
                                ids_sorted=ctx.ids_sorted)
        return dx, None, None, None, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                n_rows: Optional[int] = None, n_valid=None,
                ids_sorted: bool = False) -> torch.Tensor:
    """``x[idx]`` with zero for out-of-range ids (the JAX ``_gather_rows``).
    ``ids_sorted``: ``idx`` is non-decreasing on the ``n_valid`` prefix,
    which the backward's segment sum may use."""
    n_rows = x.shape[0] if n_rows is None else n_rows
    return _GatherRows.apply(x, idx, n_rows, n_valid, ids_sorted)


def u_mul_e_sum(x_src, e_src, e_vals, e_dst, n_dst: int, mask=None):
    """sum over edges e into i of w_e * x[src(e)]."""
    msg = gather_rows(x_src, e_src)
    w = e_vals.reshape(e_vals.shape + (1,) * (msg.dim() - e_vals.dim()))
    return masked_segment_sum(msg * w.to(msg.dtype), e_dst, n_dst, mask)


def copy_u_sum(x_src, e_src, e_dst, n_dst: int, mask=None):
    """sum over edges e into i of x[src(e)]."""
    return masked_segment_sum(gather_rows(x_src, e_src), e_dst, n_dst, mask)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Per-segment mean; empty segments give 0."""
    s = masked_segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
    cnt = masked_segment_sum(ones, segment_ids, num_segments, mask)
    cnt = cnt.clamp_min(1.0)
    cnt = cnt.reshape(cnt.shape + (1,) * (s.dim() - 1))
    return s / cnt.to(s.dtype)


def segment_count(segment_ids, num_segments: int, mask=None,
                  dtype=torch.int32, n_valid=None,
                  ids_sorted: bool = False) -> torch.Tensor:
    """Per-segment counts of a padded edge list, counted in f32 through K1
    (exact: a count stays far below 2^24); ``ids_sorted`` as in
    :func:`masked_segment_sum`."""
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32,
                      device=segment_ids.device)
    out = masked_segment_sum(ones, segment_ids, num_segments, mask,
                             n_valid=n_valid, ids_sorted=ids_sorted)
    if dtype == torch.float32:
        return out
    return torch.round(out).to(dtype)


def edge_softmax(logits: torch.Tensor, e_dst: torch.Tensor, n_dst: int,
                 mask: Optional[torch.Tensor] = None, n_valid=None,
                 ids_sorted: bool = False) -> torch.Tensor:
    """Softmax of edge scores [E] or [E, H] over each dst's incoming edges,
    in f32, returned in the logits' dtype; masked edges give exactly 0.
    ``n_valid`` and ``ids_sorted`` go to the denominator's segment sum and
    to its gather back onto the edges (``gather_rows``), whose backward is
    a segment sum (K1 for one head, K3 for several; the sorted route when
    the ids are sorted), not an index backward that serialises each hub.

    The per-dst max only shifts the exponent (the result does not depend
    on it), so it carries no gradient."""
    compute = logits.to(torch.float32)
    ids = (e_dst if mask is None else torch.where(mask, e_dst, 0)).long()
    seg_max = masked_segment_max(compute.detach(), e_dst, n_dst, mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = _mask_data(torch.exp(compute - seg_max[ids]), mask)
    denom = masked_segment_sum(ex, e_dst, n_dst, mask, n_valid=n_valid,
                               ids_sorted=ids_sorted)
    denom = torch.clamp(denom, min=torch.finfo(torch.float32).tiny)
    one_head = denom.dim() == 2 and denom.shape[1] == 1
    d = gather_rows(denom[:, 0] if one_head else denom, ids, n_dst,
                    n_valid=n_valid, ids_sorted=ids_sorted)
    d = d[:, None] if one_head else d
    return _mask_data(ex / d, mask).to(logits.dtype)
