"""K7: full-graph GATv2 attention over the CSC arrays: per dst and head,
the softmax over its in-edges of e = sum_O(leakyrelu(f_src + f_dst) *
attn), times f_src; f32 [N, H, O], zero for a dst with no in-edges.

Counterpart of ``bliss_gnn_tpu/ops/gat_pallas.py`` (banded and packed
attention: TPU layouts of one online-softmax sweep). A CUDA tensor goes to
the hand-written kernel ``csrc/gat_attention.cu`` (one pass per src range
and head, a warp streaming a chunk of dsts' edges through a shared-memory
ring with ``cp.async`` into an online softmax, each range's partial state
merged by a combine kernel; the design note is in the source); a CPU
tensor goes to :func:`gat_attention_plain`, the three-pass
``fullgraph.full_gat_attention``.

The src ranges bound one head's slice of the rows a pass reads
(``range_count``); a dst's edges from each range come from the range plan
(:func:`range_plan`), built once per graph and kept by ``RangePlans``
(``DeviceGraph.k7_ranges``). A call without plans walks its CSC as one
range.

The caller is ``models.inference``: the GATv2 layers of full-graph
layerwise inference, with the graph's plans; with ``partials`` (the
per-(dst, head) max logit and softmax denominator) ``parallel/edgeshard.py``'s
ring inference, which combines the softmax of a dst over several CSC slices
of its edges (:func:`combine_partials`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32
from bliss_gnn_tpu_torch.ops.fullgraph import full_gat_attention
from bliss_gnn_tpu_torch.utils import spans

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 128  # 16-byte vectors per head row the kernel takes
SHORT_SPAN = 1 << 16  # srcs a range may hold for 16-bit ids
CHUNK_EDGES = 16384  # edges a warp's chunk of dsts carries, about
# the one-head slice of the table a src range may hold: 2 ranges at (4,
# 256) bf16 ran fastest of 1, 2, 4 and 8 on an H100 (65.9 ms against 68.6,
# 70.9 and 78.7 a call, chunks of 16,384 edges), and a GATv2 inference
# pass at 2 ranges ran 2.0-2.6 % more nodes a second than at 1
RANGE_BYTES = 64 << 20


def gat_attention_plain(feat: torch.Tensor, attn: torch.Tensor,
                        negative_slope: float, csc_indptr: torch.Tensor,
                        csc_src: torch.Tensor, partials: bool = False):
    """Plain PyTorch version of the kernel (chunked, three passes, f32)."""
    n = csc_indptr.shape[0] - 1
    return full_gat_attention(feat, attn, negative_slope, csc_indptr,
                              csc_src, n, int(csc_indptr[-1].item()),
                              partials=partials)


def combine_partials(a, b):
    """The softmax over the union of two disjoint edge sets of each dst,
    from each set's (out, max, denominator) as ``gat_attention(partials=
    True)`` gives them: the merge of the kernel's splits (``merge`` in
    ``csrc/gat_attention.cu``), in the natural frame. Returns the same
    triple."""
    out_a, m_a, d_a = a
    out_b, m_b, d_b = b
    m = torch.maximum(m_a, m_b)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    w_a = torch.where(torch.isfinite(m_a), d_a * torch.exp(m_a - safe), 0.0)
    w_b = torch.where(torch.isfinite(m_b), d_b * torch.exp(m_b - safe), 0.0)
    den = w_a + w_b
    inv = 1.0 / torch.clamp(den, min=torch.finfo(torch.float32).tiny)
    out = (out_a * (w_a * inv)[..., None] + out_b * (w_b * inv)[..., None])
    return out, m, den


def gat_plan(h: int, o: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(O padded to whole 16-byte vectors, edges a warp step takes) of the
    kernel for ``h`` heads of ``o`` features of ``dtype``: a lane group of
    G lanes (a power of two, two vectors a lane up to 64 vectors, four past
    them) takes a head's row of one edge, so a step holds 32 / G edges
    (2 at (4, 256) bf16, 8 at (1, 41))."""
    vec = 16 // dtype.itemsize
    op = -(-o // vec) * vec
    if op > MAX_VECTORS * vec:
        raise ValueError(f"gat_attention: O = {o} is past the kernel's "
                         f"{MAX_VECTORS * vec} for {dtype}")
    vecs = op // vec
    lanes = 1 << (max(1, -(-vecs // (4 if vecs > 64 else 2))) - 1).bit_length()
    return op, 32 // lanes


def range_count(n_src: int, h: int, o: int, dtype: torch.dtype) -> int:
    """The src ranges of the kernel for a table of ``n_src`` rows of ``h``
    heads of ``o`` features of ``dtype``: one head's padded rows over
    ``RANGE_BYTES``, rounded up. 2 at (4, 256) bf16 and (1, 256) bf16, 4 at
    (4, 256) f32, 1 at (1, 41) bf16 on Reddit's 232,965 nodes."""
    op = gat_plan(h, o, dtype)[0]
    return max(1, -(-(n_src * op * dtype.itemsize) // RANGE_BYTES))


class RangePlan(NamedTuple):
    """A CSC's edges regrouped by src range: range r holds the srcs [r *
    span, (r + 1) * span). The edges of dst d from range r are ``ids[ptr[r
    * n + d]:ptr[r * n + d + 1]]``, in their CSC order, each its src less r
    * span: int16 holding 16 unsigned bits where span <= 2^16, else int32.
    ``ptr`` is int32 [ranges * n + 1]."""
    ranges: int
    span: int
    ptr: torch.Tensor
    ids: torch.Tensor


def range_plan(csc_indptr: torch.Tensor, csc_src: torch.Tensor, n_src: int,
               ranges: int) -> RangePlan:
    """The range plan of a CSC (``csc_src`` may carry padding past the last
    edge) over ``n_src`` srcs cut into ``ranges`` ranges, on the CSC's
    device: a stable sort of the edges by range keeps each dst's edges of a
    range in their CSC order, and the counts of (range, dst) give ``ptr``."""
    n = csc_indptr.shape[0] - 1
    e = int(csc_indptr[-1])
    dev = csc_src.device
    span = max(1, -(-n_src // ranges))
    src = csc_src[:e].to(torch.int32)
    rng = torch.div(src, span, rounding_mode="floor").to(
        torch.int16 if ranges < 1 << 15 else torch.int32)
    order = torch.sort(rng, stable=True).indices
    dst = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        (csc_indptr[1:] - csc_indptr[:-1]).long(), output_size=e)
    key = rng.to(torch.int32 if ranges * n < 1 << 31 else torch.int64)
    counts = torch.bincount(key * n + dst, minlength=ranges * n)
    del dst, key
    ptr = torch.zeros(ranges * n + 1, dtype=torch.int32, device=dev)
    torch.cumsum(counts, 0, out=ptr[1:])
    del counts
    ids = src[order] - rng[order].to(torch.int32) * span
    del order, rng
    if span <= SHORT_SPAN:  # 16 unsigned bits in an int16
        ids = torch.where(ids >= 1 << 15, ids - SHORT_SPAN, ids).to(
            torch.int16)
    return RangePlan(ranges, span, ptr, ids)


class RangePlans:
    """The range plans of one CSC, each built at its first use and kept, by
    (table rows, range count): a graph that K7 walks pass after pass builds
    its plan once (``DeviceGraph.k7_ranges``). ``ranges`` fixes the range
    count; by default ``range_count`` gives it for each call's table."""

    def __init__(self, csc_indptr: torch.Tensor, csc_src: torch.Tensor,
                 ranges: Optional[int] = None):
        self.csc_indptr, self.csc_src, self.ranges = (csc_indptr, csc_src,
                                                      ranges)
        self.plans: Dict[Tuple[int, int], RangePlan] = {}

    def get(self, n_src: int, h: int, o: int,
            dtype: torch.dtype) -> Optional[RangePlan]:
        """The plan for a table of ``n_src`` rows of [h, o] ``dtype``, None
        for one range."""
        r = self.ranges or range_count(n_src, h, o, dtype)
        if r == 1:
            return None
        key = (n_src, r)
        if key not in self.plans:
            self.plans[key] = range_plan(self.csc_indptr, self.csc_src,
                                         n_src, r)
        return self.plans[key]


def gat_attention(feat: torch.Tensor, attn: torch.Tensor,
                  negative_slope: float, csc_indptr: torch.Tensor,
                  csc_src: torch.Tensor, partials: bool = False,
                  ranges: Optional[RangePlans] = None):
    """feat [N, H, O] (the shared projection of every node; a dst reads its
    own row at its id), attn [1, H, O] or [H, O]; returns f32
    [len(csc_indptr) - 1, H, O]. ``csc_src`` may carry padding past the
    last edge. With ``partials``, returns (out, max, denominator), the last
    two f32 [n, H]: per dst and head the max logit and sum exp(e - max)
    (-inf and 0 for a dst with no in-edges). ``ranges``, the plans of this
    CSC (built from these very ``csc_indptr`` and ``csc_src`` tensors, or
    a ValueError), lets the kernel walk the srcs in L2-sized ranges;
    without it the CSC is one range."""
    if ranges is not None and (ranges.csc_indptr is not csc_indptr
                               or ranges.csc_src is not csc_src):
        raise ValueError("gat_attention: the range plans are of another "
                         "CSC than the one passed")
    if feat.device.type == "cpu":
        return gat_attention_plain(feat, attn, negative_slope, csc_indptr,
                                   csc_src, partials)
    if (feat.device.type != "cuda" or csc_indptr.device != feat.device
            or csc_src.device != feat.device or attn.device != feat.device):
        raise ValueError(
            f"gat_attention: no kernel for {feat.device}/{csc_src.device}")
    if feat.dim() != 3:
        raise ValueError("gat_attention: feat must be [N, H, O]")
    if feat.dtype not in _DTYPE_CODE:
        raise TypeError(f"gat_attention: no kernel for {feat.dtype}")
    n_src, h, o = feat.shape
    op = gat_plan(h, o, feat.dtype)[0]
    plan = ranges.get(n_src, h, o, feat.dtype) if ranges else None
    feat = feat.contiguous()
    attn = attn.reshape(h, o).to(torch.float32)
    if op != o:  # rows of whole 16-byte vectors; the copy is in the call
        fp = feat.new_zeros((n_src, h, op))
        fp[..., :o] = feat
        feat = fp
        attn = torch.nn.functional.pad(attn, (0, op - o))
    elif feat.data_ptr() % 16 != 0:  # the kernel loads 16-byte vectors
        feat = feat.clone()
    attn = attn.contiguous()
    n = csc_indptr.shape[0] - 1
    if plan is None:
        n_ranges, span = 1, n_src
        ptr = index_i32(csc_indptr, "gat_attention csc_indptr")
        ids = index_i32(csc_src, "gat_attention csc_src")
    else:
        n_ranges, span, ptr, ids = plan
    dev = feat.device
    out = torch.empty((n, h, o), dtype=torch.float32, device=dev)
    m = den = None
    if partials:
        m = torch.empty((n, h), dtype=torch.float32, device=dev)
        den = torch.empty((n, h), dtype=torch.float32, device=dev)
    if n == 0:
        return (out, m, den) if partials else out
    # chunks of about CHUNK_EDGES edges a warp; len(ids) bounds the edges
    chunks = max(1, min(n, -(-ids.shape[0] // (n_ranges * CHUNK_EDGES))))
    starts = torch.empty((n_ranges, chunks + 1), dtype=torch.int32,
                         device=dev)
    pm = pden = pacc = None
    if n_ranges > 1:  # each range's partial state, for the combine
        pm = torch.empty((n_ranges, n, h), dtype=torch.float32, device=dev)
        pden = torch.empty_like(pm)
        pacc = torch.empty((n_ranges, n, h, o), dtype=torch.float32,
                           device=dev)
    lib = _build.load("gat_attention")
    err = lib.bliss_gat_attention(
        feat.data_ptr(), _DTYPE_CODE[feat.dtype], h, op, o, attn.data_ptr(),
        ctypes.c_float(negative_slope), ptr.data_ptr(), ids.data_ptr(),
        ids.element_size(), n_ranges, span, chunks, n, starts.data_ptr(),
        _build.ptr(pm), _build.ptr(pden), _build.ptr(pacc), out.data_ptr(),
        _build.ptr(m), _build.ptr(den), _build.stream_of(feat))
    gat_attention.launches += 1
    gat_attention.kernel_launches += n_ranges + 1 + (n_ranges > 1)
    gat_attention.range_passes += h * n_ranges
    spans.counter(f"k7.range_passes/{n_ranges}", h * n_ranges)
    if partials:
        by = gat_attention.launches_by_shape
        key = f"partials H={h} O={o}"
        by[key] = by.get(key, 0) + 1
    _build.check(err, "gat_attention")
    return (out, m, den) if partials else out


gat_attention.launches = 0  # wrapper calls
# kernels launched: a call's chunk cuts, its R range passes and, for R > 1,
# the combine
gat_attention.kernel_launches = 0
gat_attention.range_passes = 0  # (head, src range) passes
# the launches with partial outputs by shape, e.g. "partials H=4 O=256"
gat_attention.launches_by_shape = {}
