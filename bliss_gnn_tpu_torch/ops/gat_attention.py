"""K7: full-graph GATv2 attention over the CSC arrays: per dst and head,
the softmax over its in-edges of e = sum_O(leakyrelu(f_src + f_dst) *
attn), times f_src; f32 [N, H, O], zero for a dst with no in-edges.

Counterpart of ``bliss_gnn_tpu/ops/gat_pallas.py`` (banded and packed
attention: TPU layouts of one online-softmax sweep). A CUDA tensor goes to
the hand-written kernel ``csrc/gat_attention.cu`` (a block per dst, a warp
per head and edge split, src rows streamed through a shared-memory ring
with ``cp.async``, one sweep with an online softmax; the design note is in
the source); a CPU tensor goes to :func:`gat_attention_plain`, the
three-pass ``fullgraph.full_gat_attention``.

The caller is ``models.inference``: the GATv2 layers of full-graph
layerwise inference; with ``partials`` (the per-(dst, head) max logit and
softmax denominator) ``parallel/edgeshard.py``'s ring inference, which
combines the softmax of a dst over several CSC slices of its edges
(:func:`combine_partials`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32
from bliss_gnn_tpu_torch.ops.fullgraph import full_gat_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 128  # 16-byte vectors per head row the kernel takes


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
    """(O padded to whole 16-byte vectors, edge splits per head) of the
    kernel for ``h`` heads of ``o`` features of ``dtype``. A block holds
    min(h, 8) heads times the splits, at most 8 warps; each head takes as
    many splits as fit, at most 4 (the fastest of those timed on an H100
    at (4, 256) and (1, 41): 2 and 4)."""
    vec = 16 // dtype.itemsize
    op = -(-o // vec) * vec
    if op > MAX_VECTORS * vec:
        raise ValueError(f"gat_attention: O = {o} is past the kernel's "
                         f"{MAX_VECTORS * vec} for {dtype}")
    return op, min(4, 8 // min(h, 8))


def gat_attention(feat: torch.Tensor, attn: torch.Tensor,
                  negative_slope: float, csc_indptr: torch.Tensor,
                  csc_src: torch.Tensor, partials: bool = False):
    """feat [N, H, O] (the shared projection of every node; a dst reads its
    own row at its id), attn [1, H, O] or [H, O]; returns f32
    [len(csc_indptr) - 1, H, O]. ``csc_src`` may carry padding past the
    last edge. With ``partials``, returns (out, max, denominator), the last
    two f32 [n, H]: per dst and head the max logit and sum exp(e - max)
    (-inf and 0 for a dst with no in-edges)."""
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
    h, o = feat.shape[1], feat.shape[2]
    op, splits = gat_plan(h, o, feat.dtype)
    feat = feat.contiguous()
    attn = attn.reshape(h, o).to(torch.float32)
    if op != o:  # rows of whole 16-byte vectors; the copy is in the call
        fp = feat.new_zeros((feat.shape[0], h, op))
        fp[..., :o] = feat
        feat = fp
        attn = torch.nn.functional.pad(attn, (0, op - o))
    elif feat.data_ptr() % 16 != 0:  # the kernel loads 16-byte vectors
        feat = feat.clone()
    attn = attn.contiguous()
    indptr = index_i32(csc_indptr, "gat_attention csc_indptr")
    src = index_i32(csc_src, "gat_attention csc_src")
    n = indptr.shape[0] - 1
    out = torch.empty((n, h, o), dtype=torch.float32, device=feat.device)
    m = den = None
    if partials:
        m = torch.empty((n, h), dtype=torch.float32, device=feat.device)
        den = torch.empty((n, h), dtype=torch.float32, device=feat.device)
    if n == 0:
        return (out, m, den) if partials else out
    lib = _build.load("gat_attention")
    err = lib.bliss_gat_attention(
        feat.data_ptr(), _DTYPE_CODE[feat.dtype], h, op, o, attn.data_ptr(),
        ctypes.c_float(negative_slope), splits, indptr.data_ptr(),
        src.data_ptr(), n, out.data_ptr(), _build.ptr(m), _build.ptr(den),
        _build.stream_of(feat))
    gat_attention.launches += 1
    if partials:
        by = gat_attention.launches_by_shape
        key = f"partials H={h} O={o}"
        by[key] = by.get(key, 0) + 1
    _build.check(err, "gat_attention")
    return (out, m, den) if partials else out


gat_attention.launches = 0
# the launches with partial outputs by shape, e.g. "partials H=4 O=256"
gat_attention.launches_by_shape = {}
