"""Memory-bounded full-graph sparse ops in plain PyTorch: the chunked SpMM
and the three-pass GATv2 attention (counterpart of
``bliss_gnn_tpu/ops/fullgraph.py``).

Full-graph inference aggregates over every edge; at Reddit scale (115M
edges) per-edge messages would take tens of GB, so these stream the
canonical (dst-sorted) edge list in fixed-size chunks into an [N, F] f32
accumulator. They are the plain versions of K6 (``ops/spmm.py``) and K7
(``ops/gat_attention.py``): the CPU path, and the kernels' oracle on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_CHUNK = 1 << 20  # 1M edges per chunk


def _chunk_edges(csc_indptr: torch.Tensor, csc_src: torch.Tensor,
                 start: int, stop: int):
    """(src, dst) int64 of the canonical edges [start, stop); the dst of an
    edge is found by binary search over ``csc_indptr``."""
    idx = torch.arange(start, stop, device=csc_src.device)
    dst = torch.searchsorted(csc_indptr.long(), idx, right=True) - 1
    return csc_src[start:stop].long(), dst


def full_spmm_sum(x: torch.Tensor, csc_indptr: torch.Tensor,
                  csc_src: torch.Tensor, n_nodes: int, n_edges: int,
                  edge_vals: Optional[torch.Tensor] = None,
                  chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """sum over edges e into i of w_e * x[src(e)] over the whole graph.

    x: [N, F]; edge_vals: [E] or None (unit weights); returns [N, F] f32."""
    acc = torch.zeros((n_nodes, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for start in range(0, n_edges, chunk):
        stop = min(start + chunk, n_edges)
        src, dst = _chunk_edges(csc_indptr, csc_src, start, stop)
        msg = x[src].to(torch.float32)
        if edge_vals is not None:
            msg = msg * edge_vals[start:stop].to(torch.float32)[:, None]
        acc.index_add_(0, dst, msg)
    return acc


def full_spmm_mean(x: torch.Tensor, csc_indptr: torch.Tensor,
                   csc_src: torch.Tensor, n_nodes: int, n_edges: int,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Mean over in-neighbours (zero for isolated nodes)."""
    s = full_spmm_sum(x, csc_indptr, csc_src, n_nodes, n_edges, chunk=chunk)
    deg = (csc_indptr[1:] - csc_indptr[:-1]).to(torch.float32)
    return s / torch.clamp(deg, min=1.0)[:, None]


def full_gat_attention(feat: torch.Tensor, attn: torch.Tensor,
                       negative_slope: float, csc_indptr: torch.Tensor,
                       csc_src: torch.Tensor, n_nodes: int, n_edges: int,
                       chunk: int = DEFAULT_CHUNK // 4,
                       partials: bool = False):
    """Full-graph GATv2 attention: per dst and head, the softmax over its
    in-edges of e = sum_O(leakyrelu(f_src + f_dst) * attn), times f_src.

    feat: [N, H, O] (shared src/dst projection); attn: [1, H, O] or
    [H, O]; returns [N, H, O] f32, zero for a dst with no in-edges. Three
    passes (max, exp-sum, weighted sum) recompute the logits instead of
    storing E x H of them. With ``partials`` also the per-(dst, head) max
    logit and softmax denominator, f32 [N, H] (-inf and 0 for a dst with no
    in-edges)."""
    H, O = feat.shape[1], feat.shape[2]
    attn_f = attn.reshape(1, H, O).to(torch.float32)
    dev = feat.device

    def logits(start, stop):
        src, dst = _chunk_edges(csc_indptr, csc_src, start, stop)
        el = feat[src].to(torch.float32)
        z = el + feat[dst].to(torch.float32)
        z = torch.where(z >= 0, z, negative_slope * z)
        return (z * attn_f).sum(dim=-1), el, dst  # e [chunk, H]

    def chunks():
        return ((s, min(s + chunk, n_edges)) for s in range(0, n_edges, chunk))

    seg_max = torch.full((n_nodes, H), -torch.inf, dtype=torch.float32,
                         device=dev)
    for start, stop in chunks():
        e, _, dst = logits(start, stop)
        seg_max.scatter_reduce_(0, dst[:, None].expand(-1, H), e, "amax")
    raw_max = seg_max
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)

    denom = torch.zeros((n_nodes, H), dtype=torch.float32, device=dev)
    for start, stop in chunks():
        e, _, dst = logits(start, stop)
        denom.index_add_(0, dst, torch.exp(e - seg_max[dst]))
    raw_denom = denom
    denom = torch.clamp(denom, min=torch.finfo(torch.float32).tiny)

    out = torch.zeros((n_nodes, H, O), dtype=torch.float32, device=dev)
    for start, stop in chunks():
        e, el, dst = logits(start, stop)
        a = torch.exp(e - seg_max[dst]) / denom[dst]
        out.index_add_(0, dst, el * a[..., None])
    if partials:
        return out, raw_max, raw_denom
    return out
