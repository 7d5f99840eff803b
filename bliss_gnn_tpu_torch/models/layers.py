"""GNN convolutions over capacity-padded blocks (counterpart of
``bliss_gnn_tpu/models/layers.py``): ``SAGEConv`` (edge-weighted mean),
``GraphConv`` (norm both) and ``GATv2Conv`` (shared weights, bias-free,
pre-softmax logits exported for the bandit).

Each conv computes in its ``dtype`` (bf16 by default, f32 for the
reference's ``--precision highest``) and stores its parameters in its
``param_dtype`` (f32 by default, or bf16), both fixed at construction as a
flax module's ``dtype`` and ``param_dtype`` are; the parameters are cast
to the compute dtype where they are used, and explicit casts sit at the
places the reference rounds (no autocast). When ``in_feats > out_feats`` the
projection runs before the aggregation, so fewer features go through the
segment sum. A block's edges are sorted by dst on their valid prefix, so
every sum by ``e_dst`` passes ``ids_sorted=True`` (the reduce-by-key route
of K1 and K3); sums by ``e_src`` take the atomic route.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bliss_gnn_tpu_torch.ops import gat_edge
from bliss_gnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_segment_sum,
    segment_count,
)
from bliss_gnn_tpu_torch.sampling.block import Block
from bliss_gnn_tpu_torch.utils import spans


def _linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A bias-free dense layer in ``x``'s dtype, the compute dtype (the
    parameters cast)."""
    return F.linear(x, weight.to(x.dtype))


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """A dense layer with bias in the compute dtype: the product is rounded
    before the (cast) bias is added, as a flax Dense does."""
    return _linear(x, lin.weight) + lin.bias.to(x.dtype)


def dropout(h: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator."""
    if p <= 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype,
                                                         device=h.device))


def _variance_scaling_(t: torch.Tensor, fan_in: int, fan_out: int,
                       generator: Optional[torch.Generator]) -> None:
    """Variance scaling 2.0, fan_avg, uniform (xavier uniform, gain sqrt 2)
    with explicit fans, for tensors that are not [out, in] matrices."""
    bound = math.sqrt(3.0 * 2.0 / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class SAGEConv(nn.Module):
    """h'_i = W_self h_i + W_neigh (sum_e w_e h_src(e) / deg_i) + b.

    Weights start as variance scaling 2.0, fan_avg, uniform (xavier uniform
    with gain sqrt 2); the bias starts at zero."""

    def __init__(self, in_feats: int, out_feats: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_feats, self.out_feats = in_feats, out_feats
        self.dtype = dtype
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_self = nn.Linear(in_feats, out_feats, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_feats))
        for lin in (self.fc_neigh, self.fc_self):
            nn.init.xavier_uniform_(lin.weight, gain=math.sqrt(2.0),
                                    generator=generator)
        self.to(param_dtype)

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        n_dst = block.n_dst_cap
        h_src = h_src.to(self.dtype)
        h_dst = h_src[:n_dst]
        lin_before = self.in_feats > self.out_feats
        src_val = _linear(h_src, self.fc_neigh.weight) if lin_before else h_src
        nv = block.n_valid_edges()
        msg = gather_rows(src_val, block.e_src, src_val.shape[0], n_valid=nv)
        msg = msg * block.e_weight[:, None].to(self.dtype)
        agg = masked_segment_sum(msg, block.e_dst, n_dst, block.e_mask,
                                 n_valid=nv, ids_sorted=True)
        deg = segment_count(block.e_dst, n_dst, block.e_mask,
                            dtype=torch.float32, n_valid=nv, ids_sorted=True)
        agg = agg / torch.clamp(deg, min=1.0)[:, None].to(self.dtype)
        h_neigh = agg if lin_before else _linear(agg, self.fc_neigh.weight)
        return (_linear(h_dst, self.fc_self.weight) + h_neigh
                + self.bias.to(self.dtype))


class GraphConv(nn.Module):
    """GCN layer, norm both, degrees on the block's kept edges (clamped to
    1), edge weights multiplying the messages:
    h' = D_in^-1/2 A_w D_out^-1/2 h W + b.

    The weight starts as xavier uniform, the bias at zero. As in the
    reference, with ``in_feats > out_feats`` the dense layer (bias
    included) runs on the src side before the aggregation."""

    def __init__(self, in_feats: int, out_feats: int,
                 activation: Optional[Callable] = None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_feats, self.out_feats = in_feats, out_feats
        self.activation, self.dtype = activation, dtype
        self.fc = nn.Linear(in_feats, out_feats, bias=True)
        nn.init.xavier_uniform_(self.fc.weight, generator=generator)
        nn.init.zeros_(self.fc.bias)
        self.to(param_dtype)

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        n_dst, n_src = block.n_dst_cap, block.n_src_cap
        h_src = h_src.to(self.dtype)
        nv = block.n_valid_edges()
        out_deg = segment_count(block.e_src, n_src, block.e_mask,
                                dtype=torch.float32, n_valid=nv)
        src_norm = torch.rsqrt(torch.clamp(out_deg, min=1.0)).to(self.dtype)
        feat = h_src * src_norm[:, None]
        lin_before = self.in_feats > self.out_feats
        if lin_before:
            feat = _dense(feat, self.fc)
        msg = gather_rows(feat, block.e_src, feat.shape[0], n_valid=nv)
        msg = msg * block.e_weight[:, None].to(self.dtype)
        rst = masked_segment_sum(msg, block.e_dst, n_dst, block.e_mask,
                                 n_valid=nv, ids_sorted=True)
        if not lin_before:
            rst = _dense(rst, self.fc)
        in_deg = segment_count(block.e_dst, n_dst, block.e_mask,
                               dtype=torch.float32, n_valid=nv,
                               ids_sorted=True)
        dst_norm = torch.rsqrt(torch.clamp(in_deg, min=1.0)).to(self.dtype)
        rst = rst * dst_norm[:, None]
        return rst if self.activation is None else self.activation(rst)


class GATv2Conv(nn.Module):
    """GATv2 attention over a block: one projection shared by src and dst
    (no bias), logits e = sum_O(leakyrelu(el_src + er_dst) * attn) per
    head, edge softmax per dst per head, message el_src * a, optional
    residual and activation. Returns ``(rst [n_dst, H, O], e [E, H])`` with
    the pre-softmax logits (0 on the slots that are not kept edges), which
    the bandit's GAT reward reads. There is
    no edge-weight multiply (the reference comments it out).

    The attention from the projected rows through the aggregation is
    ``ops/gat_edge.py``: on the card hand-written kernels over the block's
    valid prefix, whose only [E, H*O] tensors are the rows of the message
    aggregation and of the two row-gather backwards, each a segment sum (K5
    at H*O = 1024); on the CPU their plain versions. The attention dropout
    sits between its two autograd nodes. The attention is the device span
    ``gat.attend`` (``utils/spans.py``)."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        H, O = num_heads, out_feats
        self.dtype = dtype
        self.in_feats, self.out_feats, self.num_heads = in_feats, O, H
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope = negative_slope
        self.residual, self.activation = residual, activation
        self.fc_src = nn.Linear(in_feats, H * O, bias=False)
        nn.init.xavier_uniform_(self.fc_src.weight, gain=math.sqrt(2.0),
                                generator=generator)
        self.attn = nn.Parameter(torch.empty(1, H, O))
        _variance_scaling_(self.attn, H, O, generator)
        self.res_fc = None
        if residual and in_feats != H * O:
            self.res_fc = nn.Linear(in_feats, H * O, bias=False)
            nn.init.xavier_uniform_(self.res_fc.weight, generator=generator)
        self.to(param_dtype)

    def forward(self, block: Block, h_src: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n_dst = block.n_dst_cap
        H, O = self.num_heads, self.out_feats
        h_src = h_src.to(self.dtype)
        if self.training:
            h_src = dropout(h_src, self.feat_drop, generator)
        h_dst = h_src[:n_dst]
        feat2 = _linear(h_src, self.fc_src.weight)  # [n_src, H*O]
        with spans.device_span("gat.attend"):
            edges = (block.e_src, torch.where(block.e_mask, block.e_dst, 0),
                     block.e_mask, block.n_valid_edges(), n_dst)
            e, a, link = gat_edge.attention_scores(
                feat2, self.attn.to(self.dtype), *edges, self.negative_slope)
            if self.training:
                a = dropout(a, self.attn_drop, generator)
            rst = gat_edge.attention_messages(feat2, a, *edges, link
                                              ).reshape(n_dst, H, O)
        if self.residual:
            res = h_dst if self.res_fc is None else _linear(
                h_dst, self.res_fc.weight)
            rst = rst + res.reshape(n_dst, H, O)
        if self.activation is not None:
            rst = self.activation(rst)
        return rst, e
