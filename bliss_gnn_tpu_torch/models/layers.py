"""GraphSAGE convolution over capacity-padded blocks (counterpart of
``SAGEConv`` in ``bliss_gnn_tpu/models/layers.py``).

Parameters are f32; the compute is bf16, with explicit casts at the places
the reference rounds (no autocast). When ``in_feats > out_feats`` the
neighbour projection runs before the aggregation, so fewer features go
through the segment sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bliss_gnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_segment_sum,
    segment_count,
)
from bliss_gnn_tpu_torch.sampling.block import Block

COMPUTE_DTYPE = torch.bfloat16


def _linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A bias-free dense layer in the compute dtype (f32 params cast)."""
    return F.linear(x, weight.to(x.dtype))


class SAGEConv(nn.Module):
    """h'_i = W_self h_i + W_neigh (sum_e w_e h_src(e) / deg_i) + b.

    Weights start as variance scaling 2.0, fan_avg, uniform (xavier uniform
    with gain sqrt 2); the bias starts at zero."""

    def __init__(self, in_feats: int, out_feats: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_feats, self.out_feats = in_feats, out_feats
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_self = nn.Linear(in_feats, out_feats, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_feats))
        for lin in (self.fc_neigh, self.fc_self):
            nn.init.xavier_uniform_(lin.weight, gain=math.sqrt(2.0),
                                    generator=generator)

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        n_dst = block.n_dst_cap
        h_src = h_src.to(COMPUTE_DTYPE)
        h_dst = h_src[:n_dst]
        lin_before = self.in_feats > self.out_feats
        src_val = _linear(h_src, self.fc_neigh.weight) if lin_before else h_src
        nv = block.n_valid_edges()
        msg = gather_rows(src_val, block.e_src, src_val.shape[0], n_valid=nv)
        msg = msg * block.e_weight[:, None].to(COMPUTE_DTYPE)
        agg = masked_segment_sum(msg, block.e_dst, n_dst, block.e_mask,
                                 n_valid=nv)
        deg = segment_count(block.e_dst, n_dst, block.e_mask,
                            dtype=torch.float32, n_valid=nv)
        agg = agg / torch.clamp(deg, min=1.0)[:, None].to(COMPUTE_DTYPE)
        h_neigh = agg if lin_before else _linear(agg, self.fc_neigh.weight)
        return (_linear(h_dst, self.fc_self.weight) + h_neigh
                + self.bias.to(COMPUTE_DTYPE))
