"""Full-graph layerwise inference, the final-eval path (counterpart of
``layerwise_inference`` in ``bliss_gnn_tpu/models/inference.py``).

Every layer runs over all nodes with full neighbourhoods and no sampling
weights, dropout off, and gives the [N, n_classes] f32 logits. The math
mirrors ``models/layers.py``; the weights are read from the trained
``nn.Module``. The aggregation is K6 (``ops.spmm``, SAGE and GCN) or K7
(``ops.gat_attention``, GATv2), which run their kernels on a CUDA graph and
their plain versions on a CPU graph; the dense products stay
``torch.matmul``. The kernels read the CSC arrays directly, so there is no
layout to build beforehand.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention
from bliss_gnn_tpu_torch.ops.spmm import spmm as spmm_csr

SpMM = Callable[[torch.Tensor], torch.Tensor]
GatAttn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def default_spmm(graph: DeviceGraph) -> SpMM:
    """Unit-weight full-graph SpMM (K6): [N, F'] -> [N, F'] f32 dst sums."""
    return lambda feat: spmm_csr(feat, graph.csc_indptr, graph.csc_src)


def default_gat_attn(graph: DeviceGraph) -> GatAttn:
    """Full-graph GATv2 attention (K7): [N, H, O] -> [N, H, O] f32."""
    return lambda feat, attn, slope: gat_attention(
        feat, attn, slope, graph.csc_indptr, graph.csc_src)


def _sage_layer(conv: nn.Module, graph: DeviceGraph, h: torch.Tensor, dtype,
                spmm: SpMM) -> torch.Tensor:
    Wn = conv.fc_neigh.weight.to(dtype)
    Ws = conv.fc_self.weight.to(dtype)
    b = conv.bias.to(torch.float32)
    lin_before = h.shape[1] > Wn.shape[0]
    src_val = F.linear(h.to(dtype), Wn) if lin_before else h.to(dtype)
    deg = torch.clamp(graph.in_degrees().to(torch.float32), min=1.0)
    agg = spmm(src_val) / deg[:, None]
    h_neigh = agg if lin_before else F.linear(agg.to(dtype), Wn)
    return F.linear(h.to(dtype), Ws).to(torch.float32) + h_neigh + b


def _gcn_layer(conv: nn.Module, graph: DeviceGraph, h: torch.Tensor, dtype,
               spmm: SpMM) -> torch.Tensor:
    W = conv.fc.weight.to(dtype)
    b = conv.fc.bias.to(torch.float32)
    out_deg = graph.out_degrees().to(torch.float32)
    in_deg = graph.in_degrees().to(torch.float32)
    src_norm = torch.rsqrt(torch.clamp(out_deg, min=1.0))[:, None].to(dtype)
    feat = h.to(dtype) * src_norm
    if h.shape[1] > W.shape[0]:
        agg = spmm(F.linear(feat, W))
    else:
        agg = F.linear(spmm(feat).to(dtype), W).to(torch.float32)
    return agg * torch.rsqrt(torch.clamp(in_deg, min=1.0))[:, None] + b


def _gat_layer(conv: nn.Module, h: torch.Tensor, num_heads: int,
               negative_slope: float, residual: bool, dtype,
               gat_attn: GatAttn) -> torch.Tensor:
    W = conv.fc_src.weight.to(dtype)
    O = W.shape[0] // num_heads
    feat = F.linear(h.to(dtype), W).reshape(-1, num_heads, O)
    rst = gat_attn(feat, conv.attn, negative_slope)
    if residual:
        if conv.res_fc is not None:
            res = F.linear(h.to(dtype), conv.res_fc.weight.to(dtype))
        else:
            res = h
        rst = rst + res.reshape(-1, num_heads, O).to(torch.float32)
    return rst


@torch.no_grad()
def inference_layer(model_name: str, model: nn.Module, graph: DeviceGraph,
                    layer: int, h: torch.Tensor, n_layers: int,
                    heads: Optional[Sequence[int]] = None,
                    negative_slope: float = 0.2, residual: bool = False,
                    dtype=torch.bfloat16, spmm: Optional[SpMM] = None,
                    gat_attn: Optional[GatAttn] = None) -> torch.Tensor:
    """Layer ``layer`` over the full graph, its activation included (ReLU
    for SAGE and GCN, ELU and a head flatten for GATv2, the head mean at
    the GATv2 output). ``spmm`` and ``gat_attn`` replace the default
    aggregations (K6 and K7)."""
    name = model_name.lower()
    last = layer == n_layers - 1
    conv = model.layers[layer]
    if name in ("sage", "gcn"):
        spmm = spmm or default_spmm(graph)
        fn = _sage_layer if name == "sage" else _gcn_layer
        h = fn(conv, graph, h, dtype, spmm)
        return h if last else torch.relu(h)
    if name == "gat":
        heads = heads or model.heads
        rst = _gat_layer(conv, h, heads[layer], negative_slope,
                         residual and layer > 0, dtype,
                         gat_attn or default_gat_attn(graph))
        if last:
            return rst.mean(dim=1)
        return F.elu(rst).reshape(rst.shape[0], -1)
    raise ValueError(f"unknown model {model_name!r}")


@torch.no_grad()
def layerwise_inference(model_name: str, model: nn.Module, graph: DeviceGraph,
                        n_layers: int, heads: Optional[Sequence[int]] = None,
                        negative_slope: float = 0.2, residual: bool = False,
                        dtype=torch.bfloat16, spmm: Optional[SpMM] = None,
                        gat_attn: Optional[GatAttn] = None) -> torch.Tensor:
    """Every layer over the full graph; returns [N, n_classes] f32 logits.
    ``heads`` defaults to the model's own per-layer head counts."""
    h = graph.ndata["features"].to(torch.float32)
    for l in range(n_layers):
        h = inference_layer(model_name, model, graph, l, h, n_layers, heads,
                            negative_slope, residual, dtype, spmm, gat_attn)
    return h
