"""Full-graph layerwise inference, the final-eval path (counterpart of
``layerwise_inference`` in ``bliss_gnn_tpu/models/inference.py``).

Every layer runs over all nodes with full neighbourhoods and no sampling
weights, dropout off, and gives the [N, n_classes] f32 logits. The math
mirrors ``models/layers.py``; the weights are read from the trained
``nn.Module``. The aggregation is K6 (``ops.spmm``, SAGE and GCN) or K7
(``ops.gat_attention``, GATv2), which run their kernels on a CUDA graph and
their plain versions on a CPU graph; the dense products stay
``torch.matmul``. The kernels read the CSC arrays directly, so there is no
layout to build beforehand. ``layerwise_inference_uva`` runs the same
layers chunk by chunk from host-resident features, for graphs whose
features do not fit on the card; ``layerwise_inference_sharded`` runs
them over a mesh of ranks with the activations node-sharded.

``layerwise_inference`` is traced (``utils/spans.py``, off by default): a
host span ``infer.layer`` a layer and, with device marks on, a unit
``infer`` a pass whose marks time each layer's projection
(``infer.project``) and aggregation (``infer.attend``: K7 for GATv2, K6
for SAGE and GCN), recorded at the pass's end (a sync).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
from bliss_gnn_tpu_torch.ops.gat_attention import gat_attention
from bliss_gnn_tpu_torch.ops.spmm import spmm as spmm_csr
from bliss_gnn_tpu_torch.utils import spans

SpMM = Callable[[torch.Tensor], torch.Tensor]
GatAttn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def default_spmm(graph: DeviceGraph) -> SpMM:
    """Unit-weight full-graph SpMM (K6): [N, F'] -> [N, F'] f32 dst sums."""
    return lambda feat: spmm_csr(feat, graph.csc_indptr, graph.csc_src)


def default_gat_attn(graph: DeviceGraph) -> GatAttn:
    """Full-graph GATv2 attention (K7) in the graph's src ranges: [N, H, O]
    -> [N, H, O] f32."""
    ranges = graph.k7_ranges
    return lambda feat, attn, slope: gat_attention(
        feat, attn, slope, graph.csc_indptr, graph.csc_src, ranges=ranges)


def _sage_layer(conv: nn.Module, h_src: torch.Tensor, h_dst: torch.Tensor,
                in_deg: torch.Tensor, dtype, aggregate: SpMM) -> torch.Tensor:
    """SAGE-mean: ``aggregate`` sums rows of [len(h_src), F'] into the
    dsts, ``h_dst`` and ``in_deg`` the dsts' own rows and in-degrees."""
    Wn = conv.fc_neigh.weight.to(dtype)
    Ws = conv.fc_self.weight.to(dtype)
    b = conv.bias.to(torch.float32)
    lin_before = h_src.shape[1] > Wn.shape[0]
    with spans.device_span("infer.project"):
        src_val = (F.linear(h_src.to(dtype), Wn) if lin_before
                   else h_src.to(dtype))
    deg = torch.clamp(in_deg.to(torch.float32), min=1.0)
    with spans.device_span("infer.attend"):
        agg = aggregate(src_val)
    agg = agg / deg[:, None]
    h_neigh = agg if lin_before else F.linear(agg.to(dtype), Wn)
    return F.linear(h_dst.to(dtype), Ws).to(torch.float32) + h_neigh + b


def _gcn_layer(conv: nn.Module, h_src: torch.Tensor, out_deg: torch.Tensor,
               in_deg: torch.Tensor, dtype, aggregate: SpMM) -> torch.Tensor:
    """GCN with both-side norms: ``out_deg`` the src rows' out-degrees,
    ``in_deg`` the dsts' in-degrees."""
    W = conv.fc.weight.to(dtype)
    b = conv.fc.bias.to(torch.float32)
    src_norm = torch.rsqrt(torch.clamp(out_deg.to(torch.float32),
                                       min=1.0))[:, None].to(dtype)
    feat = h_src.to(dtype) * src_norm
    if h_src.shape[1] > W.shape[0]:
        with spans.device_span("infer.project"):
            feat = F.linear(feat, W)
        with spans.device_span("infer.attend"):
            agg = aggregate(feat)
    else:
        with spans.device_span("infer.attend"):
            agg = aggregate(feat)
        agg = F.linear(agg.to(dtype), W).to(torch.float32)
    return agg * torch.rsqrt(torch.clamp(in_deg.to(torch.float32),
                                         min=1.0))[:, None] + b


def _gat_layer(conv: nn.Module, h: torch.Tensor, num_heads: int,
               negative_slope: float, residual: bool, dtype,
               gat_attn: GatAttn, res_dtype=None) -> torch.Tensor:
    """GATv2 over the table ``h``, whose first rows are the dsts' own:
    [n_dst, H, O] f32 plus the dsts' residual, its projection in
    ``res_dtype`` (``dtype`` when None)."""
    W = conv.fc_src.weight.to(dtype)
    O = W.shape[0] // num_heads
    with spans.device_span("infer.project"):
        feat = F.linear(h.to(dtype), W).reshape(-1, num_heads, O)
    with spans.device_span("infer.attend"):
        rst = gat_attn(feat, conv.attn, negative_slope)
    if residual:
        res = h[:rst.shape[0]]
        if conv.res_fc is not None:
            rd = res_dtype or dtype
            res = F.linear(res.to(rd), conv.res_fc.weight.to(rd))
        rst = rst + res.reshape(-1, num_heads, O).to(torch.float32)
    return rst


def _activate(name: str, h: torch.Tensor, last: bool) -> torch.Tensor:
    """A layer's activation: ReLU for SAGE and GCN; for GATv2 an ELU and a
    head flatten, or the head mean at the output."""
    if name == "gat":
        if last:
            return h.mean(dim=1)
        return F.elu(h).reshape(h.shape[0], -1)
    return h if last else torch.relu(h)


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
    conv = model.layers[layer]
    if name == "sage":
        h_out = _sage_layer(conv, h, h, graph.in_degrees(), dtype,
                            spmm or default_spmm(graph))
    elif name == "gcn":
        h_out = _gcn_layer(conv, h, graph.out_degrees(), graph.in_degrees(),
                           dtype, spmm or default_spmm(graph))
    elif name == "gat":
        heads = heads or model.heads
        h_out = _gat_layer(conv, h, heads[layer], negative_slope,
                           residual and layer > 0, dtype,
                           gat_attn or default_gat_attn(graph))
    else:
        raise ValueError(f"unknown model {model_name!r}")
    return _activate(name, h_out, layer == n_layers - 1)


@torch.no_grad()
def layerwise_inference(model_name: str, model: nn.Module, graph: DeviceGraph,
                        n_layers: int, heads: Optional[Sequence[int]] = None,
                        negative_slope: float = 0.2, residual: bool = False,
                        dtype=torch.bfloat16, spmm: Optional[SpMM] = None,
                        gat_attn: Optional[GatAttn] = None) -> torch.Tensor:
    """Every layer over the full graph; returns [N, n_classes] f32 logits.
    ``heads`` defaults to the model's own per-layer head counts."""
    spans.follow_profiler()
    h = graph.ndata["features"].to(torch.float32)
    marks = spans.open_marks("infer", h.device)
    for l in range(n_layers):
        with spans.span("infer.layer"):
            h = inference_layer(model_name, model, graph, l, h, n_layers,
                                heads, negative_slope, residual, dtype, spmm,
                                gat_attn)
    spans.record(spans.finish(marks))
    return h


@torch.no_grad()
def layerwise_inference_uva(model_name: str, model: nn.Module, host_graph,
                            n_layers: int,
                            heads: Optional[Sequence[int]] = None,
                            negative_slope: float = 0.2,
                            residual: bool = False, dtype=torch.bfloat16,
                            node_batch: int = 1 << 15, features=None,
                            device="cuda",
                            timings: Optional[dict] = None) -> np.ndarray:
    """Layerwise inference with host-resident activations (the counterpart
    of the JAX ``layerwise_inference_uva``): [N, n_classes] f32 logits as a
    host array, the full [N, F] never on the device.

    Per layer and per chunk of ``node_batch`` dsts: the chunk's CSC slice
    is cut on the host, only the unique src rows it reads are fetched
    (``features``, a host array or memmap, else the graph's, at layer 0;
    then the last layer's host output), the layer runs on ``device`` (the
    card by default; raises without one) and its output is written back to
    host memory. The aggregation is K6 (SAGE, GCN) or K7 (GATv2) over the
    chunk's CSC slice, the src ids pointing into the fetched rows; K7 reads
    a dst's own projection at its row, so its table is the chunk's rows
    followed by the unique src rows. GATv2's residual projection runs in
    f32, as in the reference. ``timings``, when given, receives the host
    and device seconds and the chunk count."""
    dev = resolve_device(device)
    name = model_name.lower()
    if name not in ("sage", "gcn", "gat"):
        raise ValueError(f"unknown model {model_name!r}")
    heads = heads or getattr(model, "heads", None)
    t0 = time.perf_counter()
    host_s = dev_s = 0.0
    indptr = np.asarray(host_graph.csc_indptr, np.int64)
    csc_src = np.asarray(host_graph.csc_src)[:host_graph.n_edges]
    n = host_graph.n_nodes
    in_deg = np.diff(indptr)
    out_deg = np.asarray(host_graph.out_degrees())
    chunks = []  # (c0, c1, unique srcs, src ids into them, local indptr)
    for c0 in range(0, n, node_batch):
        c1 = min(n, c0 + node_batch)
        uniq, inv = np.unique(csc_src[indptr[c0]:indptr[c1]],
                              return_inverse=True)
        chunks.append((c0, c1, uniq, inv.astype(np.int32),
                       (indptr[c0:c1 + 1] - indptr[c0]).astype(np.int32)))
    host_s += time.perf_counter() - t0

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    h = features if features is not None else host_graph.ndata["features"]
    for layer in range(n_layers):
        conv = model.layers[layer]
        out = None
        for c0, c1, uniq, inv, ip in chunks:
            t0 = time.perf_counter()
            rows = np.asarray(h[uniq], np.float32)
            own = np.array(h[c0:c1], np.float32)
            t1 = time.perf_counter()
            ip_d = up(ip)
            if name == "gat":
                src_d = up(inv + np.int32(c1 - c0))
                res = _gat_layer(
                    conv, up(np.concatenate([own, rows])), heads[layer],
                    negative_slope, residual and layer > 0, dtype,
                    lambda feat, attn, slope: gat_attention(
                        feat, attn, slope, ip_d, src_d),
                    res_dtype=torch.float32)
            else:
                src_d = up(inv)

                def aggregate(v):
                    return spmm_csr(v, ip_d, src_d)

                if name == "sage":
                    res = _sage_layer(conv, up(rows), up(own),
                                      up(in_deg[c0:c1]), dtype, aggregate)
                else:
                    res = _gcn_layer(conv, up(rows), up(out_deg[uniq]),
                                     up(in_deg[c0:c1]), dtype, aggregate)
            res = _activate(name, res, layer == n_layers - 1).cpu().numpy()
            t2 = time.perf_counter()
            if out is None:
                out = np.empty((n, res.shape[1]), np.float32)
            out[c0:c1] = res
            host_s += (t1 - t0) + (time.perf_counter() - t2)
            dev_s += t2 - t1
        h = out
    if timings is not None:
        timings.update(host_s=host_s, device_s=dev_s, chunks=len(chunks))
    return h


@torch.no_grad()
def layerwise_inference_sharded(model_name: str, model: nn.Module,
                                host_graph, mesh, n_layers: int,
                                heads: Optional[Sequence[int]] = None,
                                negative_slope: float = 0.2,
                                residual: bool = False,
                                dtype=torch.bfloat16,
                                features=None,
                                timings: Optional[dict] = None
                                ) -> torch.Tensor:
    """Full-graph layerwise inference with the activations node-sharded
    over ``mesh`` (the counterpart of the JAX
    ``layerwise_inference_sharded``): a rank holds O(N/S * F + E/S), its
    dst range's rows, and the aggregation is the ring of
    ``parallel/edgeshard.py`` (S - 1 rotations of a feature block, K6 per
    bucket for SAGE and GCN, K7 with its partial outputs for GATv2, whose
    edge softmax is per dst and so shard-local). The dense products run
    on the rank's rows. Layer 0 reads ``features`` (a host array or
    memmap, else the graph's), this rank's rows only; GATv2's residual
    projection runs in ``dtype``, as in the JAX function. Returns the [N,
    n_classes] f32 logits on every rank (one all-gather at the end).
    ``timings``, when given, receives the seconds of the shard build and
    uploads (``build_s``) and of the layers and the gather (``layers_s``),
    each to a sync of the rank's device."""
    from bliss_gnn_tpu_torch.parallel.edgeshard import (
        RingEdgeShards,
        make_ring_gat,
        make_ring_spmm,
    )

    name = model_name.lower()
    if name not in ("sage", "gcn", "gat"):
        raise ValueError(f"unknown model {model_name!r}")
    heads = heads or getattr(model, "heads", None)
    dev = mesh.device
    t0 = time.perf_counter()
    shards = RingEdgeShards.build(host_graph, mesh)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    feats = features if features is not None else host_graph.ndata["features"]
    h = up(shards.shard_rows(feats).astype(np.float32))
    in_deg = up(shards.shard_rows(
        np.asarray(host_graph.in_degrees(), np.float32)))
    out_deg = up(shards.shard_rows(
        np.asarray(host_graph.out_degrees(), np.float32)))
    ring_spmm = make_ring_spmm(mesh, shards)
    ring_gat = make_ring_gat(mesh, shards, negative_slope)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    for layer in range(n_layers):
        conv = model.layers[layer]
        if name == "sage":
            h_out = _sage_layer(conv, h, h, in_deg, dtype, ring_spmm)
        elif name == "gcn":
            h_out = _gcn_layer(conv, h, out_deg, in_deg, dtype, ring_spmm)
        else:
            h_out = _gat_layer(conv, h, heads[layer], negative_slope,
                               residual and layer > 0, dtype,
                               lambda feat, attn, slope: ring_gat(feat, attn))
        h = _activate(name, h_out, layer == n_layers - 1)
    out = shards.unshard_rows(mesh, h)[:host_graph.n_nodes]
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings.update(build_s=t1 - t0, layers_s=time.perf_counter() - t1)
    return out
