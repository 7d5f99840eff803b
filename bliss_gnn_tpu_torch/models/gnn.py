"""Multi-layer GNN models over sampled blocks (counterpart of
``bliss_gnn_tpu/models/gnn.py``): SAGE, GCN and GATv2.

Forward contract: ``model(blocks, x, generator=None)`` returns
``(logits, aux)``, logits [n_dst_cap of the last block, n_classes] and
``aux = {"embed_norms": [L x [n_src_cap_l]], "a_ijs": [L x [e_cap_l]] or
None}``; the embed norms (and, for GATv2, the head-mean pre-softmax
logits ``a_ijs``) feed the EXP3 reward. Dropout draws from ``generator``.
Each model computes in its ``dtype`` and stores its parameters in its
``param_dtype`` (``build_model``'s ``dtype``/``param_dtype``, as the flax
modules' fields), both passed to every conv.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.models.layers import (
    GATv2Conv,
    GraphConv,
    SAGEConv,
    dropout,
)
from bliss_gnn_tpu_torch.sampling.block import Block


def _embed_norm(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """||h||_2 per src slot, 0 on padding."""
    n = torch.linalg.vector_norm(h.to(torch.float32), dim=1)
    return torch.where(mask, n, 0.0)


class SAGE(nn.Module):
    """n-layer GraphSAGE with ReLU and dropout between layers."""

    def __init__(self, in_feats: int, n_hidden: int, n_classes: int,
                 n_layers: int, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.dropout, self.dtype = n_layers, dropout, dtype
        dims = [in_feats] + [n_hidden] * (n_layers - 1) + [n_classes]
        self.layers = nn.ModuleList(
            SAGEConv(dims[l], dims[l + 1], generator=generator, dtype=dtype,
                     param_dtype=param_dtype)
            for l in range(n_layers))

    def forward(self, blocks: Sequence[Block], x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        h = x.to(self.dtype)
        embed_norms: List[torch.Tensor] = []
        for l, (conv, block) in enumerate(zip(self.layers, blocks)):
            embed_norms.append(_embed_norm(h.detach(), block.src_mask))
            h = conv(block, h)
            if l < self.n_layers - 1:
                h = torch.relu(h)
                if self.training:
                    h = dropout(h, self.dropout, generator)
        return h, {"embed_norms": embed_norms, "a_ijs": None}


class GCN(nn.Module):
    """n-layer GCN: ReLU inside each conv but the last, dropout between
    layers."""

    def __init__(self, in_feats: int, n_hidden: int, n_classes: int,
                 n_layers: int, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.dropout, self.dtype = n_layers, dropout, dtype
        dims = [in_feats] + [n_hidden] * (n_layers - 1) + [n_classes]
        self.layers = nn.ModuleList(
            GraphConv(dims[l], dims[l + 1],
                      activation=None if l == n_layers - 1 else torch.relu,
                      generator=generator, dtype=dtype,
                      param_dtype=param_dtype)
            for l in range(n_layers))

    def forward(self, blocks: Sequence[Block], x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        h = x.to(self.dtype)
        embed_norms: List[torch.Tensor] = []
        for l, (conv, block) in enumerate(zip(self.layers, blocks)):
            embed_norms.append(_embed_norm(h.detach(), block.src_mask))
            h = conv(block, h)
            if l < self.n_layers - 1 and self.training:
                h = dropout(h, self.dropout, generator)
        return h, {"embed_norms": embed_norms, "a_ijs": None}


class GATv2(nn.Module):
    """Multi-head GATv2 stack: ELU inside each conv but the last, heads
    flattened between layers and averaged at the output, residuals off on
    the first layer. ``a_ijs[l]`` is layer l's pre-softmax logit averaged
    over heads, in f32, detached."""

    def __init__(self, in_feats: int, n_hidden: int, n_classes: int,
                 n_layers: int, heads: Sequence[int] = (4, 4, 1),
                 feat_drop: float = 0.1, attn_drop: float = 0.1,
                 negative_slope: float = 0.2, residual: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(heads) != n_layers:
            raise ValueError(f"{len(heads)} head counts for {n_layers} layers")
        self.n_layers, self.heads, self.dtype = n_layers, tuple(heads), dtype
        layers = []
        d_in = in_feats
        for l in range(n_layers):
            last = l == n_layers - 1
            out = n_classes if last else n_hidden
            layers.append(GATv2Conv(
                d_in, out, heads[l], feat_drop=feat_drop,
                attn_drop=attn_drop, negative_slope=negative_slope,
                residual=residual and l > 0,
                activation=None if last else F.elu, generator=generator,
                dtype=dtype, param_dtype=param_dtype))
            d_in = out * heads[l]
        self.layers = nn.ModuleList(layers)

    def forward(self, blocks: Sequence[Block], x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        h = x.to(self.dtype)
        embed_norms: List[torch.Tensor] = []
        a_ijs: List[torch.Tensor] = []
        for l, (conv, block) in enumerate(zip(self.layers, blocks)):
            embed_norms.append(_embed_norm(h.detach(), block.src_mask))
            h, e = conv(block, h, generator=generator)
            a_ijs.append(e.detach().to(torch.float32).mean(dim=1))
            if l < self.n_layers - 1:
                h = h.reshape(h.shape[0], -1)  # flatten heads
            else:
                h = h.mean(dim=1)  # average output heads
        return h, {"embed_norms": embed_norms, "a_ijs": a_ijs}


def build_model(name: str, in_feats: int, n_hidden: int, n_classes: int,
                n_layers: int, dropout: float = 0.1, num_in_heads: int = 4,
                num_out_heads: int = 1, attn_drop: float = 0.1,
                negative_slope: float = 0.2, residual: bool = False,
                device="cuda", seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                param_dtype: torch.dtype = torch.float32) -> nn.Module:
    """Model factory (``sage``, ``gcn``, ``gat``); the weights are drawn in
    f32 on the CPU from ``seed``, stored in ``param_dtype`` and moved to
    ``device`` (which raises when it is CUDA and no card exists); the
    model computes in ``dtype``. For ``gat``, ``dropout`` is the feature
    dropout and the heads are ``num_in_heads`` per hidden layer and
    ``num_out_heads`` at the output."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=dtype, param_dtype=param_dtype)
    name = name.lower()
    if name == "sage":
        model = SAGE(in_feats, n_hidden, n_classes, n_layers, dropout,
                     generator=gen, **kw)
    elif name == "gcn":
        model = GCN(in_feats, n_hidden, n_classes, n_layers, dropout,
                    generator=gen, **kw)
    elif name == "gat":
        heads = (num_in_heads,) * (n_layers - 1) + (num_out_heads,)
        model = GATv2(in_feats, n_hidden, n_classes, n_layers, heads=heads,
                      feat_drop=dropout, attn_drop=attn_drop,
                      negative_slope=negative_slope, residual=residual,
                      generator=gen, **kw)
    else:
        raise ValueError(f"unknown model {name!r}")
    return model.to(dev)
