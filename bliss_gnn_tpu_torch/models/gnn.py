"""Multi-layer GNN models over sampled blocks (counterpart of
``bliss_gnn_tpu/models/gnn.py``; SAGE only so far).

Forward contract: ``model(blocks, x, generator=None)`` returns
``(logits, aux)``, logits [n_dst_cap of the last block, n_classes] and
``aux = {"embed_norms": [L x [n_src_cap_l]], "a_ijs": None}``; the embed
norms feed the EXP3 reward.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.models.layers import COMPUTE_DTYPE, SAGEConv
from bliss_gnn_tpu_torch.sampling.block import Block


def _embed_norm(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """||h||_2 per src slot, 0 on padding."""
    n = torch.linalg.vector_norm(h.to(torch.float32), dim=1)
    return torch.where(mask, n, 0.0)


def dropout(h: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator."""
    if p <= 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype,
                                                         device=h.device))


class SAGE(nn.Module):
    """n-layer GraphSAGE with ReLU and dropout between layers."""

    def __init__(self, in_feats: int, n_hidden: int, n_classes: int,
                 n_layers: int, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers, self.dropout = n_layers, dropout
        dims = [in_feats] + [n_hidden] * (n_layers - 1) + [n_classes]
        self.layers = nn.ModuleList(
            SAGEConv(dims[l], dims[l + 1], generator=generator)
            for l in range(n_layers))

    def forward(self, blocks: Sequence[Block], x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        h = x.to(COMPUTE_DTYPE)
        embed_norms: List[torch.Tensor] = []
        for l, (conv, block) in enumerate(zip(self.layers, blocks)):
            embed_norms.append(_embed_norm(h.detach(), block.src_mask))
            h = conv(block, h)
            if l < self.n_layers - 1:
                h = torch.relu(h)
                if self.training:
                    h = dropout(h, self.dropout, generator)
        return h, {"embed_norms": embed_norms, "a_ijs": None}


def build_model(name: str, in_feats: int, n_hidden: int, n_classes: int,
                n_layers: int, dropout: float = 0.1, device="cuda",
                seed: int = 0) -> nn.Module:
    """Model factory; the weights are drawn on the CPU from ``seed`` and
    moved to ``device`` (which raises when it is CUDA and no card exists)."""
    dev = resolve_device(device)
    if name.lower() != "sage":
        raise NotImplementedError(f"model {name!r} is not ported yet")
    gen = torch.Generator().manual_seed(seed)
    return SAGE(in_feats, n_hidden, n_classes, n_layers, dropout,
                generator=gen).to(dev)
