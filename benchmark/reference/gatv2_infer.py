"""Plain reference of full-graph GATv2 inference (Brody et al., 2022), in
float32 plain PyTorch, computed in blocks of edges so that it fits.

Per layer: f = h W^T, one projection shared by src and dst, [N, H, O];
per edge j -> i and head, e = sum_O attn * leakyrelu(f_j + f_i); the
softmax of e over the in-edges of i; out_i = sum_j a_ij f_j; ELU and the
heads flattened between layers, the heads averaged at the output. No edge
weights, no residual (the configuration turns it off), no dropout.

It imports nothing of the program. A ``Rounding`` other than float32
rounds where the program rounds to its compute precision (the layer's
input, the weight and the projection), which is the control.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from precision import Rounding

EDGE_BLOCK = 1 << 19


def _attention(feat, attn, slope, indptr, src, dst):
    """The softmax-weighted sum of the src rows for every dst and head:
    [N, H, O] f32."""
    N, H, O = feat.shape
    E = src.shape[0]
    e = torch.empty((E, H), device=feat.device)
    for a in range(0, E, EDGE_BLOCK):
        b = min(a + EDGE_BLOCK, E)
        z = feat[src[a:b].long()] + feat[dst[a:b].long()]
        e[a:b] = (F.leaky_relu(z, slope) * attn).sum(-1)
    m = torch.full((N, H), -torch.inf, device=feat.device)
    m.scatter_reduce_(0, dst.long()[:, None].expand(-1, H), e, "amax")
    e = torch.exp(e - m[dst.long()])
    den = torch.zeros((N, H), device=feat.device).index_add_(
        0, dst.long(), e)
    a = e / den[dst.long()]
    out = torch.empty_like(feat)
    with warnings.catch_warnings():  # CSR tensors are "beta"
        warnings.simplefilter("ignore", UserWarning)
        for h in range(H):
            A = torch.sparse_csr_tensor(indptr, src.long(), a[:, h], (N, N))
            out[:, h] = A @ feat[:, h].contiguous()
    return out


@torch.no_grad()
def logits(cfg, g, weights, rounding=None):
    """[N, n_classes] f32 logits of the whole graph ``g`` (indptr, src,
    dst, features on one device) under ``weights``."""
    rnd = rounding or Rounding()
    m = cfg["model"]
    L, heads, slope = m["layers"], m["heads"], m["negative_slope"]
    h = g.features
    N = h.shape[0]
    for l in range(L):
        W = rnd.c(rnd.p(weights[f"layers.{l}.fc_src.weight"]))
        attn = rnd.p(weights[f"layers.{l}.attn"]).reshape(1, heads[l], -1)
        feat = rnd.c(rnd.c(h) @ W.T).reshape(N, heads[l], -1)
        out = _attention(feat, attn, slope, g.indptr, g.src, g.dst)
        h = out.mean(1) if l == L - 1 else F.elu(out).reshape(N, -1)
    return h
