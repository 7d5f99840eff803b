"""The weights of a run, made by the benchmark on the device from the
seed's generator in one call, and handed to both sides: loaded into the
program's model, and read by the plain reference.

Names and shapes follow the port's ``named_parameters`` (SAGE:
``layers.<l>.fc_neigh.weight``, ``.fc_self.weight`` [out, in],
``.bias`` [out]; GATv2: ``layers.<l>.fc_src.weight`` [H * O, in],
``.attn`` [1, H, O]). Matrices are uniform with the port's own bounds
(Glorot with gain sqrt 2); SAGE's biases start at zero, as the port's do.
"""
from __future__ import annotations

import math

import torch


def shapes(cfg):
    """[(name, shape, bound)] of the configuration's model, in the order of
    the port's ``named_parameters``; bound 0 is a zero start."""
    m, g = cfg["model"], cfg["graph"]
    L, hid = m["layers"], m["hidden"]
    out = []
    if m["name"] == "sage":
        dims = [g["n_feats"]] + [hid] * (L - 1) + [g["n_classes"]]
        for l in range(L):
            i, o = dims[l], dims[l + 1]
            b = math.sqrt(2.0) * math.sqrt(6.0 / (i + o))
            out += [(f"layers.{l}.fc_neigh.weight", (o, i), b),
                    (f"layers.{l}.fc_self.weight", (o, i), b),
                    (f"layers.{l}.bias", (o,), 0.0)]
    elif m["name"] == "gat":
        heads = m["heads"]
        d_in = g["n_feats"]
        for l in range(L):
            H = heads[l]
            O = g["n_classes"] if l == L - 1 else hid
            b = math.sqrt(2.0) * math.sqrt(6.0 / (d_in + H * O))
            ba = math.sqrt(3.0 * 2.0 / ((H + O) / 2.0))
            out += [(f"layers.{l}.fc_src.weight", (H * O, d_in), b),
                    (f"layers.{l}.attn", (1, H, O), ba)]
            d_in = H * O
    else:
        raise ValueError(f"no weights for model {m['name']!r}")
    return out


def make(cfg, gen):
    """{name: f32 tensor} drawn from ``gen`` (on its device) in one call."""
    spec = shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in spec)
    u = torch.rand(total, generator=gen, device=gen.device) * 2.0 - 1.0
    out, o = {}, 0
    for name, shape, bound in spec:
        n = math.prod(shape)
        out[name] = (u[o:o + n] * bound).reshape(shape)
        o += n
    return out


@torch.no_grad()
def load_into(model, weights):
    """Copies ``weights`` into the program's model (its parameter dtype)."""
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"parameters {sorted(named)} against weights "
                         f"{sorted(weights)}")
    for name, p in named.items():
        p.copy_(weights[name])
