"""Carry weights and bandit state over from the reference package.

Every function takes numpy arrays (the caller turns the reference's arrays
into numpy), so this module needs nothing of the reference. A flax Dense
kernel is [in, out]; a torch Linear weight is [out, in]. Each returns its
tensors in ``dtype``: the parameters' (or the arm weights') storage dtype,
f32 or bf16. Values pass through f32, which holds every bf16 value, so a
bf16 tree comes back bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _kernel(dense: Mapping[str, Any], dtype: torch.dtype) -> torch.Tensor:
    return _tensor(np.asarray(dense["kernel"], dtype=np.float32).T,
                   dtype).contiguous()


def _layers(tree: Mapping[str, Any], prefix: str):
    """(layer index, group) of a flax params tree, with or without the
    top-level ``"params"`` key."""
    if "params" in tree:
        tree = tree["params"]
    for name, layer in tree.items():
        if not name.startswith(prefix):
            raise KeyError(f"unexpected parameter group {name!r}")
        yield int(name[len(prefix):]), layer


def sage_params_from_jax(tree: Mapping[str, Any],
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """A flax SAGE ``params`` tree as a ``state_dict`` of
    ``models.gnn.SAGE``."""
    out: Dict[str, torch.Tensor] = {}
    for l, layer in _layers(tree, "layers_"):
        for fc in ("fc_neigh", "fc_self"):
            out[f"layers.{l}.{fc}.weight"] = _kernel(layer[fc], dtype)
        out[f"layers.{l}.bias"] = _tensor(layer["bias"], dtype)
    return out


def gcn_params_from_jax(tree: Mapping[str, Any],
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """A flax GCN ``params`` tree (a ``weight`` Dense with bias per layer)
    as a ``state_dict`` of ``models.gnn.GCN``."""
    out: Dict[str, torch.Tensor] = {}
    for l, layer in _layers(tree, "layers_"):
        out[f"layers.{l}.fc.weight"] = _kernel(layer["weight"], dtype)
        out[f"layers.{l}.fc.bias"] = _tensor(layer["weight"]["bias"], dtype)
    return out


def gat_params_from_jax(tree: Mapping[str, Any],
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """A flax GATv2 ``params`` tree (``fc_src``, ``attn`` [1, H, O] and the
    optional ``res_fc`` per layer) as a ``state_dict`` of
    ``models.gnn.GATv2``."""
    out: Dict[str, torch.Tensor] = {}
    for l, layer in _layers(tree, "gatv2_layers_"):
        out[f"layers.{l}.fc_src.weight"] = _kernel(layer["fc_src"], dtype)
        out[f"layers.{l}.attn"] = _tensor(layer["attn"], dtype)
        if "res_fc" in layer:
            out[f"layers.{l}.res_fc.weight"] = _kernel(layer["res_fc"],
                                                       dtype)
    return out


def exp3_from_jax(np_state: np.ndarray, n_edges: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The reference's EXP3 grid [L, R, 128] as the port's layout
    [L, n_edges + EDGE_PAD] in ``dtype`` (the reference's bf16 by default,
    f32 for its ``exp3_dtype="float32"``), zeros on the padding."""
    L = np_state.shape[0]
    flat = np.asarray(np_state, dtype=np.float32).reshape(L, -1)[:, :n_edges]
    out = np.zeros((L, n_edges + EDGE_PAD), dtype=np.float32)
    out[:, :n_edges] = flat
    return torch.from_numpy(out).to(dtype)
