"""Carry weights and bandit state over from the reference package.

Both functions take numpy arrays (the caller turns the reference's arrays
into numpy), so this module needs nothing of the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD


def sage_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax SAGE ``params`` tree of numpy arrays (with or without the
    top-level ``"params"`` key) as a ``state_dict`` of ``models.gnn.SAGE``.
    A flax Dense kernel is [in, out]; a torch Linear weight is [out, in]."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, layer in tree.items():
        if not name.startswith("layers_"):
            raise KeyError(f"unexpected parameter group {name!r}")
        l = int(name.split("_", 1)[1])
        for fc in ("fc_neigh", "fc_self"):
            kernel = np.asarray(layer[fc]["kernel"], dtype=np.float32)
            out[f"layers.{l}.{fc}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.T))
        out[f"layers.{l}.bias"] = torch.from_numpy(
            np.asarray(layer["bias"], dtype=np.float32).copy())
    return out


def exp3_from_jax(np_state: np.ndarray, n_edges: int) -> torch.Tensor:
    """The reference's EXP3 grid [L, R, 128] as the port's layout
    [L, n_edges + EDGE_PAD] (bf16, zeros on the padding)."""
    L = np_state.shape[0]
    flat = np.asarray(np_state, dtype=np.float32).reshape(L, -1)[:, :n_edges]
    out = np.zeros((L, n_edges + EDGE_PAD), dtype=np.float32)
    out[:, :n_edges] = flat
    return torch.from_numpy(out).to(torch.bfloat16)
