"""Argument normalisation shared by the kernel wrappers."""
from __future__ import annotations

from typing import Optional

import torch


def index_i32(t: torch.Tensor, what: str) -> torch.Tensor:
    """A 1-D contiguous int32 copy of an integer index tensor, or the tensor
    itself when it is one already."""
    if t.dim() != 1 or t.is_floating_point() or t.dtype == torch.bool:
        raise TypeError(f"{what}: expected a 1-D integer tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t if t.is_contiguous() else t.contiguous()


def valid_arg(n_valid, device: torch.device) -> Optional[torch.Tensor]:
    """``n_valid`` (None, int or 1-element tensor) as a 1-element int32
    tensor on ``device`` (the tensor itself when it is one), so that a kernel
    reads it without a host sync. An int becomes a tensor through a
    host-to-device copy, which CUDA-graph capture forbids: under capture it
    raises, and the step's callers pass tensors already on the card."""
    if n_valid is None:
        return None
    if isinstance(n_valid, torch.Tensor):
        if n_valid.numel() != 1:
            raise ValueError(f"n_valid: expected one element, got shape "
                             f"{tuple(n_valid.shape)}")
        if n_valid.dtype == torch.int32 and n_valid.device == device:
            return n_valid
        return n_valid.to(device=device, dtype=torch.int32).reshape(1)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("n_valid as a Python int needs a host-to-device "
                           "copy, which CUDA-graph capture forbids: pass a "
                           "tensor on the card")
    return torch.tensor([int(n_valid)], dtype=torch.int32, device=device)


def sorted_valid_arg(n_valid, device: torch.device,
                     what: str) -> torch.Tensor:
    """``valid_arg`` for a sorted route, which needs the prefix bound: the
    masked tail past it carries id 0."""
    if n_valid is None:
        raise ValueError(f"{what}: ids_sorted=True needs n_valid")
    return valid_arg(n_valid, device)


def check_sorted(ids: torch.Tensor, n_valid, what: str) -> None:
    """The plain versions' check of an ``ids_sorted`` promise: ids
    non-decreasing on the valid prefix. Checked on a CPU tensor only (on the
    card it would cost a host sync); a missing ``n_valid`` raises anywhere."""
    nv = sorted_valid_arg(n_valid, ids.device, what)
    if ids.device.type != "cpu":
        return
    n = max(0, int(nv))
    prefix = ids[:n]
    if bool((prefix[1:] < prefix[:-1]).any()):
        raise ValueError(f"{what}: ids_sorted=True but the ids decrease "
                         f"inside the valid prefix of {n}")


def prefix_mask(n: int, n_valid, device: torch.device) -> Optional[torch.Tensor]:
    """Boolean [n] mask of the valid prefix, or None when n_valid is None."""
    if n_valid is None:
        return None
    nv = valid_arg(n_valid, device)
    return torch.arange(n, device=device) < nv
