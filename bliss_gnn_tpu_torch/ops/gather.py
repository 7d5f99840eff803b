"""K2: table lookup, out[i] = lut[idx[i]] for i < n_valid and 0 past it.

Counterpart of ``bliss_gnn_tpu/ops/gather_pallas.py`` (``lut_gather`` and
the grouped ``maybe_lut_gather_multi``). CUDA tensors go to the hand-written
kernel ``csrc/lut_gather.cu``, which serves up to eight tables that share
one index list in one launch, reads each id once, and moves each entry as
raw bits of its width (int32 exact above 2^24; bool as one byte); CPU
tensors go to the plain versions.

Callers are the sampler's per-slot takes: the keep-mask lookup, the
candidate relabelling, the block-build takes (five tables on the kept-edge
list, two on its candidate positions), the per-chunk owner takes (four
tables) and seed broadcasts, and the reward gathers (two tables on the
block's src slots; the GAT reward's two on its dst slots).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32, prefix_mask, valid_arg

MAX_TABLES = 8  # the kernel's descriptor holds eight tables


def lut_gather_plain(lut: torch.Tensor, idx: torch.Tensor,
                     n_valid=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel; indices outside [0, len(lut))
    and slots at or past ``n_valid`` read 0."""
    n = lut.shape[0]
    keep = (idx >= 0) & (idx < n)
    live = prefix_mask(idx.shape[0], n_valid, idx.device)
    if live is not None:
        keep &= live
    out = lut[torch.where(keep, idx, 0).long()]
    return out.masked_fill(~keep, 0)


def lut_gather_multi_plain(luts: Sequence[torch.Tensor], idx: torch.Tensor,
                           n_valid=None) -> List[torch.Tensor]:
    """Plain PyTorch version of the grouped kernel: one take per table."""
    return [lut_gather_plain(t, idx, n_valid) for t in luts]


def lut_gather_multi(luts: Sequence[torch.Tensor], idx: torch.Tensor,
                     n_valid=None) -> List[torch.Tensor]:
    """``[lut_gather(t, idx, n_valid) for t in luts]`` in one launch: one to
    eight 1-D tables of 1, 2, 4 or 8 byte entries, each of its own length,
    read through the shared index list ``idx``."""
    if not idx.is_cuda:
        if idx.device.type == "cpu" and all(t.device.type == "cpu"
                                            for t in luts):
            return lut_gather_multi_plain(luts, idx, n_valid)
        raise ValueError(f"lut_gather: no kernel for {idx.device}")
    if not 1 <= len(luts) <= MAX_TABLES:
        raise ValueError(f"lut_gather: {len(luts)} tables; the kernel takes "
                         f"1 to {MAX_TABLES}")
    card, device = idx.get_device(), idx.device
    idx = index_i32(idx, "lut_gather idx")
    nv = valid_arg(n_valid, device)
    m = idx.numel()
    copies, outs, desc = [], [], []
    for t in luts:
        if t.get_device() != card or t.dim() != 1:
            raise ValueError(f"lut_gather: a table of shape "
                             f"{tuple(t.shape)} on {t.device}, ids on "
                             f"{device}; tables must be 1-D on the ids' card")
        width = t.element_size()
        if width not in (1, 2, 4, 8):
            raise TypeError(f"lut_gather: no kernel for {t.dtype}")
        if not t.is_contiguous():
            t = t.contiguous()
            copies.append(t)  # alive until the launch
        out = torch.empty(m, dtype=t.dtype, device=device)
        outs.append(out)
        desc += (t.data_ptr(), out.data_ptr(), t.numel(), width)
    err = _build.load("lut_gather").bliss_lut_gather(
        (ctypes.c_longlong * len(desc))(*desc), len(outs), idx.data_ptr(),
        m, None if nv is None else nv.data_ptr(), _build.stream_of(idx))
    lut_gather.launches += 1
    if err:
        _build.check(err, "lut_gather")
    return outs


def lut_gather(lut: torch.Tensor, idx: torch.Tensor,
               n_valid=None) -> torch.Tensor:
    """out[i] = lut[idx[i]] in lut's dtype; 1-D ``lut`` of 1, 2, 4 or 8
    byte entries. ``n_valid`` bounds the prefix of live slots. The one-table
    call of :func:`lut_gather_multi`."""
    if (not lut.is_cuda and lut.device.type == "cpu"
            and idx.device.type == "cpu"):
        return lut_gather_plain(lut, idx, n_valid)
    return lut_gather_multi((lut,), idx, n_valid)[0]


lut_gather.launches = 0  # K2 launches, one-table and grouped calls alike
