"""K2: table lookup, out[i] = lut[idx[i]] for i < n_valid and 0 past it.

Counterpart of ``bliss_gnn_tpu/ops/gather_pallas.py``. A CUDA tensor goes to
the hand-written kernel ``csrc/lut_gather.cu``, which moves each entry as
raw bits of its width (int32 exact above 2^24; bool as one byte); a CPU
tensor goes to :func:`lut_gather_plain`.

Callers are the sampler's per-slot takes: the keep-mask lookups, the
candidate relabelling, the block-build takes, the per-chunk owner takes and
seed broadcasts, the reward gathers, and the EXP3 factor permutation.
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32, prefix_mask, valid_arg


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


def lut_gather(lut: torch.Tensor, idx: torch.Tensor,
               n_valid=None) -> torch.Tensor:
    """out[i] = lut[idx[i]] in lut's dtype; 1-D ``lut`` of 1, 2, 4 or 8
    byte entries. ``n_valid`` bounds the prefix of live slots."""
    if lut.device.type == "cpu":
        return lut_gather_plain(lut, idx, n_valid)
    if lut.device.type != "cuda" or idx.device != lut.device:
        raise ValueError(f"lut_gather: no kernel for {lut.device}/{idx.device}")
    if lut.dim() != 1:
        raise ValueError("lut_gather: the table must be 1-D")
    if lut.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"lut_gather: no kernel for {lut.dtype}")
    lut = lut.contiguous()
    idx = index_i32(idx, "lut_gather idx")
    nv = valid_arg(n_valid, lut.device)
    out = torch.empty(idx.shape[0], dtype=lut.dtype, device=lut.device)
    lib = _build.load("lut_gather")
    err = lib.bliss_lut_gather(
        lut.data_ptr(), lut.shape[0], lut.element_size(), idx.data_ptr(),
        out.data_ptr(), idx.shape[0], _build.ptr(nv), _build.stream_of(lut))
    lut_gather.launches += 1
    _build.check(err, "lut_gather")
    return out


lut_gather.launches = 0
