"""K6: full-graph SpMM over the CSC arrays,
out[d, :] = sum over edges e into d of w_e * x[src_e, :], f32 [N, F].

Counterpart of ``bliss_gnn_tpu/ops/spmm_pallas.py`` (banded, packed and
hybrid SpMM: TPU layouts of this one function). A CUDA tensor goes to the
hand-written kernel ``csrc/spmm_csr.cu`` (column slices that fit in L2, one
launch each; a block of four warps per dst row, several edges per warp
load, no atomics; the design note is in the source); a CPU tensor goes to
:func:`spmm_plain`, the chunked ``fullgraph.full_spmm_sum``.

The caller is ``models.inference``: the SAGE and GCN aggregations of
full-graph layerwise inference, with unit weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32
from bliss_gnn_tpu_torch.ops.fullgraph import full_spmm_sum

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the part of x one slice launch keeps in the 50 MB L2 of an H100
L2_SLICE_BYTES = 32 << 20


def spmm_plain(x: torch.Tensor, csc_indptr: torch.Tensor,
               csc_src: torch.Tensor,
               edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (chunked, f32)."""
    n = csc_indptr.shape[0] - 1
    return full_spmm_sum(x, csc_indptr, csc_src, n,
                         int(csc_indptr[-1].item()), edge_vals=edge_vals)


def spmm_plan(n_rows_x: int, f: int,
              dtype: torch.dtype) -> Tuple[int, int, int]:
    """(row width padded to whole 16-byte vectors, columns per slice,
    kernel launches per call) for x [n_rows_x, f] of ``dtype``. One slice
    when the padded table fits in ``L2_SLICE_BYTES``; else the widest
    slice of a power-of-two number of vectors that does (32 / that many
    edges per warp load). A slice is at most 32 vectors."""
    size = dtype.itemsize
    vec = 16 // size
    ld = -(-f // vec) * vec
    cols = ld
    if n_rows_x * ld * size > L2_SLICE_BYTES:
        fit = max(1, L2_SLICE_BYTES // (n_rows_x * 16))  # vectors
        cols = vec << (fit.bit_length() - 1)
    cols = max(vec, min(cols, 32 * vec, ld))  # vec: no column at all
    return ld, cols, -(-f // cols)


def spmm(x: torch.Tensor, csc_indptr: torch.Tensor, csc_src: torch.Tensor,
         edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 [N, F] sums of ``x`` [N_x, F] rows over each dst's in-edges;
    N = len(csc_indptr) - 1, ``edge_vals`` [E] optional weights. ``csc_src``
    may carry padding past the last edge."""
    if x.device.type == "cpu":
        return spmm_plain(x, csc_indptr, csc_src, edge_vals)
    if (x.device.type != "cuda" or csc_indptr.device != x.device
            or csc_src.device != x.device):
        raise ValueError(f"spmm: no kernel for {x.device}/{csc_src.device}")
    if x.dim() != 2:
        raise ValueError("spmm: x must be [N, F]")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"spmm: no kernel for {x.dtype}")
    n_x, f = x.shape
    ld, cols, _ = spmm_plan(n_x, f, x.dtype)
    x = x.contiguous()
    if ld != f:  # rows of whole 16-byte vectors; the copy is in the call
        xp = x.new_zeros((n_x, ld))
        xp[:, :f] = x
        x = xp
    elif x.data_ptr() % 16 != 0:  # the kernel loads 16-byte vectors
        x = x.clone()
    indptr = index_i32(csc_indptr, "spmm csc_indptr")
    src = index_i32(csc_src, "spmm csc_src")
    w = None
    if edge_vals is not None:
        w = edge_vals.to(device=x.device, dtype=torch.float32).contiguous()
    n = indptr.shape[0] - 1
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out
    lib = _build.load("spmm_csr")
    for c0 in range(0, f, cols):  # one launch per slice, in column order
        err = lib.bliss_spmm_csr(
            x.data_ptr(), _DTYPE_CODE[x.dtype], f, ld, c0, min(cols, f - c0),
            indptr.data_ptr(), src.data_ptr(), _build.ptr(w), n,
            out.data_ptr(), _build.stream_of(x))
        spmm.launches += 1
        _build.check(err, "spmm")
    return out


spmm.launches = 0  # kernel launches: one per column slice
