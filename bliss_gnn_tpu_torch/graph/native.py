"""ctypes bindings of the port's native graph core, ``native/graphcore.cpp``
(counterpart of ``bliss_gnn_tpu/graph/native.py``): the canonical CSC and
CSR builds and the per-dst normalised edge weights, the host preprocessing
that numpy does 10-30x slower on graphs of 10^8 edges.

At first use the source is compiled with ``g++ -O3 -shared -fPIC`` (``CXX``
names another compiler) into ``build/bliss_gnn_tpu_torch/`` at the root of
the checkout; the file name carries a hash of the source and flags, so an
edited source is rebuilt. A failed build raises. The reference instead
falls back to its numpy versions in silence; here those versions
(``graph/structure.py`` ``_build_csc``, ``_build_csr_from_csc``) are the
plain versions the tests hold the library against.

Left out for good: the ``banded_*`` entries, which build the TPU band
layout of the banded SpMM (the CUDA kernels read the CSC directly).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from bliss_gnn_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "graphcore.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_LL = ctypes.c_int64
SIGNATURES = {
    "build_csc": [_LL, _LL, _I64P, _I64P, _I64P, _I64P, _I64P],
    "build_csr_from_csc": [_LL, _LL, _I64P, _I64P, _I64P, _I64P, _I64P],
    "normalized_edata_c": [_LL, _LL, _I64P, _F32P, _F32P],
}


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgraphcore-{digest[:12]}.so"


def build() -> Path:
    """Compiles the library unless it exists; raises on a failed build."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler: install g++ or set CXX")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"graphcore build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    return lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _p(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def build_csc(src, dst, n_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, csc_src, perm): edges grouped by dst by a counting sort,
    stable within a dst; ``perm`` maps a CSC position to its input edge."""
    src, dst = _i64(src), _i64(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src and dst must be 1-D of one length")
    if len(dst) and (dst.min() < 0 or dst.max() >= n_nodes):
        raise ValueError("dst ids outside [0, n_nodes)")
    e = len(src)
    indptr = np.empty(n_nodes + 1, np.int64)
    csc_src = np.empty(e, np.int64)
    perm = np.empty(e, np.int64)
    load().build_csc(n_nodes, e, _p(src, _I64P), _p(dst, _I64P),
                     _p(indptr, _I64P), _p(csc_src, _I64P), _p(perm, _I64P))
    return indptr, csc_src, perm


def build_csr_from_csc(csc_indptr, csc_src, n_nodes: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, csr_dst, csr_eid): the CSC's edges grouped by src, in
    canonical order within a src, ``csr_eid`` their canonical ids."""
    csc_indptr, csc_src = _i64(csc_indptr), _i64(csc_src)
    e = len(csc_src)
    if len(csc_indptr) != n_nodes + 1 or csc_indptr[-1] != e:
        raise ValueError("csc_indptr does not describe csc_src")
    if e and (csc_src.min() < 0 or csc_src.max() >= n_nodes):
        raise ValueError("src ids outside [0, n_nodes)")
    indptr = np.empty(n_nodes + 1, np.int64)
    csr_dst = np.empty(e, np.int64)
    csr_eid = np.empty(e, np.int64)
    load().build_csr_from_csc(n_nodes, e, _p(csc_indptr, _I64P),
                              _p(csc_src, _I64P), _p(indptr, _I64P),
                              _p(csr_dst, _I64P), _p(csr_eid, _I64P))
    return indptr, csr_dst, csr_eid


def normalized_edata(csc_indptr, weights: Optional[np.ndarray],
                     n_edges: int) -> np.ndarray:
    """f32 [E]: w_e over the sum of w into dst(e) (1 / in-degree when
    ``weights`` is None), summed in double."""
    csc_indptr = _i64(csc_indptr)
    if csc_indptr[-1] != n_edges:
        raise ValueError("csc_indptr does not describe n_edges edges")
    w = None
    if weights is not None:
        w = np.ascontiguousarray(weights, dtype=np.float32)
        if w.shape != (n_edges,):
            raise ValueError("weights must be [n_edges]")
    out = np.empty(n_edges, np.float32)
    load().normalized_edata_c(len(csc_indptr) - 1, n_edges,
                              _p(csc_indptr, _I64P),
                              None if w is None else _p(w, _F32P),
                              _p(out, _F32P))
    return out
