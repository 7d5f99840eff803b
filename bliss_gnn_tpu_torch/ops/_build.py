"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/bliss_gnn_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``. The library file name carries a hash of the source and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.

Pointers and the CUDA stream pass as ``c_void_p``; every C entry returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bliss_gnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of each source: name -> argtypes
SIGNATURES: Dict[str, Dict[str, list]] = {
    "scatter_add": {
        "bliss_scatter_add_f32": [_P, _P, _P, _LL, _P, _I, _P],
        "bliss_scatter_add_sorted_f32": [_P, _P, _P, _LL, _P, _I, _I, _P],
    },
    "lut_gather": {"bliss_lut_gather": [_P, _I, _P, _LL, _P, _P]},
    "segment_sum": {
        "bliss_segment_sum": [_P, _I, _P, _LL, _I, _P, _I, _P, _I, _P, _I,
                              _P],
        "bliss_segment_sum_sorted": [_P, _I, _P, _P, _LL, _I, _P, _I, _P, _P,
                                     _P, _LL, _I, _P],
        "bliss_segment_sum_cast": [_P, _I, _P, _I, _I, _I, _P],
        "bliss_segment_sum_fold": [_P, _P, _I, _LL, _I, _P, _P, _I, _P],
    },
    "exp3_apply": {"bliss_exp3_apply": [_P, _P, _P, _LL, _I, _P],
                   "bliss_exp3_apply_f32": [_P, _P, _P, _LL, _I, _P],
                   "bliss_exp3_apply_groups": [_P, _P, _P, _P, _LL, _I, _I,
                                               _P],
                   "bliss_exp3_apply_groups_f32": [_P, _P, _P, _P, _LL, _I,
                                                   _I, _P]},
    "row_scatter": {
        "bliss_row_scatter_tiles": [_P, _I, _P, _P, _LL, _I, _P, _I, _P, _I,
                                    _P, _P, _LL, _I, _P],
        "bliss_row_scatter_fold": [_P, _P, _LL, _I, _P, _P, _I, _I, _P],
        "bliss_row_scatter_count": [_P, _LL, _P, _I, _P, _P, _P],
        "bliss_row_scatter_place": [_P, _LL, _P, _I, _P, _P, _P, _P, _P],
        "bliss_row_scatter_order": [_P, _I, _P, _P, _P],
    },
    "spmm_csr": {
        "bliss_spmm_csr": [_P, _I, _I, _LL, _I, _I, _P, _P, _P, _I, _P, _P]
    },
    "gat_attention": {
        "bliss_gat_attention": [_P, _I, _I, _I, _I, _P, _F, _P, _P, _I, _I,
                                _I, _I, _LL, _P, _P, _P, _P, _P, _P, _P,
                                _P]
    },
    "marks": {"bliss_mark": [_P, _P, _I, _P]},
    "gat_edge": {
        "bliss_gat_edge_scores": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                  _LL, _P, _P, _F, _P, _P, _P, _P, _P, _P],
        "bliss_gat_edge_messages": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _LL,
                                    _P, _P, _P, _P],
        "bliss_gat_edge_msg_grad": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                    _P, _LL, _P, _P, _P, _P],
        "bliss_gat_edge_grad": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                _LL, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P],
    },
    "poisson_scale": {
        "bliss_poisson_scale": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                _I, _P]
    },
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent; raises on a failed build."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    nvcc = None
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card, looked up at
    every call (under CUDA-graph capture it is the capture stream)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
