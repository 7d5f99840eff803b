#!/usr/bin/env python3
"""Times the K2 (``lut_gather``) and K4 (``exp3_apply``) wrappers of the
``bliss_gnn_tpu_torch`` that Python finds on its path, so that two
checkouts of the port can be compared on one NVIDIA GPU, each in a process
of its own:

    PYTHONPATH=<checkout> python3 tools/time_k2_k4.py

The inputs are made on the card from a fixed seed, at the shapes of the
input-most layer of ``chip_smoke.py``'s SAGE main path on the
Reddit-shaped graph (its final plan on an H100):

    K2  the keep-mask lookup: 3,279,616 ids (80% valid) into a
        233,088-entry bool table;
    K4  one step's arm-weight update: 186,496 slots of distinct indices
        (30% no-op) into 3 x (114,848,857 + EDGE_PAD) bf16 weights.

For each wrapper and for one PyTorch call of the same function
(``torch.take``, ``scatter_reduce_``) it prints ``ms`` (CUDA events around
20 back-to-back calls), ``device_ms`` (20 calls captured in a CUDA graph,
replayed 10 times) and ``host_us`` (1,000 calls with no sync), with the
timing functions of ``chip_smoke.py``; and the host time of K4's C entry
called straight through ctypes with its arguments ready, the floor under
any wrapper that launches through ctypes. One JSON line.
"""
import importlib.util
import json
import pathlib
import sys

import torch

import bliss_gnn_tpu_torch
from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD
from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
from bliss_gnn_tpu_torch.ops.gather import lut_gather

M, N_CAND, N_NODES = 3_279_616, 233_088, 232_965
BLOCK_E_CAPS, N_EDGES = (150_016, 31_872, 4_608), 114_848_857


def smoke_timers():
    """``chip_smoke.py`` of the checkout this script lies in, imported as
    a module for its timing functions."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    if not torch.cuda.is_available():
        sys.exit("time_k2_k4: torch.cuda.is_available() is false")
    smoke = smoke_timers()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def times(fn):
        return {"ms": smoke.time_ms(fn, 20, torch),
                "device_ms": smoke.device_time_ms(fn, torch),
                "host_us": smoke.host_us(fn, torch)}

    nv = torch.tensor(int(0.8 * M), dtype=torch.int32, device=dev)
    keys = torch.randint(0, N_NODES, (M,), generator=g, device=dev,
                         dtype=torch.int32)
    lut = torch.rand(N_CAND, generator=g, device=dev) < 0.3
    keys64 = keys.long()

    span = N_EDGES + EDGE_PAD
    limit = len(BLOCK_E_CAPS) * span
    u = sum(BLOCK_E_CAPS)
    idx = torch.cat([
        torch.randperm(N_EDGES, generator=g, device=dev)[:c] + l * span
        for l, c in enumerate(BLOCK_E_CAPS)]).to(torch.int32)
    idx = torch.where(torch.rand(u, generator=g, device=dev) < 0.3,
                      torch.full_like(idx, limit), idx)
    mult = torch.exp(torch.rand(u, generator=g, device=dev) * 0.5)
    state = (torch.rand(limit, generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    valid = idx < limit
    idx_v, mult_v = idx[valid].long(), mult[valid].to(torch.bfloat16)
    c_entry = _build.load("exp3_apply").bliss_exp3_apply
    c_args = (state.data_ptr(), idx.data_ptr(), mult.data_ptr(), u, limit,
              torch.cuda.current_stream().cuda_stream)

    print(json.dumps({
        "package": bliss_gnn_tpu_torch.__file__,
        "lut_gather": times(lambda: lut_gather(lut, keys, nv)),
        "torch.take": times(lambda: torch.take(lut, keys64)),
        "exp3_apply": times(lambda: exp3_apply(state, idx, mult, limit)),
        "scatter_reduce_": times(
            lambda: state.scatter_reduce_(0, idx_v, mult_v, "prod")),
        "exp3_apply_c_entry_host_us": smoke.host_us(
            lambda: c_entry(*c_args), torch),
    }), flush=True)


if __name__ == "__main__":
    main()
