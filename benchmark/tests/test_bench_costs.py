"""The FLOP and byte counts against numbers worked by hand."""
import os

import pytest

from bmk.spec import load_module

costs = load_module(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics", "costs.py"), "costs_under_test")

N, E = 232_965, 114_848_857  # the Reddit-shaped graph, self-loops in


def test_k7_ops_and_bound_at_reddit():
    # 114,848,857 x 4 x (7 * 256 + 2) = 824,155,397,832 operations; at 67
    # TFLOP/s 12.30 ms, over the 1.89 GB of bytes' 0.56 ms (PERF.md's K7 row)
    assert costs.k7_ops(E, 4, 256) == 824_155_397_832
    assert costs.k7_bound_s(N, E, 4, 256, 2) == pytest.approx(
        824_155_397_832 / 67e12)
    assert costs.k7_bound_s(N, E, 4, 256, 2) * 1e3 == pytest.approx(12.30,
                                                                    abs=0.01)
    # (1, 41): 114,848,857 x 289 = 33,191,319,673 ops, 0.495 ms
    assert costs.k7_bound_s(N, E, 1, 41, 2) * 1e3 == pytest.approx(0.495,
                                                                   abs=0.001)
    nbytes = N * 4 * 256 * 2 + (N + 1) * 4 + E * 4 + N * 4 * 256 * 4
    assert costs.k7_bytes(N, E, 4, 256, 2) == nbytes


def test_sage_flops_by_hand():
    # 602 -> 256 projects first: 2*300*602*256 (neigh, on 300 srcs)
    # + 2*100*602*256 (self) + 2*5000*256 (aggregate 256-wide)
    f = costs.sage_layer_flops(300, 100, 5000, 602, 256)
    assert f == 92_467_200 + 30_822_400 + 2_560_000
    # 256 -> 256 aggregates first: neigh and self both on the 100 dsts
    assert costs.sage_layer_flops(300, 100, 5000, 256, 256) == (
        2 * 2 * 100 * 256 * 256 + 2 * 5000 * 256)
    dims = [602, 256, 256, 41]
    counts = [300, 100, 50, 10, 5000, 900, 120]
    fwd = (costs.sage_layer_flops(300, 100, 5000, 602, 256)
           + costs.sage_layer_flops(100, 50, 900, 256, 256)
           + costs.sage_layer_flops(50, 10, 120, 256, 41))
    assert costs.sage_step_flops(dims, counts) == 3 * fwd


def test_gat_pass_flops_at_reddit():
    cfg = {"model": {"layers": 3, "hidden": 256, "heads": [4, 4, 1]},
           "graph": {"n_feats": 602, "n_classes": 41}}
    dense = 2 * N * (602 * 1024 + 1024 * 1024 + 1024 * 41)
    attn = E * 4 * 1794 * 2 + E * 289
    assert costs.gat_pass_flops(cfg, N, E) == dense + attn
    assert costs.gat_pass_flops(cfg, N, E) == pytest.approx(2.475e12,
                                                            rel=1e-3)
    assert costs.gat_pass_k7_bound_s(cfg, N, E) * 1e3 == pytest.approx(
        2 * 12.30 + 0.495, abs=0.02)
