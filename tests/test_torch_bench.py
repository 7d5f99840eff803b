"""``bench_torch.py``, the port's benchmark, against the JAX package's
``bench.py`` on the CPU:

- its Reddit-shaped graph bit-equal (indptr and srcs) to
  ``bench.build_graph()`` at a small scale, and read back from its cache;
  a cached graph is not read back once its generator's source changes;
- the headline SpMM's inputs through the port's plain path against JAX
  ``full_spmm_sum`` on the same x and weights (f32, rtol 1e-4, atol 1e-4 x
  max|y|);
- each section's keys equal to the keys ``bench.py``'s matching function
  returns (read from its source), the switches by the same names;
- with ``--platform cpu`` and every switch off but the steps, one line on
  stdout whose keys are ``bench.py``'s for those switches plus
  ``step_eager_ms``, every value finite;
- the time-to-F1 keys null when the target is not reached;
- ``spmm_sol_frac``: K6's bound (3.35 TB/s, 67 TFLOP/s) over its time.

``bench.py`` is loaded by file path with its scale set first (it reads its
sizes at import), its cache pointed at the test's directory.
"""
import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

import bench_torch
from bliss_gnn_tpu.ops.fullgraph import full_spmm_sum as jax_full_spmm_sum
from bliss_gnn_tpu_torch.ops.spmm import spmm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
SCALE = "0.001"  # bench.py's sizes: 232 nodes, 114,848 edges
STEP_SCALE = "0.00005"  # the step run's: 11 nodes, 5,742 edges


def load_bench(monkeypatch, tmp_path):
    """``bench.py`` as a fresh module at SCALE, its cache under
    ``tmp_path``."""
    monkeypatch.setenv("BLISS_BENCH_SCALE", SCALE)
    spec = importlib.util.spec_from_file_location("bench_reference", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CACHE = str(tmp_path / "jax")
    return mod


def bench_functions():
    tree = ast.parse(open(BENCH_PY).read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def returned_keys(fns, name, follow=True):
    """The string keys a ``bench.py`` function puts in what it returns: the
    dict literals it assigns to a name or returns, the keys it stores into
    such a name, a returned comprehension's keys, and with ``follow`` the
    keys of the module functions whose results it ``update``s in."""
    fn = fns[name]
    names = {t.id for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict) for t in n.targets
             if isinstance(t, ast.Name)}
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, (ast.Assign, ast.Return)) and isinstance(
                n.value, ast.Dict) and (isinstance(n, ast.Return) or any(
                    isinstance(t, ast.Name) for t in n.targets)):
            keys |= {k.value for k in n.value.keys}
        elif isinstance(n, ast.Return) and isinstance(n.value, ast.DictComp):
            keys |= {e.value for g in n.value.generators for e in g.iter.elts}
        elif (isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
              and isinstance(n.value, ast.Name) and n.value.id in names):
            keys.add(n.slice.value)
        elif (follow and isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)
              and n.func.attr == "update"
              and isinstance(n.func.value, ast.Name)
              and n.func.value.id in names
              and isinstance(n.args[0], ast.Call)
              and getattr(n.args[0].func, "id", None) in fns):
            keys |= returned_keys(fns, n.args[0].func.id)
    return keys


def test_graph_bit_equal_to_bench_build_graph(monkeypatch, tmp_path):
    bench = load_bench(monkeypatch, tmp_path)
    want_ip, want_src = bench.build_graph()
    cache = str(tmp_path / "torch")
    for _ in range(2):  # generated, then read back from the cache
        ip, src = bench_torch.build_graph(bench.N_NODES, bench.N_EDGES,
                                          cache=cache)
        assert (len(ip) - 1, len(src)) == (232, 114_848)
        assert ip.dtype == np.int64 and src.dtype == np.int32
        assert np.array_equal(ip, want_ip)
        assert np.array_equal(src, want_src)
    tag = bench_torch.source_tag(bench_torch.reddit_shaped_csc)
    assert os.listdir(cache) == [f"reddit_synth_{tag}_232_114848.npz"]


def test_graph_cache_is_not_read_back_after_its_generator_changes(
        monkeypatch, tmp_path):
    cache = str(tmp_path)
    ip, src = bench_torch.build_graph(232, 114_848, cache=cache)
    made = []

    def changed_generator(n_nodes, n_rand_edges):
        made.append((n_nodes, n_rand_edges))
        return ip, src[::-1].copy()

    monkeypatch.setattr(bench_torch, "reddit_shaped_csc", changed_generator)
    _, got = bench_torch.build_graph(232, 114_848, cache=cache)
    assert made == [(232, 114_848 - 232)]
    assert np.array_equal(got, src[::-1])
    assert len(os.listdir(cache)) == 2


def test_headline_spmm_plain_path_matches_jax(monkeypatch, tmp_path):
    bench = load_bench(monkeypatch, tmp_path)
    indptr, src = bench_torch.build_graph(bench.N_NODES, bench.N_EDGES,
                                          cache=str(tmp_path / "torch"))
    n, e = len(indptr) - 1, len(src)
    w, x = bench_torch.headline_inputs(n, e)
    assert x.shape == (n, 602) and x.dtype == w.dtype == np.float32
    got = spmm(torch.from_numpy(x), torch.from_numpy(indptr.astype(np.int32)),
               torch.from_numpy(src), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_full_spmm_sum(x, indptr.astype(np.int32),
                                        src, n, e, edge_vals=w))
    assert got.dtype == np.float32 and got.shape == want.shape == (n, 602)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_section_keys_are_bench_py_keys():
    fns = bench_functions()
    keys = bench_torch.KEYS
    assert set(keys["headline"]) == returned_keys(fns, "main", follow=False)
    assert set(keys["sbm"]) == returned_keys(fns, "_bench_sbm_spmm")
    assert set(keys["scaling"]) == returned_keys(fns, "_bench_dp_scaling")
    assert set(keys["gat"]) == returned_keys(fns, "_bench_gat")
    assert set(keys["step"]) - {"step_eager_ms"} == returned_keys(
        fns, "_bench_step")
    assert set(keys["ttf1"]) | set(keys["ablation"]) == returned_keys(
        fns, "_bench_time_to_val_f1")
    switch_vars = {n.args[0].value for n in ast.walk(fns["main"])
                   if isinstance(n, ast.Call) and getattr(
                       n.func, "attr", None) == "get" and n.args
                   and isinstance(n.args[0], ast.Constant)}
    assert switch_vars == {f"BLISS_BENCH_{v}" for v in (
        "SBM", "SCALING", "GAT", "STEP", "TTF1", "ABLATION")}


@pytest.mark.parametrize("scale,env,on", [
    (1.0, {}, {"sbm", "scaling", "gat", "step", "ttf1", "ablation"}),
    (0.1, {}, {"gat", "step", "ttf1", "ablation"}),
    (0.1, {"BLISS_BENCH_SBM": "1", "BLISS_BENCH_TTF1": "0"},
     {"sbm", "gat", "step"}),
    (1.0, {"BLISS_BENCH_ABLATION": "0", "BLISS_BENCH_GAT": "0"},
     {"sbm", "scaling", "step", "ttf1"}),
])
def test_switches_and_defaults_are_bench_py_s(scale, env, on):
    got = bench_torch.switches(env, scale)
    assert {k for k, v in got.items() if v} == on | {"headline"}


def test_step_only_line_has_bench_py_keys(monkeypatch, tmp_path, capfd):
    for var in ("SBM", "SCALING", "GAT", "TTF1"):
        monkeypatch.setenv(f"BLISS_BENCH_{var}", "0")
    monkeypatch.setenv("BLISS_BENCH_STEP", "1")
    monkeypatch.setenv("BLISS_BENCH_SCALE", STEP_SCALE)
    monkeypatch.setattr(bench_torch, "CACHE", str(tmp_path))
    bench_torch.main(["--platform", "cpu"])
    out, err = capfd.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out  # the mesh's and the notes' lines: stderr
    line = json.loads(lines[0])
    fns = bench_functions()
    want = (returned_keys(fns, "main", follow=False)
            | returned_keys(fns, "_bench_step") | {"step_eager_ms"})
    assert set(line) == want
    assert line["metric"] == "spmm_agg_edges_per_s_reddit"
    nums = {k: v for k, v in line.items() if not isinstance(v, str)}
    assert all(math.isfinite(v) and v > 0 for v in nums.values()), nums
    assert line["gat_sampling_ms"] == line["sampling_ms"]
    assert 0 < line["spmm_sol_frac"] <= 1
    notes = {l.split(" ", 2)[1]: json.loads(l.split(" ", 2)[2])
             for l in err.splitlines() if l.startswith("bench_torch: ")}
    assert {"refit", "sampling", "overflow", "dp_collectives",
            "launches"} <= set(notes)
    assert set(notes["launches"]) == {"headline", "hidden", "step"}
    assert notes["dp_collectives"]["ranks"] == 8


@pytest.mark.parametrize("reached", [False, True])
def test_ttvf1_null_rule(reached):
    res = {"steps": 200, "reached": reached, "train_seconds": 1.5,
           "final_val_f1": 0.897}
    live = bench_torch.ttvf1_record(res, freeze=False)
    assert set(live) == set(bench_torch.KEYS["ttf1"])
    assert live["time_to_val_f1_90_s"] == (1.5 if reached else None)
    assert live["ttvf1_steps"] == (200 if reached else None)
    assert live["ttvf1_final_val_f1"] == 0.897
    frozen = bench_torch.ttvf1_record(res, freeze=True)
    assert frozen == {"ttvf1_frozen_bandit_steps": 200,
                      "ttvf1_frozen_reached": reached,
                      "ttvf1_frozen_final_val_f1": 0.897}
    assert json.loads(json.dumps(live))["ttvf1_steps"] == (
        200 if reached else None)


def test_spmm_sol_frac_bound_uses_the_h100_rates():
    assert bench_torch.HBM_BYTES_PER_S == 3.35e12
    assert bench_torch.F32_FLOPS == 67e12
    # Reddit's shape at F = 602 f32, weighted: operations bind
    n, e, f = 232_965, 114_848_857, 602
    nbytes = n * f * 4 + (n + 1) * 4 + e * 4 + e * 4 + n * f * 4
    assert bench_torch.spmm_cost(n, e, f, 4, True) == (nbytes, 2 * e * f)
    ms, by = bench_torch.roofline_ms(nbytes, 2 * e * f)
    assert by == "operations" and ms == pytest.approx(2 * e * f / 67e12 * 1e3)
    assert bench_torch.spmm_bound_ms(n, e, f, 4, True) == ms
    # a sparse shape at F = 4 bf16: bytes bind, at 3.35 TB/s
    nbytes = n * 4 * 2 + (n + 1) * 4 + 1000 * 4 + n * 4 * 4
    assert bench_torch.spmm_bound_ms(n, 1000, 4, 2, False) == pytest.approx(
        nbytes / 3.35e12 * 1e3)
