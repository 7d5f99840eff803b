"""The port's node reorderings (``graph/reorder.py``) and native graph core
(``graph/native.py``, its own copy of ``native/graphcore.cpp``) against the
JAX package and the numpy versions, on the same inputs.

Permutations, labels, coverage and every CSC/CSR array must be equal
exactly; the per-dst normalised weights too with unit weights (sums of
ones), and within rtol 1e-6 of numpy's f32 sums with random weights (the
core sums in double)."""
import numpy as np
import pytest
import torch

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import reorder as jreorder
from bliss_gnn_tpu.graph import structure as jstruct

from bliss_gnn_tpu_torch.graph import native
from bliss_gnn_tpu_torch.graph import reorder as treorder
from bliss_gnn_tpu_torch.graph import structure as tstruct

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sbm():
    """A community graph with latent ids (the family reordering is for)
    and a uniform-src one, as CSC arrays."""
    out = {}
    for name, g in (("sbm", jdata.sbm_graph(3000, 40000, 4, 5, seed=2)[0]),
                    ("synth", jdata.synthetic_graph(3000, 40000, 4, 5,
                                                    seed=2)[0])):
        out[name] = (np.asarray(g.csc_indptr), np.asarray(g.csc_src))
    return out


@pytest.mark.parametrize("graph", ["sbm", "synth"])
def test_propagate_labels_matches_reference(sbm, graph):
    indptr, src = sbm[graph]
    for iters in (1, 4):
        want = jreorder.propagate_labels(indptr, src, n_iters=iters)
        got = treorder.propagate_labels(indptr, src, n_iters=iters)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", ["degree", "cluster", "hub-cluster"])
@pytest.mark.parametrize("graph", ["sbm", "synth"])
def test_locality_perm_and_coverage_match_reference(sbm, graph, order):
    indptr, src = sbm[graph]
    want = jreorder.locality_perm(indptr, src, order=order, hub_count=64)
    got = treorder.locality_perm(indptr, src, order=order, hub_count=64)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(len(indptr) - 1))
    for t in (3, 20):
        cj, sj = jreorder.dense_coverage(indptr, src, want, dense_t=t,
                                         band=1024, wr=64, sub=64)
        ct, st = treorder.dense_coverage(indptr, src, got, dense_t=t,
                                         band=1024, wr=64, sub=64)
        assert ct == cj and st == sj


def test_best_perm_matches_reference(sbm):
    indptr, src = sbm["sbm"]
    pj, oj, cj = jreorder.best_perm(indptr, src, dense_t=600)
    pt, ot, ct = treorder.best_perm(indptr, src, dense_t=600)
    np.testing.assert_array_equal(pt, pj)
    assert (ot, ct) == (oj, cj)
    # the planted communities lift coverage over the degree sort
    assert ct["cluster"] > ct["degree"]
    with pytest.raises(ValueError):
        treorder.locality_perm(indptr, src, order="nope")


@pytest.mark.parametrize("n,e", [(1, 0), (7, 40), (500, 6000)])
def test_native_csc_and_csr_equal_numpy(n, e):
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    got = native.build_csc(src, dst, n)
    want = tstruct._build_csc(src, dst, n)
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    got = native.build_csr_from_csc(want[0], want[1], n)
    want = tstruct._build_csr_from_csc(want[0], want[1], n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_native_rejects_ids_out_of_range():
    with pytest.raises(ValueError):
        native.build_csc([0, 1], [0, 5], 3)
    with pytest.raises(ValueError):
        native.build_csr_from_csc([0, 1, 2], [0, 9], 2)


def test_graph_and_weights_equal_numpy_and_reference():
    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(400, 3000, 4, 3, seed=5)[0])
    rng = np.random.default_rng(6)
    src, dst = gj.edges()
    w = rng.random(len(src)).astype(np.float32)
    gj = jstruct.Graph(src, dst, gj.n_nodes, edata={"weight": w})
    gt = tstruct.Graph(src, dst, gj.n_nodes, edata={"weight": w})
    for a in ("csc_indptr", "csc_src", "csr_indptr", "csr_dst", "csr_eid",
              "input_to_canonical_eid"):
        np.testing.assert_array_equal(getattr(gt, a), getattr(gj, a), a)
    np.testing.assert_array_equal(gt.edata["weight"], gj.edata["weight"])
    deg = np.diff(gt.csc_indptr)
    edst = np.repeat(np.arange(gt.n_nodes), deg)
    unit = tstruct.normalized_edata(gt)
    np.testing.assert_array_equal(unit, jstruct.normalized_edata(gj))
    np.testing.assert_array_equal(
        unit, (1.0 / np.maximum(deg, 1)[edst]).astype(np.float32))
    got = tstruct.normalized_edata(gt, weight="weight")
    np.testing.assert_array_equal(
        got, jstruct.normalized_edata(gj, weight="weight"))
    sums = np.zeros(gt.n_nodes, np.float32)
    np.add.at(sums, edst, gt.edata["weight"])
    np.testing.assert_allclose(got, gt.edata["weight"] / sums[edst],
                               rtol=1e-6)
    # 1 / sum(W): the numpy path, as in the reference
    np.testing.assert_array_equal(
        tstruct.normalized_edata(gt, weight="weight", multiply_weight=False),
        jstruct.normalized_edata(gj, weight="weight", multiply_weight=False))


def test_native_library_is_rebuilt_for_an_edited_source(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "graphcore.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    before = native.library_path()
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.library_path() != before
    out = native.build()
    assert out.exists() and out.parent == tmp_path / "build"
    src.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="graphcore build failed"):
        native.build()
