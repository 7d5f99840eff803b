"""The port's on-disk readers against the JAX package's on the same files:
tiny datasets in the public formats (planetoid pickles with a shuffled
test.index and citeseer's gap, GraphSAINT npz for flickr and yelp, DGL's
Reddit npz, OGB csv.gz, OGB papers100M's binary npz), written by
``chip_smoke.py``'s fixture writers (gzip and numpy, no pandas), read by
both packages. Arrays and ``(n_classes, multilabel)`` must be equal
exactly; the papers100M features must stay memory-mapped through the
graph's canonicalisation; a loaded graph runs one port step."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bliss_gnn_tpu.graph import datasets as jdata

from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct

torch.set_num_threads(1)


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setattr(jdata, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(tdata, "DATA_ROOT", str(tmp_path))
    monkeypatch.delenv("BLISS_ALLOW_DOWNLOAD", raising=False)
    return tmp_path


def _assert_same_graph(gj, gt):
    assert (gj.n_nodes, gj.n_edges) == (gt.n_nodes, gt.n_edges)
    for a in ("csc_indptr", "csc_src", "csr_indptr", "csr_dst", "csr_eid"):
        np.testing.assert_array_equal(getattr(gj, a), getattr(gt, a), a)
    assert gj.ndata.keys() == gt.ndata.keys()
    for k in gj.ndata:
        want, got = np.asarray(gj.ndata[k]), np.asarray(gt.ndata[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, k)


@pytest.mark.parametrize("name", ["pubmed", "citeseer", "flickr", "yelp",
                                  "reddit", "ogbn-arxiv",
                                  "ogbn-papers100m"])
def test_reader_matches_reference(root, name):
    want = chip_smoke.write_ondisk_fixtures(str(root))[name]
    gj, cj, mj = jdata.load_dataset(name)
    gt, ct, mt = tdata.load_dataset(name)
    assert (ct, mt) == (cj, mj)
    _assert_same_graph(gj, gt)
    n, e, c, ml = want
    assert gt.n_nodes == n and mt == ml
    assert e is None or gt.n_edges == e
    assert c is None or ct == c


def test_planetoid_test_rows_follow_the_shuffled_index(root):
    n, c, test_idx, tx, ty = chip_smoke.write_planetoid(
        str(root / "citeseer"), "citeseer", gap=True)
    g, _, _ = tdata.load_dataset("citeseer")
    np.testing.assert_allclose(g.ndata["features"][test_idx], tx, rtol=1e-6)
    np.testing.assert_array_equal(g.ndata["labels"][test_idx],
                                  ty.argmax(axis=1))
    holes = sorted(set(range(test_idx.min(), test_idx.max() + 1))
                   - set(test_idx.tolist()))
    assert holes and not g.ndata["test_mask"][holes].any()
    assert not g.ndata["features"][holes].any()


def test_papers100m_features_stay_memory_mapped(root):
    chip_smoke.write_ogb_papers(str(root))
    g, n_classes, _ = tdata.load_dataset("ogbn-papers100M")
    raw = root / "ogbn_papers100M" / "raw"
    assert isinstance(g.ndata["features"], np.memmap)
    assert os.path.exists(raw / "data.npz.node_feat.npy")
    assert (g.ndata["labels"][5:] == -1).all() and n_classes == 4
    # canonicalisation and the device graph without features copy nothing
    # of the matrix
    c = tstruct.Graph.canonicalize(g)
    assert c.ndata["features"] is g.ndata["features"]
    dg = tstruct.DeviceGraph.from_graph(c, device="cpu",
                                        exclude=("features",))
    assert "features" not in dg.ndata and "labels" in dg.ndata
    g2, _, _ = tdata.load_dataset("ogbn-papers100M")  # reuses the sidecar
    assert isinstance(g2.ndata["features"], np.memmap)
    np.testing.assert_array_equal(np.asarray(g2.ndata["features"]),
                                  np.asarray(g.ndata["features"]))


def test_loaded_graph_runs_one_port_step(root):
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )
    from bliss_gnn_tpu_torch.train import steps

    chip_smoke.write_saint(str(root / "flickr"))
    g, n_classes, ml = tdata.load_dataset("flickr")
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(4, 3))
    plan = CapacityPlan.build(4, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind)
    model = build_model("sage", 5, 8, n_classes, 2, device="cpu")
    opt, sched = steps.make_optimizer(model.parameters(), 1e-2, 1)
    state = steps.TrainState(model, opt, sched,
                             init_exp3_weights(2, g.n_edges, device="cpu"),
                             torch.Generator().manual_seed(0))
    step = steps.make_train_step(dg, cfg, plan, ml, device="cpu")
    seeds = torch.arange(4, dtype=torch.int32)
    state, m = step(state, seeds, torch.ones(4, dtype=torch.bool))
    assert torch.isfinite(m["train_loss"]) and int(m["num_edges/0"]) > 0
