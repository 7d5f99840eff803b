"""The port's seed-batch data parallelism (``parallel/dp.py``) and its
edge-partitioned aggregation (``parallel/edgeshard.py``) on gloo ranks: the
mirror of ``test_parallel.py``.

The ranks are spawned processes joined through a ``FileStore`` under
pytest's temporary directory, each importing the port only (this module
imports the JAX package inside its tests). Every rank-side scenario of the
module runs in one launch of 4 ranks (and one of a single rank), and the
tests read its results. The aggregations are held against the port's
single-device ops at rtol 1e-4 (as the JAX tests) and against the JAX
package's edge-sharded functions on its 8-device mesh at
``test_torch_inference.py``'s 5e-3."""
import types

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.ops.fullgraph import full_spmm_mean
from bliss_gnn_tpu_torch.parallel import dp as tdp
from bliss_gnn_tpu_torch.parallel import edgeshard as tes
from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import metrics as tmetrics
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

N_RANKS, LOCAL_BATCH = 4, 4


def _setup(kind="poisson-bandit"):
    g, nc, ml = tdata.synthetic_graph(300, 2400, 16, 4, seed=5)
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    cfg = tsamp.SamplerConfig(kind=kind, fanouts=(16, 8), eta=0.1)
    plan = tblock.CapacityPlan.build(LOCAL_BATCH, cfg.fanouts, g.n_nodes,
                                     g.n_edges, kind=kind)
    return g, dg, cfg, plan, nc, ml


def _state(mesh, nc, n_edges, seed=1):
    model = tgnn.build_model("sage", 16, 16, nc, 2, device="cpu", seed=seed)
    opt, sched = tsteps.make_optimizer(model.parameters(), 0.01, 10,
                                       gamma=0.5, step_size=100)
    return tsteps.TrainState(model, opt, sched,
                             tsamp.init_exp3_weights(2, n_edges,
                                                     device="cpu"),
                             mesh.generator(2))


def _graph(n, e, f, seed):
    g, _, _ = tdata.synthetic_graph(n, e, f, 4, seed=seed)
    return tstruct.Graph.canonicalize(g)


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _ranks_worker():
    """Every 4-rank scenario of the module, in one launch."""
    mesh = make_mesh(None, device="cpu")
    out = {}
    # one DP step, normalised arm weights
    g, dg, cfg, plan, nc, ml = _setup()
    B = LOCAL_BATCH * mesh.size
    st = _state(mesh, nc, g.n_edges)
    step = tdp.make_dp_train_step(mesh, dg, cfg, plan, ml)
    st, m = step(st, torch.arange(B, dtype=torch.int32),
                 torch.ones(B, dtype=torch.bool))
    out["replicates"] = dict(
        step=st.step, loss=float(m["train_loss"]),
        n_dst=int(m["num_nodes/2"]), params=_params(st),
        sums=st.exp3_weights.float().sum(dim=1).numpy())
    # 40 DP steps on random training batches
    st = _state(mesh, nc, g.n_edges)
    step = tdp.make_dp_train_step(mesh, dg, cfg, plan, ml)
    train_ids = np.where(g.ndata["train_mask"])[0]
    rng = np.random.default_rng(0)
    accs = []
    for _ in range(40):
        seeds = torch.from_numpy(rng.choice(train_ids, B, replace=False)
                                 .astype(np.int32))
        st, m = step(st, seeds, torch.ones(B, dtype=torch.bool))
        accs.append(float(tmetrics.f1_compute(m["f1"], ml)))
    out["learns"] = accs
    # the edge-sharded and ring aggregations
    g2 = _graph(300, 2500, 12, 9)
    dg2 = tstruct.DeviceGraph.from_graph(g2, device="cpu")
    x = dg2.ndata["features"].float()
    out["edge_sharded"] = tes.sharded_mean_aggregate(
        mesh, tes.EdgeShards.build(g2, mesh), x, dg2.in_degrees(),
        g2.n_nodes)
    g3 = _graph(290, 2300, 12, 11)
    dg3 = tstruct.DeviceGraph.from_graph(g3, device="cpu")
    x = dg3.ndata["features"].float()
    out["ring"] = tes.ring_mean_aggregate(
        mesh, tes.RingEdgeShards.build(g3, mesh), x, dg3.in_degrees(),
        g3.n_nodes)
    g4 = _graph(120, 900, 8, 13)
    w = np.random.default_rng(3).random(g4.n_edges).astype(np.float32)
    shards = tes.RingEdgeShards.build(g4, mesh, edge_vals=w)
    xs = torch.from_numpy(shards.shard_rows(
        np.asarray(g4.ndata["features"], np.float32)))
    out["ring_weighted"] = shards.unshard_rows(
        mesh, tes.make_ring_spmm(mesh, shards)(xs))[:g4.n_nodes]
    return out


def _one_rank_worker():
    """A world of one: the DP step against the fused step, bit for bit."""
    mesh = make_mesh(None, device="cpu")
    g, dg, cfg, plan, nc, ml = _setup()
    a, b = _state(mesh, nc, g.n_edges), _state(mesh, nc, g.n_edges)
    seeds = torch.arange(LOCAL_BATCH, dtype=torch.int32)
    smask = torch.ones(LOCAL_BATCH, dtype=torch.bool)
    dp_step = tdp.make_dp_train_step(mesh, dg, cfg, plan, ml)
    fused = tsteps.make_train_step(dg, cfg, plan, ml, device="cpu")
    b, m_dp = dp_step(b, seeds, smask)
    a, m_f = fused(a, seeds, smask)
    tsamp.normalize_exp3_weights(a.exp3_weights)
    return dict(exp3_dp=b.exp3_weights, exp3_f=a.exp3_weights,
                params_dp=_params(b), params_f=_params(a),
                m_dp={k: v for k, v in m_dp.items() if k != "f1"},
                m_f={k: v for k, v in m_f.items() if k != "f1"})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return multihost.run_ranks(_ranks_worker, N_RANKS, device="cpu",
                               workdir=str(tmp_path_factory.mktemp("dp4")))


def test_dp_step_runs_and_replicates(ranks):
    for o in ranks:
        r = o["replicates"]
        assert r["step"] == 1
        assert np.isfinite(r["loss"])
        # the rows stay L1-normalised after the combined update
        np.testing.assert_allclose(r["sums"], 1.0, rtol=0.02)
        # the summed dst count of the top layer is the global batch
        assert r["n_dst"] == LOCAL_BATCH * N_RANKS
        assert r["loss"] == ranks[0]["replicates"]["loss"]
        for k, v in r["params"].items():
            assert torch.equal(v, ranks[0]["replicates"]["params"][k]), k


def test_dp_training_learns(ranks):
    accs = ranks[0]["learns"]
    assert accs[-1] > max(0.5, accs[0] + 0.15), (accs[0], accs[-1])
    assert all(o["learns"] == accs for o in ranks)


def test_dp_matches_single_device_exp3_semantics(tmp_path):
    """At one rank the DP step (which normalises its arm weights) is the
    fused step followed by the normalisation, bit for bit."""
    o, = multihost.run_ranks(_one_rank_worker, 1, device="cpu",
                             workdir=str(tmp_path))
    assert torch.equal(o["exp3_dp"], o["exp3_f"])
    w2 = o["exp3_dp"].float()
    np.testing.assert_allclose(w2.sum(dim=1).numpy(), 1.0, rtol=0.02)
    assert int((w2[0] != w2[0][0]).sum()) > 0
    for k, v in o["params_dp"].items():
        assert torch.equal(v, o["params_f"][k]), k
    for k, v in o["m_f"].items():
        assert torch.equal(torch.as_tensor(o["m_dp"][k]),
                           torch.as_tensor(v)), k


def test_edge_sharded_spmm_matches_dense(ranks):
    """Edge-partitioned aggregation (K6's plain version on each rank's
    slice, then one all-gather) against the single-device chunked SpMM
    and the JAX package's edge-sharded aggregation on 8 devices."""
    import jax.numpy as jnp

    from bliss_gnn_tpu.graph.datasets import synthetic_graph
    from bliss_gnn_tpu.graph.structure import Graph
    from bliss_gnn_tpu.parallel.edgeshard import (
        EdgeShards,
        sharded_mean_aggregate,
    )
    from bliss_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh

    g = _graph(300, 2500, 12, 9)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    x = dg.ndata["features"].float()
    ref = full_spmm_mean(x, dg.csc_indptr, dg.csc_src, g.n_nodes, g.n_edges)
    gj = Graph.canonicalize(synthetic_graph(300, 2500, 12, 4, seed=9)[0])
    dj = gj.to_device()
    want = sharded_mean_aggregate(
        jmake_mesh(8), EdgeShards.build(gj, 8),
        dj.ndata["features"].astype(jnp.float32), dj.in_degrees(),
        gj.n_nodes)
    for o in ranks:
        np.testing.assert_allclose(o["edge_sharded"].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["edge_sharded"].numpy(),
                                   np.asarray(want), rtol=5e-3, atol=5e-3)


def test_ring_spmm_matches_dense(ranks):
    """The node-sharded ring SpMM (S - 1 rotations, K6's plain version per
    bucket) with N % S != 0, against the single-device SpMM and the JAX
    ring on 8 devices."""
    import jax.numpy as jnp

    from bliss_gnn_tpu.graph.datasets import synthetic_graph
    from bliss_gnn_tpu.graph.structure import Graph
    from bliss_gnn_tpu.parallel.edgeshard import (
        RingEdgeShards,
        ring_mean_aggregate,
    )
    from bliss_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh

    g = _graph(290, 2300, 12, 11)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    x = dg.ndata["features"].float()
    ref = full_spmm_mean(x, dg.csc_indptr, dg.csc_src, g.n_nodes, g.n_edges)
    gj = Graph.canonicalize(synthetic_graph(290, 2300, 12, 4, seed=11)[0])
    dj = gj.to_device()
    want = ring_mean_aggregate(
        jmake_mesh(8), RingEdgeShards.build(gj, 8),
        dj.ndata["features"].astype(jnp.float32), dj.in_degrees(),
        gj.n_nodes)
    for o in ranks:
        np.testing.assert_allclose(o["ring"].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["ring"].numpy(), np.asarray(want),
                                   rtol=5e-3, atol=5e-3)


def test_ring_spmm_weighted_matches_segment_sum(ranks):
    g = _graph(120, 900, 8, 13)
    w = np.random.default_rng(3).random(g.n_edges).astype(np.float32)
    x = np.asarray(g.ndata["features"], np.float32)
    src, dst = g.edges()
    ref = np.zeros((g.n_nodes, x.shape[1]), np.float32)
    np.add.at(ref, dst, x[src] * w[:, None])
    for o in ranks:
        np.testing.assert_allclose(o["ring_weighted"].numpy(), ref,
                                   rtol=1e-4, atol=1e-4)


def test_balanced_shard_cuts_bound_edge_skew():
    """Equal-edge cuts bound the per-shard edge skew on a power-law graph
    and the mixed cut bounds both edges and nodes; the port's cuts are the
    JAX package's, and a rank's buckets hold its edges, each once."""
    from bliss_gnn_tpu.parallel import edgeshard as jes

    rng = np.random.default_rng(2)
    n, S = 20_000, 8
    deg = np.minimum(rng.zipf(1.6, n), 2_000)
    dst = np.repeat(rng.permutation(n), deg)
    src = rng.integers(0, n, len(dst))
    g = tstruct.Graph.canonicalize(tstruct.Graph(src, dst, n, ndata={
        "features": np.zeros((n, 2), np.float32),
        "labels": np.zeros(n, np.int64),
        "train_mask": np.ones(n, bool),
        "val_mask": np.zeros(n, bool),
        "test_mask": np.zeros(n, bool),
    }))
    ip = np.asarray(g.csc_indptr)
    for balance in ("edges", "mixed", "nodes"):
        assert tes.balanced_node_ranges(ip, S, balance) == \
            jes.balanced_node_ranges(ip, S, balance)

    def edge_counts(lo):
        return np.diff(ip[np.asarray(lo)])

    e_edge = edge_counts(tes.balanced_node_ranges(ip, S, "edges"))
    e_mixed = edge_counts(tes.balanced_node_ranges(ip, S, "mixed"))
    e_node = edge_counts(tes.balanced_node_ranges(ip, S, "nodes"))
    assert e_edge.sum() == e_mixed.sum() == e_node.sum() == g.n_edges
    assert e_edge.max() / e_edge.mean() <= 1.2
    assert e_mixed.max() / e_mixed.mean() <= 2.05
    n_mixed = np.diff(tes.balanced_node_ranges(ip, S, "mixed"))
    assert n_mixed.max() / n_mixed.mean() <= 2.05
    assert e_mixed.max() < e_node.max()
    total = 0
    for r in range(S):
        mesh = types.SimpleNamespace(size=S, rank=r,
                                     device=torch.device("cpu"))
        shards = tes.RingEdgeShards.build(g, mesh)
        assert shards.lo == tes.balanced_node_ranges(ip, S, "mixed")
        sizes = [int(s.numel()) for s in shards.src_rel]
        assert sizes == [int(p[-1]) for p in shards.indptr]
        assert sum(sizes) == e_mixed[r]
        total += sum(sizes)
    assert total == g.n_edges
