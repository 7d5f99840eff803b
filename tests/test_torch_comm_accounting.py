"""The communication contract of the port's DP step: the mirror of
``test_comm_accounting.py``.

The JAX package reads its DP step's collectives out of the lowered HLO;
the port records them as they are issued (``parallel/commstats.py``: every
collective of ``parallel/mesh.py`` reports its kind, shape, dtype and
bytes). The questions are the JAX test's: the gradient all-reduce and the
EXP3 all-gather are there; the EXP3 sync is the sparse delta lists, not an
O(E) arm-weight sync; the all-reduce budget is the parameters plus the
metrics; the scaling arithmetic holds. One eager DP step runs on two gloo
ranks (spawned, joined through a ``FileStore``, the port only) on a graph
where a dense sync would dwarf the sparse lists."""
import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.parallel import commstats
from bliss_gnn_tpu_torch.parallel import dp as tdp
from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.parallel import shardedstep as tss
from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

N_RANKS = 2
LOCAL_BATCH = 4
N_EDGES = 200_000


def _worker():
    mesh = make_mesh(None, device="cpu")
    g, nc, ml = tdata.synthetic_graph(20_000, N_EDGES, 16, 4, seed=5)
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=(16, 8),
                              eta=0.1)
    plan = tblock.CapacityPlan.build(LOCAL_BATCH, cfg.fanouts, g.n_nodes,
                                     g.n_edges, kind=cfg.kind)
    model = tgnn.build_model("sage", 16, 16, nc, 2, device="cpu")
    opt, sched = tsteps.make_optimizer(model.parameters(), 0.01, 10)
    state = tsteps.TrainState(model, opt, sched,
                              tsamp.init_exp3_weights(2, g.n_edges,
                                                      device="cpu"),
                              mesh.generator(2))
    step = tdp.make_dp_train_step(mesh, dg, cfg, plan, ml)
    B = LOCAL_BATCH * mesh.size
    seeds = torch.arange(B, dtype=torch.int32)
    with commstats.recording() as rec:
        step(state, seeds, torch.ones(B, dtype=torch.bool))
    # the sharded step's row gathers, for the record
    sg = tss.ShardedDeviceGraph.build(g, mesh)
    state.exp3_weights = tss.init_exp3_shard(2, g.n_edges, mesh)
    sh_step = tss.make_sharded_train_step(mesh, sg, cfg, plan, ml)
    with commstats.recording() as rec_sh:
        sh_step(state, seeds, torch.ones(B, dtype=torch.bool))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    return dict(entries=rec.entries, sharded=rec_sh.entries,
                caps=plan.block_e_caps, param_bytes=param_bytes,
                n_edges=g.n_edges)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    return multihost.run_ranks(
        _worker, N_RANKS, device="cpu",
        workdir=str(tmp_path_factory.mktemp("comm")))[0]


def test_collectives_extracted(recorded):
    kinds = {c.kind for c in recorded["entries"]}
    assert "all_reduce" in kinds, "gradient all-reduce missing"
    assert "all_gather" in kinds, "EXP3 sparse-delta all-gather missing"
    sh = commstats.comm_summary(recorded["sharded"], N_RANKS)
    # the sharded step adds the distributed row gathers
    assert sh["per_kind"]["reduce_scatter"]["count"] > 0


def test_exp3_sync_is_sparse_not_dense(recorded):
    entries = recorded["entries"]
    dense_bytes = 2 * recorded["n_edges"] * 2  # L = 2 layers x E x bf16
    largest = max(c.out_bytes for c in entries)
    assert largest < dense_bytes / 2, (largest, dense_bytes)
    # per layer, eid (int32) + exponent (f32), [S, block_e_cap] gathered
    expected = sum(N_RANKS * cap * (4 + 4) for cap in recorded["caps"])
    got = sum(c.out_bytes for c in entries if c.kind == "all_gather")
    assert got <= expected * 1.25 + 4096, (got, expected)
    assert got == expected  # one packed all-gather, nothing else


def test_allreduce_budget_is_params_plus_metrics(recorded):
    ar = sum(c.out_bytes for c in recorded["entries"]
             if c.kind == "all_reduce")
    assert ar < 4 * recorded["param_bytes"] + (1 << 20), (
        ar, recorded["param_bytes"])
    assert ar >= recorded["param_bytes"]  # the gradients are in it


def test_predicted_scaling_model_arithmetic():
    """The port's model is the JAX package's: equal on equal inputs; at
    the H100's NVLink rate a dense sync would still cost scaling."""
    from bliss_gnn_tpu.parallel import commstats as jcs

    for t, b in ((36.6e-3, 10e6), (36.6e-3, 2 * 690e6 * 7 / 8)):
        assert commstats.predicted_scaling_pct(t, b, jcs.ICI_BYTES_PER_S) \
            == pytest.approx(jcs.predicted_scaling_pct(t, b))
    assert 99.0 < commstats.predicted_scaling_pct(36.6e-3, 10e6) < 100.0
    assert commstats.predicted_scaling_pct(36.6e-3, 2 * 690e6 * 7 / 8) < 95.0


def test_summary_matches_jax_accounting(recorded):
    """``comm_summary`` and the per-rank byte model give the JAX package's
    numbers on the same entries (the JAX test holds its two HLO parsers
    against each other; the port has one recorder)."""
    from bliss_gnn_tpu.parallel import commstats as jcs

    entries = recorded["entries"]
    as_jax = [jcs.Collective(c.kind, c.shape, c.dtype, c.out_bytes)
              for c in entries]
    for n in (2, 4, 8):
        got = commstats.comm_summary(entries, n)
        want = jcs.comm_summary(as_jax, n)
        assert got == want
    assert all(c.out_bytes == int(np.prod(c.shape)) * (
        8 if c.dtype == "f64" else 4) for c in entries)
