"""The host-resident feature path of the port: ``FeatureCache`` against the
JAX package's, the split UVA steps against the fused step, and the trainer
under ``use_uva``.

Tolerances: the cache's outputs, tags and miss rates equal the JAX cache's
exactly at f32 (both copy rows and pick the same winners); three UVA steps
from a state equal three fused steps from the same state exactly (the
same blocks, losses, parameters, Adam moments and arm weights: the same
ops on the same rows, the sampler's and then dropout's draws from one
generator); the UVA trainer's logits equal the HBM trainer's (the same
parameters, the chunked pass against the full-graph one) within rtol and
atol 5e-3, as ``tests/test_torch_inference.py`` holds inference."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bliss_gnn_tpu.graph.featurecache import FeatureCache as JFeatureCache

from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
from bliss_gnn_tpu_torch.train import steps

torch.set_num_threads(1)


def _batches(rng, n, k, b):
    """k batches of b ids in [0, n) with repeats, some slots masked."""
    out = []
    for _ in range(k):
        gids = rng.integers(0, n, b).astype(np.int32)
        gids[: b // 4] = gids[b // 4: b // 2]  # repeats within the batch
        mask = rng.random(b) < 0.85
        out.append((gids, mask))
    return out


@pytest.mark.parametrize("capacity", [7, 64, 1000])
def test_cache_matches_reference(capacity):
    rng = np.random.default_rng(0)
    n, f = 300, 5
    host = rng.normal(size=(n, f)).astype(np.float32)
    jc = JFeatureCache(host, capacity=capacity, dtype=jnp.float32)
    tc = FeatureCache(host, capacity, dtype=torch.float32, device="cpu")
    assert tc.capacity == jc.capacity
    for gids, mask in _batches(rng, n, 6, 48):
        want, wmiss = jc.gather(jnp.asarray(gids), jnp.asarray(mask))
        got, miss = tc.gather(torch.from_numpy(gids), torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy()[mask], host[gids[mask]])
        assert not got.numpy()[~mask].any()
        assert miss == wmiss
        np.testing.assert_array_equal(tc.tags.numpy(), np.asarray(jc.tags))
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        assert tc.miss_rate == jc.miss_rate
    # each miss fetched one row of f f32 from the host
    assert tc.bytes_fetched == round(tc.miss_rate * tc._lookups) * f * 4


def test_warm_cache_hits_and_serves_bf16():
    rng = np.random.default_rng(1)
    n, f = 256, 8
    host = rng.normal(size=(n, f)).astype(np.float32)
    tc = FeatureCache(host, n, device="cpu")  # bf16, no collisions
    tc.warm(np.arange(n))
    assert tc.miss_rate == 1.0
    gids = torch.from_numpy(rng.integers(0, n, 100).astype(np.int32))
    out, miss = tc.gather(gids, torch.ones(100, dtype=torch.bool))
    assert miss == 0.0 and out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, torch.from_numpy(host[gids.numpy()]).to(torch.bfloat16),
        rtol=0, atol=0)
    jc = JFeatureCache(host, n)
    jc.warm(np.arange(n))
    want, _ = jc.gather(jnp.asarray(gids.numpy()), jnp.ones(100, bool))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def _uva_setup(model_name="sage"):
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )

    g, n_cls, _ = tdata.synthetic_graph(600, 6000, 12, 4, seed=3)
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    full = tstruct.DeviceGraph.from_graph(g, device="cpu")
    bare = tstruct.DeviceGraph.from_graph(g, device="cpu",
                                          exclude=("features",))
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(64, 32),
                        model=model_name)
    plan = CapacityPlan.build(16, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind)

    def fresh():
        model = build_model(model_name, 12, 16, n_cls, 2, dropout=0.2,
                            attn_drop=0.1, device="cpu", seed=1)
        opt, sched = steps.make_optimizer(model.parameters(), 1e-2, 1,
                                          gamma=0.5, step_size=2)
        return steps.TrainState(model, opt, sched,
                                init_exp3_weights(2, g.n_edges, device="cpu"),
                                torch.Generator().manual_seed(7))

    return g, full, bare, cfg, plan, fresh


@pytest.mark.parametrize("model_name", ["sage", "gat"])
def test_uva_steps_equal_fused_steps(monkeypatch, model_name):
    g, full, bare, cfg, plan, fresh = _uva_setup(model_name)
    recorded = []
    sample = steps.sample_blocks

    def recording(*args, **kw):
        blocks, stats = sample(*args, **kw)
        recorded.append(blocks)
        return blocks, stats

    monkeypatch.setattr(steps, "sample_blocks", recording)
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.choice(g.n_nodes, 16, replace=False)
                                .astype(np.int32)) for _ in range(3)]
    smask = torch.ones(16, dtype=torch.bool)

    fused = steps.make_train_step(full, cfg, plan, False, device="cpu")
    st_f, m_f = fresh(), []
    for seeds in batches:
        st_f, m = fused(st_f, seeds, smask)
        m_f.append(m)
    blocks_f, recorded[:] = list(recorded), []

    sample_fn, train_fn, _ = steps.make_uva_steps(bare, cfg, plan, False,
                                                  device="cpu")
    cache = FeatureCache(g.ndata["features"], 200, device="cpu")
    st_u, m_u = fresh(), []
    for seeds in batches:
        blocks, _ = sample_fn(st_u, seeds, smask)
        x, _ = cache.gather(blocks[0].src_gids, blocks[0].src_mask)
        st_u, m = train_fn(st_u, blocks, x)
        m_u.append(m)
    assert len(recorded) == len(blocks_f) == 3 and st_u.step == 3
    for bu, bf in zip(recorded, blocks_f):
        for a, b in zip(bu, bf):
            for k in ("src_gids", "src_mask", "e_src", "e_dst", "e_mask",
                      "eid", "e_weight", "e_q"):
                assert torch.equal(getattr(a, k), getattr(b, k)), k
            # the dst-sorted promise of ids_sorted=True
            nv = int(a.n_valid_edges())
            assert bool((a.e_dst[1:nv] >= a.e_dst[:nv - 1]).all())
    for a, b in zip(m_u, m_f):
        assert torch.equal(a["train_loss"], b["train_loss"])
        assert all(int(a[k]) == int(b[k]) for k in a if k.startswith("num_"))
    for (n, p), q in zip(st_u.model.named_parameters(),
                         st_f.model.parameters()):
        assert torch.equal(p, q), n
        for k, v in st_u.optimizer.state[p].items():
            assert torch.equal(v, st_f.optimizer.state[q][k]), (n, k)
    assert torch.equal(st_u.exp3_weights, st_f.exp3_weights)
    assert torch.equal(st_u.generator.get_state(), st_f.generator.get_state())


def test_uva_eval_fn_equals_eval_step():
    g, full, bare, cfg, plan, fresh = _uva_setup()
    st = fresh()
    seeds = torch.arange(16, dtype=torch.int32)
    smask = torch.ones(16, dtype=torch.bool)
    smask[12:] = False
    want = steps.make_eval_step(full, cfg, plan, False, device="cpu")(
        st, torch.Generator().manual_seed(3), seeds, smask)
    sample_fn, _, eval_fn = steps.make_uva_steps(bare, cfg, plan, False,
                                                 device="cpu")
    blocks, _ = sample_fn(st, seeds, smask,
                          generator=torch.Generator().manual_seed(3))
    x, _ = FeatureCache(g.ndata["features"], 50, device="cpu").gather(
        blocks[0].src_gids, blocks[0].src_mask)
    got = eval_fn(st, blocks, x)
    for a, b in zip(got[0].__dict__.values(), want[0].__dict__.values()):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2]) == 12
    assert st.step == 0
    # over a mesh of one rank (the DP hooks: the sums all-reduced), the same
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, device="cpu")
    try:
        sample_fn, _, eval_fn = steps.make_uva_steps(
            bare, cfg, plan, False, device="cpu", mesh=mesh)
        blocks, _ = sample_fn(st, seeds, smask,
                              generator=torch.Generator().manual_seed(3))
        got = eval_fn(st, blocks, x)
    finally:
        mesh.close()
    for a, b in zip(got[0].__dict__.values(), want[0].__dict__.values()):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2])


def test_uva_trainer_matches_hbm_trainer(tmp_path):
    """The toy config under ``use_uva``: finite losses, ``cache_miss``
    logged every step, no features on the device, and the final eval's
    logits (chunked from host memory) equal to the full-graph pass's on
    the same parameters."""
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    base = dict(dataset="toy", model="sage", sampler="poisson-bandit",
                fan_out=(4, 4), num_layers=2, batch_size=4, num_steps=3,
                num_hidden=8, disable_checkpoint=True, logdir=str(tmp_path))
    t = Trainer(TrainConfig(**base, use_uva=True, cache_size=4),
                device="cpu")
    assert "features" not in t.graph.ndata
    assert t.feature_cache.capacity == 4 and t.multi_step is None
    t.fit()
    assert t.feature_cache._lookups > 0
    with open(os.path.join(t.run_dir, "metrics.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    miss = [float(r[2]) for r in rows if r[1] == "cache_miss"]
    assert len(miss) == 3 and all(0.0 <= m <= 1.0 for m in miss)
    assert miss[0] == 1.0  # a cold cache
    out = t.final_eval()
    assert np.isfinite(out["Train"])
    hbm = Trainer(TrainConfig(**base), device="cpu")
    hbm.state.model.load_state_dict(t.state.model.state_dict())
    torch.testing.assert_close(t.final_logits(), hbm.final_logits(),
                               rtol=5e-3, atol=5e-3)


def test_uva_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bliss_gnn_tpu_torch.models.inference import layerwise_inference_uva

    g, full, bare, cfg, plan, fresh = _uva_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureCache(g.ndata["features"], 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_uva_steps(bare, cfg, plan, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        layerwise_inference_uva("sage", fresh().model, g, 2)


def test_loss_masks_unlabelled_slots():
    """A padded slot of an unlabelled node (label -1, as in papers100M)
    leaves the loss as the JAX step's: masked out, never gathered."""
    from bliss_gnn_tpu.train import steps as jsteps

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = np.array([1, 4, -1, 0, -1, 2])
    mask = labels >= 0
    want = float(jsteps.cross_entropy_loss(jnp.asarray(logits),
                                           jnp.asarray(labels),
                                           jnp.asarray(mask), False))
    got = float(steps.cross_entropy_loss(torch.from_numpy(logits),
                                         torch.from_numpy(labels),
                                         torch.from_numpy(mask), False))
    assert got == pytest.approx(want, rel=1e-6)


def test_uva_trainer_on_sparse_labels(tmp_path):
    """``use_uva`` on a graph labelled at 10% of its nodes (the rest -1,
    as synth-papers100m-small): training and the padded validation
    batches run, and the final eval is finite."""
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    g, n_cls, _ = tdata.synthetic_graph(400, 3000, 8, 3, seed=9)
    labeled = np.random.default_rng(9).random(g.n_nodes) < 0.1
    g.ndata["labels"] = np.where(labeled, g.ndata["labels"], -1)
    for m in ("train_mask", "val_mask", "test_mask"):
        g.ndata[m] &= labeled
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    cfg = TrainConfig(dataset="synth", fan_out=(8, 8), num_layers=2,
                      batch_size=8, num_steps=4, num_hidden=8,
                      use_uva=True, cache_size=64, disable_checkpoint=True,
                      logdir=str(tmp_path))
    t = Trainer(cfg, graph=g, n_classes=n_cls, multilabel=False,
                device="cpu").fit()
    assert len(t.val_nid) % t.batch_size  # the last batch is padded
    assert all(np.isfinite(v) for v in t.final_eval().values())
