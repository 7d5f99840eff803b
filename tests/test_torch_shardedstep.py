"""The port's edge-partitioned sampled training (``parallel/shardedstep.py``)
and its seed-batch DP step (``parallel/dp.py``) on gloo ranks, against each
other and against the JAX package's on an S-device CPU mesh: the mirror of
``test_shardedstep.py``.

The ranks are spawned processes joined through a ``FileStore`` under
``tmp_path``; they import the port only (this module imports the JAX
package inside its tests). The JAX steps run on the conftest's 8-device
mesh; the sampler draws each device makes are recorded inside the JAX DP
step (``jax.debug.callback`` with the axis index) and fed to the port's
ranks. Tolerances: counts exact; loss and parameters at the fused-step
tolerances of ``test_torch_step.py`` (rtol 2e-2; parameters atol 2.5 x lr
a step); arm weights within one bf16 ulp of the JAX weights relative to
the rows' scale (the factor-rounding divergence of ROADMAP Queue 3); the
sharded step against the port's DP step as ``test_shardedstep.py:68``
does; inference at ``test_torch_inference.py``'s 5e-3."""
import functools

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.models import inference as tinf
from bliss_gnn_tpu_torch.parallel import dp as tdp
from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.parallel import shardedstep as tss
from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

FANOUTS, LOCAL_BATCH, HIDDEN, LR, STEPS = (16, 8), 4, 16, 0.01, 3


def _graph():
    g, nc, ml = tdata.synthetic_graph(300, 2400, 16, 4, seed=5)
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    return g, nc, ml


def _port_setup(params=None, seed=1):
    g, nc, ml = _graph()
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=FANOUTS, eta=0.1)
    plan = tblock.CapacityPlan.build(LOCAL_BATCH, FANOUTS, g.n_nodes,
                                     g.n_edges, kind=cfg.kind)

    def mk_state(exp3, mesh):
        model = tgnn.build_model("sage", 16, HIDDEN, nc, 2, dropout=0.0,
                                 device="cpu", seed=seed)
        if params is not None:
            model.load_state_dict(params)
        opt, sched = tsteps.make_optimizer(model.parameters(), LR, 10,
                                           gamma=0.5, step_size=100)
        return tsteps.TrainState(model, opt, sched, exp3, mesh.generator(2))

    return g, nc, ml, cfg, plan, mk_state


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _run(tmp_path, n, fn, *args):
    return multihost.run_ranks(fn, n, args, device="cpu",
                               workdir=str(tmp_path / f"ranks_{fn.__name__}"))


# ---------------------------------------------------------------------------
# rank workers (the port only)
# ---------------------------------------------------------------------------


def _four_ranks_worker(w):
    """The module's 4-rank scenarios in one launch: DP against sharded
    steps (the indptr replicated, then sharded), the renormalisation, the
    eval steps, one sharded step's blocks."""
    n = 4 * LOCAL_BATCH
    return dict(
        steps={flag: _steps_worker(_global_seeds(4), None, None, None, flag)
               for flag in (False, True)},
        renorm=_renorm_worker(w),
        eval=_eval_worker(np.arange(n, dtype=np.int32)),
        sorted=_sorted_worker(np.arange(n, dtype=np.int32) * 7))


def _steps_worker(seeds, params, exp3, draws, shard_indptr):
    """STEPS DP steps and STEPS sharded steps from one state, the same
    seeds and (when given) the same injected draws; returns each run's
    metrics, parameters and arm weights (the sharded run's shard)."""
    mesh = make_mesh(None, device="cpu")
    g, nc, ml, cfg, plan, mk_state = _port_setup(params)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    sg = tss.ShardedDeviceGraph.build(g, mesh, shard_indptr=shard_indptr)
    exp3 = (tsamp.init_exp3_weights(2, g.n_edges, device="cpu")
            if exp3 is None else exp3)
    dp_step = tdp.make_dp_train_step(mesh, dg, cfg, plan, ml,
                                     exp3_normalize=False)
    sh_step = tss.make_sharded_train_step(mesh, sg, cfg, plan, ml)
    st_dp = mk_state(exp3.clone(), mesh)
    st_sh = mk_state(tss.shard_exp3(exp3, 2, g.n_edges, mesh.size,
                                    rank=mesh.rank), mesh)
    out = {"dp": [], "sh": []}
    for t in range(STEPS):
        s = torch.from_numpy(seeds[t])
        m = torch.ones_like(s, dtype=torch.bool)
        d = None if draws is None else [torch.from_numpy(x)
                                        for x in draws[mesh.rank][t]]
        st_dp, m_dp = dp_step(st_dp, s, m, d)
        st_sh, m_sh = sh_step(st_sh, s, m, d)
        out["dp"].append({k: (float(v) if not isinstance(v, tsteps.F1State)
                              else float(v.total)) for k, v in m_dp.items()})
        out["sh"].append({k: (float(v) if not isinstance(v, tsteps.F1State)
                              else float(v.total)) for k, v in m_sh.items()})
    out.update(params_dp=_params(st_dp), params_sh=_params(st_sh),
               exp3_dp=st_dp.exp3_weights.clone(),
               exp3_sh=st_sh.exp3_weights.clone(), epr=sg.epr)
    return out


def _renorm_worker(w):
    mesh = make_mesh(None, device="cpu")
    n_edges = _graph()[0].n_edges
    local = tss.shard_exp3(w, 2, n_edges, mesh.size, rank=mesh.rank)
    epr = (local.shape[0] - 1) // 2
    tss.make_sharded_renorm(mesh, 2, epr)(local)
    return local


def _eval_worker(seeds):
    mesh = make_mesh(None, device="cpu")
    g, nc, ml, cfg, plan, mk_state = _port_setup()
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    sg = tss.ShardedDeviceGraph.build(g, mesh)
    exp3 = tsamp.init_exp3_weights(2, g.n_edges, device="cpu")
    st_dp = mk_state(exp3, mesh)
    st_sh = mk_state(tss.shard_exp3(exp3, 2, g.n_edges, mesh.size,
                                    rank=mesh.rank), mesh)
    s = torch.from_numpy(seeds)
    m = torch.ones_like(s, dtype=torch.bool)
    out = []
    for st, ev in ((st_dp, tdp.make_dp_eval_step(mesh, dg, cfg, plan, ml)),
                   (st_sh, tss.make_sharded_eval_step(mesh, sg, cfg, plan,
                                                      ml))):
        f1, ln, n = ev(st, mesh.generator(7), s, m)
        out.append((float(f1.tp), float(f1.fp), float(f1.fn),
                    float(f1.total), float(ln), int(n)))
    chained = tss.make_sharded_multi_eval_step(mesh, sg, cfg, plan, ml)
    f1, ln, n = chained(st_sh, mesh.generator(7), s[None], m[None])
    out.append((float(f1.tp), float(f1.fp), float(f1.fn), float(f1.total),
                float(ln), int(n)))
    return out


def _inference_worker(state_dicts, feats):
    mesh = make_mesh(None, device="cpu")
    g, nc, ml = _graph()
    out = {}
    for name, sd in state_dicts.items():
        model = tgnn.build_model(name, 16, HIDDEN, nc, 2, num_in_heads=2,
                                 num_out_heads=1, device="cpu")
        model.load_state_dict(sd)
        out[name] = tinf.layerwise_inference_sharded(
            name, model, g, mesh, 2, heads=(2, 1), dtype=torch.float32,
            features=feats)
    return out


def _sorted_worker(seeds):
    """One sharded step's blocks (sampled on the rank's view through the
    plain versions, whose sorted-id checks run on CPU tensors) and the
    replicated sampler's blocks from the same generator state."""
    mesh = make_mesh(None, device="cpu")
    g, nc, ml, cfg, plan, mk_state = _port_setup()
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    sg = tss.ShardedDeviceGraph.build(g, mesh, shard_indptr=True)
    exp3 = tsamp.init_exp3_weights(2, g.n_edges, device="cpu")
    local = tss.shard_exp3(exp3, 2, g.n_edges, mesh.size, rank=mesh.rank)
    s = tdp.local_slice(mesh, torch.from_numpy(seeds))
    m = torch.ones_like(s, dtype=torch.bool)
    storage = tss.sharded_storage(sg, 2)
    b_sh, _ = tsamp.sample_blocks(tss._LocalView(sg), cfg, plan,
                                  mesh.generator(4), s, m,
                                  storage.exp3_view(local))
    b_rep, _ = tsamp.sample_blocks(dg, cfg, plan, mesh.generator(4), s, m,
                                   exp3)
    feats = storage.node_rows(tss._LocalView(sg), "features",
                              b_sh[0].src_gids)
    # one step through the plain versions on the sharded storage
    step = tss.make_sharded_train_step(mesh, sg, cfg, plan, ml)
    st, metrics = step(mk_state(local.clone(), mesh),
                       torch.from_numpy(seeds),
                       torch.ones(len(seeds), dtype=torch.bool))
    return {"sh": [(b.e_dst, b.e_mask, b.src_gids, b.eid) for b in b_sh],
            "rep": [(b.e_dst, b.e_mask, b.src_gids, b.eid) for b in b_rep],
            "feats": feats, "want_feats": dg.ndata["features"][
                b_rep[0].src_gids.long()],
            "loss": float(metrics["train_loss"])}


# ---------------------------------------------------------------------------
# the JAX side (imported inside the tests)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """The JAX graph, config, model and initial state, built once a
    module (``mk_state`` copies the parameters; nothing here is donated)."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.graph import datasets as jdata
    from bliss_gnn_tpu.graph import structure as jstruct
    from bliss_gnn_tpu.models import gnn as jgnn
    from bliss_gnn_tpu.sampling import block as jblock
    from bliss_gnn_tpu.sampling import samplers as jsamp
    from bliss_gnn_tpu.train import steps as jsteps

    g, nc, ml = jdata.synthetic_graph(300, 2400, 16, 4, seed=5)
    g = jstruct.Graph.canonicalize(g)
    g.edata["w"] = jstruct.normalized_edata(g)
    dg = g.to_device()
    cfg = jsamp.SamplerConfig(kind="poisson-bandit", fanouts=FANOUTS, eta=0.1)
    plan = jblock.CapacityPlan.build(LOCAL_BATCH, FANOUTS, g.n_nodes,
                                     g.n_edges, kind=cfg.kind)
    model = jgnn.build_model("sage", HIDDEN, nc, 2, dropout=0.0)
    tx = jsteps.make_optimizer(LR, 10, gamma=0.5, step_size=100)
    exp3 = jsamp.init_exp3_weights(2, g.n_edges)
    seeds0 = jnp.arange(LOCAL_BATCH, dtype=jnp.int32)
    blocks, _ = jax.jit(lambda gr, e: jsamp.sample_blocks(
        gr, cfg, plan, jax.random.PRNGKey(0), seeds0,
        jnp.ones(LOCAL_BATCH, bool), e))(dg, exp3)
    x = jnp.take(dg.ndata["features"], blocks[0].src_gids, axis=0)
    params = model.init(jax.random.PRNGKey(1), blocks, x)

    def mk_state(e3):
        p = jax.tree.map(jnp.copy, params)
        return jsteps.TrainState(params=p, opt_state=tx.init(p),
                                 exp3_weights=e3, key=jax.random.PRNGKey(2),
                                 step=jnp.zeros((), jnp.int32))

    return g, dg, cfg, plan, model, tx, mk_state, exp3, params


def _jax_runs(monkeypatch, n_dev, seeds):
    """The JAX DP and sharded steps (STEPS each) on an n_dev mesh; the DP
    step's per-device draws, recorded as it runs: draws[rank][step] in the
    port's block order."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.parallel.dp import make_dp_train_step
    from bliss_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from bliss_gnn_tpu.parallel.shardedstep import (
        ShardedDeviceGraph,
        make_sharded_train_step,
        shard_exp3,
        unshard_exp3,
    )
    from bliss_gnn_tpu.sampling import samplers as jsamp

    g, dg, cfg, plan, model, tx, mk_state, exp3, params = _jax_setup()
    params0 = jax.tree.map(np.asarray, params)
    exp3_0 = np.asarray(exp3, np.float32)  # the steps donate their state
    rec = {"on": True, "traced": 0, "draws": {}}
    bern = jsamp._bernoulli_select

    def bern_rec(key, p, cand_mask):
        layer = 1 - rec["traced"] % 2  # block 1 is sampled first
        rec["traced"] += 1

        def save(u, rank):
            if rec["on"]:
                rec["draws"].setdefault((int(rank), layer), []).append(
                    np.array(u))

        jax.debug.callback(save, jax.random.uniform(key, p.shape,
                                                    jnp.float32),
                           jax.lax.axis_index("dp"))
        return bern(key, p, cand_mask)

    monkeypatch.setattr(jsamp, "_bernoulli_select", bern_rec)
    mesh = jmake_mesh(n_dev)
    dp_step = make_dp_train_step(mesh, dg, model, tx, cfg, plan, False,
                                 exp3_normalize=False)
    sg = ShardedDeviceGraph.build(g, n_dev)
    sh_step = make_sharded_train_step(mesh, sg, model, tx, cfg, plan, False)
    st_dp = mk_state(jnp.copy(exp3))
    st_sh = mk_state(shard_exp3(exp3, 2, g.n_edges, n_dev))
    m_dp, m_sh = [], []
    for t in range(STEPS):
        s = jnp.asarray(seeds[t])
        m = jnp.ones(len(seeds[t]), bool)
        rec["on"] = True
        st_dp, md = dp_step(st_dp, s, m, dg)
        jax.block_until_ready(md)
        jax.effects_barrier()  # every recorded draw has landed
        rec["on"] = False
        st_sh, ms = sh_step(st_sh, s, m, sg)
        m_dp.append(jax.tree.map(np.asarray, md))
        m_sh.append(jax.tree.map(np.asarray, ms))
    draws = [[[rec["draws"][(r, l)][t] for l in range(2)]
              for t in range(STEPS)] for r in range(n_dev)]
    exp3_sh = unshard_exp3(st_sh.exp3_weights, 2, g.n_edges)
    return dict(params0=params0, exp3_0=exp3_0, g=g, draws=draws, m_dp=m_dp,
                m_sh=m_sh, p_dp=st_dp.params, p_sh=st_sh.params,
                e_dp=np.asarray(st_dp.exp3_weights, np.float32),
                e_sh=np.asarray(exp3_sh, np.float32))


def _global_seeds(n_dev, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, 300, LOCAL_BATCH * n_dev).astype(np.int32)
            for _ in range(STEPS)]


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_dp_and_sharded_steps_match_jax(tmp_path, monkeypatch, n_dev):
    """The port's n_dev-rank DP and sharded steps against the JAX DP and
    sharded steps on an n_dev-device mesh, the same per-rank draws, three
    steps from one state."""
    import jax

    seeds = _global_seeds(n_dev)
    j = _jax_runs(monkeypatch, n_dev, seeds)
    params = convert.sage_params_from_jax(jax.tree.map(np.asarray,
                                                       j["params0"]))
    exp3 = convert.exp3_from_jax(np.asarray(j["exp3_0"], np.float32),
                                 j["g"].n_edges)
    outs = _run(tmp_path, n_dev, _steps_worker, seeds, params, exp3,
                j["draws"], False)
    E = j["g"].n_edges
    for r, o in enumerate(outs):
        for t in range(STEPS):
            for run, want in (("dp", j["m_dp"][t]), ("sh", j["m_sh"][t])):
                got = o[run][t]
                for k in want:
                    if k.startswith(("num_", "layer")):
                        assert got[k] == int(want[k]), (r, t, run, k)
                np.testing.assert_allclose(got["train_loss"],
                                           float(want["train_loss"]),
                                           rtol=2e-2)
        for run, jp in (("dp", j["p_dp"]), ("sh", j["p_sh"])):
            want = convert.sage_params_from_jax(jax.tree.map(np.asarray, jp))
            for name, w in want.items():
                np.testing.assert_allclose(
                    o[f"params_{run}"][name].numpy(), w.numpy(), rtol=2e-2,
                    atol=2.5 * LR * STEPS, err_msg=f"{run} {name}")
        got_dp = o["exp3_dp"].float().numpy()[:, :E]
        want_dp = j["e_dp"].reshape(2, -1)[:, :E]
        assert np.any(want_dp != 1.0)
        for got, want in ((got_dp, want_dp), (
                tss.unshard_exp3(torch.stack([x["exp3_sh"] for x in outs]),
                                 2, E).float().numpy()[:, :E],
                j["e_sh"].reshape(2, -1)[:, :E])):
            assert np.all(np.abs(got - want) <= _ulp(want) + 1e-30), (
                np.abs(got - want).max())
    for o in outs[1:]:  # every rank holds the same parameters
        for name, p in o["params_dp"].items():
            assert torch.equal(p, outs[0]["params_dp"][name]), name


def _noisy_weights():
    g, nc, ml = _graph()
    rng = np.random.default_rng(1)
    w = tsamp.init_exp3_weights(2, g.n_edges, device="cpu").float()
    return torch.where(w > 0, w * torch.from_numpy(
        rng.random(w.shape).astype(np.float32) + 0.5), 0.0).to(torch.bfloat16)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("four_ranks"), 4,
                _four_ranks_worker, _noisy_weights())


@pytest.mark.parametrize("shard_indptr", [False, True])
def test_sharded_step_matches_replicated_dp(four_ranks, shard_indptr):
    """Three steps: the sharded step's metrics, parameters and unsharded
    arm weights against the port's replicated DP step from the same state
    and draws, with the indptr replicated or node-range sharded."""
    outs = [o["steps"][shard_indptr] for o in four_ranks]
    o = outs[0]
    for m_dp, m_sh in zip(o["dp"], o["sh"]):
        for k in m_dp:
            if k.startswith("num_"):
                assert m_dp[k] == m_sh[k], k
    np.testing.assert_allclose(o["sh"][-1]["train_loss"],
                               o["dp"][-1]["train_loss"], rtol=1e-5,
                               atol=1e-6)
    for name, p in o["params_dp"].items():
        np.testing.assert_allclose(o["params_sh"][name].numpy(), p.numpy(),
                                   rtol=2e-5, atol=2e-6)
    E = _graph()[0].n_edges
    w_sh = tss.unshard_exp3(torch.stack([x["exp3_sh"] for x in outs]), 2,
                            E).float().numpy()
    w_dp = o["exp3_dp"].float().numpy()
    np.testing.assert_allclose(w_sh, w_dp, rtol=2e-2, atol=1e-6)
    assert (w_dp != w_dp[0]).sum() > 0


def test_sharded_memory_is_partitioned():
    """A rank's graph state is O(E/S + N/S); the port's sharded arm
    weights are the JAX package's, value for value; the round trip is
    exact."""
    import types

    from bliss_gnn_tpu.parallel import shardedstep as jss

    g, nc, ml = _graph()
    S = 8
    for r in (0, S - 1):
        mesh = types.SimpleNamespace(size=S, rank=r,
                                     device=torch.device("cpu"))
        sg = tss.ShardedDeviceGraph.build(g, mesh)
        assert sg.csc_src_sh.shape == (sg.epr,)
        assert sg.epr * S < g.n_edges + S * 256
        assert sg.npr * S < g.n_nodes + S * 16
        assert sg.features_sh.shape == (sg.npr, 16)
    exp3 = tsamp.init_exp3_weights(2, g.n_edges, device="cpu")
    st = tss.shard_exp3(exp3, 2, g.n_edges, S)
    assert st.shape == (S, 2 * sg.epr + 1)
    assert st.shape[1] * S < 2 * (g.n_edges + S * 256) + S
    assert torch.equal(tss.unshard_exp3(st, 2, g.n_edges), exp3)
    for r in range(S):
        assert torch.equal(tss.shard_exp3(exp3, 2, g.n_edges, S, rank=r),
                           st[r])
        mesh = types.SimpleNamespace(size=S, rank=r,
                                     device=torch.device("cpu"))
        assert torch.equal(tss.init_exp3_shard(2, g.n_edges, mesh), st[r])
    from bliss_gnn_tpu.sampling import samplers as jsamp

    want = np.asarray(jss.shard_exp3(jsamp.init_exp3_weights(2, g.n_edges),
                                     2, g.n_edges, S), np.float32)
    np.testing.assert_array_equal(st.float().numpy(), want)


def test_sharded_renorm_matches_global(four_ranks):
    g, nc, ml = _graph()
    w = _noisy_weights()
    got = tss.unshard_exp3(torch.stack([o["renorm"] for o in four_ranks]),
                           2, g.n_edges)
    ref = tsamp.normalize_exp3_weights(w.clone())
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=2e-2, atol=1e-8)


def _trainer_worker(model_kinds, logdir):
    return {k: _trainer_run(k, logdir) for k in model_kinds}


def _trainer_run(model_kind, logdir):
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        dataset="synth-small", model=model_kind, sampler="poisson-bandit",
        fan_out=(16, 8), num_layers=2, num_hidden=16, num_in_heads=2,
        batch_size=32, num_steps=4, num_epochs=1, logdir=logdir,
        dp=2, shard_graph=True, refit_after=2, exp3_renorm_every=2,
        steps_per_call=2)
    tr = Trainer(cfg, device="cpu")
    assert tr.graph is None  # no replicated graph on any rank
    tr.fit()
    best = tr.best_state
    tr.load_checkpoint()
    loaded = tr._snapshot()
    final = tr.final_eval()
    return {"epr": tr.sharded_graph.epr, "src_sh": tuple(
        tr.sharded_graph.csc_src_sh.shape), "exp3": tuple(
        tr.state.exp3_weights.shape), "final": final, "step": tr.global_step,
        "same_exp3": torch.equal(best["exp3_weights"],
                                 loaded["exp3_weights"]),
        "same_params": all(torch.equal(best["params"][k], v)
                           for k, v in loaded["params"].items()),
        "exp3_shape": tuple(best["exp3_weights"].shape),
        "n_edges": tr.host_graph.n_edges}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """Both models' sharded trainer runs on two ranks, in one launch."""
    tmp = tmp_path_factory.mktemp("sharded_trainer")
    return _run(tmp, 2, _trainer_worker, ("sage", "gat"), str(tmp))


@pytest.mark.parametrize("model_kind", ["sage", "gat"])
def test_trainer_shard_graph_end_to_end(trainer_runs, model_kind):
    """The product path: Trainer(dp=2, shard_graph) trains, validates,
    renormalises the sharded arm weights, checkpoints the canonical
    weights and loads them back, and runs the node-sharded final eval."""
    outs = [o[model_kind] for o in trainer_runs]
    for o in outs:
        assert o["step"] == 4
        assert o["src_sh"] == (o["epr"],)
        assert o["exp3"] == (2 * o["epr"] + 1,)
        assert o["exp3_shape"] == (2, o["n_edges"] + tstruct.EDGE_PAD)
        assert o["same_exp3"] and o["same_params"]
        assert np.isfinite(o["final"]["Test"])
    assert outs[0]["final"] == outs[1]["final"]


@pytest.fixture(scope="module")
def inference_models():
    """The JAX parameters of SAGE, GCN and GATv2 (same block shapes) and
    their single-device layerwise inference in f32."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.models import gnn as jgnn
    from bliss_gnn_tpu.models.inference import layerwise_inference
    from bliss_gnn_tpu.sampling import samplers as jsamp

    g, dg, cfg, plan, model, tx, mk_state, exp3, params = _jax_setup()
    seeds0 = jnp.arange(plan.batch_size, dtype=jnp.int32)
    blocks, _ = jax.jit(lambda gr, e: jsamp.sample_blocks(
        gr, cfg, plan, jax.random.PRNGKey(0), seeds0,
        jnp.ones(plan.batch_size, bool), e))(dg, exp3)
    x = jnp.take(dg.ndata["features"], blocks[0].src_gids, axis=0)
    out = {}
    for name in ("sage", "gcn", "gat"):
        mdl = jgnn.build_model(name, HIDDEN, 4, 2, num_in_heads=2,
                               num_out_heads=1)
        p = mdl.init(jax.random.PRNGKey(1), blocks, x)
        heads = (2, 1) if name == "gat" else None
        ref = layerwise_inference(name, p, dg, 2, dtype=jnp.float32,
                                  heads=heads)
        out[name] = (jax.tree.map(np.asarray, p), np.asarray(ref))
    feats = np.asarray(dg.ndata["features"].astype(jnp.float32))
    return out, feats


def test_sharded_layerwise_inference_matches_single_device(
        tmp_path, inference_models):
    """Node-sharded ring inference on 4 ranks (K6 over buckets for SAGE and
    GCN, K7 with its partial outputs combined over buckets for GATv2)
    against the port's single-device pass and the JAX one."""
    models, feats = inference_models
    conv = {"sage": convert.sage_params_from_jax,
            "gcn": convert.gcn_params_from_jax,
            "gat": convert.gat_params_from_jax}
    sds = {k: conv[k](p) for k, (p, _) in models.items()}
    outs = _run(tmp_path, 4, _inference_worker, sds, feats)
    g, nc, ml = _graph()
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu",
                                        feature_dtype=torch.float32)
    dg.ndata["features"] = torch.from_numpy(feats.copy())
    for name, (_, ref) in models.items():
        model = tgnn.build_model(name, 16, HIDDEN, nc, 2, num_in_heads=2,
                                 num_out_heads=1, device="cpu")
        model.load_state_dict(sds[name])
        single = tinf.layerwise_inference(name, model, dg, 2, heads=(2, 1),
                                          dtype=torch.float32)
        for o in outs:
            np.testing.assert_allclose(o[name].numpy(), single.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
            np.testing.assert_allclose(o[name].numpy(), ref, rtol=5e-3,
                                       atol=5e-3, err_msg=name)


def test_sharded_eval_matches_dp_eval(four_ranks):
    outs = [o["eval"] for o in four_ranks]
    for dp_out, sh_out, chained in outs:
        assert dp_out[5] == sh_out[5] == chained[5] == 4 * LOCAL_BATCH
        np.testing.assert_allclose(sh_out[:5], dp_out[:5], rtol=1e-5)
        assert chained == sh_out
    assert all(o == outs[0] for o in outs)


def test_sharded_step_is_dst_sorted_and_matches(four_ranks):
    """The sorted promise (ROADMAP Queue 3): blocks sampled through the
    sharded storage equal the replicated sampler's from the same draws, so
    their kept edges keep the frontier's dst order; a sharded step runs
    through the plain versions, whose sorted-id checks raise on a broken
    promise."""
    for o in (r["sorted"] for r in four_ranks):
        assert np.isfinite(o["loss"])
        for (e_dst, e_mask, gids, eid), want in zip(o["sh"], o["rep"]):
            for a, b in zip((e_dst, e_mask, gids, eid), want):
                assert torch.equal(a, b)
            nv = int(e_mask.nonzero().max()) + 1 if e_mask.any() else 0
            assert bool((e_dst[:nv].diff() >= 0).all())
        assert torch.equal(o["feats"], o["want_feats"])
