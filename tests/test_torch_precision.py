"""The port's precision surface against the JAX package: the reference's
``compute_dtype`` (bf16, or f32 for ``--precision highest``),
``param_dtype`` (f32, or bf16) and ``exp3_dtype`` (bf16, or f32).

- K4 on an f32 arm-weight state against the streaming Pallas kernel in
  interpret mode, at ``tests/test_exp3_pallas.py``'s rtol 2e-6 (and bit
  for bit on the entries updated once: one f32 multiply, one rounding);
- the f32 cases of ``tests/test_models.py`` (SAGE, GCN and GATv2 convs on
  a full block, the SAGE model's embedding norms) against the port at
  rtol 1e-5: the same f32 ops, sums taken in another order; full-graph
  inference at f32 compute with bf16 parameters, so too;
- one fused step at f32 compute with f32 arm weights, SAGE, GCN and
  GATv2, against the JAX step with the recorded draws: loss, parameters
  and arm weights at rtol 1e-5 (Adam's first step moves a parameter by
  about lr, so parameters also take atol 1e-5 x lr); GATv2's arm weights
  at rtol 1e-4: its reward divides each logit by its dst's sum of signed
  logits, and squares the ratio, so the logits' f32 rounding comes back
  amplified where that sum cancels;
- the step with bf16 parameters against the JAX one at
  ``tests/test_torch_step.py``'s bf16 bounds (rtol 2e-2, parameters atol
  2.5 x lr: Adam's step of about lr rounded to a bf16 parameter);
- the JAX ``Trainer`` against the port's under each setting on ``toy``:
  hparams equal, the dtypes of features, parameters, Adam's moments and
  arm weights equal, one step from one state, and ``final_eval``;
- one UVA step and one S = 2 gloo sharded step at f32 compute and f32 arm
  weights: the UVA step equal to the fused step exactly (the same ops on
  the same rows), the sharded step against the replicated DP step of the
  same two ranks (its twin at S = 2) at ``test_torch_shardedstep.py``'s
  rtol 1e-5 / 2e-5, the arm weights at rtol 1e-6 (no bf16 rounding of
  the factors: both apply the same f32 products).
"""
import json
import os

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.models import inference as tinf
from bliss_gnn_tpu_torch.models import layers as tlayers
from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
from bliss_gnn_tpu_torch.parallel import dp as tdp
from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.parallel import shardedstep as tss
from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

FANOUTS, BATCH, HIDDEN, N_CLASSES, LR = (16, 8), 4, 16, 4, 1e-3
F32_RTOL = 1e-5
BF16_RTOL = 2e-2
CONVERT = {"sage": convert.sage_params_from_jax,
           "gcn": convert.gcn_params_from_jax,
           "gat": convert.gat_params_from_jax}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32)


def _jdtype(dtype):
    import jax.numpy as jnp

    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _graphs(n=200, e=1200, f=16, c=N_CLASSES, seed=7):
    """Both packages' canonicalised synthetic graph with its weights."""
    from bliss_gnn_tpu.graph import datasets as jdata
    from bliss_gnn_tpu.graph import structure as jstruct

    gj = jstruct.Graph.canonicalize(jdata.synthetic_graph(n, e, f, c,
                                                          seed=seed)[0])
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(tdata.synthetic_graph(n, e, f, c,
                                                          seed=seed)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    return gj, gt


# -- K4's 32-bit route --------------------------------------------------------


@pytest.mark.parametrize("dup", [False, True])
def test_exp3_apply_f32_matches_streaming_kernel(dup):
    import jax.numpy as jnp

    from bliss_gnn_tpu.ops.exp3_pallas import TILE_ROWS, exp3_apply_streaming

    rng = np.random.default_rng(0)
    L, R = 2, TILE_ROWS
    limit = L * R * 128
    state = rng.random((L, R, 128)).astype(np.float32) + 0.5
    U = 300
    idx = rng.integers(0, limit, U).astype(np.int32)
    if dup:
        idx[: U // 2] = idx[U // 2: U // 2 * 2]  # duplicates compose
    idx[-40:] = limit  # no-op tail slots
    mult = rng.random(U).astype(np.float32) * 0.5 + 0.75
    want, n_over = exp3_apply_streaming(
        jnp.asarray(state), jnp.asarray(idx), jnp.asarray(mult),
        interpret=True)
    assert int(n_over) == 0
    want = np.asarray(want).reshape(-1)
    got = _t(state.reshape(-1).copy())
    assert got.dtype == torch.float32
    exp3_apply(got, _t(idx), _t(mult), limit)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    count = np.bincount(idx[idx < limit], minlength=limit)
    once = count <= 1
    np.testing.assert_array_equal(got.numpy()[once], want[once])
    assert (count >= 2).any() == dup


# -- the f32 convs and models (tests/test_models.py's f32 cases) -------------


def _full_blocks():
    """The full-neighbour block over the first 8 nodes of the small
    synthetic graph, from both packages (no draws: every edge is kept)."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.sampling import block as jblock
    from bliss_gnn_tpu.sampling import samplers as jsamp

    gj, gt = _graphs()
    dj = gj.to_device(feature_dtype=jnp.float32)
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu",
                                        feature_dtype=torch.float32)
    batch = 8
    args = (batch, (0,), gj.n_nodes, gj.n_edges)
    bj, _ = jsamp.sample_blocks(
        dj, jsamp.SamplerConfig(kind="full", fanouts=(0,)),
        jblock.CapacityPlan.build(*args, kind="full", frontier_slack=16.0),
        jax.random.PRNGKey(0), jnp.arange(batch, dtype=jnp.int32),
        jnp.ones(batch, bool))
    bt, _ = tsamp.sample_blocks(
        dt, tsamp.SamplerConfig(kind="full", fanouts=(0,)),
        tblock.CapacityPlan.build(*args, kind="full", frontier_slack=16.0),
        torch.Generator().manual_seed(0),
        torch.arange(batch, dtype=torch.int32),
        torch.ones(batch, dtype=torch.bool))
    for k in ("src_gids", "e_src", "e_dst", "e_mask"):
        np.testing.assert_array_equal(_np(getattr(bt[0], k)),
                                      np.asarray(getattr(bj[0], k)), k)
    return bj[0], bt[0], dj, dt


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat", "sage_model"])
def test_f32_layers_match_reference(kind):
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.models import gnn as jgnn
    from bliss_gnn_tpu.models import layers as jlayers

    bj, bt, dj, dt = _full_blocks()
    xj = jnp.take(dj.ndata["features"], bj.src_gids, axis=0)
    xt = dt.ndata["features"][bt.src_gids.long()]
    f32 = dict(dtype=torch.float32)
    if kind == "sage_model":
        model_j = jgnn.SAGE(8, N_CLASSES, 1, dtype=jnp.float32)
        params = model_j.init(jax.random.PRNGKey(1), [bj], xj)
        out_j, aux_j = model_j.apply(params, [bj], xj)
        model_t = tgnn.SAGE(16, 8, N_CLASSES, 1, **f32)
        model_t.load_state_dict(convert.sage_params_from_jax(
            jax.tree.map(np.asarray, params)))
        out_t, aux_t = model_t([bt], xt)
        m = np.asarray(bj.src_mask)
        np.testing.assert_allclose(_np(aux_t["embed_norms"][0])[m],
                                   _np(aux_j["embed_norms"][0])[m],
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(
            np.linalg.norm(_np(xt), axis=1)[m],
            _np(aux_t["embed_norms"][0])[m], rtol=F32_RTOL)
    else:
        if kind == "sage":
            conv_j, conv_t = (jlayers.SAGEConv(12, dtype=jnp.float32),
                              tlayers.SAGEConv(16, 12, **f32))
            fn, group = convert.sage_params_from_jax, "layers_0"
        elif kind == "gcn":
            conv_j, conv_t = (jlayers.GraphConv(12, dtype=jnp.float32),
                              tlayers.GraphConv(16, 12, **f32))
            fn, group = convert.gcn_params_from_jax, "layers_0"
        else:
            conv_j = jlayers.GATv2Conv(out_feats=6, num_heads=3,
                                       dtype=jnp.float32)
            conv_t = tlayers.GATv2Conv(16, 6, 3, **f32)
            fn, group = convert.gat_params_from_jax, "gatv2_layers_0"
        params = conv_j.init(jax.random.PRNGKey(0), bj, xj)
        params = jax.tree.map(lambda p: p + 0.05, params)  # non-zero biases
        out_j = conv_j.apply(params, bj, xj)
        conv_t.load_state_dict({
            k.split(".", 2)[2]: v for k, v in fn(jax.tree.map(
                np.asarray, {group: params["params"]})).items()})
        out_t = conv_t.eval()(bt, xt)
        if kind == "gat":  # the logits of the kept edges; 0 elsewhere
            (out_j, e_j), (out_t, e_t) = out_j, out_t
            assert e_t.dtype == torch.float32
            m = np.asarray(bj.e_mask)
            np.testing.assert_allclose(_np(e_t)[m], _np(e_j)[m],
                                       rtol=F32_RTOL,
                                       atol=F32_RTOL * np.abs(_np(e_j)[m]).max())
            assert not _np(e_t)[~m].any()
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(_np(out_j)).max())


@pytest.mark.parametrize("name", ["sage", "gcn", "gat"])
def test_f32_inference_with_bf16_params_matches_reference(name):
    """Full-graph layerwise inference at f32 compute of a model whose
    parameters are bf16, both packages (the port on K6's and K7's plain
    versions), at rtol 1e-5 of the largest logit."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.models import gnn as jgnn
    from bliss_gnn_tpu.models import inference as jinf

    bj, _, dj, dt = _full_blocks()
    model_j = jgnn.build_model(name, 16, N_CLASSES, 1, dtype=jnp.float32,
                               param_dtype=jnp.bfloat16, num_out_heads=2)
    params = model_j.init(jax.random.PRNGKey(0), [bj], jnp.take(
        dj.ndata["features"], bj.src_gids, axis=0))
    want = np.asarray(jinf.layerwise_inference(
        name, params, dj, 1, dtype=jnp.float32, heads=(2,)), np.float32)
    model_t = tgnn.build_model(name, 16, 16, N_CLASSES, 1, device="cpu",
                               num_out_heads=2, dtype=torch.float32,
                               param_dtype=torch.bfloat16)
    model_t.load_state_dict(CONVERT[name](jax.tree.map(np.asarray, params),
                                          dtype=torch.bfloat16))
    assert {p.dtype for p in model_t.parameters()} == {torch.bfloat16}
    got = tinf.layerwise_inference(name, model_t, dt, 1,
                                   dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())


# -- the fused step at f32 compute, and with bf16 parameters ------------------


@pytest.fixture(scope="module")
def setup():
    import jax.numpy as jnp

    from bliss_gnn_tpu.sampling import block as jblock

    gj, gt = _graphs()
    kind = "poisson-bandit"
    args = (BATCH, FANOUTS, gj.n_nodes, gj.n_edges)
    out = dict(
        plan_j=jblock.CapacityPlan.build(*args, kind=kind,
                                         frontier_slack=16.0),
        plan_t=tblock.CapacityPlan.build(*args, kind=kind,
                                         frontier_slack=16.0),
        kind=kind, n_edges=gj.n_edges)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        out[f"dj_{name}"] = gj.to_device(feature_dtype=_jdtype(dtype))
        out[f"dt_{name}"] = tstruct.DeviceGraph.from_graph(
            gt, device="cpu", feature_dtype=dtype)
    return out


def _record_draws(monkeypatch):
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.sampling import samplers as jsamp

    draws = []
    bern = jsamp._bernoulli_select

    def bern_rec(key, p, cand_mask):
        draws.append(np.array(jax.random.uniform(key, p.shape, jnp.float32)))
        return bern(key, p, cand_mask)

    monkeypatch.setattr(jsamp, "_bernoulli_select", bern_rec)
    return draws


def _step_pair(s, monkeypatch, name, dtype, pdtype, exp3_dtype):
    """One fused step of ``name`` in both packages from one state (the JAX
    parameters, drawn on a pilot sample, converted) on the same seeds, the
    port fed the JAX sampler's draws. Returns (JAX state, JAX metrics,
    port state, port metrics)."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.models import gnn as jgnn
    from bliss_gnn_tpu.sampling import samplers as jsamp
    from bliss_gnn_tpu.train import steps as jsteps

    dname = "f32" if dtype == torch.float32 else "bf16"
    dj, dt = s[f"dj_{dname}"], s[f"dt_{dname}"]
    cfg_j = jsamp.SamplerConfig(kind=s["kind"], fanouts=FANOUTS, model=name)
    cfg_t = tsamp.SamplerConfig(kind=s["kind"], fanouts=FANOUTS, model=name)
    seeds, smask = np.arange(BATCH, dtype=np.int32), np.ones(BATCH, bool)
    exp3_j = jsamp.init_exp3_weights(2, s["n_edges"],
                                     dtype=_jdtype(exp3_dtype))
    exp3_t = convert.exp3_from_jax(np.asarray(exp3_j, np.float32),
                                   s["n_edges"], dtype=exp3_dtype)
    with jax.disable_jit():
        b0, _ = jsamp.sample_blocks(dj, cfg_j, s["plan_j"],
                                    jax.random.PRNGKey(9), jnp.asarray(seeds),
                                    jnp.asarray(smask), exp3_j)
    kw = dict(dropout=0.0)
    if name == "gat":
        kw.update(attn_drop=0.0)
    model_j = jgnn.build_model(name, HIDDEN, N_CLASSES, len(FANOUTS),
                               dtype=_jdtype(dtype),
                               param_dtype=_jdtype(pdtype), **kw)
    params = model_j.init(jax.random.PRNGKey(0), b0,
                          jnp.take(dj.ndata["features"], b0[0].src_gids,
                                   axis=0))
    params = jax.tree.map(lambda p: p + 0.01, params)  # non-zero biases
    model_t = tgnn.build_model(name, 16, HIDDEN, N_CLASSES, len(FANOUTS),
                               device="cpu", dtype=dtype, param_dtype=pdtype,
                               **kw)
    model_t.load_state_dict(CONVERT[name](jax.tree.map(np.asarray, params),
                                          dtype=pdtype))

    draws = _record_draws(monkeypatch)
    tx = jsteps.make_optimizer(LR, 10)
    state_j = jsteps.TrainState(params=params, opt_state=tx.init(params),
                                exp3_weights=exp3_j,
                                key=jax.random.PRNGKey(3),
                                step=jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        step_j = jsteps.make_train_step(dj, model_j, tx, cfg_j, s["plan_j"],
                                        False, donate=False)
        new_j, m_j = step_j(state_j, jnp.asarray(seeds), jnp.asarray(smask),
                            dj)
    opt, sched = tsteps.make_optimizer(model_t.parameters(), LR, 10)
    state_t = tsteps.TrainState(model_t, opt, sched, exp3_t,
                                torch.Generator().manual_seed(0))
    step_t = tsteps.make_train_step(dt, cfg_t, s["plan_t"], False,
                                    device="cpu")
    state_t, m_t = step_t(state_t, _t(seeds), _t(smask),
                          draws=[_t(d) for d in draws[::-1]])
    return new_j, m_j, state_t, m_t


def _assert_step(new_j, m_j, state_t, m_t, name, rtol, param_atol,
                 exp3_rtol):
    import jax

    # the port's step adds each layer's Poisson fixed-point iteration count
    n_layers = sum(k.startswith("num_edges/") for k in m_j)
    assert set(m_t) == set(m_j) | {f"poisson_iters/{l}"
                                   for l in range(n_layers)}
    for k in m_j:
        if k not in ("train_loss", "f1"):
            assert int(m_t[k]) == int(m_j[k]), k
    np.testing.assert_allclose(float(m_t["train_loss"]),
                               float(m_j["train_loss"]), rtol=rtol)
    want = {k: v.numpy() for k, v in CONVERT[name](
        jax.tree.map(np.asarray, new_j.params)).items()}
    got = state_t.model.state_dict()
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=rtol,
                                   atol=param_atol, err_msg=k)
    E = state_t.exp3_weights.shape[1] - tstruct.EDGE_PAD
    want_exp3 = np.asarray(new_j.exp3_weights, np.float32).reshape(2, -1)[:, :E]
    assert np.any(want_exp3 != 1.0)
    np.testing.assert_allclose(_np(state_t.exp3_weights)[:, :E], want_exp3,
                               rtol=exp3_rtol)


@pytest.mark.parametrize("name", ["sage", "gcn", "gat"])
def test_f32_step_matches_reference(setup, monkeypatch, name):
    new_j, m_j, state_t, m_t = _step_pair(
        setup, monkeypatch, name, torch.float32, torch.float32,
        torch.float32)
    assert state_t.exp3_weights.dtype == torch.float32
    _assert_step(new_j, m_j, state_t, m_t, name, F32_RTOL, F32_RTOL * LR,
                 1e-4 if name == "gat" else F32_RTOL)


@pytest.mark.parametrize("name", ["sage"])
def test_bf16_param_step_matches_reference(setup, monkeypatch, name):
    new_j, m_j, state_t, m_t = _step_pair(
        setup, monkeypatch, name, torch.bfloat16, torch.bfloat16,
        torch.bfloat16)
    for p in state_t.model.parameters():
        assert p.dtype == torch.bfloat16
        # Adam's moments in the parameters' dtype, as optax's (mu_dtype
        # None)
        for k in ("exp_avg", "exp_avg_sq"):
            assert state_t.optimizer.state[p][k].dtype == torch.bfloat16
    _assert_step(new_j, m_j, state_t, m_t, name, BF16_RTOL, 2.5 * LR,
                 BF16_RTOL)


# -- the trainer under each setting -----------------------------------------


SETTINGS = {"compute_f32": dict(compute_dtype="float32"),
            "params_bf16": dict(param_dtype="bfloat16"),
            "exp3_f32": dict(exp3_dtype="float32")}


def _hparams(tr):
    with open(os.path.join(tr.run_dir, "hparams.json")) as f:
        payload = json.load(f)
    payload["config"].pop("logdir")
    return {k: payload[k] for k in ("config", "capacity_plan", "batch_size",
                                    "n_classes", "multilabel", "dp")}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_trainer_matches_reference(tmp_path, monkeypatch, setting):
    """Both trainers on ``toy`` with one setting: hparams and dtypes equal;
    one step from the JAX trainer's state with its draws (loss, parameters
    and arm weights at the setting's bounds: rtol 1e-5 when everything the
    step computes is f32, else bf16's 2e-2); then the final logits and
    ``final_eval``."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.models import inference as jinf
    from bliss_gnn_tpu.train import trainer as jtrainer

    from bliss_gnn_tpu_torch.train import trainer as ttrainer

    args = dict(dataset="toy", model="sage", sampler="poisson-bandit",
                fan_out=(4, 4), batch_size=4, num_hidden=8, num_layers=2,
                lr=0.01, num_epochs=1, lr_step_size=100, dropout=0.0,
                disable_checkpoint=True, **SETTINGS[setting])
    tj = jtrainer.Trainer(jtrainer.TrainConfig(
        logdir=str(tmp_path / "jax"), **args))
    tt = ttrainer.Trainer(ttrainer.TrainConfig(
        logdir=str(tmp_path / "torch"), **args), device="cpu")
    assert _hparams(tj) == _hparams(tt)
    jdt = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}
    assert tt.graph.ndata["features"].dtype == jdt[
        tj.graph.ndata["features"].dtype]
    assert ({p.dtype for p in tt.state.model.parameters()}
            == {jdt[p.dtype] for p in jax.tree.leaves(tj.state.params)})
    assert tt.state.exp3_weights.dtype == jdt[tj.state.exp3_weights.dtype]

    E = tt.host_graph.n_edges
    params = jax.tree.map(np.asarray, tj.state.params)
    tt.state.model.load_state_dict(convert.sage_params_from_jax(
        params, dtype=tt.pdtype))
    tt.state.exp3_weights.copy_(convert.exp3_from_jax(
        np.asarray(tj.state.exp3_weights, np.float32), E,
        dtype=tt.exp3_dtype))
    seeds = np.arange(tt.batch_size, dtype=np.int32)
    smask = np.ones(tt.batch_size, bool)
    draws = _record_draws(monkeypatch)
    with jax.disable_jit():
        tj.state, m_j = tj.train_step(tj.state, jnp.asarray(seeds),
                                      jnp.asarray(smask), tj._step_graph)
    tt.state, m_t = tt.train_step(tt.state, _t(seeds), _t(smask),
                                  draws=[_t(d) for d in draws[::-1]])
    for p in tt.state.model.parameters():
        for v in tt.state.optimizer.state[p].values():
            if v.dim() > 0:
                assert v.dtype == tt.pdtype
    all_f32 = setting == "compute_f32"
    rtol = F32_RTOL if all_f32 else BF16_RTOL
    _assert_step(tj.state, m_j, tt.state, m_t, "sage", rtol,
                 F32_RTOL * 0.01 if all_f32 else 2.5 * 0.01,
                 F32_RTOL if all_f32 else BF16_RTOL)

    cfg = tj.cfg
    want = np.asarray(jinf.layerwise_inference(
        cfg.model, tj.state.params, tj.graph, cfg.num_layers,
        dtype=tj.dtype), np.float32)
    got = _np(tt.final_logits())
    tol = F32_RTOL if all_f32 else 5e-3
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    res_j, res_t = tj.final_eval(), tt.final_eval()
    assert res_j.keys() == res_t.keys()
    top2 = np.sort(got, axis=1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= tol * (2 + np.abs(top2).sum(1))
    nid = np.where(tt.host_graph.ndata["train_mask"])[0]
    assert abs(res_j["Train"] - res_t["Train"]) * len(nid) <= (
        tie[nid].sum() + 1e-6), (res_j, res_t)


# -- UVA and sharded steps with f32 arm weights -------------------------------


def _f32_fresh(g, model_name="sage", generator=None):
    from bliss_gnn_tpu_torch.models.gnn import build_model

    model = build_model(model_name, g.ndata["features"].shape[1], 16, 4, 2,
                        dropout=0.2, device="cpu", seed=1,
                        dtype=torch.float32)
    opt, sched = tsteps.make_optimizer(model.parameters(), 1e-2, 1,
                                       gamma=0.5, step_size=2)
    exp3 = tsamp.init_exp3_weights(2, g.n_edges, device="cpu",
                                   dtype=torch.float32)
    return tsteps.TrainState(model, opt, sched, exp3,
                             generator or torch.Generator().manual_seed(7))


def test_f32_uva_step_equals_fused_step():
    g, _, _ = tdata.synthetic_graph(600, 6000, 12, 4, seed=3)
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    f32 = torch.float32
    full = tstruct.DeviceGraph.from_graph(g, device="cpu", feature_dtype=f32)
    bare = tstruct.DeviceGraph.from_graph(g, device="cpu",
                                          exclude=("features",))
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=(64, 32))
    plan = tblock.CapacityPlan.build(16, cfg.fanouts, g.n_nodes, g.n_edges,
                                     kind=cfg.kind)
    seeds = torch.from_numpy(np.random.default_rng(2).choice(
        g.n_nodes, 16, replace=False).astype(np.int32))
    smask = torch.ones(16, dtype=torch.bool)
    st_f, m_f = tsteps.make_train_step(full, cfg, plan, False, device="cpu")(
        _f32_fresh(g), seeds, smask)
    sample_fn, train_fn, _ = tsteps.make_uva_steps(bare, cfg, plan, False,
                                                   device="cpu")
    cache = FeatureCache(g.ndata["features"], 200, dtype=f32, device="cpu")
    st_u = _f32_fresh(g)
    blocks, _ = sample_fn(st_u, seeds, smask)
    x, _ = cache.gather(blocks[0].src_gids, blocks[0].src_mask)
    assert x.dtype == f32
    st_u, m_u = train_fn(st_u, blocks, x)
    assert torch.equal(m_u["train_loss"], m_f["train_loss"])
    for p, q in zip(st_u.model.parameters(), st_f.model.parameters()):
        assert torch.equal(p, q)
    assert st_u.exp3_weights.dtype == f32
    assert torch.equal(st_u.exp3_weights, st_f.exp3_weights)
    assert bool((st_u.exp3_weights != tsamp.init_exp3_weights(
        2, g.n_edges, device="cpu", dtype=f32)).any())


def _sharded_f32_worker(seeds):
    """Rank r of 2: one DP step and one sharded step from one f32 state
    (f32 compute, f32 arm weights) on the global batch ``seeds`` (each
    rank samples its half)."""
    mesh = make_mesh(None, device="cpu")
    g, _, ml = tdata.synthetic_graph(300, 2400, 16, 4, seed=5)
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    f32 = torch.float32
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=(16, 8),
                              eta=0.1)
    plan = tblock.CapacityPlan.build(4, cfg.fanouts, g.n_nodes, g.n_edges,
                                     kind=cfg.kind)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu", feature_dtype=f32)
    sg = tss.ShardedDeviceGraph.build(g, mesh, feature_dtype=f32)
    st_dp = _f32_fresh(g, generator=mesh.generator(2))
    st_sh = _f32_fresh(g, generator=mesh.generator(2))
    st_sh.exp3_weights = tss.init_exp3_shard(2, g.n_edges, mesh, dtype=f32)
    s = torch.from_numpy(seeds)
    m = torch.ones_like(s, dtype=torch.bool)
    st_dp, m_dp = tdp.make_dp_train_step(mesh, dg, cfg, plan, ml,
                                         exp3_normalize=False)(st_dp, s, m)
    st_sh, m_sh = tss.make_sharded_train_step(mesh, sg, cfg, plan, ml)(
        st_sh, s, m)
    metrics = [{k: float(v) for k, v in mm.items()
                if not isinstance(v, tsteps.F1State)} for mm in (m_dp, m_sh)]
    return dict(metrics=metrics, n_edges=g.n_edges,
                params=[{k: v.detach().clone() for k, v in
                         st.model.state_dict().items()}
                        for st in (st_dp, st_sh)],
                exp3_dp=st_dp.exp3_weights.clone(),
                exp3_sh=st_sh.exp3_weights.clone())


def test_f32_sharded_step_matches_dp_step(tmp_path):
    seeds = np.arange(8, dtype=np.int32) * 3
    outs = multihost.run_ranks(_sharded_f32_worker, 2, (seeds,),
                               device="cpu", workdir=str(tmp_path / "ranks"))
    o = outs[0]
    m_dp, m_sh = o["metrics"]
    for k in m_dp:
        if k.startswith("num_"):
            assert m_dp[k] == m_sh[k], k
    np.testing.assert_allclose(m_sh["train_loss"], m_dp["train_loss"],
                               rtol=1e-5, atol=1e-6)
    for name, p in o["params"][0].items():
        np.testing.assert_allclose(o["params"][1][name].numpy(), p.numpy(),
                                   rtol=2e-5, atol=2e-6)
    w_sh = tss.unshard_exp3(torch.stack([x["exp3_sh"] for x in outs]), 2,
                            o["n_edges"])
    assert w_sh.dtype == o["exp3_dp"].dtype == torch.float32
    np.testing.assert_allclose(w_sh.numpy(), o["exp3_dp"].numpy(),
                               rtol=1e-6)
    assert bool((o["exp3_dp"][:, :o["n_edges"]] != 1.0).any())
