"""The port's SAGE model and fused training step against the JAX package,
plus the port's own contracts: the CUDA default raises without a card,
importing the port loads nothing of JAX, and dropout draws from an
explicit generator.

The JAX parameters are loaded into the port with
``convert.sage_params_from_jax``; dropout is 0 so both runs are
deterministic; the sampler draws the JAX side makes are recorded and fed
to the port. Tolerances: the compute is bf16 in both, with f32 sums, so
activations and gradients agree to rtol 2e-2."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import structure as jstruct
from bliss_gnn_tpu.models import gnn as jgnn
from bliss_gnn_tpu.sampling import block as jblock
from bliss_gnn_tpu.sampling import samplers as jsamp
from bliss_gnn_tpu.train import steps as jsteps

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import metrics as tmetrics
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FANOUTS, BATCH, HIDDEN, N_CLASSES = (16, 8), 4, 16, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32 if x.dtype == jnp.bfloat16 else None)


@pytest.fixture(scope="module")
def setup():
    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    kind = "poisson-bandit"
    args = (BATCH, FANOUTS, gj.n_nodes, gj.n_edges)
    return dict(
        dj=gj.to_device(), dt=tstruct.DeviceGraph.from_graph(gt, device="cpu"),
        cfg_j=jsamp.SamplerConfig(kind=kind, fanouts=FANOUTS),
        cfg_t=tsamp.SamplerConfig(kind=kind, fanouts=FANOUTS),
        plan_j=jblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0),
        plan_t=tblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0),
        n_edges=gj.n_edges,
    )


def _record_draws(monkeypatch):
    draws = []
    bern = jsamp._bernoulli_select

    def bern_rec(key, p, cand_mask):
        draws.append(np.array(jax.random.uniform(key, p.shape, jnp.float32)))
        return bern(key, p, cand_mask)

    monkeypatch.setattr(jsamp, "_bernoulli_select", bern_rec)
    return draws


def _seeds():
    return (np.arange(BATCH, dtype=np.int32), np.ones(BATCH, bool))


def _jax_model_and_params(blocks, x):
    model = jgnn.build_model("sage", HIDDEN, N_CLASSES, len(FANOUTS),
                             dropout=0.0)
    params = model.init(jax.random.PRNGKey(0), blocks, x)
    return model, params


def _port_model(params):
    model = tgnn.build_model("sage", 16, HIDDEN, N_CLASSES, len(FANOUTS),
                             dropout=0.0, device="cpu")
    model.load_state_dict(convert.sage_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return model


def _port_params(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _jax_params_as_port(params):
    return {k: v.numpy() for k, v in convert.sage_params_from_jax(
        jax.tree.map(np.asarray, params)).items()}


def test_sage_forward_and_grads_match(setup, monkeypatch):
    s = setup
    seeds, smask = _seeds()
    draws = _record_draws(monkeypatch)
    exp3_j = jsamp.init_exp3_weights(2, s["n_edges"])
    with jax.disable_jit():
        bj, _ = jsamp.sample_blocks(s["dj"], s["cfg_j"], s["plan_j"],
                                    jax.random.PRNGKey(2), jnp.asarray(seeds),
                                    jnp.asarray(smask), exp3_j)
    bt, _ = tsamp.sample_blocks(
        s["dt"], s["cfg_t"], s["plan_t"], None, torch.from_numpy(seeds),
        torch.from_numpy(smask),
        tsamp.init_exp3_weights(2, s["n_edges"], device="cpu"),
        draws=[torch.from_numpy(d) for d in draws[::-1]])
    xj = jnp.take(s["dj"].ndata["features"], bj[0].src_gids, axis=0)
    labels = np.asarray(s["dj"].ndata["labels"])[np.asarray(bj[-1].dst_gids)]
    model_j, params = _jax_model_and_params(bj, xj)

    def loss_j(p):
        logits, aux = model_j.apply(p, bj, xj)
        return jsteps.cross_entropy_loss(
            logits, jnp.asarray(labels), bj[-1].dst_mask, False), (logits, aux)

    (lj, (logits_j, aux_j)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(params)

    model_t = _port_model(params)
    xt = s["dt"].ndata["features"][bt[0].src_gids.long()]
    np.testing.assert_array_equal(_np(xt), _np(xj))
    logits_t, aux_t = model_t(bt, xt)
    assert aux_t["a_ijs"] is None
    lt = tsteps.cross_entropy_loss(logits_t, torch.from_numpy(labels),
                                   bt[-1].dst_mask, False)
    lt.backward()
    np.testing.assert_allclose(_np(logits_t), _np(logits_j), rtol=2e-2,
                               atol=2e-2)
    for nt, nj in zip(aux_t["embed_norms"], aux_j["embed_norms"]):
        np.testing.assert_allclose(_np(nt), _np(nj), rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-2)
    gj = _jax_params_as_port(grads_j)
    for name, p in model_t.named_parameters():
        scale = np.abs(gj[name]).max()
        np.testing.assert_allclose(p.grad.numpy(), gj[name], rtol=2e-2,
                                   atol=2e-2 * scale, err_msg=name)


def test_fused_step_matches(setup, monkeypatch):
    s = setup
    seeds, smask = _seeds()
    lr, spe = 1e-3, 10
    exp3_j = jsamp.init_exp3_weights(2, s["n_edges"])
    exp3_t = convert.exp3_from_jax(np.asarray(exp3_j, np.float32),
                                   s["n_edges"])
    # params initialised on one pilot sample of the JAX side
    with jax.disable_jit():
        b0, _ = jsamp.sample_blocks(s["dj"], s["cfg_j"], s["plan_j"],
                                    jax.random.PRNGKey(9), jnp.asarray(seeds),
                                    jnp.asarray(smask), exp3_j)
    model_j, params = _jax_model_and_params(
        b0, jnp.take(s["dj"].ndata["features"], b0[0].src_gids, axis=0))
    model_t = _port_model(params)

    draws = _record_draws(monkeypatch)
    tx = jsteps.make_optimizer(lr, spe)
    state_j = jsteps.TrainState(params=params, opt_state=tx.init(params),
                                exp3_weights=exp3_j,
                                key=jax.random.PRNGKey(3),
                                step=jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        step_j = jsteps.make_train_step(s["dj"], model_j, tx, s["cfg_j"],
                                        s["plan_j"], False, donate=False)
        new_j, m_j = step_j(state_j, jnp.asarray(seeds), jnp.asarray(smask),
                            s["dj"])

    opt, sched = tsteps.make_optimizer(model_t.parameters(), lr, spe)
    state_t = tsteps.TrainState(model_t, opt, sched, exp3_t,
                                torch.Generator().manual_seed(0))
    step_t = tsteps.make_train_step(s["dt"], s["cfg_t"], s["plan_t"], False,
                                    device="cpu")
    state_t, m_t = step_t(state_t, torch.from_numpy(seeds),
                          torch.from_numpy(smask),
                          draws=[torch.from_numpy(d) for d in draws[::-1]])

    assert state_t.step == 1
    assert set(m_t) == set(m_j)
    np.testing.assert_allclose(float(m_t["train_loss"]),
                               float(m_j["train_loss"]), rtol=2e-2)
    for k in m_j:
        if k not in ("train_loss", "f1"):
            assert int(m_t[k]) == int(m_j[k]), k
    assert int(m_t["exp3_apply_overflow"]) == 0
    assert float(m_t["f1"].total) == float(m_j["f1"].total)
    # Adam's first step moves each parameter by about lr * sign(grad): a
    # near-zero gradient whose sign differs between the two bf16 paths
    # moves a parameter by up to 2 * lr, hence atol 2.5 * lr
    want = _jax_params_as_port(new_j.params)
    got = _port_params(state_t.model)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=2e-2,
                                   atol=2.5 * lr, err_msg=name)
    E = s["n_edges"]
    want_exp3 = np.asarray(new_j.exp3_weights, np.float32).reshape(2, -1)[:, :E]
    assert np.any(want_exp3 != 1.0)
    # the rewards read the bf16 hidden activations' norms: rtol 2e-2
    np.testing.assert_allclose(_np(state_t.exp3_weights)[:, :E], want_exp3,
                               rtol=2e-2)


def test_f1_and_loss_match():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 12)
    mask = rng.random(12) < 0.7
    from bliss_gnn_tpu.train import metrics as jmetrics

    fj = jmetrics.f1_update(jmetrics.F1State.zero(), jnp.asarray(logits),
                            jnp.asarray(labels), jnp.asarray(mask), False)
    ft = tmetrics.f1_update(tmetrics.F1State.zero(), torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask),
                            False)
    assert float(tmetrics.f1_compute(ft, False)) == pytest.approx(
        float(jmetrics.f1_compute(fj, False)))
    ml = (rng.random((12, 5)) < 0.3).astype(np.float32)
    fj = jmetrics.f1_update(jmetrics.F1State.zero(), jnp.asarray(logits),
                            jnp.asarray(ml), jnp.asarray(mask), True)
    ft = tmetrics.f1_update(tmetrics.F1State.zero(), torch.from_numpy(logits),
                            torch.from_numpy(ml), torch.from_numpy(mask), True)
    assert float(tmetrics.f1_compute(ft, True)) == pytest.approx(
        float(jmetrics.f1_compute(fj, True)))
    for multi, lab in ((False, labels), (True, ml)):
        lj = jsteps.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(lab),
                                       jnp.asarray(mask), multi)
        lt = tsteps.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(lab),
                                       torch.from_numpy(mask), multi)
        assert float(lt) == pytest.approx(float(lj), rel=1e-5)


def test_staircase_schedule_matches_optax():
    spe, lr = 3, 0.1
    model = torch.nn.Linear(2, 1)
    opt, sched = tsteps.make_optimizer(model.parameters(), lr, spe,
                                       gamma=0.5, step_size=2)
    import optax

    want = optax.exponential_decay(lr, 2 * spe, 0.5, staircase=True)
    for t in range(15):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(t)))
        opt.step()
        sched.step()


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = tstruct.Graph.canonicalize(tdata.toy_graph()[0])
    g.edata["w"] = tstruct.normalized_edata(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstruct.DeviceGraph.from_graph(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsamp.init_exp3_weights(2, g.n_edges)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgnn.build_model("sage", 4, 8, 2, 2)
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=(2, 2))
    plan = tblock.CapacityPlan.build(2, (2, 2), g.n_nodes, g.n_edges,
                                     kind=cfg.kind)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_train_step(dg, cfg, plan, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_eval_step(dg, cfg, plan, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_multi_eval_step(dg, cfg, plan, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_multi_train_step(dg, cfg, plan, False, 2)
    from bliss_gnn_tpu_torch.train import cli, trainer

    tcfg = trainer.TrainConfig(dataset="toy", fan_out=(2, 2), batch_size=2,
                               num_layers=2, logdir=os.devnull)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(tcfg, graph=g, n_classes=2, multilabel=False)
    import dataclasses

    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(dataclasses.replace(tcfg, dp=2), graph=g,
                        n_classes=2, multilabel=False)
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.parallel.multihost import run_ranks

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_ranks(print, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--dataset", "toy", "--num-layers", "2", "--fan-out",
                  "2,2", "--num-steps", "1", "--logdir", os.devnull])


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bliss_gnn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bench_torch, chip_smoke, harness_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'bliss_gnn_tpu')]\n"
        "n = sum(m.startswith('bliss_gnn_tpu_torch.') for m in sys.modules)\n"
        "print(n, bad)\n"
        "assert n >= 15 and not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_dropout_fraction_under_a_seeded_generator():
    h = torch.ones(400, 250, dtype=torch.bfloat16)
    a = tgnn.dropout(h, 0.3, torch.Generator().manual_seed(11))
    b = tgnn.dropout(h, 0.3, torch.Generator().manual_seed(11))
    assert torch.equal(a, b)
    dropped = (a == 0).float().mean().item()
    assert abs(dropped - 0.3) < 0.01  # 10^5 draws: std ~0.0015
    kept = a[a != 0].float()
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.7), rtol=1e-2)
    assert torch.equal(tgnn.dropout(h, 0.0, None), h)
