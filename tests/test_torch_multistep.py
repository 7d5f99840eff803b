"""The port's chained train step and its evaluation steps, on the CPU, where
a chain is a plain loop over the single step: K chained steps equal K
single steps, a chain with a remainder equals single steps throughout,
chained validation equals the unchained sums bit for bit, and the eval step
matches the JAX eval body on the same draws and leaves the arm weights as
they were (the reference's ``tests/test_multistep.py``, at the step level:
the port has no trainer yet). On the card the chain replays a CUDA graph:
``tests/test_torch_cuda.py`` holds it against eager steps.

Tolerances: chained against single steps, the same code on the same
inputs, rtol 1e-5 and atol 1e-6 on the parameters, the arm weights equal;
the eval step against JAX as the fused step tests hold the step (bf16
compute: the loss to rtol 2e-2, the counts exactly)."""
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
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

FANOUTS, BATCH, HIDDEN, N_CLASSES = (16, 8), 4, 16, 4
KIND = "poisson-bandit"


@pytest.fixture(scope="module")
def setup():
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    cfg = tsamp.SamplerConfig(kind=KIND, fanouts=FANOUTS)
    plan = tblock.CapacityPlan.build(BATCH, FANOUTS, gt.n_nodes, gt.n_edges,
                                     kind=KIND, frontier_slack=16.0)
    return dt, cfg, plan, gt.n_edges


def _state(n_edges, seed=0):
    """A fresh state: SAGE with dropout 0.5 (so the generator feeds the
    dropout masks too), Adam, uniform arm weights."""
    model = tgnn.build_model("sage", 16, HIDDEN, N_CLASSES, len(FANOUTS),
                             dropout=0.5, device="cpu", seed=seed)
    opt, sched = tsteps.make_optimizer(model.parameters(), 1e-2, 2,
                                       step_size=1)
    return tsteps.TrainState(
        model, opt, sched,
        tsamp.init_exp3_weights(len(FANOUTS), n_edges, device="cpu"),
        torch.Generator().manual_seed(seed))


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    seeds = np.stack([rng.choice(200, BATCH, replace=False)
                      for _ in range(k)]).astype(np.int32)
    mask = np.ones((k, BATCH), bool)
    mask[:, -1] = rng.random(k) < 0.5  # some batches short of one seed
    return torch.from_numpy(seeds), torch.from_numpy(mask)


def _assert_same_state(a, b):
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    assert torch.equal(a.exp3_weights, b.exp3_weights)
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()


def test_chained_steps_match_single_steps(setup):
    dt, cfg, plan, n_edges = setup
    seeds, mask = _batches(3)
    single = tsteps.make_train_step(dt, cfg, plan, False, device="cpu")
    multi = tsteps.make_multi_train_step(dt, cfg, plan, False, 3,
                                         device="cpu")
    s1, s3 = _state(n_edges), _state(n_edges)
    losses = []
    for k in range(3):
        s1, m = single(s1, seeds[k], mask[k])
        losses.append(m)
    s3, m3 = multi(s3, seeds, mask)
    assert s3.step == 3
    _assert_same_state(s1, s3)
    assert not torch.equal(s3.exp3_weights,
                           _state(n_edges).exp3_weights)  # it learned
    assert set(m3) == set(losses[0])
    for key, v in m3.items():
        if key == "f1":
            for f in ("tp", "fp", "fn", "total"):
                want = torch.stack([getattr(m["f1"], f) for m in losses])
                assert torch.equal(getattr(v, f), want), f
        else:
            want = torch.stack([torch.as_tensor(m[key]) for m in losses])
            assert v.shape == (3,) and torch.equal(v, want.to(v.dtype)), key


def test_chain_with_a_remainder_matches_single_steps(setup):
    """Six steps as one chain of four and two single steps."""
    dt, cfg, plan, n_edges = setup
    seeds, mask = _batches(6, seed=1)
    single = tsteps.make_train_step(dt, cfg, plan, False, device="cpu")
    multi = tsteps.make_multi_train_step(dt, cfg, plan, False, 4,
                                         device="cpu")
    s1, s4 = _state(n_edges), _state(n_edges)
    for k in range(6):
        s1, _ = single(s1, seeds[k], mask[k])
    s4, _ = multi(s4, seeds[:4], mask[:4])
    for k in (4, 5):
        s4, _ = single(s4, seeds[k], mask[k])
    assert s4.step == 6
    _assert_same_state(s1, s4)
    with pytest.raises(ValueError, match="chain of 4"):
        multi(s4, seeds[:2], mask[:2])


def test_chain_without_a_length_takes_each_calls_batches(setup):
    """Without ``n_steps`` one chained step takes K from its seeds on every
    call: a chain of one and a chain of two equal three single steps."""
    dt, cfg, plan, n_edges = setup
    seeds, mask = _batches(3, seed=3)
    single = tsteps.make_train_step(dt, cfg, plan, False, device="cpu")
    multi = tsteps.make_multi_train_step(dt, cfg, plan, False, device="cpu")
    s1, sk = _state(n_edges), _state(n_edges)
    for k in range(3):
        s1, _ = single(s1, seeds[k], mask[k])
    sk, m1 = multi(sk, seeds[:1], mask[:1])
    sk, m2 = multi(sk, seeds[1:], mask[1:])
    assert m1["train_loss"].shape == (1,) and m2["train_loss"].shape == (2,)
    assert sk.step == 3
    _assert_same_state(s1, sk)


def test_chained_validation_matches_unchained(setup):
    """The chained eval's (f1, loss * n, n) are the per-batch loop's sums,
    bit for bit, from generators in the same state."""
    dt, cfg, plan, n_edges = setup
    state = _state(n_edges)
    state, _ = tsteps.make_train_step(dt, cfg, plan, False, device="cpu")(
        state, *(t[0] for t in _batches(1)))
    seeds, mask = _batches(5, seed=2)
    one = tsteps.make_eval_step(dt, cfg, plan, False, device="cpu")
    multi = tsteps.make_multi_eval_step(dt, cfg, plan, False, device="cpu")
    gen_a = torch.Generator().manual_seed(11)
    gen_b = torch.Generator().manual_seed(11)
    f1, loss_n, n = multi(state, gen_a, seeds, mask)
    fields = ("tp", "fp", "fn", "total")
    want_f1 = {f: torch.zeros(()) for f in fields}
    want_ln = torch.zeros(())
    want_n = torch.zeros((), dtype=torch.int32)
    for k in range(5):
        df1, dln, dn = one(state, gen_b, seeds[k], mask[k])
        want_f1 = {f: want_f1[f] + getattr(df1, f) for f in fields}
        want_ln, want_n = want_ln + dln, want_n + dn
    for f in fields:
        assert torch.equal(getattr(f1, f), want_f1[f]), f
    assert torch.equal(loss_n, want_ln) and torch.equal(n, want_n)
    assert int(n) == int(mask.sum()) and float(f1.total) == int(n)
    # the generators advanced alike
    assert torch.equal(torch.rand(3, generator=gen_a),
                       torch.rand(3, generator=gen_b))


def test_eval_leaves_the_state_as_it_was(setup):
    """No EXP3 update, no parameter change, the model's mode restored."""
    dt, cfg, plan, n_edges = setup
    state = _state(n_edges)
    noise = torch.rand(state.exp3_weights.shape,
                       generator=torch.Generator().manual_seed(3))
    state.exp3_weights.mul_((0.5 + noise).to(torch.bfloat16))
    before = state.exp3_weights.clone()
    params = [p.detach().clone() for p in state.model.parameters()]
    seeds, mask = _batches(3, seed=4)
    gen = torch.Generator().manual_seed(0)
    tsteps.make_eval_step(dt, cfg, plan, False, device="cpu")(
        state, gen, seeds[0], mask[0])
    tsteps.make_multi_eval_step(dt, cfg, plan, False, device="cpu")(
        state, gen, seeds, mask)
    assert torch.equal(state.exp3_weights, before)
    assert all(torch.equal(p, q)
               for p, q in zip(state.model.parameters(), params))
    assert state.model.training


def test_eval_step_matches_jax_eval_body(monkeypatch):
    """The port's eval step against the JAX ``_make_eval_fn`` body,
    unjitted, on arm weights away from 1, the port fed the draws the JAX
    sampler made. Dropout is 0.5 in both models: eval runs without it."""
    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    dj, dt = gj.to_device(), tstruct.DeviceGraph.from_graph(gt, device="cpu")
    args = (BATCH, FANOUTS, gj.n_nodes, gj.n_edges)
    plan_j = jblock.CapacityPlan.build(*args, kind=KIND, frontier_slack=16.0)
    plan_t = tblock.CapacityPlan.build(*args, kind=KIND, frontier_slack=16.0)
    cfg_j = jsamp.SamplerConfig(kind=KIND, fanouts=FANOUTS)
    cfg_t = tsamp.SamplerConfig(kind=KIND, fanouts=FANOUTS)
    ones = np.asarray(jsamp.init_exp3_weights(2, gj.n_edges), np.float32)
    noise = np.random.default_rng(6).random(ones.shape).astype(np.float32)
    exp3_j = jnp.asarray(ones * (0.25 + 2 * noise), jnp.bfloat16)
    exp3_t = convert.exp3_from_jax(np.asarray(exp3_j, np.float32),
                                   gj.n_edges)
    seeds = np.array([3, 17, 58, 120], np.int32)
    smask = np.array([True, True, True, False])
    with jax.disable_jit():
        b0, _ = jsamp.sample_blocks(dj, cfg_j, plan_j, jax.random.PRNGKey(9),
                                    jnp.asarray(seeds), jnp.asarray(smask),
                                    exp3_j)
    model_j = jgnn.build_model("sage", HIDDEN, N_CLASSES, 2, dropout=0.5)
    params = model_j.init(jax.random.PRNGKey(0), b0,
                          jnp.take(dj.ndata["features"], b0[0].src_gids,
                                   axis=0))
    model_t = tgnn.build_model("sage", 16, HIDDEN, N_CLASSES, 2, dropout=0.5,
                               device="cpu")
    model_t.load_state_dict(convert.sage_params_from_jax(
        jax.tree.map(np.asarray, params)))

    draws = []
    bern = jsamp._bernoulli_select

    def bern_rec(key, p, cand_mask):
        draws.append(np.array(jax.random.uniform(key, p.shape, jnp.float32)))
        return bern(key, p, cand_mask)

    monkeypatch.setattr(jsamp, "_bernoulli_select", bern_rec)
    state_j = jsteps.TrainState(params=params, opt_state=None,
                                exp3_weights=exp3_j,
                                key=jax.random.PRNGKey(0),
                                step=jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        f1_j, ln_j, n_j = jsteps._make_eval_fn(model_j, cfg_j, plan_j, False)(
            state_j, jax.random.PRNGKey(4), jnp.asarray(seeds),
            jnp.asarray(smask), dj)

    opt, sched = tsteps.make_optimizer(model_t.parameters(), 1e-3, 10)
    state_t = tsteps.TrainState(model_t, opt, sched, exp3_t, None)
    f1_t, ln_t, n_t = tsteps.make_eval_step(dt, cfg_t, plan_t, False,
                                            device="cpu")(
        state_t, None, torch.from_numpy(seeds), torch.from_numpy(smask),
        draws=[torch.from_numpy(d) for d in draws[::-1]])
    assert int(n_t) == int(n_j) == 3
    assert float(f1_t.total) == float(f1_j.total)
    np.testing.assert_allclose(float(ln_t), float(ln_j), rtol=2e-2)


def test_capturable_schedule_matches_optax():
    """The capturable Adam's tensor rate follows the same staircase as the
    float rate of ``test_staircase_schedule_matches_optax``."""
    import optax

    spe, lr = 3, 0.1
    model = torch.nn.Linear(2, 1)
    opt, sched = tsteps.make_optimizer(model.parameters(), lr, spe,
                                       gamma=0.5, step_size=2,
                                       capturable=True)
    rate = opt.param_groups[0]["lr"]
    assert isinstance(rate, torch.Tensor) and rate.dim() == 0
    assert opt.param_groups[0]["capturable"]
    want = optax.exponential_decay(lr, 2 * spe, 0.5, staircase=True)
    for t in range(15):
        assert float(rate) == pytest.approx(float(want(t)), rel=1e-6)
        assert sched.get_last_lr()[0] == pytest.approx(float(want(t)))
        sched.step()
    assert opt.param_groups[0]["lr"] is rate  # filled in place
