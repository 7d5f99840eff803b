"""The port's split UVA step against the JAX package's ``make_uva_steps``,
the chain of one against single steps, and, on the card, the replayed
split halves and the trainer's replayed default path.

On the CPU:
- the port's eager halves (``sample_fn``, ``train_fn``, ``eval_fn``)
  against the JAX halves run unjitted, SAGE and GATv2, on the same numpy
  inputs: the JAX sampler's draws recorded and injected into the port, the
  rows fetched through each package's ``FeatureCache``, the JAX weights
  loaded into the port (``convert.py``), dropout 0. Blocks, masks, the
  fetched rows and every count exactly; the blocks' float fields at rtol
  1e-5 (``test_torch_sampling.py``'s); loss, eval sums and the updated
  parameters at the fused step tests' bounds (bf16 compute: rtol 2e-2,
  the parameters also atol 2.5 x lr); the arm weights within one bf16
  ulp of the JAX update (the documented EXP3 rounding);
- a chain of one (``make_multi_train_step``, ``make_multi_eval_step`` at K
  = 1, over 3 calls) equals 3 single steps bit for bit: on the CPU a
  chain is a loop over the same step;
- the trainer at ``steps_per_call = 1`` builds no chained step there;
- a UVA trainer goes with its last reference, no collection needed.

On the card (marker ``cuda``; they skip without one): the replayed split
halves against the eager ones from one state over 2 x
(CAPTURE_WARMUP_STEPS + 3) steps, at ``test_replayed_steps_equal_eager_
steps``' bounds, and so over a one-rank NCCL mesh (the collectives
captured), replicated and range-sharded; alternating train and
validation halves capture each graph once; the trainer at ``steps_per_call = 1`` captures its step once
after the pilot, and its losses equal an eager trainer's within
chip_smoke.py's ``LOCKSTEP_TOLERANCE`` on the loss (2^-7 of max(|loss|,
1): two free-running runs can part where an atomic sum flips a draw).
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FANOUTS, BATCH, HIDDEN, N_CLASSES = (16, 8), 4, 16, 4
KIND = "poisson-bandit"
LR = 1e-3


def _graphs():
    """The same canonicalised synthetic graph from both packages."""
    from bliss_gnn_tpu.graph import datasets as jdata
    from bliss_gnn_tpu.graph import structure as jstruct
    from bliss_gnn_tpu_torch.graph import datasets as tdata
    from bliss_gnn_tpu_torch.graph import structure as tstruct

    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    return gj, gt


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32 if x.dtype.name == "bfloat16" else None)


def _bf16_ulp(x):
    """One bf16 ulp at each value of ``x`` (f32 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


class _Pair:
    """Both packages' graphs, configs, plans, models (the JAX weights in
    the port) and arm weights away from 1, for one model."""

    def __init__(self, model):
        import jax
        import jax.numpy as jnp

        from bliss_gnn_tpu.models import gnn as jgnn
        from bliss_gnn_tpu.sampling import block as jblock
        from bliss_gnn_tpu.sampling import samplers as jsamp
        from bliss_gnn_tpu_torch import convert
        from bliss_gnn_tpu_torch.graph import structure as tstruct
        from bliss_gnn_tpu_torch.models import gnn as tgnn
        from bliss_gnn_tpu_torch.sampling import block as tblock
        from bliss_gnn_tpu_torch.sampling import samplers as tsamp

        gj, gt = _graphs()
        self.n_edges = gj.n_edges
        self.host = np.asarray(gt.ndata["features"], np.float32)
        self.dj = gj.to_device()
        self.bare = tstruct.DeviceGraph.from_graph(gt, device="cpu",
                                                   exclude=("features",))
        self.cfg_j = jsamp.SamplerConfig(kind=KIND, fanouts=FANOUTS,
                                         model=model)
        self.cfg_t = tsamp.SamplerConfig(kind=KIND, fanouts=FANOUTS,
                                         model=model)
        args = (BATCH, FANOUTS, gj.n_nodes, gj.n_edges)
        self.plan_j = jblock.CapacityPlan.build(*args, kind=KIND,
                                                frontier_slack=16.0)
        self.plan_t = tblock.CapacityPlan.build(*args, kind=KIND,
                                                frontier_slack=16.0)
        ones = np.asarray(jsamp.init_exp3_weights(2, gj.n_edges), np.float32)
        noise = np.random.default_rng(6).random(ones.shape).astype(np.float32)
        self.exp3_j = jnp.asarray(ones * (0.25 + 2 * noise), jnp.bfloat16)
        self.exp3_t = convert.exp3_from_jax(
            np.asarray(self.exp3_j, np.float32), gj.n_edges)
        seeds = jnp.arange(BATCH, dtype=jnp.int32)
        with jax.disable_jit():
            b0, _ = jsamp.sample_blocks(
                self.dj, self.cfg_j, self.plan_j, jax.random.PRNGKey(9),
                seeds, jnp.ones(BATCH, bool), self.exp3_j)
        kw = dict(dropout=0.0)
        if model == "gat":
            kw.update(attn_drop=0.0)
        self.model_j = jgnn.build_model(model, HIDDEN, N_CLASSES,
                                        len(FANOUTS), **kw)
        params = self.model_j.init(
            jax.random.PRNGKey(0), b0,
            jnp.take(self.dj.ndata["features"], b0[0].src_gids, axis=0))
        # non-zero biases
        self.params = jax.tree.map(lambda p: p + 0.01, params)
        self.convert = {"sage": convert.sage_params_from_jax,
                        "gat": convert.gat_params_from_jax}[model]
        self.model_t = tgnn.build_model(model, 16, HIDDEN, N_CLASSES,
                                        len(FANOUTS), device="cpu", **kw)
        self.model_t.load_state_dict(
            self.convert(jax.tree.map(np.asarray, self.params)))

    def as_port(self, params):
        import jax

        return {k: v.numpy() for k, v in self.convert(
            jax.tree.map(np.asarray, params)).items()}


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


def _split_both(pair, monkeypatch, seeds, smask):
    """Both packages' samples of one batch and the rows fetched for them:
    (JAX blocks, stats, x, miss), (port blocks, stats, x, miss), the JAX
    state, the port state and both packages' halves."""
    import jax
    import jax.numpy as jnp

    from bliss_gnn_tpu.graph.featurecache import FeatureCache as JCache
    from bliss_gnn_tpu.train import steps as jsteps
    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
    from bliss_gnn_tpu_torch.train import steps as tsteps

    tx = jsteps.make_optimizer(LR, 10)
    state_j = jsteps.TrainState(params=pair.params,
                                opt_state=tx.init(pair.params),
                                exp3_weights=pair.exp3_j,
                                key=jax.random.PRNGKey(3),
                                step=jnp.zeros((), jnp.int32))
    halves_j = jsteps.make_uva_steps(pair.model_j, tx, pair.cfg_j,
                                     pair.plan_j, False)
    draws = _record_draws(monkeypatch)
    with jax.disable_jit():
        bj, sj, k_drop, key = halves_j[0](state_j, jnp.asarray(seeds),
                                          jnp.asarray(smask), pair.dj)
    xj, miss_j = JCache(pair.host, 64).gather(bj[0].src_gids, bj[0].src_mask)

    opt, sched = tsteps.make_optimizer(pair.model_t.parameters(), LR, 10)
    state_t = tsteps.TrainState(pair.model_t, opt, sched, pair.exp3_t,
                                torch.Generator().manual_seed(0))
    halves_t = tsteps.make_uva_steps(pair.bare, pair.cfg_t, pair.plan_t,
                                     False, device="cpu")
    bt, st = halves_t[0](state_t, torch.from_numpy(seeds),
                         torch.from_numpy(smask),
                         draws=[torch.from_numpy(d) for d in draws[::-1]])
    xt, miss_t = FeatureCache(pair.host, 64, device="cpu").gather(
        bt[0].src_gids, bt[0].src_mask)
    return ((bj, sj, xj, miss_j, k_drop, key), (bt, st, xt, miss_t),
            state_j, state_t, halves_j, halves_t)


def _assert_same_sample(j, t):
    (bj, sj, xj, miss_j, *_), (bt, st, xt, miss_t) = j, t
    for layer, (a, b) in enumerate(zip(bt, bj)):
        for f in ("src_gids", "src_mask", "e_src", "e_dst", "e_mask", "eid"):
            np.testing.assert_array_equal(_np(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"layer {layer} {f}")
        for f in ("e_weight", "e_q", "src_node_prob", "e_alpha"):
            if getattr(b, f) is not None:
                np.testing.assert_allclose(
                    _np(getattr(a, f)), np.asarray(getattr(b, f)),
                    rtol=1e-5, atol=1e-7, err_msg=f"layer {layer} {f}")
    # the port's sampler stats add each layer's fixed-point iteration count
    assert set(st) == set(sj) | {f"poisson_iters/{l}"
                                 for l in range(len(bt))}
    for k in sj:
        assert int(st[k]) == int(sj[k]), k
    np.testing.assert_array_equal(_np(xt), _np(xj))
    assert miss_t == miss_j > 0


SEEDS = np.array([3, 17, 58, 120], np.int32)
SMASK = np.array([True, True, True, False])


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_split_train_halves_match_jax(monkeypatch, model):
    """``sample_fn``, the fetch, ``train_fn``: the same blocks, stats and
    rows; the loss, counts, parameters and arm weights after the step."""
    import jax

    pair = _Pair(model)
    j, t, state_j, state_t, halves_j, halves_t = _split_both(
        pair, monkeypatch, SEEDS, SMASK)
    _assert_same_sample(j, t)
    bj, _, xj, _, k_drop, key = j
    bt, _, xt, _ = t
    with jax.disable_jit():
        new_j, m_j = halves_j[1](state_j, bj, xj, k_drop, key, pair.dj)
    state_t, m_t = halves_t[1](state_t, bt, xt)
    assert state_t.step == 1 and int(new_j.step) == 1
    assert set(m_j) <= set(m_t)
    np.testing.assert_allclose(float(m_t["train_loss"]),
                               float(m_j["train_loss"]), rtol=2e-2)
    for k in m_j:
        if k not in ("train_loss", "f1"):
            assert int(m_t[k]) == int(m_j[k]), k
    assert float(m_t["f1"].total) == float(m_j["f1"].total) == 3
    want = pair.as_port(new_j.params)
    got = {k: v.detach().numpy()
           for k, v in state_t.model.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=2.5 * LR,
                                   err_msg=k)
    E = pair.n_edges
    before = np.asarray(pair.exp3_j, np.float32).reshape(2, -1)[:, :E]
    w_j = np.asarray(new_j.exp3_weights, np.float32).reshape(2, -1)[:, :E]
    w_t = _np(state_t.exp3_weights)[:, :E]
    assert np.any(w_j != before)  # the bandit learned
    assert np.all(np.abs(w_t - w_j) <= _bf16_ulp(w_j))


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_split_eval_halves_match_jax(monkeypatch, model):
    """``sample_fn`` with a validation generator, the fetch, ``eval_fn``:
    the same blocks and rows; f1 counts and n exactly, loss * n at rtol
    2e-2; the state as it was."""
    import jax

    pair = _Pair(model)
    j, t, state_j, state_t, halves_j, halves_t = _split_both(
        pair, monkeypatch, SEEDS, SMASK)
    _assert_same_sample(j, t)
    bj, _, xj, *_ = j
    bt, _, xt, _ = t
    with jax.disable_jit():
        f1_j, ln_j, n_j = halves_j[2](state_j, bj, xj, pair.dj)
    exp3 = state_t.exp3_weights.clone()
    f1_t, ln_t, n_t = halves_t[2](state_t, bt, xt)
    assert int(n_t) == int(n_j) == 3
    for f in ("tp", "fp", "fn", "total"):
        assert float(getattr(f1_t, f)) == float(getattr(f1_j, f)), f
    np.testing.assert_allclose(float(ln_t), float(ln_j), rtol=2e-2)
    assert state_t.step == 0 and torch.equal(state_t.exp3_weights, exp3)


# -- the chain of one --------------------------------------------------------


def _port_setup():
    from bliss_gnn_tpu_torch.graph import datasets as tdata
    from bliss_gnn_tpu_torch.graph import structure as tstruct
    from bliss_gnn_tpu_torch.sampling import block as tblock
    from bliss_gnn_tpu_torch.sampling import samplers as tsamp

    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, N_CLASSES, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    cfg = tsamp.SamplerConfig(kind=KIND, fanouts=FANOUTS)
    plan = tblock.CapacityPlan.build(BATCH, FANOUTS, gt.n_nodes, gt.n_edges,
                                     kind=KIND, frontier_slack=16.0)
    return dt, cfg, plan, gt.n_edges


def _port_state(n_edges, seed=0):
    """SAGE with dropout 0.5 (the generator feeds the dropout masks too),
    Adam, uniform arm weights."""
    from bliss_gnn_tpu_torch.models import gnn as tgnn
    from bliss_gnn_tpu_torch.sampling import samplers as tsamp
    from bliss_gnn_tpu_torch.train import steps as tsteps

    model = tgnn.build_model("sage", 16, HIDDEN, N_CLASSES, len(FANOUTS),
                             dropout=0.5, device="cpu", seed=seed)
    opt, sched = tsteps.make_optimizer(model.parameters(), 1e-2, 2,
                                       step_size=1)
    return tsteps.TrainState(
        model, opt, sched,
        tsamp.init_exp3_weights(len(FANOUTS), n_edges, device="cpu"),
        torch.Generator().manual_seed(seed))


def test_chains_of_one_equal_single_steps():
    """Three calls of the chained train step at K = 1 equal three single
    steps (metrics, parameters, Adam's state, arm weights, generator,
    rate); three chained evals at K = 1 equal three single evals."""
    from bliss_gnn_tpu_torch.train import steps as tsteps

    dt, cfg, plan, n_edges = _port_setup()
    rng = np.random.default_rng(5)
    seeds = torch.from_numpy(np.stack([rng.choice(200, BATCH, replace=False)
                                       for _ in range(3)]).astype(np.int32))
    mask = torch.ones((3, BATCH), dtype=torch.bool)
    mask[1, -1] = False
    single = tsteps.make_train_step(dt, cfg, plan, False, device="cpu")
    multi = tsteps.make_multi_train_step(dt, cfg, plan, False, device="cpu")
    s1, sk = _port_state(n_edges), _port_state(n_edges)
    for i in range(3):
        s1, m1 = single(s1, seeds[i], mask[i])
        sk, mk = multi(sk, seeds[i:i + 1], mask[i:i + 1])
        for key, v in mk.items():
            if key == "f1":
                for f in ("tp", "fp", "fn", "total"):
                    assert torch.equal(getattr(v, f),
                                       getattr(m1["f1"], f)[None]), f
            else:
                assert v.shape == (1,), key
                assert torch.equal(v, torch.as_tensor(m1[key])[None]
                                   .to(v.dtype)), key
    assert s1.step == sk.step == 3
    for (name, p), q in zip(s1.model.named_parameters(),
                            sk.model.parameters()):
        assert torch.equal(p, q), name
        for k, v in s1.optimizer.state[p].items():
            assert torch.equal(v, sk.optimizer.state[q][k]), (name, k)
    assert torch.equal(s1.exp3_weights, sk.exp3_weights)
    assert torch.equal(s1.generator.get_state(), sk.generator.get_state())
    assert s1.scheduler.get_last_lr() == sk.scheduler.get_last_lr()

    one = tsteps.make_eval_step(dt, cfg, plan, False, device="cpu")
    multi_eval = tsteps.make_multi_eval_step(dt, cfg, plan, False,
                                             device="cpu")
    gen_a = torch.Generator().manual_seed(11)
    gen_b = torch.Generator().manual_seed(11)
    for i in range(3):
        f1_a, ln_a, n_a = one(s1, gen_a, seeds[i], mask[i])
        f1_b, ln_b, n_b = multi_eval(s1, gen_b, seeds[i:i + 1],
                                     mask[i:i + 1])
        for f in ("tp", "fp", "fn", "total"):
            assert torch.equal(getattr(f1_a, f), getattr(f1_b, f)), f
        assert torch.equal(ln_a, ln_b) and torch.equal(n_a, n_b)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


def test_cpu_trainer_at_one_step_per_call_builds_no_chain(tmp_path):
    """On the CPU a trainer at ``steps_per_call = 1`` and
    ``eval_steps_per_call = 1`` runs every step and batch alone, as
    before; it trains."""
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(dataset="synth-small", fan_out=(32, 16), batch_size=32,
                      num_hidden=16, num_layers=2, num_steps=6,
                      eval_steps_per_call=1, logdir=str(tmp_path),
                      disable_checkpoint=True)
    tr = Trainer(cfg, device="cpu")
    assert tr.multi_step is None and tr.multi_eval is None
    assert not tr._replays
    tr.fit()
    assert tr.global_step == 6 and tr.multi_step is None


def test_uva_trainer_goes_with_its_last_reference(tmp_path):
    """A UVA trainer is in no reference cycle: its last reference dropped,
    it goes at once, its split halves (on the card their captured graphs)
    with it, with no collection run, so that none outlives the group whose
    collectives it holds. It trains and validates through its step
    functions first."""
    import gc
    import weakref

    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(dataset="synth-small", fan_out=(32, 16), batch_size=32,
                      num_hidden=16, num_layers=2, num_steps=4,
                      use_uva=True, cache_size=64, logdir=str(tmp_path),
                      disable_checkpoint=True)
    tr = Trainer(cfg, device="cpu")
    tr.fit()
    assert tr.global_step == 4
    trainer, half = weakref.ref(tr), weakref.ref(tr._uva_fns[0])
    gc.collect()
    gc.disable()
    try:
        del tr
        assert trainer() is None and half() is None
    finally:
        gc.enable()


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _card_training(dev):
    """A 3,000-node synthetic graph on the card without its features (in
    host memory), batch 32, fan-outs 256/128, poisson-bandit SAGE with
    dropout 0.1 and a capturable Adam whose rate halves every 3 steps."""
    from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
    from bliss_gnn_tpu_torch.graph.structure import (
        DeviceGraph, Graph, normalized_edata)
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig, init_exp3_weights)
    from bliss_gnn_tpu_torch.train import steps

    g, n_cls, _ = synthetic_graph(3000, 60000, 64, 7, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    bare = DeviceGraph.from_graph(g, device=dev, exclude=("features",))
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(256, 128))
    plan = CapacityPlan.build(32, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind, dense_candidates=False)

    def fresh():
        model = build_model("sage", 64, 32, n_cls, 2, dropout=0.1,
                            device=dev)
        opt, sched = steps.make_optimizer(model.parameters(), 1e-3, 1,
                                          gamma=0.5, step_size=3,
                                          capturable=True)
        return steps.TrainState(model, opt, sched,
                                init_exp3_weights(2, g.n_edges, device=dev),
                                torch.Generator(device=dev).manual_seed(0))

    return g, bare, cfg, plan, fresh


def _training_tensors(state):
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = p.detach().clone()
        for k, v in state.optimizer.state[p].items():
            out[f"{name}.{k}"] = v.detach().clone()
    return out


@pytest.mark.cuda
def test_replayed_split_steps_equal_eager_split_steps(dev):
    """2 x (CAPTURE_WARMUP_STEPS + 3) split steps (sample, fetch through a
    cold 500-row cache, train), replayed, against as many eager split
    steps from the same state: each step's blocks equal (the uniforms
    injected, dropout from the state's generator, registered with both
    graphs), losses within rtol 1e-5, parameters and Adam's state within
    rtol 1e-5 and 1e-6 of their largest magnitude, the arm weights within
    one bf16 ulp (rtol 2^-8): ``test_replayed_steps_equal_eager_steps``'
    bounds. Two captures (sample, train); the replays launch nothing
    through the wrappers."""
    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum
    from bliss_gnn_tpu_torch.train import steps

    g, bare, cfg, plan, fresh = _card_training(dev)
    host = np.asarray(g.ndata["features"], np.float32)
    n = 2 * (steps.CAPTURE_WARMUP_STEPS + 3)
    cpu_gen = torch.Generator().manual_seed(4)
    draws = [[torch.rand(c, generator=cpu_gen).to(dev) for c in plan.cand_caps]
             for _ in range(n)]
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.choice(3000, 32, replace=False)
                                .astype(np.int32)).to(dev) for _ in range(n)]
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    runs = {}
    for capture in (False, True):
        halves = steps.make_uva_steps(bare, cfg, plan, False, device=dev,
                                      capture=capture)
        cache = FeatureCache(host, 500, device=dev)
        st, losses, src = fresh(), [], []
        captures0 = steps._Replay.captures
        for i in range(n):
            if i == steps.CAPTURE_WARMUP_STEPS + 1:
                launched = segment_sum.launches
            blocks, _ = halves[0](st, batches[i], smask, draws=draws[i])
            src.append([b.src_gids.clone() for b in blocks])
            x, _ = cache.gather(blocks[0].src_gids, blocks[0].src_mask)
            st, m = halves[1](st, blocks, x)
            losses.append(float(m["train_loss"]))
        runs[capture] = dict(
            losses=losses, src=src, train=_training_tensors(st),
            exp3=st.exp3_weights.clone(), step=st.step,
            lr=float(st.optimizer.param_groups[0]["lr"]),
            captures=steps._Replay.captures - captures0,
            launches_after_capture=segment_sum.launches - launched)
    eager, replayed = runs[False], runs[True]
    assert eager["captures"] == 0 and replayed["captures"] == 2
    assert replayed["launches_after_capture"] == 0
    assert eager["launches_after_capture"] > 0
    assert replayed["step"] == eager["step"] == n
    for a, b in zip(replayed["src"], eager["src"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(replayed["losses"], eager["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert replayed["lr"] == eager["lr"]
    want = eager["train"]
    assert replayed["train"].keys() == want.keys()
    for name, w in want.items():
        atol = 1e-6 * float(w.abs().max()) if w.is_floating_point() else 0
        torch.testing.assert_close(replayed["train"][name], w, rtol=1e-5,
                                   atol=atol, msg=name)
    torch.testing.assert_close(replayed["exp3"].float(),
                               eager["exp3"].float(), rtol=2.0 ** -8, atol=0)


@pytest.mark.cuda
def test_alternating_train_and_validation_halves_capture_once(dev):
    """Rounds of a train split step then a validation batch (sample from a
    validation generator reseeded each round, fetch, eval): four graphs
    (train sample, validation sample, train, eval) captured once each,
    none again over the later rounds; each round's validation sums equal
    the eager halves' from a generator reseeded alike (n and the F1 total
    exactly, loss * n within rtol 1e-5), the state unchanged by them."""
    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
    from bliss_gnn_tpu_torch.train import steps

    g, bare, cfg, plan, fresh = _card_training(dev)
    host = np.asarray(g.ndata["features"], np.float32)
    replayed = steps.make_uva_steps(bare, cfg, plan, False, device=dev)
    eager = steps.make_uva_steps(bare, cfg, plan, False, device=dev,
                                 capture=False)
    cache = FeatureCache(host, 500, device=dev)
    st = fresh()
    rng = np.random.default_rng(2)
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    val_gen = torch.Generator(device=dev)
    eager_gen = torch.Generator(device=dev)
    captures0 = steps._Replay.captures
    warm = steps.CAPTURE_WARMUP_STEPS + 1
    for r in range(warm + 3):
        seeds = torch.from_numpy(rng.choice(3000, 32, replace=False)
                                 .astype(np.int32)).to(dev)
        blocks, _ = replayed[0](st, seeds, smask)
        x, _ = cache.gather(blocks[0].src_gids, blocks[0].src_mask)
        st, m = replayed[1](st, blocks, x)
        assert np.isfinite(float(m["train_loss"]))
        vseeds = torch.from_numpy(rng.choice(3000, 32, replace=False)
                                  .astype(np.int32)).to(dev)
        exp3 = st.exp3_weights.clone()
        out = {}
        for name, halves, gen in (("replayed", replayed, val_gen),
                                  ("eager", eager, eager_gen)):
            gen.manual_seed(100 + r)
            vb, _ = halves[0](st, vseeds, smask, generator=gen)
            vx, _ = cache.gather(vb[0].src_gids, vb[0].src_mask)
            f1, loss_n, n = halves[2](st, vb, vx)
            out[name] = (float(f1.total), float(loss_n), int(n))
        assert out["replayed"][0] == out["eager"][0] == 32
        assert out["replayed"][2] == out["eager"][2] == 32
        assert (abs(out["replayed"][1] - out["eager"][1])
                <= 1e-5 * abs(out["eager"][1]))
        assert torch.equal(st.exp3_weights, exp3)
        if r == warm - 1:
            assert steps._Replay.captures - captures0 == 4
    assert steps._Replay.captures - captures0 == 4


@pytest.mark.cuda
def test_trainer_at_one_step_per_call_replays_after_the_pilot(dev, tmp_path):
    """``Trainer`` at ``steps_per_call = 1`` (the CLI's default) on the
    card: 3 eager pilot steps, the refit, then 12 steps as chains of one,
    one captured train graph and one captured eval graph (10 validation
    batches: a chain of 8, then a shorter chain of 2); its losses against
    an eager trainer's from the same seed (the same pilot, then every
    step alone) within 2^-7 of max(|loss|, 1)."""
    from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
    from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata
    from bliss_gnn_tpu_torch.train import steps
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer

    g, n_cls, _ = synthetic_graph(3000, 60000, 64, 7, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)

    class Eager(Trainer):
        def _rebuild_steps(self):
            self._replays = False
            super()._rebuild_steps()

    def run(cls, sub):
        cfg = TrainConfig(model="sage", fan_out=(256, 128), batch_size=32,
                          num_hidden=32, num_layers=2, num_steps=15,
                          refit_after=3, refit_block_edge_slack=4.0,
                          refit_frontier_slack=4.0,
                          logdir=os.path.join(str(tmp_path), sub),
                          disable_checkpoint=True)
        tr = cls(cfg, graph=g, n_classes=n_cls, multilabel=False,
                 device=dev)
        losses = []
        log = tr.logger.log

        def logged(step, scalars):
            if "train_loss" in scalars:
                losses.append(scalars["train_loss"])
            log(step, scalars)

        tr.logger.log = logged
        c0 = steps._Replay.captures
        tr.fit()
        return tr, losses, steps._Replay.captures - c0

    tr, replayed, captures = run(Trainer, "replayed")
    assert tr._replays and tr.multi_step is not None
    assert tr.global_step == 15 and tr.n_widens == 0
    assert -(-len(tr.val_nid) // tr.batch_size) == 10
    assert captures == 2
    eager_tr, eager, _ = run(Eager, "eager")
    assert eager_tr.multi_step is None and eager_tr.global_step == 15
    assert len(replayed) == len(eager) == 15
    for a, b in zip(replayed, eager):
        assert abs(a - b) <= 2.0 ** -7 * max(abs(b), 1.0)
    assert all(np.isfinite(replayed))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["dp", "sharded"])
def test_replayed_split_steps_on_a_one_rank_nccl_mesh(dev, storage):
    """The halves over a one-rank NCCL mesh (``mesh.capturable``: the
    sampler stats' and metrics' all-reduces, the gradient all-reduce and
    the delta all-gather captured with the step), replicated (``dp``) or
    over range shards (``sharded``: graph sharding with UVA), replayed
    against the eager halves over the same mesh from one state,
    CAPTURE_WARMUP_STEPS + 3 steps: blocks equal, the bounds of
    ``test_replayed_split_steps_equal_eager_split_steps``."""
    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
    from bliss_gnn_tpu_torch.parallel import shardedstep as pss
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.train import steps

    g, bare, cfg, plan, fresh = _card_training(dev)
    host = np.asarray(g.ndata["features"], np.float32)
    n = steps.CAPTURE_WARMUP_STEPS + 3
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.choice(3000, 32, replace=False)
                                .astype(np.int32)).to(dev) for _ in range(n)]
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    mesh = make_mesh(1, device=dev)
    try:
        assert mesh.capturable
        graph, store, sg = bare, None, None
        if storage == "sharded":
            sg = pss.ShardedDeviceGraph.build(g, mesh, include_features=False)
            graph, store = pss._LocalView(sg), pss.sharded_storage(sg, 2)
        runs = {}
        for capture in (False, True):
            halves = steps.make_uva_steps(graph, cfg, plan, False,
                                          device=dev, mesh=mesh,
                                          storage=store, capture=capture)
            cache = FeatureCache(host, 500, device=dev)
            st = fresh()
            if sg is not None:
                st.exp3_weights = pss.init_exp3_shard(2, g.n_edges, mesh)
            losses, src = [], []
            c0 = steps._Replay.captures
            for seeds in batches:
                blocks, _ = halves[0](st, seeds, smask)
                src.append([b.src_gids.clone() for b in blocks])
                x, _ = cache.gather(blocks[0].src_gids, blocks[0].src_mask)
                st, m = halves[1](st, blocks, x)
                losses.append(float(m["train_loss"]))
            runs[capture] = dict(losses=losses, src=src,
                                 train=_training_tensors(st),
                                 exp3=st.exp3_weights.clone(),
                                 captures=steps._Replay.captures - c0)
    finally:
        mesh.close()
    eager, replayed = runs[False], runs[True]
    assert eager["captures"] == 0 and replayed["captures"] == 2
    for a, b in zip(replayed["src"], eager["src"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(replayed["losses"], eager["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, w in eager["train"].items():
        atol = 1e-6 * float(w.abs().max()) if w.is_floating_point() else 0
        torch.testing.assert_close(replayed["train"][name], w, rtol=1e-5,
                                   atol=atol, msg=name)
    torch.testing.assert_close(replayed["exp3"].float(),
                               eager["exp3"].float(), rtol=2.0 ** -8, atol=0)
