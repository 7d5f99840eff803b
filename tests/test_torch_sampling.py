"""The port's graph, frontier and sampler layers against the JAX package on
the same numpy inputs. Index, mask and count outputs must match exactly,
float outputs to 1e-5. Random draws cannot match bit for bit across the
two frameworks, so the JAX side records the draws its selects make from
their keys (a wrapped ``_bernoulli_select`` / ``_gumbel_topk_select``) and
the port is fed the same draws."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import structure as jstruct
from bliss_gnn_tpu.models import gnn as jgnn
from bliss_gnn_tpu.sampling import block as jblock
from bliss_gnn_tpu.sampling import frontier as jfr
from bliss_gnn_tpu.sampling import samplers as jsamp
from bliss_gnn_tpu.train import steps as jsteps

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import frontier as tfr
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

LADIES = ["ladies", "poisson-ladies", "bandit", "poisson-bandit"]
INDEX_FIELDS = ("src_gids", "src_mask", "e_src", "e_dst", "e_mask", "eid")
FLOAT_FIELDS = ("e_weight", "e_q", "src_node_prob", "e_alpha")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32 if x.dtype == torch.bfloat16
                             else x.dtype).numpy()
    return np.asarray(x)


def _graphs(name):
    """The same canonicalised graph built by both packages."""
    if name == "toy":
        gj, gt = jdata.toy_graph()[0], tdata.toy_graph()[0]
    else:
        gj = jdata.synthetic_graph(200, 1200, 16, 4, seed=7)[0]
        gt = tdata.synthetic_graph(200, 1200, 16, 4, seed=7)[0]
    gj = jstruct.Graph.canonicalize(gj)
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(gt)
    gt.edata["w"] = tstruct.normalized_edata(gt)
    return gj, gt


@pytest.fixture(scope="module")
def synth_pair():
    return _graphs("small_synth")


# -- graph ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["toy", "small_synth"])
def test_graph_arrays_match(name):
    gj, gt = _graphs(name)
    for f in ("csc_indptr", "csc_src", "csr_indptr", "csr_dst", "csr_eid",
              "input_to_canonical_eid"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f), f)
    np.testing.assert_array_equal(gt.in_degrees(), gj.in_degrees())
    np.testing.assert_allclose(gt.edata["w"], gj.edata["w"], rtol=1e-6)
    for k in gj.ndata:
        np.testing.assert_array_equal(gt.ndata[k], gj.ndata[k], k)
    dj = gj.to_device()
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    np.testing.assert_array_equal(_np(dt.csc_indptr), np.asarray(dj.csc_indptr))
    np.testing.assert_array_equal(_np(dt.csc_src), np.asarray(dj.csc_src))
    np.testing.assert_array_equal(_np(dt.edata["w"]), np.asarray(dj.edata["w"]))
    np.testing.assert_array_equal(_np(dt.ndata["features"]),
                                  np.asarray(dj.ndata["features"], np.float32))


def test_canonicalize_undirected_matches():
    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(50, 300, 4, 3, seed=2)[0], undirected=True)
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(50, 300, 4, 3, seed=2)[0], undirected=True)
    assert gt.n_edges == gj.n_edges
    for f in ("csc_indptr", "csc_src", "csr_indptr", "csr_dst", "csr_eid"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f), f)


def test_weighted_normalized_edata_and_toy_fixture():
    gj, gt = jdata.toy_graph()[0], tdata.toy_graph()[0]
    for mw in (True, False):
        np.testing.assert_allclose(
            tstruct.normalized_edata(gt, "weight", mw),
            jstruct.normalized_edata(gj, "weight", mw), rtol=1e-6)


# -- frontier ---------------------------------------------------------------


def _seed_set(rng, n_nodes, n_seeds, n_masked):
    seeds = rng.choice(n_nodes, n_seeds, replace=False).astype(np.int32)
    mask = np.ones(n_seeds, bool)
    mask[rng.choice(n_seeds, n_masked, replace=False)] = False
    seeds[~mask] = 0
    return seeds, mask


def _frontiers(gj, gt, seeds, mask, e_cap, ck=None):
    dj = gj.to_device()
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    fj = jfr.gather_in_edges(dj.csc_indptr, dj.csc_src, jnp.asarray(seeds),
                             jnp.asarray(mask), e_cap, ck=ck)
    ft = tfr.gather_in_edges(dt.csc_indptr, dt.csc_src, torch.from_numpy(seeds),
                             torch.from_numpy(mask), e_cap, ck=ck)
    return fj, ft


@pytest.mark.parametrize("e_cap,ck", [(2048, None), (512, 8), (96, 8)])
def test_gather_in_edges_matches(synth_pair, e_cap, ck):
    """Includes a truncating capacity (96 slots)."""
    gj, gt = synth_pair
    seeds, mask = _seed_set(np.random.default_rng(0), gj.n_nodes, 24, 4)
    fj, ft = _frontiers(gj, gt, seeds, mask, e_cap, ck)
    for f in jfr.Frontier._fields:
        np.testing.assert_array_equal(_np(getattr(ft, f)),
                                      np.asarray(getattr(fj, f)), f)
    assert int(ft.n_valid_slots()) == int(fj.n_valid_slots())


def test_frontier_reductions_match(synth_pair):
    gj, gt = synth_pair
    seeds, mask = _seed_set(np.random.default_rng(1), gj.n_nodes, 16, 2)
    fj, ft = _frontiers(gj, gt, seeds, mask, 1024)
    vals = np.random.default_rng(2).random(1024).astype(np.float32)
    vals = np.where(np.asarray(fj.e_mask), vals, 0).astype(np.float32)
    np.testing.assert_allclose(
        _np(tfr.frontier_segment_sum(ft, torch.from_numpy(vals), 16)),
        np.asarray(jfr.frontier_segment_sum(fj, jnp.asarray(vals), 16)),
        rtol=1e-5)
    per_seed = np.arange(16, dtype=np.float32)
    np.testing.assert_array_equal(
        _np(tfr.frontier_seed_broadcast(ft, torch.from_numpy(per_seed))),
        np.asarray(jfr.frontier_seed_broadcast(fj, jnp.asarray(per_seed))))


@pytest.mark.parametrize("dense", [False, True])
def test_candidates_match(synth_pair, dense):
    gj, gt = synth_pair
    seeds, mask = _seed_set(np.random.default_rng(3), gj.n_nodes, 20, 3)
    fj, ft = _frontiers(gj, gt, seeds, mask, 1024)
    c_cap = 256 if dense else 128
    make_j = jfr.dense_candidates if dense else jfr.compact_candidates
    make_t = tfr.dense_candidates if dense else tfr.compact_candidates
    cj = make_j(jnp.asarray(seeds), jnp.asarray(mask), fj, c_cap, gj.n_nodes)
    ct = make_t(torch.from_numpy(seeds), torch.from_numpy(mask), ft, c_cap,
                gt.n_nodes)
    for f in jfr.Candidates._fields:
        a, b = getattr(ct, f), getattr(cj, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(_np(a), np.asarray(b), f)


@pytest.mark.parametrize("n_in,out_cap,p", [(300, 64, 0.3), (2048, 512, 0.2),
                                            (2048, 100, 0.5)])
def test_compact_by_mask_matches(n_in, out_cap, p):
    """The tiny scatter path, the gather-side path, and overflow."""
    m = np.random.default_rng(n_in + out_cap).random(n_in) < p
    want = jfr.compact_by_mask(jnp.asarray(m), out_cap)
    got = tfr.compact_by_mask(torch.from_numpy(m), out_cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# -- samplers ---------------------------------------------------------------


def _record_draws(monkeypatch):
    """Wrap the JAX selects so they record the draw each makes from its key
    (the wrapped function redraws the same values from the same key)."""
    draws = []
    bern, gumbel = jsamp._bernoulli_select, jsamp._gumbel_topk_select
    rank = jsamp._segment_rank

    def bern_rec(key, p, cand_mask):
        draws.append(np.array(jax.random.uniform(key, p.shape, jnp.float32)))
        return bern(key, p, cand_mask)

    def gumbel_rec(key, prob, cand_mask, k):
        draws.append(np.array(jax.random.gumbel(key, (prob.shape[0],),
                                                  jnp.float32)))
        return gumbel(key, prob, cand_mask, k)

    def rank_rec(dst_spos, key, e_mask):
        draws.append(np.array(jax.random.uniform(key, (dst_spos.shape[0],),
                                                 jnp.float32)))
        return rank(dst_spos, key, e_mask)

    monkeypatch.setattr(jsamp, "_bernoulli_select", bern_rec)
    monkeypatch.setattr(jsamp, "_gumbel_topk_select", gumbel_rec)
    monkeypatch.setattr(jsamp, "_segment_rank", rank_rec)
    return draws


def sample_both(gj, gt, kind, fanouts, batch, monkeypatch, key=0,
                dense=None, exp3_np=None, seeds=None, **cfg_kw):
    """Sample with both packages on the same draws (seeds 0..batch-1 unless
    ``seeds`` is given); ``cfg_kw`` goes to both SamplerConfigs. Returns
    (jax blocks, jax stats, port blocks, port stats, port graph, port EXP3
    state, cfgs)."""
    cfg_j = jsamp.SamplerConfig(kind=kind, fanouts=tuple(fanouts), **cfg_kw)
    cfg_t = tsamp.SamplerConfig(kind=kind, fanouts=tuple(fanouts), **cfg_kw)
    args = (batch, fanouts, gj.n_nodes, gj.n_edges)
    kw = dict(kind=kind, frontier_slack=16.0, dense_candidates=dense)
    plan_j = jblock.CapacityPlan.build(*args, **kw)
    plan_t = tblock.CapacityPlan.build(*args, **kw)
    assert dataclass_tuple(plan_t) == dataclass_tuple(plan_j)
    L = len(fanouts)
    exp3_j = exp3_t = None
    if cfg_j.is_bandit:
        exp3_j = jsamp.init_exp3_weights(L, gj.n_edges)
        if exp3_np is not None:
            exp3_j = jnp.asarray(exp3_np, jnp.bfloat16)
        exp3_t = convert.exp3_from_jax(np.asarray(exp3_j, np.float32),
                                       gj.n_edges)
    seeds = (np.arange(batch, dtype=np.int32) if seeds is None
             else np.asarray(seeds, np.int32))
    smask = np.ones(batch, bool)
    draws = _record_draws(monkeypatch)
    with jax.disable_jit():
        bj, sj = jsamp.sample_blocks(
            gj.to_device(), cfg_j, plan_j, jax.random.PRNGKey(key),
            jnp.asarray(seeds), jnp.asarray(smask), exp3_j)
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    per_block = [torch.from_numpy(d) for d in draws[::-1]]  # block order
    bt, st = tsamp.sample_blocks(
        dt, cfg_t, plan_t, None, torch.from_numpy(seeds),
        torch.from_numpy(smask), exp3_t, draws=per_block or None)
    return bj, sj, bt, st, dt, exp3_t, (cfg_j, cfg_t)


def dataclass_tuple(plan):
    return (plan.dst_caps, plan.extra_caps, plan.frontier_caps,
            plan.cand_caps, plan.block_e_caps, plan.dense_cands)


@pytest.mark.parametrize("kind,stats", [
    ("poisson-bandit", dict(deg_std=30.0, max_degree=900)),
    ("ladies", dict(dense_candidates=True)),
    ("bandit", dict(frontier_slack=2.0, max_frontier_edges=20_000)),
])
def test_capacity_plan_build_refit_widen_match(kind, stats):
    args = (256, (4096, 2048, 1024), 232_965, 114_848_857)
    pj = jblock.CapacityPlan.build(*args, kind=kind, **stats)
    pt = tblock.CapacityPlan.build(*args, kind=kind, **stats)
    assert dataclass_tuple(pt) == dataclass_tuple(pj)
    fr, be = [1_577_992, 666_832, 113_029], [57_605, 13_233, 1_882]
    pj, pt = pj.refit(fr, be, max_degree=900), pt.refit(fr, be,
                                                        max_degree=900)
    assert dataclass_tuple(pt) == dataclass_tuple(pj)
    for frontier in (False, True):
        assert (dataclass_tuple(pt.widen(1.5, frontier=frontier))
                == dataclass_tuple(pj.widen(1.5, frontier=frontier)))


def assert_blocks_match(bt, bj):
    for l, (b_t, b_j) in enumerate(zip(bt, bj)):
        assert b_t.n_dst_cap == b_j.n_dst_cap
        for f in INDEX_FIELDS:
            np.testing.assert_array_equal(
                _np(getattr(b_t, f)), np.asarray(getattr(b_j, f)),
                f"layer {l} {f}")
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(
                _np(getattr(b_t, f)), np.asarray(getattr(b_j, f)),
                rtol=1e-5, atol=1e-7, err_msg=f"layer {l} {f}")
        assert int(b_t.n_valid_edges()) == int(b_j.n_valid_edges())
        np.testing.assert_array_equal(_np(b_t.in_degrees()),
                                      np.asarray(b_j.in_degrees()))


@pytest.mark.parametrize("dense,importance", [(None, True), (False, True),
                                              (None, False)])
@pytest.mark.parametrize("kind", LADIES)
def test_sample_blocks_match(synth_pair, monkeypatch, kind, dense,
                             importance):
    """Dense and compact candidates; importance sampling on and off."""
    gj, gt = synth_pair
    bj, sj, bt, st, *_ = sample_both(gj, gt, kind, (16, 8), 4, monkeypatch,
                                     dense=dense,
                                     importance_sampling=importance)
    assert_blocks_match(bt, bj)
    assert set(st) == set(sj)
    for k in sj:
        assert int(st[k]) == int(sj[k]), k


def test_sample_blocks_repeated_seeds_match(synth_pair, monkeypatch):
    """A seed repeated in the batch (a batch drawn with replacement) is one
    candidate with several src slots: its edges point at the last slot, as
    the reference's scatter gives on the CPU (the port's ``amax`` scatter
    gives the same on the card, where a plain index write would leave the
    winning slot to the run)."""
    gj, gt = synth_pair
    seeds = [3, 11, 3, 40, 11, 3]
    bj, sj, bt, *_ = sample_both(gj, gt, "poisson-bandit", (16, 8), 6,
                                 monkeypatch, key=2, seeds=seeds)
    assert_blocks_match(bt, bj)
    top = bt[-1]
    used = set(top.e_src[top.e_mask].tolist())
    # slots 0-5 hold 3, 11, 3, 40, 11, 3; every seed's self-loop is kept
    assert {3, 4, 5} <= used and not {0, 1, 2} & used


def test_sample_blocks_bandit_nonuniform_weights(synth_pair, monkeypatch):
    """Arm weights away from 1 exercise the EXP3 edge probabilities."""
    gj, gt = synth_pair
    L, E = 2, gj.n_edges
    ones = np.asarray(jsamp.init_exp3_weights(L, E), np.float32)
    noise = np.random.default_rng(4).random(ones.shape).astype(np.float32)
    exp3_np = ones * (0.25 + 2 * noise)
    bj, _, bt, *_ = sample_both(gj, gt, "poisson-bandit", (16, 8), 4,
                                monkeypatch, key=3, exp3_np=exp3_np)
    assert_blocks_match(bt, bj)


def test_port_draws_its_own_coins(synth_pair):
    """Without injected draws the port samples from its generator:
    same seed, same blocks."""
    _, gt = synth_pair
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=(16, 8))
    plan = tblock.CapacityPlan.build(4, (16, 8), gt.n_nodes, gt.n_edges,
                                     kind=cfg.kind, frontier_slack=16.0)
    exp3 = tsamp.init_exp3_weights(2, gt.n_edges, device="cpu")
    seeds, smask = torch.arange(4, dtype=torch.int32), torch.ones(4, dtype=bool)
    runs = [tsamp.sample_blocks(dt, cfg, plan,
                                torch.Generator().manual_seed(5), seeds,
                                smask, exp3)[0] for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(_np(a.eid), _np(b.eid))


@pytest.mark.parametrize("kind", ["neighbor", "full"])
def test_neighbor_samplers_match(synth_pair, monkeypatch, kind):
    """k uniform in-edges per dst and every in-edge: indices, masks, unit
    weights and counts are the JAX sampler's, the rank's uniforms fed from
    its draws."""
    gj, gt = synth_pair
    fanouts = (4, 3) if kind == "neighbor" else (0, 0)
    bj, sj, bt, st, *_ = sample_both(gj, gt, kind, fanouts, 6, monkeypatch)
    assert_blocks_match(bt, bj)
    assert set(st) == set(sj)
    for k in sj:
        assert int(st[k]) == int(sj[k]), k
    kept, offered = (int(st["layer1/n_block_edges"]),
                     int(st["layer1/frontier_edges"]))
    assert kept < offered if kind == "neighbor" else kept == offered


def _port_blocks(gt, kind, fanouts, batch, seed=0):
    """The port's own blocks of seeds 0..batch-1, from its generator."""
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    cfg = tsamp.SamplerConfig(kind=kind, fanouts=fanouts)
    plan = tblock.CapacityPlan.build(batch, fanouts, gt.n_nodes, gt.n_edges,
                                     kind=kind, frontier_slack=16.0)
    seeds = torch.arange(batch, dtype=torch.int32)
    smask = torch.ones(batch, dtype=torch.bool)
    return tsamp.sample_blocks(dt, cfg, plan,
                               torch.Generator().manual_seed(seed), seeds,
                               smask)[0]


def test_neighbor_sampler_fanout_bound(synth_pair):
    """At most k kept in-edges per dst, and at least one wherever the graph
    has one (the reference's ``test_neighbor_sampler_fanout_bound``)."""
    _, gt = synth_pair
    indeg = gt.in_degrees()
    for l, b in enumerate(_port_blocks(gt, "neighbor", (4, 3), 6)):
        deg = _np(b.in_degrees())
        assert deg.max() <= (4, 3)[l]
        dst_gids, dst_mask = _np(b.dst_gids), _np(b.dst_mask)
        for i in np.where(dst_mask)[0]:
            if indeg[dst_gids[i]] > 0:
                assert deg[i] >= 1


def test_full_sampler_keeps_everything(synth_pair):
    _, gt = synth_pair
    b = _port_blocks(gt, "full", (0, 0), 6)[-1]
    np.testing.assert_array_equal(_np(b.in_degrees())[:6],
                                  gt.in_degrees()[:6])


@pytest.mark.parametrize("normalize,formula", [(False, False), (True, False),
                                               (False, True)])
def test_exp3_update_matches(synth_pair, monkeypatch, normalize, formula):
    """Constant and per-dst (the paper's formula) learning rates."""
    gj, gt = synth_pair
    L, E = 2, gj.n_edges
    bj, _, bt, _, dt, exp3_t, (cfg_j, cfg_t) = sample_both(
        gj, gt, "bandit", (16, 8), 4, monkeypatch, key=1,
        exp3_delta_formula=formula)
    rng = np.random.default_rng(6)
    norms = [(rng.random(b.n_src_cap) * 3).astype(np.float32)
             * np.asarray(b.src_mask) for b in bj]
    exp3_j = jsamp.init_exp3_weights(L, E)
    with jax.disable_jit():
        dj = jsamp.exp3_edge_deltas(gj.to_device(), cfg_j, bj,
                                    [jnp.asarray(n) for n in norms])
        want = jsamp.apply_exp3_deltas(exp3_j, dj, normalize=normalize)
    dtl = tsamp.exp3_edge_deltas(dt, cfg_t, bt,
                                 [torch.from_numpy(n) for n in norms])
    for (ej, rj), (et, rt) in zip(dj, dtl):
        np.testing.assert_array_equal(_np(et), np.asarray(ej))
        np.testing.assert_allclose(_np(rt), np.asarray(rj), rtol=1e-5,
                                   atol=1e-8)
    via_update = tsamp.exp3_update(dt, cfg_t, exp3_t.clone(), bt,
                                   [torch.from_numpy(n) for n in norms],
                                   normalize=normalize)
    got = tsamp.apply_exp3_deltas(exp3_t, dtl, normalize=normalize)
    assert torch.equal(via_update, got)
    assert any(np.asarray(rj).any() for _, rj in dj)
    want_le = np.asarray(want, np.float32).reshape(L, -1)[:, :E]
    # the paper's rate is too small to move a bf16 weight of 1 in one step
    assert formula or np.any(want_le != want_le[0, 0])
    # the JAX CPU path rounds the factor to bf16 before a bf16 multiply,
    # the port multiplies in f32 and rounds once: one bf16 ulp apart
    np.testing.assert_allclose(_np(got)[:, :E], want_le, rtol=2.0 ** -7)
    assert not _np(got)[:, E:].any()


# -- the sorted routes' promise on a sampled step -----------------------------

CONVERT = {"sage": convert.sage_params_from_jax,
           "gcn": convert.gcn_params_from_jax,
           "gat": convert.gat_params_from_jax}


def _spy(monkeypatch, module, name, record):
    """Wrap ``module.name`` so that each call's arguments and result are
    appended to ``record``."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        out = fn(*args, **kw)
        record.append((args, out))
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_sampled_step_is_dst_sorted_and_matches(synth_pair, monkeypatch,
                                                model):
    """One fused poisson-bandit step of each model, as the sorted routes of
    K1 and K3 see it: every block's ``e_dst`` and every frontier's chunk
    owners are non-decreasing on their valid prefixes, which hold only
    valid slots (the CPU step's plain versions also check each sorted
    call). Its blocks, loss and arm weights equal the JAX step's, the
    sampler fed the JAX draws (tolerances as in the step tests: bf16
    compute, rtol 2e-2)."""
    gj, gt = synth_pair
    fanouts, batch, hidden, n_cls, lr = (16, 8), 4, 16, 4, 1e-3
    kind, E = "poisson-bandit", gj.n_edges
    cfg_j = jsamp.SamplerConfig(kind=kind, fanouts=fanouts, model=model)
    cfg_t = tsamp.SamplerConfig(kind=kind, fanouts=fanouts, model=model)
    args = (batch, fanouts, gj.n_nodes, E)
    plan_j = jblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0)
    plan_t = tblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0)
    dj, dt = gj.to_device(), tstruct.DeviceGraph.from_graph(gt, device="cpu")
    seeds, smask = np.arange(batch, dtype=np.int32), np.ones(batch, bool)
    exp3_j = jsamp.init_exp3_weights(2, E)
    exp3_t = convert.exp3_from_jax(np.asarray(exp3_j, np.float32), E)
    with jax.disable_jit():
        b0, _ = jsamp.sample_blocks(dj, cfg_j, plan_j, jax.random.PRNGKey(9),
                                    jnp.asarray(seeds), jnp.asarray(smask),
                                    exp3_j)
    kw = dict(dropout=0.0, **({"attn_drop": 0.0} if model == "gat" else {}))
    model_j = jgnn.build_model(model, hidden, n_cls, 2, **kw)
    params = model_j.init(jax.random.PRNGKey(0), b0,
                          jnp.take(dj.ndata["features"], b0[0].src_gids,
                                   axis=0))
    model_t = tgnn.build_model(model, 16, hidden, n_cls, 2, device="cpu",
                               **kw)
    model_t.load_state_dict(CONVERT[model](jax.tree.map(np.asarray, params)))

    draws = _record_draws(monkeypatch)
    blocks_j, blocks_t, frontier_sums = [], [], []
    _spy(monkeypatch, jsteps, "sample_blocks", blocks_j)
    _spy(monkeypatch, tsteps, "sample_blocks", blocks_t)
    _spy(monkeypatch, tsamp, "frontier_segment_sum", frontier_sums)
    tx = jsteps.make_optimizer(lr, 10)
    state_j = jsteps.TrainState(params=params, opt_state=tx.init(params),
                                exp3_weights=exp3_j,
                                key=jax.random.PRNGKey(3),
                                step=jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        step_j = jsteps.make_train_step(dj, model_j, tx, cfg_j, plan_j, False,
                                        donate=False)
        new_j, m_j = step_j(state_j, jnp.asarray(seeds), jnp.asarray(smask),
                            dj)
    opt, sched = tsteps.make_optimizer(model_t.parameters(), lr, 10)
    state_t = tsteps.TrainState(model_t, opt, sched, exp3_t,
                                torch.Generator().manual_seed(0))
    step_t = tsteps.make_train_step(dt, cfg_t, plan_t, False, device="cpu")
    state_t, m_t = step_t(state_t, torch.from_numpy(seeds),
                          torch.from_numpy(smask),
                          draws=[torch.from_numpy(d) for d in draws[::-1]])

    (_, (bt, _)), = blocks_t
    for b in bt:
        nv = int(b.n_valid_edges())
        assert nv == int(b.num_edges()) > 0  # the prefix is all valid
        e_dst = _np(b.e_dst)[:nv]
        assert (np.diff(e_dst) >= 0).all()
    assert len(frontier_sums) == 2 * len(fanouts)  # EXP3 and importance
    for (frontier, _, _), _ in frontier_sums:
        nc = int(frontier.chunk_valid.sum())
        assert nc > 0 and not _np(frontier.chunk_valid)[nc:].any()
        assert (np.diff(_np(frontier.chunk_owner)[:nc]) >= 0).all()

    (_, (bj, _)), = blocks_j
    assert_blocks_match(bt, bj)
    np.testing.assert_allclose(float(m_t["train_loss"]),
                               float(m_j["train_loss"]), rtol=2e-2)
    for k in m_j:
        if k not in ("train_loss", "f1"):
            assert int(m_t[k]) == int(m_j[k]), k
    want = np.asarray(new_j.exp3_weights, np.float32).reshape(2, -1)[:, :E]
    assert np.any(want != 1.0)
    np.testing.assert_allclose(_np(state_t.exp3_weights)[:, :E], want,
                               rtol=2e-2)


@pytest.mark.parametrize("kind", ["neighbor", "full"])
def test_neighbor_step_is_dst_sorted_and_matches(synth_pair, monkeypatch,
                                                 kind):
    """One fused SAGE step with each per-dst kind, through the plain
    versions, whose sorted routes check the ``ids_sorted`` promise on the
    CPU: every block's ``e_dst`` is non-decreasing on its valid prefix,
    and the blocks and the loss are the JAX step's (rtol 2e-2: bf16
    compute)."""
    gj, gt = synth_pair
    fanouts = (4, 3) if kind == "neighbor" else (0, 0)
    batch, hidden, n_cls, lr = 6, 16, 4, 1e-3
    cfg_j = jsamp.SamplerConfig(kind=kind, fanouts=fanouts)
    cfg_t = tsamp.SamplerConfig(kind=kind, fanouts=fanouts)
    args = (batch, fanouts, gj.n_nodes, gj.n_edges)
    plan_j = jblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0)
    plan_t = tblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0)
    dj, dt = gj.to_device(), tstruct.DeviceGraph.from_graph(gt, device="cpu")
    seeds, smask = np.arange(batch, dtype=np.int32), np.ones(batch, bool)
    with jax.disable_jit():
        b0, _ = jsamp.sample_blocks(dj, cfg_j, plan_j, jax.random.PRNGKey(9),
                                    jnp.asarray(seeds), jnp.asarray(smask))
    model_j = jgnn.build_model("sage", hidden, n_cls, 2, dropout=0.0)
    params = model_j.init(jax.random.PRNGKey(0), b0,
                          jnp.take(dj.ndata["features"], b0[0].src_gids,
                                   axis=0))
    model_t = tgnn.build_model("sage", 16, hidden, n_cls, 2, dropout=0.0,
                               device="cpu")
    model_t.load_state_dict(CONVERT["sage"](jax.tree.map(np.asarray, params)))

    draws = _record_draws(monkeypatch)
    blocks_j, blocks_t = [], []
    _spy(monkeypatch, jsteps, "sample_blocks", blocks_j)
    _spy(monkeypatch, tsteps, "sample_blocks", blocks_t)
    tx = jsteps.make_optimizer(lr, 10)
    state_j = jsteps.TrainState(params=params, opt_state=tx.init(params),
                                exp3_weights=None, key=jax.random.PRNGKey(3),
                                step=jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        step_j = jsteps.make_train_step(dj, model_j, tx, cfg_j, plan_j, False,
                                        donate=False)
        _, m_j = step_j(state_j, jnp.asarray(seeds), jnp.asarray(smask), dj)
    opt, sched = tsteps.make_optimizer(model_t.parameters(), lr, 10)
    state_t = tsteps.TrainState(model_t, opt, sched, None,
                                torch.Generator().manual_seed(0))
    step_t = tsteps.make_train_step(dt, cfg_t, plan_t, False, device="cpu")
    _, m_t = step_t(state_t, torch.from_numpy(seeds), torch.from_numpy(smask),
                    draws=[torch.from_numpy(d) for d in draws[::-1]] or None)

    (_, (bt, _)), = blocks_t
    for b in bt:
        nv = int(b.n_valid_edges())
        assert nv == int(b.num_edges()) > 0  # the prefix is all valid
        assert (np.diff(_np(b.e_dst)[:nv]) >= 0).all()
    (_, (bj, _)), = blocks_j
    assert_blocks_match(bt, bj)
    np.testing.assert_allclose(float(m_t["train_loss"]),
                               float(m_j["train_loss"]), rtol=2e-2)
    for k in m_j:
        if k not in ("train_loss", "f1"):
            assert int(m_t[k]) == int(m_j[k]), k
