"""The port's GAT-side segment ops, K5's plain version, the GATv2 and GCN
layers and models, the GAT bandit reward and one fused GAT (and GCN) step
against the JAX package, on the same numpy inputs.

Weights go from the JAX side into the port through ``convert.py``; dropout
is 0, so both runs are deterministic; the sampler draws the JAX side makes
are recorded and fed to the port, as in ``test_torch_step.py``.
Tolerances: masks, indices and maxima exactly; f32 segment ops rtol 1e-5;
the bf16 models and the step rtol 2e-2 (bf16 compute, f32 sums in both);
K5's plain version against the Pallas kernel in interpret mode at f32
rtol 1e-5 (the kernel accumulates in f32 too)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import structure as jstruct
from bliss_gnn_tpu.models import gnn as jgnn
from bliss_gnn_tpu.models import layers as jlayers
from bliss_gnn_tpu.ops import rowscatter_pallas as jrow
from bliss_gnn_tpu.ops import segment as jseg
from bliss_gnn_tpu.sampling import block as jblock
from bliss_gnn_tpu.sampling import samplers as jsamp
from bliss_gnn_tpu.train import steps as jsteps

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.models import layers as tlayers
from bliss_gnn_tpu_torch.ops import segment as tseg
from bliss_gnn_tpu_torch.ops.rowscatter import (
    row_scatter_add,
    row_scatter_add_diff,
    row_scatter_add_plain,
)
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

FANOUTS, BATCH, HIDDEN, N_CLASSES = (16, 8), 4, 16, 4
CONVERT = {"gat": convert.gat_params_from_jax,
           "gcn": convert.gcn_params_from_jax}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32 if x.dtype == jnp.bfloat16 else None)


# -- segment ops ------------------------------------------------------------


def _edges(seed, e=300, s=400, shape=()):
    """Edge data, ids (a few out of range, several segments empty) and a
    mask."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(e,) + shape).astype(np.float32)
    ids = rng.integers(0, s, e).astype(np.int32)
    ids[:5] = [s, s + 7, -1, s, 2 * s]
    mask = rng.random(e) < 0.7
    return data, ids, mask, s


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_segment_max_matches(shape, masked):
    data, ids, mask, s = _edges(0, shape=shape)
    m = mask if masked else None
    want = jseg.masked_segment_max(jnp.asarray(data), jnp.asarray(ids), s,
                                   None if m is None else jnp.asarray(m))
    got = tseg.masked_segment_max(_t(data), _t(ids), s,
                                  None if m is None else _t(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()).any()  # empty segments: -inf


def test_gather_u_v_match():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 200).astype(np.int32)
    ids[:3] = [50, -2, 99]  # out of range reads NaN, as jnp.take does
    mask = rng.random(200) < 0.6
    mask[:2] = True
    for jf, tf in ((jseg.gather_u, tseg.gather_u),
                   (jseg.gather_v, tseg.gather_v)):
        for m in (None, mask):
            want = np.asarray(jf(jnp.asarray(x), jnp.asarray(ids),
                                 None if m is None else jnp.asarray(m)))
            got = tf(_t(x), _t(ids), None if m is None else _t(m)).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(), (4,)])
def test_copy_e_sum_matches(shape):
    data, ids, mask, s = _edges(2, shape=shape)
    ids = np.clip(ids, 0, s - 1)
    want = jseg.copy_e_sum(jnp.asarray(data), jnp.asarray(ids), s,
                           jnp.asarray(mask))
    got = tseg.copy_e_sum(_t(data), _t(ids), s, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(), (4,)])
def test_edge_softmax_and_grad_match(shape):
    data, ids, mask, s = _edges(3, s=60, shape=shape)
    ids = np.clip(ids, 0, s - 1)
    w = np.random.default_rng(4).normal(size=data.shape).astype(np.float32)

    def loss_j(x):
        return jnp.sum(jseg.edge_softmax(x, jnp.asarray(ids), s,
                                         jnp.asarray(mask)) * w)

    want = np.asarray(jseg.edge_softmax(jnp.asarray(data), jnp.asarray(ids),
                                        s, jnp.asarray(mask)))
    grad_j = np.asarray(jax.grad(loss_j)(jnp.asarray(data)))
    x = _t(data).requires_grad_()
    got = tseg.edge_softmax(x, _t(ids), s, _t(mask))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-7)
    assert not got.detach().numpy()[~mask].any()  # masked edges exactly 0
    np.testing.assert_allclose(x.grad.numpy(), grad_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(), (1,), (4,)])
def test_edge_softmax_sorted_route_matches(monkeypatch, shape):
    """A block's softmax (ids sorted by dst on the valid prefix, a hub of
    700 edges into one dst, the masked tail past ``n_valid``) against the
    JAX ``edge_softmax``, forward and gradient, at one head (1-D and [E,
    1]) and four: the denominator's gather goes through ``gather_rows``,
    whose backward is the sorted segment sum (K1 for one head, K3 for
    four), its promise checked by the plain versions."""
    rng = np.random.default_rng(5)
    s, e, nv = 90, 2000, 1700
    counts = rng.multinomial(nv - 700, np.ones(s - 1) / (s - 1))
    ids = np.zeros(e, np.int32)
    ids[:nv] = np.sort(np.concatenate([np.repeat(np.arange(1, s), counts),
                                       np.full(700, 40)]))
    mask = np.arange(e) < nv
    data = rng.normal(size=(e,) + shape).astype(np.float32)
    w = rng.normal(size=data.shape).astype(np.float32)

    def loss_j(x):
        return jnp.sum(jseg.edge_softmax(x, jnp.asarray(ids), s,
                                         jnp.asarray(mask)) * w)

    want = np.asarray(jseg.edge_softmax(jnp.asarray(data), jnp.asarray(ids),
                                        s, jnp.asarray(mask)))
    grad_j = np.asarray(jax.grad(loss_j)(jnp.asarray(data)))
    sums = []
    segsum = tseg.masked_segment_sum

    def spy(*args, **kw):
        sums.append((args[0].dim(), kw.get("ids_sorted", False)))
        return segsum(*args, **kw)

    monkeypatch.setattr(tseg, "masked_segment_sum", spy)
    x = _t(data).requires_grad_()
    got = tseg.edge_softmax(x, _t(ids), s, _t(mask),
                            n_valid=torch.tensor(nv, dtype=torch.int32),
                            ids_sorted=True)
    n_fwd = len(sums)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-7)
    assert not got.detach().numpy()[~mask].any()
    np.testing.assert_allclose(x.grad.numpy(), grad_j, rtol=1e-5, atol=1e-6)
    # the backward's sums: the gather's, sorted, 1-D for one head
    one_head = data.ndim == 1 or data.shape[1] == 1
    assert sums[n_fwd:] == [(1 if one_head else 2, True)]


# -- K5 ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype,n_valid,ordered", [
    pytest.param(np.float32, None, False, id="float32-None"),
    pytest.param(np.float32, 3100, False, id="float32-3100"),
    pytest.param("bf16", 4500, False, id="bf16-4500"),
    pytest.param(np.float32, 3100, True, id="float32-3100-sorted"),
    pytest.param("bf16", 4500, True, id="bf16-4500-sorted")])
def test_row_scatter_plain_matches_pallas_interpret(dtype, n_valid, ordered):
    """Unsorted ids, and dst-sorted ids with ``ids_sorted=True`` (the GATv2
    message sum's and er-gather backward's promise: a hub row of 700 ids,
    empty rows, ids at or past S in the tail past the prefix)."""
    rng = np.random.default_rng(5)
    e, f, s = 5000, 256, 300
    ids = rng.integers(0, s, e).astype(np.int32)  # unsorted
    if ordered:
        ids[:700] = 17  # a hub
        ids = np.sort(np.where(ids % 5 == 3, ids + 1, ids))  # empty rows
        ids[n_valid:] = s + rng.integers(0, 3, e - n_valid)
    data = rng.normal(size=(e, f)).astype(np.float32)
    if n_valid is not None:
        data[n_valid:] = 0.0  # the callers' promise: zeros past the prefix
    if dtype == "bf16":
        dj = jnp.asarray(data, jnp.bfloat16)
        dt = _t(data).to(torch.bfloat16)
    else:
        dj, dt = jnp.asarray(data), _t(data)
    nv = None if n_valid is None else jnp.int32(n_valid)
    want = np.asarray(jrow.banked_row_scatter_add(
        jnp.asarray(np.clip(ids, 0, s - 1)) if ordered else jnp.asarray(ids),
        dj, s, n_valid=nv, interpret=True))
    got = row_scatter_add(dt, _t(ids), s, n_valid=n_valid, ids_sorted=ordered)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if ordered:
        assert not got.numpy()[3::5].any()  # rows no id names read 0


def test_row_scatter_sorted_promise_is_checked_on_cpu():
    """A broken ``ids_sorted`` promise raises on a CPU tensor (on the card
    it would give wrong sums silently), and the flag needs ``n_valid``."""
    ids = torch.tensor([0, 2, 1, 3, 0, 0], dtype=torch.int32)
    data = torch.ones((6, 16))
    with pytest.raises(ValueError, match="decrease"):
        row_scatter_add(data, ids, 4, n_valid=4, ids_sorted=True)
    with pytest.raises(ValueError, match="needs n_valid"):
        row_scatter_add(data, ids, 4, ids_sorted=True)
    # the decrease lies past the prefix: the promise holds
    got = row_scatter_add(data, ids, 4, n_valid=2, ids_sorted=True)
    assert got.sum() == 2 * 16


@pytest.mark.parametrize("ordered", [False, True])
def test_row_scatter_bf16_out_is_f32_rounded_once(ordered):
    rng = np.random.default_rng(9)
    e, f, s, nv = 3000, 128, 97, 2600
    ids = rng.integers(-2, s + 2, e).astype(np.int32)
    if ordered:
        ids = np.sort(ids)
    data = _t(rng.normal(size=(e, f)).astype(np.float32)).to(torch.bfloat16)
    f32 = row_scatter_add(data, _t(ids), s, nv, ordered)
    got = row_scatter_add(data, _t(ids), s, nv, ordered,
                          out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    assert torch.equal(
        row_scatter_add_plain(data, _t(ids), s, nv, ordered, torch.bfloat16),
        got)


def test_row_scatter_drops_out_of_range_ids_and_dead_rows():
    rng = np.random.default_rng(6)
    ids = rng.integers(-3, 43, 500).astype(np.int32)
    data = rng.normal(size=(500, 16)).astype(np.float32)
    got = row_scatter_add_plain(_t(data), _t(ids), 40, n_valid=400).numpy()
    want = np.zeros((40, 16), np.float32)
    for i in range(400):
        if 0 <= ids[i] < 40:
            want[ids[i]] += data[i]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_row_scatter_grad_matches_jax(monkeypatch):
    monkeypatch.setattr(jrow, "INTERPRET", True)
    rng = np.random.default_rng(7)
    e, f, s = 4096, 128, 200
    ids = rng.integers(0, s, e).astype(np.int32)
    ids[:4] = s + 5  # dropped forward, zero gradient
    data = rng.normal(size=(e, f)).astype(np.float32)
    g = rng.normal(size=(s, f)).astype(np.float32)
    dj = jnp.asarray(data, jnp.bfloat16)
    _, vjp = jax.vjp(lambda d: jrow._row_scatter_diff(
        jnp.asarray(ids), d, jnp.full((1,), e, jnp.int32), s), dj)
    (want,) = vjp(jnp.asarray(g))
    dt = _t(data).to(torch.bfloat16).requires_grad_()
    (row_scatter_add_diff(dt, _t(ids), s) * _t(g)).sum().backward()
    assert dt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(dt.grad), _np(want))


@pytest.mark.parametrize("e,f,routed", [(1 << 15, 512, True),
                                        (1 << 15, 384, False),
                                        ((1 << 15) - 1, 1024, False)])
def test_wide_payloads_route_to_row_scatter(monkeypatch, e, f, routed):
    """K5 takes the wide payloads, with the caller's ``ids_sorted`` and
    the payload's dtype as its output dtype."""
    calls = []
    real = tseg.row_scatter_add_diff

    def spy(*args):
        calls.append((args[0].shape, args[4], args[5]))
        return real(*args)

    monkeypatch.setattr(tseg, "row_scatter_add_diff", spy)
    rng = np.random.default_rng(8)
    s = 64
    ids = rng.integers(0, s, e).astype(np.int32)
    data = rng.normal(size=(e, f)).astype(np.float32)
    mask = rng.random(e) < 0.9
    got = tseg.masked_segment_sum(_t(data), _t(ids), s, _t(mask))
    assert calls == [((e, f), False, torch.float32)] * int(routed)
    want = jseg.masked_segment_sum(jnp.asarray(data), jnp.asarray(ids), s,
                                   jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # dst-sorted ids on a valid prefix, bf16: the sorted route, bf16 out
    nv = e - 100
    ids_s = np.sort(ids[:nv])
    mask_s = np.arange(e) < nv
    calls.clear()
    got = tseg.masked_segment_sum(
        _t(data).to(torch.bfloat16), _t(np.concatenate([ids_s, ids[nv:]])),
        s, _t(mask_s), n_valid=nv, ids_sorted=True)
    assert calls == [((e, f), True, torch.bfloat16)] * int(routed)
    assert got.dtype == torch.bfloat16
    # the reference sums the same bf16 values in f32, then rounds once
    data_b = _np(_t(data[:nv]).to(torch.bfloat16))
    want = jseg.masked_segment_sum(jnp.asarray(data_b), jnp.asarray(ids_s), s)
    np.testing.assert_allclose(
        _np(got), _np(jnp.asarray(want).astype(jnp.bfloat16)),
        rtol=2 ** -7, atol=1e-5)


# -- layers, models, reward and the fused step --------------------------------


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
        plan_j=jblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0),
        plan_t=tblock.CapacityPlan.build(*args, kind=kind, frontier_slack=16.0),
        kind=kind, n_edges=gj.n_edges,
    )


def _cfgs(s, model):
    return (jsamp.SamplerConfig(kind=s["kind"], fanouts=FANOUTS, model=model),
            tsamp.SamplerConfig(kind=s["kind"], fanouts=FANOUTS, model=model))


def _record_draws(monkeypatch):
    draws = []
    bern = jsamp._bernoulli_select

    def bern_rec(key, p, cand_mask):
        draws.append(np.array(jax.random.uniform(key, p.shape, jnp.float32)))
        return bern(key, p, cand_mask)

    monkeypatch.setattr(jsamp, "_bernoulli_select", bern_rec)
    return draws


def _seeds():
    return np.arange(BATCH, dtype=np.int32), np.ones(BATCH, bool)


def _sample_both(s, monkeypatch, model="gat"):
    """The same blocks from both packages (the port fed the JAX draws)."""
    seeds, smask = _seeds()
    cfg_j, cfg_t = _cfgs(s, model)
    draws = _record_draws(monkeypatch)
    with jax.disable_jit():
        bj, _ = jsamp.sample_blocks(
            s["dj"], cfg_j, s["plan_j"], jax.random.PRNGKey(2),
            jnp.asarray(seeds), jnp.asarray(smask),
            jsamp.init_exp3_weights(2, s["n_edges"]))
    bt, _ = tsamp.sample_blocks(
        s["dt"], cfg_t, s["plan_t"], None, _t(seeds), _t(smask),
        tsamp.init_exp3_weights(2, s["n_edges"], device="cpu"),
        draws=[_t(d) for d in draws[::-1]])
    return bj, bt, cfg_j, cfg_t


def _port_state(params, convert_fn):
    return {k: v.numpy() for k, v in convert_fn(
        jax.tree.map(np.asarray, params)).items()}


def _assert_grads(model_t, grads_j, convert_fn):
    gj = _port_state(grads_j, convert_fn)
    assert set(gj) == {n for n, _ in model_t.named_parameters()}
    for name, p in model_t.named_parameters():
        scale = np.abs(gj[name]).max()
        np.testing.assert_allclose(p.grad.numpy(), gj[name], rtol=2e-2,
                                   atol=2e-2 * scale, err_msg=name)


@pytest.mark.parametrize("kind", ["gat", "gat_residual", "gcn_lin_before",
                                  "gcn_lin_after"])
def test_conv_layer_matches(setup, monkeypatch, kind):
    """One conv over the input-most block: output (and, for GATv2, the
    pre-softmax logits) and parameter gradients."""
    bj, bt, _, _ = _sample_both(setup, monkeypatch)
    block_j, block_t = bj[0], bt[0]
    rng = np.random.default_rng(9)
    in_feats = 12 if kind == "gcn_lin_before" else 8
    h = rng.normal(size=(block_t.n_src_cap, in_feats)).astype(np.float32)
    if kind.startswith("gat"):
        res = kind == "gat_residual"
        conv_j = jlayers.GATv2Conv(out_feats=4, num_heads=3, residual=res,
                                   activation=jax.nn.elu)
        conv_t = tlayers.GATv2Conv(in_feats, 4, 3, residual=res,
                                   activation=torch.nn.functional.elu)
    else:
        conv_j = jlayers.GraphConv(out_feats=10, activation=jax.nn.relu)
        conv_t = tlayers.GraphConv(in_feats, 10, activation=torch.relu)
    params = conv_j.init(jax.random.PRNGKey(3), block_j, jnp.asarray(h))
    params = jax.tree.map(lambda p: p + 0.05, params)  # non-zero biases

    def loss_j(p):
        out = conv_j.apply(p, block_j, jnp.asarray(h))
        rst = out[0] if isinstance(out, tuple) else out
        return jnp.sum(rst.astype(jnp.float32) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    # a single conv's params in the port's names: wrap as layer 0
    wrap = {"gatv2_layers_0" if kind.startswith("gat") else "layers_0":
            params["params"]}
    state = {k.split(".", 2)[2]: v for k, v in
             (convert.gat_params_from_jax if kind.startswith("gat")
              else convert.gcn_params_from_jax)(
                 jax.tree.map(np.asarray, wrap)).items()}
    conv_t.load_state_dict(state)
    out_t = conv_t(block_t, _t(h))
    rst_t = out_t[0] if isinstance(out_t, tuple) else out_t
    (rst_t.float() ** 2).sum().backward()
    rst_j = out_j[0] if isinstance(out_j, tuple) else out_j
    scale = np.abs(_np(rst_j)).max()
    np.testing.assert_allclose(_np(rst_t), _np(rst_j), rtol=2e-2,
                               atol=2e-2 * scale)
    if kind.startswith("gat"):  # the logits of the kept edges; 0 elsewhere
        m = np.asarray(block_j.e_mask)
        np.testing.assert_allclose(_np(out_t[1])[m], _np(out_j[1])[m],
                                   rtol=2e-2,
                                   atol=2e-2 * np.abs(_np(out_j[1])[m]).max())
        assert not _np(out_t[1])[~m].any()
    gwrap = {next(iter(wrap)): grads_j["params"]}
    gj = {k.split(".", 2)[2]: v.numpy() for k, v in
          (convert.gat_params_from_jax if kind.startswith("gat")
           else convert.gcn_params_from_jax)(
              jax.tree.map(np.asarray, gwrap)).items()}
    for name, p in conv_t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[name], rtol=2e-2,
                                   atol=2e-2 * np.abs(gj[name]).max(),
                                   err_msg=name)


def _model_pair(name, blocks_j, xj, residual=False):
    kw = dict(dropout=0.0)
    if name == "gat":
        kw.update(attn_drop=0.0, residual=residual)
    model_j = jgnn.build_model(name, HIDDEN, N_CLASSES, len(FANOUTS), **kw)
    params = model_j.init(jax.random.PRNGKey(0), blocks_j, xj)
    params = jax.tree.map(lambda p: p + 0.01, params)  # non-zero biases
    model_t = tgnn.build_model(name, 16, HIDDEN, N_CLASSES, len(FANOUTS),
                               device="cpu", **kw)
    model_t.load_state_dict(CONVERT[name](jax.tree.map(np.asarray, params)))
    return model_j, params, model_t


@pytest.mark.parametrize("name,residual", [("gat", False), ("gat", True),
                                           ("gcn", False)])
def test_model_forward_and_grads_match(setup, monkeypatch, name, residual):
    s = setup
    bj, bt, _, _ = _sample_both(s, monkeypatch, name)
    xj = jnp.take(s["dj"].ndata["features"], bj[0].src_gids, axis=0)
    labels = np.asarray(s["dj"].ndata["labels"])[np.asarray(bj[-1].dst_gids)]
    model_j, params, model_t = _model_pair(name, bj, xj, residual)

    def loss_j(p):
        logits, aux = model_j.apply(p, bj, xj)
        return jsteps.cross_entropy_loss(
            logits, jnp.asarray(labels), bj[-1].dst_mask, False), (logits, aux)

    (lj, (logits_j, aux_j)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(params)
    xt = s["dt"].ndata["features"][bt[0].src_gids.long()]
    logits_t, aux_t = model_t(bt, xt)
    lt = tsteps.cross_entropy_loss(logits_t, _t(labels), bt[-1].dst_mask,
                                   False)
    lt.backward()
    np.testing.assert_allclose(_np(logits_t), _np(logits_j), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-2)
    for nt, nj in zip(aux_t["embed_norms"], aux_j["embed_norms"]):
        np.testing.assert_allclose(_np(nt), _np(nj), rtol=2e-2, atol=1e-3)
    if name == "gat":
        for at, aj, b in zip(aux_t["a_ijs"], aux_j["a_ijs"], bj):
            assert at.dtype == torch.float32 and not at.requires_grad
            m = np.asarray(b.e_mask)
            np.testing.assert_allclose(
                _np(at)[m], _np(aj)[m], rtol=2e-2,
                atol=2e-2 * np.abs(_np(aj)[m]).max())
    else:
        assert aux_t["a_ijs"] is None
    _assert_grads(model_t, grads_j, CONVERT[name])


def test_gat_reward_matches(setup, monkeypatch):
    """The GAT alpha (attention ratio times the per-dst q sum) and the
    exponents, on the same blocks, logits and embedding norms; a dst whose
    logits sum to exactly 0 takes the nan_to_num branch."""
    s = setup
    bj, bt, cfg_j, cfg_t = _sample_both(s, monkeypatch)
    rng = np.random.default_rng(10)
    norms = [(rng.random(b.n_src_cap) * 3).astype(np.float32)
             * np.asarray(b.src_mask) for b in bj]
    a_ijs = [rng.normal(size=b.e_cap).astype(np.float32) for b in bj]
    e_dst, e_mask = np.asarray(bj[1].e_dst), np.asarray(bj[1].e_mask)
    a_ijs[1][(e_dst == 0) & e_mask] = 0.0
    with jax.disable_jit():
        dj = jsamp.exp3_edge_deltas(s["dj"], cfg_j, bj,
                                    [jnp.asarray(n) for n in norms],
                                    [jnp.asarray(a) for a in a_ijs])
    dt = tsamp.exp3_edge_deltas(s["dt"], cfg_t, bt,
                                [_t(n) for n in norms], [_t(a) for a in a_ijs])
    for (ej, rj), (et, rt) in zip(dj, dt):
        np.testing.assert_array_equal(_np(et), np.asarray(ej))
        np.testing.assert_allclose(_np(rt), np.asarray(rj), rtol=1e-5,
                                   atol=1e-8)
    assert any(np.asarray(rj).any() for _, rj in dj)
    with pytest.raises(ValueError, match="a_ij"):
        tsamp.exp3_edge_deltas(s["dt"], cfg_t, bt, [_t(n) for n in norms])
    with pytest.raises(ValueError, match="model"):
        tsamp.SamplerConfig(model="gin")


@pytest.mark.parametrize("name", ["gat", "gcn"])
def test_fused_step_matches(setup, monkeypatch, name):
    s = setup
    seeds, smask = _seeds()
    lr, spe = 1e-3, 10
    cfg_j, cfg_t = _cfgs(s, name)
    exp3_j = jsamp.init_exp3_weights(2, s["n_edges"])
    exp3_t = convert.exp3_from_jax(np.asarray(exp3_j, np.float32),
                                   s["n_edges"])
    with jax.disable_jit():
        b0, _ = jsamp.sample_blocks(s["dj"], cfg_j, s["plan_j"],
                                    jax.random.PRNGKey(9), jnp.asarray(seeds),
                                    jnp.asarray(smask), exp3_j)
    model_j, params, model_t = _model_pair(
        name, b0, jnp.take(s["dj"].ndata["features"], b0[0].src_gids, axis=0))

    draws = _record_draws(monkeypatch)
    tx = jsteps.make_optimizer(lr, spe)
    state_j = jsteps.TrainState(params=params, opt_state=tx.init(params),
                                exp3_weights=exp3_j,
                                key=jax.random.PRNGKey(3),
                                step=jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        step_j = jsteps.make_train_step(s["dj"], model_j, tx, cfg_j,
                                        s["plan_j"], False, donate=False)
        new_j, m_j = step_j(state_j, jnp.asarray(seeds), jnp.asarray(smask),
                            s["dj"])

    opt, sched = tsteps.make_optimizer(model_t.parameters(), lr, spe)
    state_t = tsteps.TrainState(model_t, opt, sched, exp3_t,
                                torch.Generator().manual_seed(0))
    step_t = tsteps.make_train_step(s["dt"], cfg_t, s["plan_t"], False,
                                    device="cpu")
    state_t, m_t = step_t(state_t, _t(seeds), _t(smask),
                          draws=[_t(d) for d in draws[::-1]])

    # the port's step adds each layer's Poisson fixed-point iteration count
    assert set(m_t) == set(m_j) | {f"poisson_iters/{l}"
                                   for l in range(len(FANOUTS))}
    np.testing.assert_allclose(float(m_t["train_loss"]),
                               float(m_j["train_loss"]), rtol=2e-2)
    for k in m_j:
        if k not in ("train_loss", "f1"):
            assert int(m_t[k]) == int(m_j[k]), k
    assert int(m_t["exp3_apply_overflow"]) == 0
    # Adam moves a parameter by about lr * sign(grad) on its first step: a
    # near-zero gradient whose sign differs between the two bf16 paths
    # moves it by up to 2 * lr, hence atol 2.5 * lr
    want = _port_state(new_j.params, CONVERT[name])
    got = {k: v.detach().numpy() for k, v in state_t.model.state_dict().items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=2.5 * lr,
                                   err_msg=k)
    E = s["n_edges"]
    want_exp3 = np.asarray(new_j.exp3_weights, np.float32).reshape(2, -1)[:, :E]
    assert np.any(want_exp3 != 1.0)
    np.testing.assert_allclose(_np(state_t.exp3_weights)[:, :E], want_exp3,
                               rtol=2e-2)
