"""The port's full-graph ops (``ops/fullgraph.py``), the plain versions of
K6 and K7 and ``layerwise_inference`` against the JAX package, on the same
numpy inputs.

Tolerances: the chunked f32 ops rtol 1e-5; K6's plain version against the
banded Pallas SpMM in interpret mode and K7's against the banded Pallas
attention at the tolerances of ``test_spmm_pallas.py`` (the kernel's
one-hot contraction runs in bf16: relative Frobenius error 1e-2, rtol and
atol 6e-2) and ``test_gat_pallas.py`` (rtol and atol 2e-4); inference
rtol and atol 5e-3, as ``test_inference.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import structure as jstruct
from bliss_gnn_tpu.models import gnn as jgnn
from bliss_gnn_tpu.models import inference as jinf
from bliss_gnn_tpu.ops import fullgraph as jfull
from bliss_gnn_tpu.ops.gat_pallas import banded_gat_attention
from bliss_gnn_tpu.ops.spmm_pallas import (
    DeviceBandedLayout,
    build_banded_layout,
    spmm_via_pallas,
)
from bliss_gnn_tpu.sampling import block as jblock
from bliss_gnn_tpu.sampling import samplers as jsamp

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.models import inference as tinf
from bliss_gnn_tpu_torch.ops import fullgraph as tfull
from bliss_gnn_tpu_torch.ops.gat_attention import (
    gat_attention,
    gat_attention_plain,
    gat_plan,
)
from bliss_gnn_tpu_torch.ops.spmm import spmm, spmm_plain, spmm_plan

torch.set_num_threads(1)

CONVERT = {"sage": convert.sage_params_from_jax,
           "gcn": convert.gcn_params_from_jax,
           "gat": convert.gat_params_from_jax}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_graph(seed, n, e):
    """Both packages' graph of the same random edges; the last node has no
    in-edges."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 1, e)
    return jstruct.Graph(src, dst, n), tstruct.Graph(src, dst, n)


def _csc(g):
    return _t(g.csc_indptr.astype(np.int32)), _t(g.csc_src.astype(np.int32))


# -- chunked full-graph ops ----------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_full_spmm_sum_and_mean_match(weighted):
    gj, gt = _random_graph(0, 300, 2500)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 9)).astype(np.float32)
    w = rng.random(gj.n_edges).astype(np.float32) if weighted else None
    ip, src = _csc(gt)
    # a small chunk forces a dst's edges across chunk boundaries
    want = jfull.full_spmm_sum(jnp.asarray(x), jnp.asarray(gj.csc_indptr),
                               jnp.asarray(gj.csc_src), 300, gj.n_edges,
                               None if w is None else jnp.asarray(w),
                               chunk=128)
    got = tfull.full_spmm_sum(_t(x), ip, src, 300, gt.n_edges,
                              None if w is None else _t(w), chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = jfull.full_spmm_mean(jnp.asarray(x), jnp.asarray(gj.csc_indptr),
                                jnp.asarray(gj.csc_src), 300, gj.n_edges,
                                chunk=128)
    got = tfull.full_spmm_mean(_t(x), ip, src, 300, gt.n_edges, chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("h,o", [(4, 8), (1, 41)])
def test_full_gat_attention_matches(h, o):
    gj, gt = _random_graph(2, 400, 2000)
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(400, h, o)).astype(np.float32)
    attn = rng.normal(size=(1, h, o)).astype(np.float32)
    want = np.asarray(jfull.full_gat_attention(
        jnp.asarray(feat), jnp.asarray(attn), 0.2,
        jnp.asarray(gj.csc_indptr), jnp.asarray(gj.csc_src), 400,
        gj.n_edges, chunk=256))
    ip, src = _csc(gt)
    got = tfull.full_gat_attention(_t(feat), _t(attn), 0.2, ip, src, 400,
                                   gt.n_edges, chunk=256).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    no_in = np.diff(gt.csc_indptr) == 0
    assert no_in.any() and not got[no_in].any()


# -- K6 and K7: the plain versions against the Pallas kernels ----------------


def test_spmm_plain_matches_banded_pallas_interpret():
    gj, gt = _random_graph(4, 500, 4000)
    w = np.random.default_rng(5).random(gj.n_edges).astype(np.float32)
    layout = build_banded_layout(gj.csc_indptr, gj.csc_src, w,
                                 band=256, wr=64, et=256)
    x = np.random.default_rng(6).normal(size=(500, 130)).astype(np.float32)
    want = np.asarray(spmm_via_pallas(jnp.asarray(x),
                                      DeviceBandedLayout.from_host(layout),
                                      500, interpret=True))
    ip, src = _csc(gt)
    got = spmm_plain(_t(x), ip, src, _t(w)).numpy()
    # the kernel's one-hot contraction runs in bf16: compare in aggregate
    err = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9)
    assert err < 1e-2, f"relative frobenius error {err}"
    np.testing.assert_allclose(got, want, rtol=6e-2, atol=6e-2)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(spmm(_t(x), ip, src, _t(w)), _t(got))


@pytest.mark.parametrize("h,o", [(4, 8), (1, 41)])
def test_gat_attention_plain_matches_banded_pallas_interpret(h, o):
    n = 700 if h == 4 else 300
    gj, gt = _random_graph(7, n, 3000 if h == 4 else 1500)
    layout = build_banded_layout(gj.csc_indptr, gj.csc_src, None,
                                 band=256, wr=64, et=2048)
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(n, h, o)).astype(np.float32)
    attn = rng.normal(size=(1, h, o)).astype(np.float32)
    want = np.asarray(banded_gat_attention(
        jnp.asarray(feat), jnp.asarray(attn), 0.2,
        DeviceBandedLayout.from_host(layout), n, interpret=True))
    ip, src = _csc(gt)
    got = gat_attention_plain(_t(feat), _t(attn), 0.2, ip, src).numpy()
    has = np.diff(gt.csc_indptr) > 0
    np.testing.assert_allclose(got[has], want[has], rtol=2e-4, atol=2e-4)
    assert (~has).any() and not got[~has].any()  # zero in-degree: zeros
    assert torch.equal(gat_attention(_t(feat), _t(attn), 0.2, ip, src),
                       _t(got))


# -- the kernels' plans and K7's edge split ----------------------------------


@pytest.mark.parametrize("n,f,dtype,plan", [
    (232_965, 256, torch.bfloat16, (256, 64, 4)),  # 29.8 MB slices in L2
    (232_965, 41, torch.bfloat16, (48, 48, 1)),   # padded, one walk
    (232_965, 41, torch.float32, (44, 32, 2)),   # 41 MB: two slices
    (3000, 300, torch.bfloat16, (304, 256, 2)),   # at most 32 vectors
    (3000, 128, torch.float32, (128, 128, 1))])
def test_spmm_plan(n, f, dtype, plan):
    """K6's row padding, columns per slice and launches per call."""
    assert spmm_plan(n, f, dtype) == plan


@pytest.mark.parametrize("h,o,dtype,plan", [
    (4, 256, torch.bfloat16, (256, 2)), (1, 41, torch.bfloat16, (48, 8)),
    (2, 64, torch.float32, (64, 4)), (3, 41, torch.float32, (44, 4)),
    (8, 64, torch.bfloat16, (64, 8)), (16, 8, torch.float32, (8, 32)),
    (5, 16, torch.bfloat16, (16, 32))])
def test_gat_plan(h, o, dtype, plan):
    """K7's padded head width and edges a warp step."""
    assert gat_plan(h, o, dtype) == plan


def _merge(a, b):
    """K7's merge of two online-softmax states (m, den, acc), a first."""
    m = np.maximum(a[0], b[0])
    if np.isneginf(m).all():
        return a
    with np.errstate(invalid="ignore"):
        x, y = np.exp(a[0] - m), np.exp(b[0] - m)
    x, y = np.nan_to_num(x), np.nan_to_num(y)  # a side with no edges: 0
    return (np.where(np.isneginf(m), a[0], m), a[1] * x + b[1] * y,
            a[2] * x[:, None] + b[2] * y[:, None])


def _split_attention(feat, attn, slope, indptr, src, lanes):
    """Plain model of K7's edge split, per dst: lane group q of 32 // lanes
    takes edges q, q + 32 // lanes, ... of the dst (a step of the warp holds
    one edge a group). Each group leaves (m, den, acc) per head; the groups
    merge as the kernel's shuffles do (xor 1, 2, 4, ... groups)."""
    n, h, o = feat.shape
    p = 32 // lanes
    out = np.zeros((n, h, o))
    for d in range(n):
        rel = np.arange(indptr[d + 1] - indptr[d])
        s_ids = src[indptr[d]:indptr[d + 1]]
        z = feat[s_ids] + feat[d]
        e = (np.where(z >= 0, z, slope * z) * attn).sum(-1)  # [deg, h]
        groups = []
        for q in range(p):
            sel = rel % p == q
            if not sel.any():
                groups.append((np.full(h, -np.inf), np.zeros(h),
                               np.zeros((h, o))))
                continue
            m = e[sel].max(0)
            w = np.exp(e[sel] - m)
            groups.append((m, w.sum(0),
                           (w[..., None] * feat[s_ids[sel]]).sum(0)))
        k = 1
        while k < p:
            groups = [_merge(groups[q], groups[q ^ k]) for q in range(p)]
            k *= 2
        st = groups[0]
        out[d] = st[2] / np.maximum(st[1], np.finfo(np.float32).tiny)[:, None]
    return out


@pytest.mark.parametrize("h,o", [(1, 41), (4, 8), (2, 24)])
def test_split_attention_model_matches_jax(h, o):
    """K7's split of a dst's edges into per-group partial states, merged
    in the kernel's order, against the JAX package's full_gat_attention:
    rtol and atol 1e-5 (f64 model, f32 reference). Degrees up to 300 give
    every group many edges."""
    n = 90
    rng = np.random.default_rng(11)
    deg = rng.integers(0, 300, n)
    deg[::13] = 0
    src = rng.integers(0, n, int(deg.sum()))
    dst = np.repeat(np.arange(n), deg)
    gj = jstruct.Graph(src, dst, n)
    feat = rng.normal(size=(n, h, o)).astype(np.float32)
    attn = rng.normal(size=(1, h, o)).astype(np.float32)
    want = np.asarray(jfull.full_gat_attention(
        jnp.asarray(feat), jnp.asarray(attn), 0.2,
        jnp.asarray(gj.csc_indptr), jnp.asarray(gj.csc_src), n, gj.n_edges))
    step = gat_plan(h, o, torch.bfloat16)[1]  # edges a step: a group each
    got = _split_attention(feat.astype(np.float64), attn[0].astype(
        np.float64), 0.2, gj.csc_indptr, gj.csc_src, 32 // step)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[deg == 0].any()


# -- layerwise inference -------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(200, 1200, 16, 4, seed=7)[0])
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, 4, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    return gj, gt


@pytest.mark.parametrize("name,n_layers,residual", [
    ("sage", 2, False), ("gcn", 2, False), ("gat", 2, False),
    ("gat", 3, True)])
def test_layerwise_inference_matches(graphs, name, n_layers, residual):
    gj, gt = graphs
    dj = gj.to_device()
    fan = (2,) * n_layers
    plan = jblock.CapacityPlan.build(8, fan, gj.n_nodes, gj.n_edges,
                                     kind="ladies")
    blocks, _ = jsamp.sample_blocks(
        dj, jsamp.SamplerConfig(kind="ladies", fanouts=fan), plan,
        jax.random.PRNGKey(0), jnp.arange(8, dtype=jnp.int32),
        jnp.ones(8, bool))
    x = jnp.take(dj.ndata["features"].astype(jnp.float32),
                 blocks[0].src_gids, axis=0)
    kw = {"residual": residual} if name == "gat" else {}
    model_j = jgnn.build_model(name, 12, 4, n_layers, dropout=0.0,
                               dtype=jnp.float32, **kw)
    params = model_j.init(jax.random.PRNGKey(1), blocks, x)
    params = jax.tree.map(lambda p: p + 0.01, params)  # non-zero biases
    heads = (4,) * (n_layers - 1) + (1,)
    want = np.asarray(jinf.layerwise_inference(
        name, params, dj, n_layers, heads=heads, residual=residual,
        dtype=jnp.float32))
    model_t = tgnn.build_model(name, 16, 12, 4, n_layers, device="cpu",
                               **kw)
    model_t.load_state_dict(CONVERT[name](jax.tree.map(np.asarray, params)))
    model_t.eval()
    dt = tstruct.DeviceGraph.from_graph(gt, device="cpu")
    got = tinf.layerwise_inference(name, model_t, dt, n_layers,
                                   residual=residual, dtype=torch.float32)
    assert got.shape == (gt.n_nodes, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
