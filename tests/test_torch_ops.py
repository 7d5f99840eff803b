"""The port's kernel modules (K1-K4) and segment layer against the JAX
package: the same numpy inputs through the Pallas kernel (in interpret
mode, as the JAX package's own tests run it) and through the port's CPU
path, which is the plain PyTorch version of each CUDA kernel."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bliss_gnn_tpu.ops import segment as jseg
from bliss_gnn_tpu.ops import segsum_pallas
from bliss_gnn_tpu.ops.exp3_pallas import TILE_ROWS, exp3_apply_streaming
from bliss_gnn_tpu.ops.gather_pallas import lut_gather as jax_lut_gather
from bliss_gnn_tpu.ops.scatter_pallas import banked_scatter_add

from bliss_gnn_tpu_torch.ops import segment as tseg
from bliss_gnn_tpu_torch.ops._args import valid_arg
from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
from bliss_gnn_tpu_torch.ops.gather import (
    lut_gather,
    lut_gather_multi,
    lut_gather_multi_plain,
)
from bliss_gnn_tpu_torch.ops.scatter import scatter_add, scatter_add_diff
from bliss_gnn_tpu_torch.ops.segsum import segment_sum, segment_sum_diff

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative, at the bottom of a binade


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(t):
    return t.to(torch.float32).numpy()


# -- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [None, 2100])
def test_scatter_add_matches_banked_kernel(n_valid):
    rng = np.random.default_rng(0)
    e, n_out = 3000, 700
    keys = rng.integers(0, n_out, e).astype(np.int32)
    vals = rng.normal(size=e).astype(np.float32)
    if n_valid is not None:
        vals[n_valid:] = 0.0  # the callers' promise: zeros past the prefix
    nv = None if n_valid is None else jnp.int32(n_valid)
    want = np.asarray(banked_scatter_add(
        jnp.asarray(keys), jnp.asarray(vals), n_out, tile=1024,
        interpret=True, n_valid=nv))
    got = scatter_add(_t(keys), _t(vals), n_out, n_valid=n_valid).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_scatter_add_grad_is_gather():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 50, 400).astype(np.int32)
    vals = _t(rng.normal(size=400).astype(np.float32)).requires_grad_()
    w = rng.normal(size=50).astype(np.float32)
    (scatter_add_diff(_t(keys), vals, 50) * _t(w)).sum().backward()
    np.testing.assert_array_equal(vals.grad.numpy(), w[keys])


def _sorted_keys(rng, e, n_out, hub):
    """``e`` sorted int32 keys: ``hub`` copies of row 3 (more than half),
    the rest over the rows not divisible by 5 (every 5th row empty)."""
    rest = rng.integers(0, n_out // 5, e - hub) * 5 + rng.integers(1, 5,
                                                                     e - hub)
    return np.sort(np.concatenate([rest, np.full(hub, 3)])).astype(np.int32)


@pytest.mark.parametrize("n_valid", [0, 2100, 3000])
def test_scatter_add_sorted_matches_banked_kernel(n_valid):
    """The sorted route (on the CPU, its plain version, which checks the
    promise) against the JAX kernel: a hub row, empty rows, n_valid 0."""
    rng = np.random.default_rng(13)
    e, n_out = 3000, 700
    keys = _sorted_keys(rng, e, n_out, hub=1700)
    vals = rng.normal(size=e).astype(np.float32)
    keys[n_valid:], vals[n_valid:] = 0, 0.0  # the masked tail
    want = np.asarray(banked_scatter_add(
        jnp.asarray(keys), jnp.asarray(vals), n_out, tile=1024,
        interpret=True, n_valid=jnp.int32(n_valid)))
    got = scatter_add(_t(keys), _t(vals), n_out, n_valid=n_valid,
                      ids_sorted=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    assert not got[::5].any()
    via = tseg.masked_segment_sum(_t(vals), _t(keys), n_out,
                                  n_valid=n_valid, ids_sorted=True).numpy()
    np.testing.assert_array_equal(via, got)


@pytest.mark.parametrize("f,n_valid", [(128, 4096), (41, 3000), (41, 0)])
def test_segment_sum_sorted_matches_onehot_kernel(monkeypatch, f, n_valid):
    monkeypatch.setattr(segsum_pallas, "INTERPRET", True)
    rng = np.random.default_rng(14)
    e, s = 4096, 96
    ids = _sorted_keys(rng, e, s, hub=2200)
    data = rng.normal(size=(e, f)).astype(np.float32)
    ids[n_valid:], data[n_valid:] = 0, 0.0
    jd = jnp.asarray(data, jnp.bfloat16)
    want = np.asarray(segsum_pallas.onehot_segment_sum(
        jd, jnp.asarray(ids), jnp.int32(n_valid), s).astype(jnp.float32))
    td = _t(data).to(torch.bfloat16)
    got = segment_sum(td, _t(ids), s, n_valid=n_valid, ids_sorted=True)
    assert got.dtype == torch.bfloat16
    # bf16 rounding of the inputs and the sums; accumulation is f32 in both
    np.testing.assert_allclose(_bf16_np(got), want, rtol=2e-2, atol=2e-1)
    assert not _bf16_np(got)[::5].any()
    via = tseg.masked_segment_sum(td, _t(ids), s, n_valid=n_valid,
                                  ids_sorted=True)
    assert torch.equal(via, got)


def test_sorted_route_promise_is_checked():
    """ids_sorted needs n_valid on every route; on a CPU tensor the plain
    versions check that the ids do not decrease inside the prefix (and only
    there: the masked tail carries id 0)."""
    ids = _t(np.array([0, 2, 2, 5, 0, 0], np.int32))
    vals = torch.ones(6)
    rows = torch.ones(6, 4)
    with pytest.raises(ValueError, match="n_valid"):
        scatter_add(ids, vals, 6, ids_sorted=True)
    with pytest.raises(ValueError, match="n_valid"):
        segment_sum(rows, ids, 6, ids_sorted=True)
    with pytest.raises(ValueError, match="n_valid"):
        tseg.masked_segment_sum(vals, ids, 6, ids_sorted=True)
    assert scatter_add(ids, vals, 6, n_valid=4, ids_sorted=True).tolist() == [
        1, 0, 2, 0, 0, 1]
    with pytest.raises(ValueError, match="decrease"):
        scatter_add(ids, vals, 6, n_valid=5, ids_sorted=True)
    with pytest.raises(ValueError, match="decrease"):
        segment_sum(rows, ids, 6, n_valid=6, ids_sorted=True)


# -- K2 ---------------------------------------------------------------------


def test_lut_gather_int32_exact_above_2_24():
    rng = np.random.default_rng(2)
    lut = rng.integers(2 ** 24, 2 ** 31 - 1, size=4000).astype(np.int32)
    idx = rng.integers(0, 4000, size=2500).astype(np.int32)
    want = np.asarray(jax_lut_gather(jnp.asarray(lut), jnp.asarray(idx),
                                     interpret=True, elem_dtype=jnp.int32,
                                     flat2d=True))
    got = lut_gather(_t(lut), _t(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_gather_f32_and_valid_prefix():
    rng = np.random.default_rng(3)
    lut = rng.normal(size=5000).astype(np.float32)
    idx = rng.integers(0, 5000, size=3000).astype(np.int32)
    nv = 2049
    want = np.asarray(jax_lut_gather(jnp.asarray(lut), jnp.asarray(idx),
                                     interpret=True, n_valid=jnp.int32(nv)))
    got = lut_gather(_t(lut), _t(idx), n_valid=nv).numpy()
    # the TPU kernel zero-fills whole tiles past n_valid, the port every
    # slot past it: compare the valid prefix, then the port's zeros
    np.testing.assert_array_equal(got[:nv], want[:nv])
    assert not got[nv:].any()


def test_lut_gather_bool_matches_mxusel():
    rng = np.random.default_rng(4)
    lut = rng.random(3000) < 0.4
    idx = rng.integers(0, 3000, size=4100).astype(np.int32)
    nv = 4000
    want = np.asarray(jax_lut_gather(
        jnp.asarray(lut, jnp.float32), jnp.asarray(idx), interpret=True,
        mxusel=True, n_valid=jnp.int32(nv))) != 0
    got = lut_gather(_t(lut), _t(idx), n_valid=nv)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy()[:nv], want[:nv])


def _jax_take(lut, idx, nv):
    """The JAX package's lut_gather of one table, routed by dtype as its
    sampler routes it (bool through the MXU-select kernel, integers as int32,
    floats as f32; int64 as its two exact int32 halves). ``idx`` in range."""
    run = lambda a, **kw: np.asarray(jax_lut_gather(  # noqa: E731
        jnp.asarray(a), jnp.asarray(idx), interpret=True,
        n_valid=None if nv is None else jnp.int32(nv), **kw))
    if lut.dtype == np.bool_:
        return run(lut.astype(np.float32), mxusel=True) != 0
    if lut.dtype == np.int64:
        lo = run((lut & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                 elem_dtype=jnp.int32, flat2d=True)
        hi = run((lut >> 32).astype(np.int32), elem_dtype=jnp.int32,
                 flat2d=True)
        return (hi.astype(np.int64) << 32) | lo.view(np.uint32).astype(np.int64)
    if lut.dtype == np.int32:
        return run(lut, elem_dtype=jnp.int32, flat2d=True)
    return run(lut.astype(np.float32), flat2d=True)


def _mixed_tables(rng, lengths):
    """bool, bf16, int32 above 2^24, f32 and int64 above 2^32 tables."""
    n0, n1, n2, n3, n4 = lengths
    bf = rng.normal(size=n1).astype(np.float32)
    return [rng.random(n0) < 0.4,
            _t(bf).to(torch.bfloat16).float().numpy(),  # bf16-exact
            rng.integers(2 ** 24, 2 ** 31 - 1, size=n2).astype(np.int32),
            rng.normal(size=n3).astype(np.float32),
            rng.integers(2 ** 33, 2 ** 62, size=n4).astype(np.int64)]


@pytest.mark.parametrize("case", ["mixed_widths_n_valid", "lengths_differ",
                                  "out_of_range_ids"])
def test_lut_gather_multi_matches_jax(case):
    rng = np.random.default_rng(12)
    lengths = {"lengths_differ": (700, 3100, 1500, 4000, 257)}.get(
        case, (3000,) * 5)
    tables = _mixed_tables(rng, lengths)
    m, nv = 2600, (2049 if case == "mixed_widths_n_valid" else None)
    # ids past a short table's end read 0 from it alone
    lo, hi = {"lengths_differ": (0, max(lengths)),
              "out_of_range_ids": (-40, 3040)}.get(case, (0, 3000))
    idx = rng.integers(lo, hi, size=m).astype(np.int32)
    luts = [_t(t) for t in tables]
    luts[1] = luts[1].to(torch.bfloat16)
    got = lut_gather_multi(luts, _t(idx), n_valid=nv)
    plain = lut_gather_multi_plain(luts, _t(idx), n_valid=nv)
    assert len(got) == len(luts)
    prefix = m if nv is None else nv
    for t, lut, g, p in zip(tables, luts, got, plain):
        assert g.dtype == lut.dtype and g.shape == (m,)
        assert torch.equal(g, p)  # every slot, out-of-range ids included
        gn = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        inr = (idx >= 0) & (idx < t.shape[0])
        want = _jax_take(t, np.where(inr, idx, 0), nv)
        live = inr[:prefix]
        np.testing.assert_array_equal(gn[:prefix][live], want[:prefix][live])
        assert not gn[:prefix][~live].any()  # out of range: 0
        assert not gn[prefix:].any()  # past n_valid: 0


# -- K3 ---------------------------------------------------------------------


@pytest.mark.parametrize("f,n_valid", [(128, None), (128, 3000), (41, 3500)])
def test_segment_sum_matches_onehot_kernel(monkeypatch, f, n_valid):
    monkeypatch.setattr(segsum_pallas, "INTERPRET", True)
    rng = np.random.default_rng(5)
    e, s = 4096, 96
    data = rng.normal(size=(e, f)).astype(np.float32)
    if n_valid is not None:
        data[n_valid:] = 0.0
    ids = rng.integers(0, s, e).astype(np.int32)
    jd = jnp.asarray(data, jnp.bfloat16)
    nv = None if n_valid is None else jnp.int32(n_valid)
    want = np.asarray(segsum_pallas.onehot_segment_sum(
        jd, jnp.asarray(ids), nv, s).astype(jnp.float32))
    got = segment_sum(_t(data).to(torch.bfloat16), _t(ids), s,
                      n_valid=n_valid)
    assert got.dtype == torch.bfloat16
    # bf16 rounding of the inputs and the sums; accumulation is f32 in both
    np.testing.assert_allclose(_bf16_np(got), want, rtol=2e-2, atol=2e-1)


def test_segment_sum_grad_matches_onehot_vjp(monkeypatch):
    monkeypatch.setattr(segsum_pallas, "INTERPRET", True)
    rng = np.random.default_rng(6)
    e, f, s = 2048, 128, 64
    data = rng.normal(size=(e, f)).astype(np.float32)
    ids = rng.integers(0, s + 8, e).astype(np.int32)  # some out of range
    w = rng.normal(size=(s, f)).astype(np.float32)

    def loss(d):
        out = segsum_pallas.onehot_segment_sum(d, jnp.asarray(ids), None, s)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = np.asarray(jax.grad(loss)(
        jnp.asarray(data, jnp.bfloat16)).astype(jnp.float32))
    td = _t(data).to(torch.bfloat16).requires_grad_()
    (segment_sum_diff(td, _t(ids), s).float() * _t(w)).sum().backward()
    np.testing.assert_allclose(_bf16_np(td.grad), want, rtol=2e-2, atol=2e-2)


# -- K4 ---------------------------------------------------------------------


@pytest.mark.parametrize("dup", [False, True])
def test_exp3_apply_matches_streaming_kernel(dup):
    rng = np.random.default_rng(7)
    L, R = 1, TILE_ROWS
    limit = L * R * 128
    state = (rng.random((L, R, 128)) + 0.5).astype(np.float32)
    U = 600
    idx = rng.choice(limit, U, replace=False).astype(np.int32)
    if dup:
        idx[: U // 4] = idx[U // 4: U // 2]  # pairs compose
    idx[-50:] = limit  # no-op slots
    mult = (rng.random(U) * 0.5 + 0.75).astype(np.float32)
    want, n_over = exp3_apply_streaming(
        jnp.asarray(state, jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(mult), interpret=True)
    assert int(n_over) == 0
    flat = _t(state.reshape(-1)).to(torch.bfloat16)
    exp3_apply(flat, _t(idx), _t(mult), limit)
    want = np.asarray(want.astype(jnp.float32)).reshape(-1)
    np.testing.assert_allclose(_bf16_np(flat), want, rtol=BF16_ULP)


# -- segment layer ----------------------------------------------------------


def _edges(rng, e=500, n=40):
    ids = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    return ids, mask, n


def test_masked_segment_sum_1d_and_2d():
    rng = np.random.default_rng(8)
    ids, mask, n = _edges(rng)
    v1 = rng.normal(size=ids.shape[0]).astype(np.float32)
    want1 = np.asarray(jseg.masked_segment_sum(
        jnp.asarray(v1), jnp.asarray(ids), n, jnp.asarray(mask)))
    got1 = tseg.masked_segment_sum(_t(v1), _t(ids), n, _t(mask)).numpy()
    np.testing.assert_allclose(got1, want1, rtol=2e-5, atol=1e-5)
    v2 = rng.normal(size=(ids.shape[0], 24)).astype(np.float32)
    want2 = np.asarray(jseg.masked_segment_sum(
        jnp.asarray(v2, jnp.bfloat16), jnp.asarray(ids), n,
        jnp.asarray(mask)).astype(jnp.float32))
    got2 = tseg.masked_segment_sum(_t(v2).to(torch.bfloat16), _t(ids), n,
                                   _t(mask))
    np.testing.assert_allclose(_bf16_np(got2), want2, rtol=2e-2, atol=2e-1)


def test_segment_count_exact():
    rng = np.random.default_rng(9)
    ids, mask, n = _edges(rng)
    want = np.asarray(jseg.segment_count(jnp.asarray(ids), n,
                                         jnp.asarray(mask)))
    got = tseg.segment_count(_t(ids), n, _t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["u_mul_e_sum", "copy_u_sum", "segment_mean"])
def test_message_passing_ops_match(op):
    rng = np.random.default_rng(11)
    n_src, n_dst, e, f = 30, 12, 200, 8
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    e_src = rng.integers(0, n_src, e).astype(np.int32)
    e_dst = rng.integers(0, n_dst, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    mask = rng.random(e) < 0.8
    args = {
        "u_mul_e_sum": lambda c: (c(x), c(e_src), c(w), c(e_dst), n_dst,
                                  c(mask)),
        "copy_u_sum": lambda c: (c(x), c(e_src), c(e_dst), n_dst, c(mask)),
        "segment_mean": lambda c: (c(x[e_src]), c(e_dst), n_dst, c(mask)),
    }[op]
    want = np.asarray(getattr(jseg, op)(*args(jnp.asarray)))
    got = getattr(tseg, op)(*args(_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gather_rows_forward_and_grad():
    rng = np.random.default_rng(10)
    n_rows, f, e = 30, 16, 200
    x = rng.normal(size=(n_rows, f)).astype(np.float32)
    idx = rng.integers(0, n_rows + 5, e).astype(np.int32)  # some OOB
    nv = 150
    idx[nv:] = 0
    w = rng.normal(size=(e, f)).astype(np.float32)
    w[nv:] = 0.0  # consumers mask past the prefix

    def loss(xj):
        return jnp.sum(jseg._gather_rows(xj, jnp.asarray(idx), n_rows,
                                         jnp.int32(nv)) * w)

    jx = jnp.asarray(x)
    want_fwd = np.asarray(jseg._gather_rows(jx, jnp.asarray(idx), n_rows))
    want_grad = np.asarray(jax.grad(loss)(jx))
    tx = _t(x).requires_grad_()
    out = tseg.gather_rows(tx, _t(idx), n_rows, n_valid=nv)
    np.testing.assert_array_equal(out.detach().numpy(), want_fwd)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-5)


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        scatter_add(torch.zeros(4, dtype=torch.int32, device="meta"), meta, 3)
    with pytest.raises(ValueError):
        lut_gather(meta, torch.zeros(2, dtype=torch.int32, device="meta"))


def test_valid_arg_takes_one_element():
    cpu = torch.device("cpu")
    one = torch.tensor([7], dtype=torch.int32)
    assert valid_arg(one, cpu) is one
    assert valid_arg(torch.tensor(7), cpu).tolist() == [7]
    with pytest.raises(ValueError):
        valid_arg(torch.tensor([7, 9], dtype=torch.int32), cpu)
