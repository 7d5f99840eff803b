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
from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply
from bliss_gnn_tpu_torch.ops.gather import lut_gather
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
    over = exp3_apply(flat, _t(idx), _t(mult), limit)
    assert int(over) == 0
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
