"""The port's seven CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so without a GPU these tests skip;
run them on one with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply, exp3_apply_plain
from bliss_gnn_tpu_torch.ops.gat_attention import (
    gat_attention,
    gat_attention_plain,
)
from bliss_gnn_tpu_torch.ops.gather import (
    lut_gather,
    lut_gather_multi,
    lut_gather_multi_plain,
    lut_gather_plain,
)
from bliss_gnn_tpu_torch.ops.rowscatter import (
    row_scatter_add,
    row_scatter_add_diff,
    row_scatter_add_plain,
)
from bliss_gnn_tpu_torch.ops.scatter import scatter_add, scatter_add_plain
from bliss_gnn_tpu_torch.ops.segsum import (
    segment_sum,
    segment_sum_diff,
    segment_sum_plain,
)
from bliss_gnn_tpu_torch.ops import spmm as spmm_mod
from bliss_gnn_tpu_torch.ops.spmm import spmm, spmm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("n_valid", [None, 70_000])
def test_scatter_add_kernel(dev, gen, n_valid):
    keys = torch.randint(0, 5000, (100_000,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randn(100_000, generator=gen, device=dev)
    before = scatter_add.launches
    got = scatter_add(keys, vals, 5000, n_valid)
    assert scatter_add.launches == before + 1
    want = scatter_add_plain(keys, vals, 5000, n_valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bool, torch.bfloat16, torch.int32,
                                   torch.float32, torch.int64])
def test_lut_gather_kernel(dev, gen, dtype):
    lut = torch.randint(0, 2 ** 30, (9000,), generator=gen, device=dev)
    lut = (lut % 2 == 0) if dtype == torch.bool else lut.to(dtype)
    idx = torch.randint(-5, 9005, (50_000,), generator=gen, device=dev,
                        dtype=torch.int32)  # some out of range
    got = lut_gather(lut, idx, n_valid=40_000)
    assert got.dtype == dtype
    assert torch.equal(got, lut_gather_plain(lut, idx, n_valid=40_000))


_MIXED = (torch.bool, torch.bfloat16, torch.int32, torch.float32, torch.int64,
          torch.int16, torch.uint8, torch.float64)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_lut_gather_multi_kernel(dev, gen, k):
    """k tables of mixed widths and lengths in one launch, bitwise against
    the per-table plain version; odd k reads ids from an unaligned view."""
    luts = []
    for s in range(k):
        n = 3000 + 1500 * s
        raw = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen,
                            device=dev)
        dtype = _MIXED[s]
        if dtype == torch.bool:
            luts.append(raw % 2 == 0)
        elif dtype.is_floating_point:
            luts.append((raw % 10_000).to(dtype) / 7)
        else:
            luts.append(raw.to(dtype))  # wraps: every bit pattern counts
    ids = torch.randint(-5, 3000 + 1500 * k, (50_003,), generator=gen,
                        device=dev, dtype=torch.int32)
    idx = ids[1:] if k % 2 else ids[:50_001]
    for n_valid in (None, 37_777):
        before = lut_gather.launches
        got = lut_gather_multi(luts, idx, n_valid=n_valid)
        assert lut_gather.launches == before + 1
        want = lut_gather_multi_plain(luts, idx, n_valid=n_valid)
        for g, w, t in zip(got, want, luts):
            assert g.dtype == t.dtype and g.shape == idx.shape
            assert torch.equal(g, w)


@pytest.mark.parametrize("f,dtype", [(256, torch.bfloat16),
                                     (41, torch.bfloat16),
                                     (41, torch.float32)])
def test_segment_sum_kernel(dev, gen, f, dtype):
    ids = torch.randint(-2, 300, (20_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    data = torch.randn((20_000, f), generator=gen, device=dev).to(dtype)
    got = segment_sum(data, ids, 298, n_valid=15_000).float()
    want = segment_sum_plain(data, ids, 298, n_valid=15_000).float()
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-3)


def test_segment_sum_grad_is_row_gather(dev, gen):
    ids = torch.randint(0, 80, (5000,), generator=gen, device=dev,
                        dtype=torch.int32)
    data = torch.randn((5000, 64), generator=gen, device=dev,
                       dtype=torch.bfloat16).requires_grad_()
    w = torch.randn((80, 64), generator=gen, device=dev)
    (segment_sum_diff(data, ids, 80).float() * w).sum().backward()
    torch.testing.assert_close(data.grad.float(),
                               w[ids.long()].to(torch.bfloat16).float())


def test_exp3_apply_kernel(dev, gen):
    limit = 1 << 20
    idx = torch.randint(0, limit, (30_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:5000] = idx[5000:10_000]  # duplicates compose
    idx[-3000:] = limit  # no-op slots
    mult = torch.exp(torch.rand(30_000, generator=gen, device=dev) * 0.5)
    state = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    ref = state.clone()
    exp3_apply(state, idx, mult, limit)
    exp3_apply_plain(ref, idx, mult, limit)
    torch.testing.assert_close(state.float(), ref.float(), rtol=2.0 ** -7,
                               atol=0.0)


def _exp3_inputs(gen, dev, limit, u):
    state = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    mult = torch.exp(torch.rand(u, generator=gen, device=dev) * 0.5)
    return state, mult


def _bf16_ulp(x):
    """One bf16 ulp at each value of the bf16 tensor ``x``."""
    _, e = torch.frexp(x.float())  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def test_exp3_apply_distinct_is_bitwise(dev, gen):
    limit = 1 << 21
    idx = torch.randperm(limit, generator=gen, device=dev)[:120_000].to(
        torch.int32)
    idx[::5] = limit + 7  # no-op slots
    idx[1::97] = -1
    state, mult = _exp3_inputs(gen, dev, limit, idx.shape[0])
    ref = state.clone()
    before = exp3_apply.launches
    exp3_apply(state, idx, mult, limit)
    assert exp3_apply.launches == before + 1
    exp3_apply_plain(ref, idx, mult, limit)
    assert torch.equal(state, ref)


def test_exp3_apply_duplicates_within_m_minus_1_ulps(dev, gen):
    """Each index 1 to 8 times: every update rounds, in the card's order,
    so an entry updated m times is within m - 1 ulps of one rounding."""
    limit = 1 << 20
    base = torch.randperm(limit, generator=gen, device=dev)[:20_000]
    reps = torch.randint(1, 9, (base.shape[0],), generator=gen, device=dev)
    idx = base.repeat_interleave(reps)
    idx = idx[torch.randperm(idx.shape[0], generator=gen, device=dev)].to(
        torch.int32)
    state, mult = _exp3_inputs(gen, dev, limit, idx.shape[0])
    ref = state.clone()
    exp3_apply(state, idx, mult, limit)
    exp3_apply_plain(ref, idx, mult, limit)
    m = torch.zeros(limit, dtype=torch.float32, device=dev)
    m.index_add_(0, idx.long(), torch.ones_like(mult))
    ulp = torch.maximum(_bf16_ulp(state), _bf16_ulp(ref))
    diff = (state.float() - ref.float()).abs()
    assert (diff <= (m - 1).clamp(min=0) * ulp).all()
    assert torch.equal(state[m == 0], ref[m == 0])
    assert int(m.max()) == 8


def test_exp3_apply_all_noop_leaves_state(dev, gen):
    limit = 1 << 16
    idx = torch.full((5000,), limit, dtype=torch.int32, device=dev)
    idx[::2] = -3
    state, mult = _exp3_inputs(gen, dev, limit, idx.shape[0])
    before = state.clone()
    exp3_apply(state, idx, mult, limit)
    assert torch.equal(state, before)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    exp3_apply(state, empty, mult[:0], limit)
    assert torch.equal(state, before)


@pytest.mark.parametrize("dtype,n_valid", [(torch.bfloat16, None),
                                           (torch.bfloat16, 30_001),
                                           (torch.float32, 12_345)])
def test_row_scatter_kernel(dev, gen, dtype, n_valid):
    # unsorted ids, some outside [0, S); zero rows issue no atomic
    ids = torch.randint(-3, 3003, (40_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    data = torch.randn((40_000, 1024), generator=gen, device=dev).to(dtype)
    data[::7] = 0
    before = row_scatter_add.launches
    got = row_scatter_add(data, ids, 3000, n_valid)
    assert row_scatter_add.launches == before + 1
    assert got.dtype == torch.float32
    want = row_scatter_add_plain(data, ids, 3000, n_valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_row_scatter_grad_is_row_gather(dev, gen):
    ids = torch.randint(0, 90, (5000,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[:10] = 95  # out of range: zero gradient
    data = torch.randn((5000, 512), generator=gen, device=dev,
                       dtype=torch.bfloat16).requires_grad_()
    w = torch.randn((90, 512), generator=gen, device=dev)
    (row_scatter_add_diff(data, ids, 90) * w).sum().backward()
    want = w[ids.clamp(max=89).long()].to(torch.bfloat16)
    want[:10] = 0
    assert torch.equal(data.grad, want)


def _csc(gen, dev, n, hub):
    """Random CSC arrays: in-degrees 0-39 with every 97th row empty and one
    hub row, srcs uniform, EDGE_PAD zeros past the last edge."""
    deg = torch.randint(0, 40, (n,), generator=gen, device=dev)
    deg[::97] = 0
    deg[5] = hub
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    e = int(indptr[-1])
    src = torch.randint(0, n, (e + 128,), generator=gen, device=dev,
                        dtype=torch.int32)
    src[e:] = 0
    return indptr, src, e


@pytest.mark.parametrize("f,dtype,weighted", [(256, torch.bfloat16, False),
                                              (41, torch.bfloat16, False),
                                              (41, torch.float32, True),
                                              (128, torch.float32, False),
                                              (300, torch.bfloat16, True),
                                              (300, torch.float32, False)])
def test_spmm_kernel(dev, gen, f, dtype, weighted):
    """Any F (300 pads to 304 bf16 columns and takes two slices, f32
    three), a hub row of 30,000 edges, one launch per slice; two calls give
    the same bits (no atomics)."""
    indptr, src, e = _csc(gen, dev, 3000, hub=30_000)
    x = torch.randn((3000, f), generator=gen, device=dev).to(dtype)
    w = torch.rand(e, generator=gen, device=dev) if weighted else None
    before = spmm.launches
    got = spmm(x, indptr, src, w)
    assert spmm.launches == before + spmm_mod.spmm_plan(3000, f, dtype)[2]
    want = spmm_plain(x, indptr, src, w)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    assert not got[::97].any()  # rows without in-edges
    assert torch.equal(spmm(x, indptr, src, w), got)


@pytest.mark.parametrize("slice_cols", [8, 32, 64, 128])
def test_spmm_kernel_column_slices(dev, gen, monkeypatch, slice_cols):
    """F = 256 cut into L2 slices of 8 to 128 bf16 columns, one launch
    each, against the plain version."""
    indptr, src, e = _csc(gen, dev, 3000, hub=30_000)
    monkeypatch.setattr(spmm_mod, "L2_SLICE_BYTES", 3000 * 2 * slice_cols)
    assert spmm_mod.spmm_plan(3000, 256, torch.bfloat16) == (
        256, slice_cols, 256 // slice_cols)
    x = torch.randn((3000, 256), generator=gen, device=dev).to(torch.bfloat16)
    before = spmm.launches
    got = spmm(x, indptr, src)
    assert spmm.launches == before + 256 // slice_cols
    torch.testing.assert_close(got, spmm_plain(x, indptr, src), rtol=1e-4,
                               atol=1e-3)
    assert torch.equal(spmm(x, indptr, src), got)


@pytest.mark.parametrize("h,o,dtype", [(4, 256, torch.bfloat16),
                                       (1, 41, torch.bfloat16),
                                       (2, 64, torch.float32),
                                       (3, 41, torch.float32),
                                       (8, 64, torch.bfloat16),
                                       (1, 300, torch.bfloat16),
                                       (1, 500, torch.float32),
                                       (16, 8, torch.float32)])
def test_gat_attention_kernel(dev, gen, h, o, dtype):
    """Every lane-group width (1 to 32 lanes, 2 and 4 chunks), 1 to 16
    heads, a hub row of 30,000 edges; two calls give the same bits."""
    indptr, src, _ = _csc(gen, dev, 2000, hub=30_000)
    feat = torch.randn((2000, h, o), generator=gen, device=dev).to(dtype)
    attn = torch.randn((1, h, o), generator=gen, device=dev) / o ** 0.5
    before = gat_attention.launches
    got = gat_attention(feat, attn, 0.2, indptr, src)
    assert gat_attention.launches == before + 1
    want = gat_attention_plain(feat, attn, 0.2, indptr, src)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[::97].any()  # zero in-degree: zeros
    assert torch.equal(gat_attention(feat, attn, 0.2, indptr, src), got)
