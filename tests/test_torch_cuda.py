"""The port's CUDA kernels (K1-K7 and the sampler's Poisson fixed point)
against their plain PyTorch versions, on the card. A CUDA kernel has no
CPU mode, so without a GPU these tests skip; run them on one with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from bliss_gnn_tpu_torch.ops import gat_edge
from bliss_gnn_tpu_torch.ops.exp3 import (
    exp3_apply,
    exp3_apply_plain,
    group_table_log2,
)
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
from bliss_gnn_tpu_torch.ops.poisson import (
    poisson_route,
    poisson_scale,
    poisson_scale_plain,
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
                                     (41, torch.float32),
                                     (256, torch.float32)])
def test_segment_sum_kernel(dev, gen, f, dtype):
    """The unsorted route: a memset, float4 atomics into an f32 scratch,
    then a cast kernel (two launches); f32 at F % 4 == 0 accumulates
    straight into the output (one launch)."""
    ids = torch.randint(-2, 300, (20_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    data = torch.randn((20_000, f), generator=gen, device=dev).to(dtype)
    n_launch = 1 if dtype == torch.float32 and f % 4 == 0 else 2
    before = segment_sum.launches
    key = f"unsorted 20000x{f}"
    by = segment_sum.launches_by_shape.get(key, 0)
    got = segment_sum(data, ids, 298, n_valid=15_000).float()
    assert segment_sum.launches == before + n_launch
    assert segment_sum.launches_by_shape[key] == by + n_launch
    want = segment_sum_plain(data, ids, 298, n_valid=15_000).float()
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-3)


def _sorted_ids(gen, dev, n, s, hub):
    """``n`` int32 ids in order: two below 0, ``hub`` copies of row 5 (a
    hub holding more than half of them), three past ``s``, the rest uniform
    over the rows not divisible by 7, so every 7th row is empty."""
    m = n - hub - 5
    base = (torch.randint(0, s // 7, (m,), generator=gen, device=dev) * 7
            + torch.randint(1, 7, (m,), generator=gen, device=dev))
    ids = torch.cat([torch.full((2,), -1, device=dev), base,
                     torch.full((hub,), 5, device=dev),
                     torch.full((3,), s + 2, device=dev)])
    return torch.sort(ids).values.to(torch.int32)


# n_valid of the sorted-route cases, by case; past it the ids are 0 (the
# masked tail) and the payload is junk that must add nothing
_SORTED_CASES = {"hub": 31_000, "full": 40_000, "empty": 0, "unaligned": 39_999}


def _sorted_inputs(gen, dev, case, f=None, dtype=torch.float32):
    n, s = 40_000, 3000
    ids = _sorted_ids(gen, dev, n + 1, s, hub=21_000)
    shape = (n + 1,) if f is None else (n + 1, f)
    data = torch.randn(shape, generator=gen, device=dev)
    if f is None:  # multiples of 1/64: every order of the sums is exact
        data = torch.round(data * 64) / 64
    data = data.to(dtype)
    nv = _SORTED_CASES[case]
    if case == "unaligned":  # views 4 (K1) or 2-4 (K3) bytes off 16
        flat = data.reshape(-1)[1:1 + n * (f or 1)]
        ids, data = ids[1:], flat.reshape((n,) if f is None else (n, f))
        assert ids.data_ptr() % 16 and data.data_ptr() % 16
    else:
        ids, data = ids[:n].clone(), data[:n]
    ids[nv:] = 0
    return ids, data, s, torch.tensor(nv, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("case", list(_SORTED_CASES))
def test_scatter_add_sorted_kernel(dev, gen, case):
    """The sorted route: one launch, no atomics; a hub row of 21,000 keys
    (one warp reads on through 164 tiles of 128), empty rows, ids out of
    range."""
    keys, vals, s, nv = _sorted_inputs(gen, dev, case)
    before = scatter_add.launches
    key = f"sorted n={keys.shape[0]}"
    by = scatter_add.launches_by_shape.get(key, 0)
    got = scatter_add(keys, vals, s, nv, ids_sorted=True)
    assert scatter_add.launches == before + 1
    assert scatter_add.launches_by_shape[key] == by + 1
    want = scatter_add_plain(keys, vals, s, nv, ids_sorted=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    if case != "empty":
        assert not got[::7].any()  # rows no key names read 0
        assert got[5] != 0


@pytest.mark.parametrize("f,dtype", [(256, torch.bfloat16),
                                     (41, torch.bfloat16),
                                     (256, torch.float32),
                                     (41, torch.float32),
                                     (1024, torch.bfloat16)])
@pytest.mark.parametrize("case", list(_SORTED_CASES))
def test_segment_sum_sorted_kernel(dev, gen, case, f, dtype):
    """The sorted route on 16-byte rows (F = 256, and 1024 as K5's GATv2
    rows: two launches, tiles and the carry fold) and on narrow rows (F =
    41, or an unaligned view: one launch, a block per output row), bf16
    and f32."""
    ids, data, s, nv = _sorted_inputs(gen, dev, case, f, dtype)
    n_launch = 2 if f % 8 == 0 and case != "unaligned" else 1
    before = segment_sum.launches
    key = f"sorted {ids.shape[0]}x{f}"
    by = segment_sum.launches_by_shape.get(key, 0)
    got = segment_sum(data, ids, s, nv, ids_sorted=True)
    assert segment_sum.launches == before + n_launch
    assert segment_sum.launches_by_shape[key] == by + n_launch
    assert got.dtype == dtype
    want = segment_sum_plain(data, ids, s, nv, ids_sorted=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)
    if case != "empty":
        assert not got[::7].any()
        assert got[5].abs().sum() > 0


def test_sorted_routes_repeat_bitwise(dev, gen):
    """No atomics on the sorted routes: two calls on the same inputs give
    the same bits, whatever the order of the f32 sums."""
    keys, _, s, nv = _sorted_inputs(gen, dev, "hub")
    vals = torch.randn(keys.shape[0], generator=gen, device=dev)
    assert torch.equal(scatter_add(keys, vals, s, nv, ids_sorted=True),
                       scatter_add(keys, vals, s, nv, ids_sorted=True))
    for f in (256, 41):
        data = torch.randn((keys.shape[0], f), generator=gen,
                           device=dev).to(torch.bfloat16)
        assert torch.equal(segment_sum(data, keys, s, nv, ids_sorted=True),
                           segment_sum(data, keys, s, nv, ids_sorted=True))


@pytest.mark.parametrize("f,dtype", [(41, torch.bfloat16),
                                     (1024, torch.bfloat16),
                                     (41, torch.float32),
                                     (256, torch.float32)])
def test_segment_sum_stable_route(dev, gen, f, dtype):
    """``deterministic=True`` on unsorted ids: K5's counting sort (three
    launches), then the sorted route through the permutation (two on
    16-byte rows, one on narrow ones). It equals the sorted route on the
    rows sorted stably on the host bit for bit, so two calls agree too; a
    hub of 1,000 copies, ids out of range, a valid prefix."""
    n, s, nv = 20_000, 2_000, 15_000
    ids = torch.randint(-2, s + 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.randperm(nv, generator=gen, device=dev)[:1000]] = 7
    data = torch.randn((n, f), generator=gen, device=dev).to(dtype)
    nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
    before = segment_sum.launches
    key = f"stable {n}x{f}"
    by = segment_sum.launches_by_shape.get(key, 0)
    got = segment_sum(data, ids, s, nv_d, deterministic=True)
    n_launch = 3 + (2 if f * data.element_size() % 16 == 0 else 1)
    assert segment_sum.launches == before + n_launch
    assert segment_sum.launches_by_shape[key] == by + n_launch
    assert got.dtype == dtype
    want = segment_sum_plain(data, ids, s, nv_d)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)
    live = ids[:nv].cpu()
    keep = ((live >= 0) & (live < s)).nonzero()[:, 0]
    order = keep[torch.sort(live[keep], stable=True).indices]
    keys = live[order].to(dev)
    by_key = segment_sum(data[order.to(dev)], keys, s,
                         torch.tensor(keys.shape[0], dtype=torch.int32,
                                      device=dev), ids_sorted=True)
    assert torch.equal(got, by_key)
    assert torch.equal(segment_sum(data, ids, s, nv_d, deterministic=True),
                       got)


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
    """Entries updated once or twice within one bf16 ulp (rtol 2^-7); an
    entry updated m >= 3 times rounds after each update in the card's
    order, so it is held to K4's contract of m - 1 ulps (as in
    ``test_exp3_apply_duplicates_within_m_minus_1_ulps``)."""
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
    live = idx < limit
    m = torch.zeros(limit, dtype=torch.float32, device=dev)
    m.index_add_(0, idx[live].long(), torch.ones_like(mult[live]))
    many = m >= 3
    assert many.any()  # the seed-0 draw repeats some indices 3 and 4 times
    torch.testing.assert_close(state.float()[~many], ref.float()[~many],
                               rtol=2.0 ** -7, atol=0.0)
    ulp = torch.maximum(_bf16_ulp(state), _bf16_ulp(ref))[many]
    diff = (state.float() - ref.float()).abs()[many]
    assert (diff <= (m[many] - 1) * ulp).all()


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


def _f32_ulp(x):
    """One f32 ulp at each value of the f32 tensor ``x``."""
    _, e = torch.frexp(x)  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x), e - 24)


def test_exp3_apply_f32_distinct_is_bitwise(dev, gen):
    """K4's 32-bit route on an f32 state: one f32 multiply and one rounding
    per entry, bit for bit the plain version; no-op slots (past the limit
    and negative) and untouched entries unchanged; launched once, on the
    f32 route."""
    limit = 1 << 21
    idx = torch.randperm(limit, generator=gen, device=dev)[:120_000].to(
        torch.int32)
    idx[::5] = limit + 7  # no-op slots
    idx[1::97] = -1
    state = torch.rand(limit, generator=gen, device=dev) + 0.5
    mult = torch.exp(torch.rand(idx.shape[0], generator=gen, device=dev)
                     * 0.5)
    ref, before = state.clone(), state.clone()
    launches = exp3_apply.launches
    by_route = dict(exp3_apply.launches_by_shape)
    exp3_apply(state, idx, mult, limit)
    assert exp3_apply.launches == launches + 1
    key = f"f32 {idx.shape[0]}"
    assert exp3_apply.launches_by_shape[key] == by_route.get(key, 0) + 1
    exp3_apply_plain(ref, idx, mult, limit)
    assert torch.equal(state, ref)
    touched = torch.zeros(limit, dtype=torch.bool, device=dev)
    live = idx[(idx >= 0) & (idx < limit)].long()
    touched[live] = True
    assert torch.equal(state[~touched], before[~touched])
    assert not torch.equal(state[touched], before[touched])


def test_exp3_apply_f32_duplicates_within_m_minus_1_ulps(dev, gen):
    """Each index 1 to 8 times on an f32 state: every update rounds, in the
    card's order, so an entry updated m times is within m - 1 f32 ulps of
    one rounding of the product."""
    limit = 1 << 20
    base = torch.randperm(limit, generator=gen, device=dev)[:20_000]
    reps = torch.randint(1, 9, (base.shape[0],), generator=gen, device=dev)
    idx = base.repeat_interleave(reps)
    idx = idx[torch.randperm(idx.shape[0], generator=gen, device=dev)].to(
        torch.int32)
    state = torch.rand(limit, generator=gen, device=dev) + 0.5
    mult = torch.exp(torch.rand(idx.shape[0], generator=gen, device=dev)
                     * 0.5)
    ref = state.clone()
    exp3_apply(state, idx, mult, limit)
    exp3_apply_plain(ref, idx, mult, limit)
    m = torch.zeros(limit, dtype=torch.float32, device=dev)
    m.index_add_(0, idx.long(), torch.ones_like(mult))
    ulp = torch.maximum(_f32_ulp(state), _f32_ulp(ref))
    diff = (state - ref).abs()
    assert (diff <= (m - 1).clamp(min=0) * ulp).all()
    assert torch.equal(state[m <= 1], ref[m <= 1])
    assert int(m.max()) == 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_exp3_apply_repeats_route_same_bits_every_call(dev, gen, dtype):
    """K4's repeats route on a gathered list of four ranks' lists, each
    distinct, so an index repeats up to 4 times (as the all-gathered deltas of
    a DP step at S = 4 do), with no-op slots: the same bits on 20 calls (the
    card's slot order does not reach the result), bit for bit the CPU's
    sequential ``exp3_apply_plain`` (the same products in list order, one
    rounding), within one ulp of the plain version on the card, untouched
    entries unchanged; two launches a call (insert, apply), counted on its
    route."""
    limit, per = 1 << 20, 60_000
    pool = torch.randperm(limit, generator=gen, device=dev)[:90_000]
    lists = [pool[torch.randperm(pool.shape[0], generator=gen,
                                 device=dev)[:per]] for _ in range(4)]
    idx = torch.cat(lists).to(torch.int32)
    idx[::7] = limit  # zero exponents: no-op slots
    idx[3::101] = -1
    mult = torch.exp(torch.rand(idx.shape[0], generator=gen, device=dev)
                     * 0.5)
    state = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(dtype)
    live = idx[(idx >= 0) & (idx < limit)].long()
    uniq, cnt = torch.unique(live, return_counts=True)
    assert int(cnt.max()) == 4 and int((cnt == 1).sum()) > 0
    launches = exp3_apply.launches
    key = (f"repeats {'f32' if dtype == torch.float32 else 'bf16'} "
           f"{idx.shape[0]} S=4")
    before = exp3_apply.launches_by_shape.get(key, 0)
    outs = []
    for _ in range(20):
        got = state.clone()
        exp3_apply(got, idx, mult, limit, max_repeats=4)
        outs.append(got)
    assert exp3_apply.launches == launches + 40
    assert exp3_apply.launches_by_shape[key] == before + 40
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    got = outs[0]
    cpu = state.cpu()
    exp3_apply_plain(cpu, idx.cpu(), mult.cpu(), limit)
    assert torch.equal(got.cpu(), cpu)
    ref = state.clone()
    exp3_apply_plain(ref, idx, mult, limit)
    ulp_of = _f32_ulp if dtype == torch.float32 else _bf16_ulp
    a, b = got[uniq].float(), ref[uniq].float()
    ulp = torch.maximum(ulp_of(a.to(dtype)), ulp_of(b.to(dtype)))
    assert ((a - b).abs() <= ulp).all()
    untouched = torch.ones(limit, dtype=torch.bool, device=dev)
    untouched[uniq] = False
    assert torch.equal(got[untouched], state[untouched])


def _hash_mul():
    """The group-by route's hash multiplier, read from its kernel source."""
    import pathlib
    import re

    import bliss_gnn_tpu_torch

    src = (pathlib.Path(bliss_gnn_tpu_torch.__file__).parent / "csrc"
           / "exp3_apply.cu").read_text()
    return int(re.search(r"kHashMul = (0x[0-9A-Fa-f]+)u", src).group(1), 16)


def _group_case(gen, dev, case, s, per=3000, limit=1 << 20):
    """(flat indices, limit) of ``s`` ranks' lists of ``per`` slots, each
    rank's live indices distinct, laid out rank by rank as the gathered
    deltas are. ``case``: ``every_rank`` (1,000 indices in every rank),
    ``one_rank`` (each index in one rank only), ``noops`` (``every_rank``
    with a no-op after every slot, -1 and ``limit`` in turn, each repeated
    thousands of times), ``empty``, ``all_noops``,
    ``collide`` (2,000 indices in every rank, all hashing to the table's
    first 16 slots: one probe run of 2,000 slots, the table's worst
    case)."""
    if case == "empty":
        return torch.empty(0, dtype=torch.int32, device=dev), limit
    if case == "collide":
        per, limit = 2000, 1 << 24
        log2_t = group_table_log2(s * per)
        k = torch.arange(limit, dtype=torch.int64)
        slot = ((k * _hash_mul()) & 0xFFFFFFFF) >> (32 - log2_t)
        keys = k[slot < 16][:per]  # 2^24 * 16 / T >= 4,096 candidates
        assert keys.numel() == per
        lists = [keys[torch.randperm(per)].to(dev) for _ in range(s)]
    elif case == "one_rank":
        keys = torch.randperm(limit, generator=gen, device=dev)[:s * per]
        lists = list(keys.view(s, per))
    else:
        pool = torch.randperm(limit, generator=gen, device=dev)[:4 * per]
        common = pool[:1000]
        lists = [torch.cat([common, pool[1000:][torch.randperm(
            3 * per, generator=gen, device=dev)[:per - 1000]]])[
            torch.randperm(per, generator=gen, device=dev)]
            for _ in range(s)]
    idx = torch.cat(lists).to(torch.int32)
    if case == "noops":
        noop = torch.full_like(idx, -1)
        noop[1::2] = limit
        idx = torch.stack([idx, noop], 1).reshape(-1)
    if case == "all_noops":
        idx[::2] = -1
        idx[1::2] = limit
    return idx, limit


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [2, 4, 8, 16])
@pytest.mark.parametrize("case", ["every_rank", "one_rank", "noops",
                                  "empty", "all_noops", "collide"])
def test_exp3_apply_group_route_cases(dev, gen, case, s, dtype):
    """The group-by route at S ranks: bit for bit the CPU's
    ``exp3_apply_plain`` on every case of ``_group_case``; entries outside the
    list untouched; two launches a call, also on an empty list. At S = 16 an
    index's 16 slots overflow the kernel's 8 registers and take its list-walk
    path."""
    idx, limit = _group_case(gen, dev, case, s)
    live = idx[(idx >= 0) & (idx < limit)].long()
    if live.numel():
        most = int(torch.unique(live, return_counts=True)[1].max())
        assert most == (s if case in ("every_rank", "noops") else
                        s if case == "collide" else 1)
    mult = torch.exp(torch.rand(idx.shape[0], generator=gen, device=dev)
                     * 0.5 - 0.25)
    state = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(dtype)
    got = state.clone()
    launches = exp3_apply.launches
    exp3_apply(got, idx, mult, limit, max_repeats=s)
    assert exp3_apply.launches == launches + 2
    cpu = state.cpu()
    exp3_apply_plain(cpu, idx.cpu(), mult.cpu(), limit)
    assert torch.equal(got.cpu(), cpu)
    untouched = torch.ones(limit, dtype=torch.bool, device=dev)
    untouched[live] = False
    assert torch.equal(got[untouched], state[untouched])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_exp3_apply_group_route_replays_in_a_cuda_graph(dev, gen, dtype):
    """The group-by route captured in a CUDA graph (its scratch from the
    graph's pool, its memset and two launches recorded, no host sync)
    replays to the eager call's bits, on every replay."""
    idx, limit = _group_case(gen, dev, "noops", 4)
    mult = torch.exp(torch.rand(idx.shape[0], generator=gen, device=dev)
                     * 0.5 - 0.25)
    state = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(dtype)
    want = state.clone()
    exp3_apply(want, idx, mult, limit, max_repeats=4)
    st = state.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        exp3_apply(st, idx, mult, limit, max_repeats=4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        exp3_apply(st, idx, mult, limit, max_repeats=4)
    for _ in range(3):
        st.copy_(state)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(st, want)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_exp3_apply_other_dtypes_raise(dev, dtype):
    state = torch.ones(1024, dtype=dtype, device=dev)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bf16 or f32"):
        exp3_apply(state, idx, torch.ones(8, device=dev), 1024)
    with pytest.raises(TypeError, match="bf16 or f32"):
        exp3_apply(torch.ones((32, 32), device=dev), idx,
                   torch.ones(8, device=dev), 1024)


@pytest.mark.parametrize("dtype,n_valid,out_dtype", [
    (torch.bfloat16, None, torch.float32),
    (torch.bfloat16, 30_001, torch.float32),
    (torch.float32, 12_345, torch.float32),
    (torch.bfloat16, 30_001, torch.bfloat16),
    (torch.float32, 12_345, torch.bfloat16)])
def test_row_scatter_kernel(dev, gen, dtype, n_valid, out_dtype):
    """The unsorted route: a counting sort of the ids (count with the scan,
    place, order), then the reduce by key (tiles, fold): five launches. Ids
    outside [0, S), a hub of 1,000 ids, every 7th row empty."""
    ids = torch.randint(-3, 3003, (40_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[ids % 7 == 0] += 1
    ids[torch.randperm(40_000, generator=gen, device=dev)[:1000]] = 5
    data = _exact(torch.randn((40_000, 1024), generator=gen, device=dev)
                  .to(dtype))
    data[::7] = 0
    before = row_scatter_add.launches
    key = "unsorted 40000x1024"
    by = row_scatter_add.launches_by_shape.get(key, 0)
    got = row_scatter_add(data, ids, 3000, n_valid, out_dtype=out_dtype)
    assert row_scatter_add.launches == before + 5
    assert row_scatter_add.launches_by_shape[key] == by + 5
    assert got.dtype == out_dtype
    want = row_scatter_add_plain(data, ids, 3000, n_valid,
                                 out_dtype=out_dtype)
    _assert_row_sums_close(got, want)
    assert not got[7::7].any()
    assert torch.equal(row_scatter_add(data, ids, 3000, n_valid,
                                       out_dtype=out_dtype), got)


def _exact(data):
    """``data`` rounded in place to multiples of 1/64: every order of its f32
    sums is exact, so a hub's thousands of adds leave no rounding error
    that depends on the order."""
    return data.copy_(torch.round(data.float() * 64) / 64)


def _assert_row_sums_close(got, want):
    """f32 sums to rtol 1e-5 + atol 1e-4; a bf16 output, each sum rounded
    once, to one bf16 ulp (the f32 sums' order differs from the plain
    version's, so a value near a rounding boundary may round the other
    way)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-4)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(_SORTED_CASES))
def test_row_scatter_sorted_kernel(dev, gen, case, dtype, out_dtype):
    """The sorted route at F = 1024: two launches (tiles, carry fold), no
    atomics, no memset; a hub row of 21,000 ids, every 7th row empty, ids
    below 0 and past S, the n_valid prefix, bf16 and f32 payloads and
    outputs, and an unaligned view of the payload."""
    ids, data, s, nv = _sorted_inputs(gen, dev, case, 1024, dtype)
    _exact(data)
    before = row_scatter_add.launches
    key = f"sorted {ids.shape[0]}x1024"
    by = row_scatter_add.launches_by_shape.get(key, 0)
    got = row_scatter_add(data, ids, s, nv, ids_sorted=True,
                          out_dtype=out_dtype)
    assert row_scatter_add.launches == before + 2
    assert row_scatter_add.launches_by_shape[key] == by + 2
    assert got.dtype == out_dtype
    want = row_scatter_add_plain(data, ids, s, nv, ids_sorted=True,
                                 out_dtype=out_dtype)
    _assert_row_sums_close(got, want)
    if case != "empty":
        assert not got[::7].any()
        assert got[5].abs().sum() > 0


@pytest.mark.parametrize("ids_sorted", [True, False])
def test_row_scatter_repeat_bitwise(dev, gen, ids_sorted):
    """No atomics on the payload on either route: two calls on the same
    inputs give the same bits (the unsorted route's permutation is the
    stable one)."""
    ids, data, s, nv = _sorted_inputs(gen, dev, "hub", 1024, torch.bfloat16)
    if not ids_sorted:  # uniform ids in edge order with a hub of 900
        ids = torch.randint(0, s, ids.shape, generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.randperm(ids.shape[0], generator=gen, device=dev)[:900]] = 5
    for out_dtype in (torch.float32, torch.bfloat16):
        a = row_scatter_add(data, ids, s, nv, ids_sorted, out_dtype)
        assert torch.equal(a, row_scatter_add(data, ids, s, nv, ids_sorted,
                                              out_dtype))


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


def _exact_payload(gen, dev, shape, dtype):
    """Integers in [-64, 64] over 64 (exact in bf16 too): with weights in
    eighths (``_exact_weights``) every partial sum of the 30,000-edge hub
    row is exact in f32, so no order of the plain version's ``index_add_``
    atomics rounds it differently from the kernel's. Unit normals left the
    hub's sums about 1e-3 apart, at the test's atol (one miss in 50 calls
    at F = 300, f32; tools/kernel_probe.py k6-hub)."""
    return (torch.randint(-64, 65, shape, generator=gen, device=dev)
            / 64).to(dtype)


def _exact_weights(gen, dev, e):
    """Edge weights, integers in [0, 8] over 8."""
    return torch.randint(0, 9, (e,), generator=gen, device=dev) / 8


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
    x = _exact_payload(gen, dev, (3000, f), dtype)
    w = _exact_weights(gen, dev, e) if weighted else None
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
    x = _exact_payload(gen, dev, (3000, 256), torch.bfloat16)
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


@pytest.mark.parametrize("ranges", [2, 4])
@pytest.mark.parametrize("h,o,dtype,n", [(4, 256, torch.bfloat16, 2000),
                                         (1, 41, torch.bfloat16, 2000),
                                         (2, 64, torch.float32, 2000),
                                         (1, 41, torch.bfloat16, 140_000)])
def test_gat_attention_ranged_kernel(dev, gen, h, o, dtype, n, ranges):
    """K7 over a range plan of 2 and 4 src ranges (16-bit ids; int32 ids
    at 140,000 srcs in 2 ranges), a hub row of 30,000 edges, against the
    plain version: the attention and the partial max and denominator;
    the call without partials bit-equal; two calls the same bits; the
    (head, range) passes counted; one wrapper call, R + 2 kernels (the
    chunk cuts, the range passes, the combine)."""
    from bliss_gnn_tpu_torch.ops.gat_attention import RangePlans

    indptr, src, _ = _csc(gen, dev, n, hub=30_000)
    plans = RangePlans(indptr, src, ranges=ranges)
    feat = torch.randn((n, h, o), generator=gen, device=dev).to(dtype)
    attn = torch.randn((1, h, o), generator=gen, device=dev) / o ** 0.5
    wide_ids = -(-n // ranges) > 1 << 16
    launches, passes = gat_attention.launches, gat_attention.range_passes
    kernels = gat_attention.kernel_launches
    out, m, den = gat_attention(feat, attn, 0.2, indptr, src, partials=True,
                                ranges=plans)
    assert plans.get(n, h, o, dtype).ids.dtype == (
        torch.int32 if wide_ids else torch.int16)
    assert gat_attention.launches == launches + 1
    assert gat_attention.kernel_launches == kernels + ranges + 2
    assert gat_attention.range_passes == passes + h * ranges
    w_out, w_m, w_den = gat_attention_plain(feat, attn, 0.2, indptr, src,
                                            partials=True)
    torch.testing.assert_close(out, w_out, rtol=1e-4, atol=1e-4)
    assert not out[::97].any()  # zero in-degree: zeros
    fin = torch.isfinite(w_m)
    assert torch.equal(fin, torch.isfinite(m))
    assert not fin[::97].any() and not den[::97].any()
    torch.testing.assert_close(m[fin], w_m[fin], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(den, w_den, rtol=1e-4, atol=1e-6)
    again = gat_attention(feat, attn, 0.2, indptr, src, ranges=plans)
    assert torch.equal(again, out)
    assert torch.equal(
        gat_attention(feat, attn, 0.2, indptr, src, ranges=plans), again)
    assert gat_attention.range_passes == passes + 3 * h * ranges


@pytest.mark.parametrize("case", list(_SORTED_CASES))
def test_segment_sum_sorted_softmax_rows(dev, gen, case):
    """K3's sorted route on GATv2's softmax-denominator backward rows, [E,
    4] f32 (one 16-byte vector a row: two launches; an unaligned view:
    one), with a hub of 21,000 rows; payloads in multiples of 1/64, so
    every order of the f32 sums is exact."""
    ids, data, s, nv = _sorted_inputs(gen, dev, case, 4, torch.float32)
    _exact(data)
    n_launch = 1 if case == "unaligned" else 2
    before = segment_sum.launches
    got = segment_sum(data, ids, s, nv, ids_sorted=True)
    assert segment_sum.launches == before + n_launch
    want = segment_sum_plain(data, ids, s, nv, ids_sorted=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    if case != "empty":
        assert not got[::7].any()
        assert got[5].abs().sum() > 0


@pytest.mark.parametrize("heads", [1, 4])
def test_edge_softmax_sorted_on_the_card(dev, gen, heads):
    """GATv2's edge softmax on a block's sorted ids (a hub of 700 edges
    into one dst, the masked tail past n_valid), forward and gradient, on
    the card (its denominator's gather backward through K1 for one head,
    K3 for four) against the CPU's plain versions."""
    from bliss_gnn_tpu_torch.ops.segment import edge_softmax

    s, e, nv = 300, 6000, 5000
    ids = torch.randint(0, s, (nv - 700,), generator=gen, device=dev)
    ids = torch.sort(torch.cat([ids, torch.full((700,), 40, device=dev)]))[0]
    ids = torch.cat([ids, torch.zeros(e - nv, dtype=torch.long,
                                      device=dev)]).int()
    mask = torch.arange(e, device=dev) < nv
    logits = torch.randn((e, heads), generator=gen, device=dev)
    w = torch.randn((e, heads), generator=gen, device=dev)
    nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
    out = {}
    for where in ("cuda", "cpu"):
        x = logits.detach().to(where).requires_grad_()
        a = edge_softmax(x, ids.to(where), s, mask.to(where),
                         n_valid=nv_d.to(where), ids_sorted=True)
        (a * w.to(where)).sum().backward()
        out[where] = (a.detach().cpu(), x.grad.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _small_training(dev, model_name):
    """chip_smoke.py's small step: a 3,000-node synthetic graph, batch 32,
    fan-outs 256/128, poisson-bandit, dropout 0.1 (drawn from the state's
    generator); returns the graph, config, plan and a fresh-state maker
    with a capturable Adam whose rate halves every 3 steps (so a chain
    crosses the staircase, and a replay that read a stale rate shows in
    the parameters)."""
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
    dg = DeviceGraph.from_graph(g, device=dev)
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(256, 128),
                        model=model_name)
    plan = CapacityPlan.build(32, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind, dense_candidates=False)

    def fresh():
        model = build_model(model_name, 64, 32, n_cls, 2, dropout=0.1,
                            attn_drop=0.1, device=dev)
        opt, sched = steps.make_optimizer(model.parameters(), 1e-3, 1,
                                          gamma=0.5, step_size=3,
                                          capturable=True)
        return steps.TrainState(model, opt, sched,
                                init_exp3_weights(2, g.n_edges, device=dev),
                                torch.Generator(device=dev).manual_seed(0))

    return dg, cfg, plan, fresh


def _train_tensors(state):
    """The state's parameters and Adam's moments and step counts, by name,
    cloned."""
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = p.detach().clone()
        for k, v in state.optimizer.state[p].items():
            out[f"{name}.{k}"] = v.detach().clone()
    return out


def _assert_same_training(got, want):
    """Two ``_train_tensors``: the same names, each tensor within rtol 1e-5
    and 1e-6 of its own largest magnitude (the replays were exact in every
    run; the bound leaves room for a last-bit reorder of the atomic sums,
    and is far below one Adam update, about the rate per parameter)."""
    assert got.keys() == want.keys() and got
    for name, w in want.items():
        atol = 1e-6 * float(w.abs().max()) if w.is_floating_point() else 0
        torch.testing.assert_close(got[name], w, rtol=1e-5, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("model_name", ["sage", "gat"])
def test_replayed_steps_equal_eager_steps(dev, monkeypatch, model_name):
    """Two chains of CAPTURE_WARMUP_STEPS + 3 steps (the first: eager
    warm-ups, the capture, replays; the second: replays only, which launch
    nothing through the wrappers) against as many eager steps from the
    same state: each step's blocks equal (the sampler's uniforms injected,
    dropout drawn from the registered generator), losses within rtol 1e-5,
    the parameters, Adam's moments and the rate as ``_assert_same_training``
    holds them, the arm weights within one bf16 ulp (rtol 2^-8). The
    replays were exact in every run; the bounds leave room for a last-bit
    reorder of the atomic sums."""
    from bliss_gnn_tpu_torch.train import steps

    dg, cfg, plan, fresh = _small_training(dev, model_name)
    k = steps.CAPTURE_WARMUP_STEPS + 3
    cpu_gen = torch.Generator().manual_seed(4)
    draws = [[torch.rand(c, generator=cpu_gen).to(dev) for c in plan.cand_caps]
             for _ in range(2 * k)]
    seeds = torch.arange(32, dtype=torch.int32, device=dev)
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    # every step's src tables into rows of a ring: a device-side copy, so a
    # replay records its blocks too
    ring = [torch.zeros((2 * k, plan.src_cap(l)), dtype=torch.int32,
                        device=dev) for l in range(2)]
    row = torch.zeros(1, dtype=torch.long, device=dev)
    sample = steps.sample_blocks

    def recorded(*args, **kw):
        blocks, stats = sample(*args, **kw)
        for r, b in zip(ring, blocks):
            r.index_copy_(0, row, b.src_gids[None])
        row.add_(1)
        return blocks, stats

    monkeypatch.setattr(steps, "sample_blocks", recorded)
    step = steps.make_train_step(dg, cfg, plan, False, device=dev)
    st = fresh()
    eager_loss = []
    for i in range(2 * k):
        st, m = step(st, seeds, smask, draws=draws[i])
        eager_loss.append(float(m["train_loss"]))
    eager_src, eager_exp3 = [r.clone() for r in ring], st.exp3_weights.clone()
    eager_train, eager_lr = _train_tensors(st), float(
        st.optimizer.param_groups[0]["lr"])

    row.zero_()
    multi = steps.make_multi_train_step(dg, cfg, plan, False, k, device=dev)
    st = fresh()
    ks, km = seeds.expand(k, -1), smask.expand(k, -1)
    edge_before = gat_edge.launches
    st, m1 = multi(st, ks, km, draws=draws[:k])
    # GATv2's attention through its edge kernels, in the eager warm-ups
    assert (gat_edge.launches > edge_before) == (model_name == "gat")
    before, edge_before = segment_sum.launches, gat_edge.launches
    st, m2 = multi(st, ks, km, draws=draws[k:])
    assert segment_sum.launches == before  # replays launch from the graph
    assert gat_edge.launches == edge_before
    assert st.step == 2 * k
    losses = torch.cat([m1["train_loss"], m2["train_loss"]]).tolist()
    for r, want in zip(ring, eager_src):
        assert torch.equal(r, want)
    for a, b in zip(losses, eager_loss):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert float(st.optimizer.param_groups[0]["lr"]) == eager_lr
    assert st.scheduler.get_last_lr() == [1e-3 / 8]  # 10 steps, 3 halvings
    _assert_same_training(_train_tensors(st), eager_train)
    torch.testing.assert_close(st.exp3_weights.float(), eager_exp3.float(),
                               rtol=2.0 ** -8, atol=0)


def test_replayed_eval_equals_eager_eval(dev):
    """Two chained evals of CAPTURE_WARMUP_STEPS + 2 batches (warm-ups,
    capture, replays; then replays only) against the eager eval step's
    sums from a generator in the same state: n and the F1 total equal, the
    true positives within one, loss * n within rtol 1e-5 (exact in every
    run; room for a last-bit reorder of the atomic sums); the arm weights
    bit-equal after both."""
    from bliss_gnn_tpu_torch.train import steps

    dg, cfg, plan, fresh = _small_training(dev, "sage")
    st = fresh()
    seeds = torch.arange(32, dtype=torch.int32, device=dev)
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    st, _ = steps.make_train_step(dg, cfg, plan, False, device=dev)(
        st, seeds, smask)
    exp3 = st.exp3_weights.clone()
    k = steps.CAPTURE_WARMUP_STEPS + 2
    bseeds = torch.stack([(seeds + 37 * i) % 3000 for i in range(k)])
    bmask = torch.ones((k, 32), dtype=torch.bool, device=dev)
    one = steps.make_eval_step(dg, cfg, plan, False, device=dev)
    multi = steps.make_multi_eval_step(dg, cfg, plan, False, device=dev)
    gen_e = torch.Generator(device=dev).manual_seed(11)
    gen_r = torch.Generator(device=dev).manual_seed(11)
    for _ in range(2):
        f1, loss_n, n = multi(st, gen_r, bseeds, bmask)
        tot = [torch.zeros((), device=dev) for _ in range(5)]
        n_e = 0
        for i in range(k):
            df1, dln, dn = one(st, gen_e, bseeds[i], bmask[i])
            tot = [a + b for a, b in zip(tot, (df1.tp, df1.fp, df1.fn,
                                               df1.total, dln))]
            n_e += int(dn)
        assert int(n) == n_e == 32 * k
        assert float(f1.total) == float(tot[3]) == 32 * k
        assert abs(float(f1.tp) - float(tot[0])) <= 1
        assert abs(float(loss_n) - float(tot[4])) <= 1e-5 * abs(float(tot[4]))
    assert torch.equal(st.exp3_weights, exp3)


# -- host-resident features ---------------------------------------------------


def test_feature_cache_on_the_card_equals_the_cpu_cache(dev):
    """A sequence of batches with repeats, masked slots and colliding slots
    through a 64-row cache on the card (pinned staging, one copy a batch)
    and on the CPU: equal outputs, tags, data, miss rates and bytes."""
    import numpy as np

    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache

    rng = np.random.default_rng(0)
    host = rng.normal(size=(5000, 40)).astype(np.float32)
    caches = {d: FeatureCache(host, 64, device=d) for d in (dev, "cpu")}
    for _ in range(8):
        gids = rng.integers(0, 5000, 300).astype(np.int32)
        gids[:50] = gids[50:100]
        mask = rng.random(300) < 0.9
        got = {}
        for d, c in caches.items():
            out, miss = c.gather(torch.from_numpy(gids).to(d),
                                 torch.from_numpy(mask).to(d))
            got[d] = (out.cpu(), miss)
        assert torch.equal(got[dev][0], got["cpu"][0])
        assert got[dev][1] == got["cpu"][1]
        assert torch.equal(caches[dev].tags.cpu(), caches["cpu"].tags)
        assert torch.equal(caches[dev].data.cpu(), caches["cpu"].data)
    assert caches[dev].miss_rate == caches["cpu"].miss_rate
    assert caches[dev].bytes_fetched == caches["cpu"].bytes_fetched > 0


@pytest.mark.parametrize("name", ["sage", "gcn", "gat"])
def test_chunked_inference_equals_its_plain_version(dev, name):
    """``layerwise_inference_uva`` on the card (K6 or K7 over each chunk's
    CSC slice, the src ids into the fetched rows) against the same pass on
    the CPU (their plain versions), 5 chunks of a 2,000-node graph:
    within 1e-2 of the largest logit, the inference checks' bound."""
    from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
    from bliss_gnn_tpu_torch.graph.structure import Graph
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.models.inference import layerwise_inference_uva

    g = Graph.canonicalize(synthetic_graph(2000, 30000, 64, 7, seed=1)[0])
    model = build_model(name, 64, 64, 7, 2, residual=name == "gat",
                        device="cpu", seed=2).eval()
    launches = {"sage": spmm, "gcn": spmm, "gat": gat_attention}[name]
    before = launches.launches
    want = layerwise_inference_uva(name, model, g, 2, node_batch=400,
                                   residual=name == "gat", device="cpu")
    assert launches.launches == before  # the plain versions count nothing
    got = layerwise_inference_uva(name, model.to(dev), g, 2, node_batch=400,
                                  residual=name == "gat", device=dev)
    assert launches.launches - before >= 2 * 5  # a launch a chunk a layer
    scale = float(abs(want).max())
    assert abs(got - want).max() <= 1e-2 * scale


def test_uva_step_equals_the_fused_step(dev, monkeypatch):
    """Three steps of sample, fetch through a cold 500-row cache, train,
    against three fused steps from the same state at chip_smoke.py's small
    size: each step's src tables equal, losses within rtol 1e-5, the
    parameters and Adam's state as ``_assert_same_training`` holds them,
    the arm weights within one bf16 ulp (the bounds of the replay test:
    room for a last-bit reorder of the atomic sums)."""
    import dataclasses

    import numpy as np

    from bliss_gnn_tpu_torch.graph.featurecache import FeatureCache
    from bliss_gnn_tpu_torch.train import steps

    dg, cfg, plan, fresh = _small_training(dev, "sage")
    bare = dataclasses.replace(dg, ndata={
        k: v for k, v in dg.ndata.items() if k != "features"})
    host = dg.ndata["features"].float().cpu().numpy()
    recorded = []
    sample = steps.sample_blocks

    def recording(*args, **kw):
        blocks, stats = sample(*args, **kw)
        recorded.append([b.src_gids.clone() for b in blocks])
        return blocks, stats

    monkeypatch.setattr(steps, "sample_blocks", recording)
    batches = [torch.arange(32, dtype=torch.int32, device=dev) + 97 * i
               for i in range(3)]
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    fused = steps.make_train_step(dg, cfg, plan, False, device=dev)
    st = fresh()
    want = []
    for seeds in batches:
        st, m = fused(st, seeds, smask)
        want.append(float(m["train_loss"]))
    want_src, recorded[:] = list(recorded), []
    want_train, want_exp3 = _train_tensors(st), st.exp3_weights.clone()

    sample_fn, train_fn, _ = steps.make_uva_steps(bare, cfg, plan, False,
                                                  device=dev)
    cache = FeatureCache(host, 500, device=dev)
    st = fresh()
    got = []
    for seeds in batches:
        blocks, _ = sample_fn(st, seeds, smask)
        x, miss = cache.gather(blocks[0].src_gids, blocks[0].src_mask)
        st, m = train_fn(st, blocks, x)
        got.append(float(m["train_loss"]))
    assert 0.0 < cache.miss_rate <= 1.0
    for a, b in zip(recorded, want_src):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b)
    _assert_same_training(_train_tensors(st), want_train)
    torch.testing.assert_close(st.exp3_weights.float(), want_exp3.float(),
                               rtol=2.0 ** -8, atol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("h,o,dtype", [(4, 256, torch.bfloat16),
                                       (1, 41, torch.bfloat16),
                                       (2, 64, torch.float32),
                                       (3, 41, torch.float32),
                                       (8, 64, torch.bfloat16),
                                       (1, 300, torch.bfloat16),
                                       (1, 500, torch.float32),
                                       (16, 8, torch.float32)])
def test_gat_attention_partials_kernel(dev, gen, h, o, dtype):
    """K7's partial outputs at the kernel test's grid: the attention
    bit-equal to the call without them; the per-(dst, head) max logit and
    denominator against the plain version's (-inf and 0 on rows without
    in-edges); two edge sets of every dst (the src's parity) combined equal
    the whole."""
    from bliss_gnn_tpu_torch.ops.gat_attention import combine_partials

    indptr, src, e = _csc(gen, dev, 2000, hub=30_000)
    feat = torch.randn((2000, h, o), generator=gen, device=dev).to(dtype)
    attn = torch.randn((1, h, o), generator=gen, device=dev) / o ** 0.5
    before = gat_attention.launches
    key = f"partials H={h} O={o}"
    by = gat_attention.launches_by_shape.get(key, 0)
    out, m, den = gat_attention(feat, attn, 0.2, indptr, src, partials=True)
    assert gat_attention.launches == before + 1
    assert gat_attention.launches_by_shape[key] == by + 1
    assert torch.equal(out, gat_attention(feat, attn, 0.2, indptr, src))
    assert gat_attention.launches_by_shape[key] == by + 1
    w_out, w_m, w_den = gat_attention_plain(feat, attn, 0.2, indptr, src,
                                            partials=True)
    fin = torch.isfinite(w_m)
    assert torch.equal(fin, torch.isfinite(m))
    assert not fin[::97].any() and not den[::97].any()
    torch.testing.assert_close(m[fin], w_m[fin], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(den, w_den, rtol=1e-4, atol=1e-6)
    # split each dst's edges by src parity: two CSC slices of its edges
    dst = torch.repeat_interleave(
        torch.arange(2000, device=dev), (indptr[1:] - indptr[:-1]).long())
    parts = []
    for parity in (0, 1):
        keep = src[:e] % 2 == parity
        ip = torch.zeros(2001, dtype=torch.int32, device=dev)
        ip[1:] = torch.cumsum(torch.bincount(dst[keep], minlength=2000), 0)
        parts.append(gat_attention(feat, attn, 0.2, ip, src[:e][keep],
                                   partials=True))
    c_out, c_m, c_den = combine_partials(*parts)
    torch.testing.assert_close(c_out, out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_m[fin], m[fin], rtol=1e-6, atol=0)
    torch.testing.assert_close(c_den, den, rtol=1e-4, atol=1e-6)


def _one_rank_mesh(dev):
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(1, device=dev)


def _step_vs_fused(dev, monkeypatch, build, exp3_of, to_state):
    """Three steps of a one-rank parallel step against three fused steps
    from the same state at ``_small_training``'s size: each step's blocks
    equal, losses within rtol 1e-5, parameters and Adam's state as
    ``_assert_same_training`` holds them, the canonical arm weights within
    one bf16 ulp."""
    from bliss_gnn_tpu_torch.train import steps

    dg, cfg, plan, fresh = _small_training(dev, "sage")
    recorded = []
    sample = steps.sample_blocks

    def recording(*args, **kw):
        blocks, stats = sample(*args, **kw)
        recorded.append([b.src_gids.clone() for b in blocks])
        return blocks, stats

    monkeypatch.setattr(steps, "sample_blocks", recording)
    batches = [torch.arange(32, dtype=torch.int32, device=dev) + 97 * i
               for i in range(3)]
    smask = torch.ones(32, dtype=torch.bool, device=dev)
    fused = steps.make_train_step(dg, cfg, plan, False, device=dev)
    st = fresh()
    want = []
    for seeds in batches:
        st, m = fused(st, seeds, smask)
        want.append(float(m["train_loss"]))
    want_src, recorded[:] = list(recorded), []
    want_train, want_exp3 = _train_tensors(st), st.exp3_weights.clone()
    mesh = _one_rank_mesh(dev)
    try:
        step = build(mesh, dg, cfg, plan)
        st = to_state(fresh(), mesh, dg)
        got = []
        for seeds in batches:
            st, m = step(st, seeds, smask)
            got.append(float(m["train_loss"]))
        got_exp3 = exp3_of(st, mesh, dg)
    finally:
        mesh.close()
    for a, b in zip(recorded, want_src):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b)
    _assert_same_training(_train_tensors(st), want_train)
    torch.testing.assert_close(got_exp3.float(), want_exp3.float(),
                               rtol=2.0 ** -8, atol=0)


def test_dp_step_at_one_rank_equals_the_fused_step(dev, monkeypatch):
    """``make_dp_train_step`` over a one-rank NCCL mesh: the fused step
    (the gradient all-reduce, the delta all-gather and the metric sums
    of one rank change nothing)."""
    from bliss_gnn_tpu_torch.parallel.dp import make_dp_train_step

    _step_vs_fused(
        dev, monkeypatch,
        lambda mesh, dg, cfg, plan: make_dp_train_step(
            mesh, dg, cfg, plan, False, exp3_normalize=False),
        lambda st, mesh, dg: st.exp3_weights,
        lambda st, mesh, dg: st)


def test_sharded_step_at_one_rank_equals_the_fused_step(dev, monkeypatch):
    """``make_sharded_train_step`` at S = 1 (every row served by the
    distributed gather, K4 on the flat shard): the fused step's blocks,
    loss, update and arm weights."""
    import dataclasses

    from bliss_gnn_tpu_torch.parallel.shardedstep import (
        ShardedDeviceGraph,
        init_exp3_shard,
        make_sharded_train_step,
        unshard_exp3,
    )

    def host(dg):  # the small graph's arrays as the sharded build reads them
        import types

        e = dg.n_edges
        return types.SimpleNamespace(
            csc_indptr=dg.csc_indptr.cpu().numpy(),
            csc_src=dg.csc_src[:e].cpu().numpy(),
            edata={"w": dg.edata["w"][:e].cpu().numpy()},
            ndata={"features": dg.ndata["features"].float().cpu().numpy(),
                   "labels": dg.ndata["labels"].cpu().numpy()},
            n_nodes=dg.n_nodes, n_edges=e)

    _step_vs_fused(
        dev, monkeypatch,
        lambda mesh, dg, cfg, plan: make_sharded_train_step(
            mesh, ShardedDeviceGraph.build(host(dg), mesh, shard_indptr=True),
            cfg, plan, False),
        lambda st, mesh, dg: unshard_exp3(st.exp3_weights[None], 2,
                                          dg.n_edges),
        lambda st, mesh, dg: dataclasses.replace(
            st, exp3_weights=init_exp3_shard(2, dg.n_edges, mesh)))


def test_repeated_seeds_sample_the_same_blocks_on_the_card(dev):
    """A batch with repeated seeds: the card's blocks equal the CPU's and
    their own on a second call (each repeated seed's edges at its last
    slot, an ``amax`` scatter; a plain index write leaves the slot to the
    run on the card)."""
    from bliss_gnn_tpu_torch.graph.structure import DeviceGraph
    from bliss_gnn_tpu_torch.sampling.samplers import (
        init_exp3_weights, sample_blocks)

    dg, cfg, plan, _ = _small_training(dev, "sage")
    host = DeviceGraph(**{
        f: (getattr(dg, f).cpu() if isinstance(getattr(dg, f), torch.Tensor)
            else {k: v.cpu() for k, v in getattr(dg, f).items()}
            if isinstance(getattr(dg, f), dict) else getattr(dg, f))
        for f in ("csc_indptr", "csc_src", "csr_indptr", "csr_dst",
                  "csr_eid", "ndata", "edata", "n_nodes", "n_edges")})
    seeds = (torch.arange(32, dtype=torch.int32) % 7) * 31  # each 4-5 times
    smask = torch.ones(32, dtype=torch.bool)
    draws = [torch.rand(plan.cand_caps[l], generator=torch.Generator()
                        .manual_seed(l)) for l in range(2)]
    got = []
    for d, s, m, w, g in ((dev, seeds.to(dev), smask.to(dev),
                           init_exp3_weights(2, dg.n_edges, device=dev), dg),
                          (dev, seeds.to(dev), smask.to(dev),
                           init_exp3_weights(2, dg.n_edges, device=dev), dg),
                          ("cpu", seeds, smask,
                           init_exp3_weights(2, dg.n_edges, device="cpu"),
                           host)):
        blocks, _ = sample_blocks(g, cfg, plan, None, s, m, w,
                                  draws=[x.to(d) for x in draws])
        got.append([(b.src_gids.cpu(), b.e_src.cpu(), b.e_dst.cpu(),
                     b.e_mask.cpu()) for b in blocks])
    for other in got[1:]:
        for a, b in zip(got[0], other):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def _poisson_case(dev, c_cap, dense, case="random", seed=0):
    """A layer's candidates as the sampler hands them to the fixed point:
    dense (position = node id, mask = positive probability or seed) or
    compact (the candidates packed first), a skewed probability, 1 % seeds;
    ``case`` bends it to an edge of the rule."""
    from types import SimpleNamespace

    g = torch.Generator(device=dev).manual_seed(seed)
    num = 4096 if c_cap > 100_000 else 256
    iters, eps = 50, 0.9999
    # a heavy tail: the fixed point saturates the head and rescales a while
    prob = 1e-4 / (torch.rand(c_cap, generator=g, device=dev) + 1e-4)
    pick = torch.rand(c_cap, generator=g, device=dev)
    if dense:
        prob = torch.where(pick < 0.3, prob, 0.0)
        is_seed = (pick < 0.003)
        mask = (prob > 0) | is_seed
    else:
        mask = torch.arange(c_cap, device=dev) < int(0.7 * c_cap)
        is_seed = mask & (pick < 0.01)
    if case == "few_candidates":
        mask &= torch.arange(c_cap, device=dev) < num // 2
    elif case == "zero_probs":
        prob = torch.zeros_like(prob)
    elif case == "out_of_iterations":
        # a head that saturates at 1, a tail that needs many rescalings
        prob = torch.where(mask, 1e-7, 0.0)
        head = torch.nonzero(mask).squeeze(1)[:num - 2]
        prob[head] = 0.5
        iters = 3
    elif case == "nan":
        prob[torch.nonzero(mask).squeeze(1)[:3]] = float("nan")
    prob = torch.where(mask, prob, 0.0)
    cand = SimpleNamespace(mask=mask, is_seed=is_seed & mask,
                           n=mask.sum(dtype=torch.int32))
    return prob, cand, num, eps, iters


def _assert_poisson_close(got, want, eps):
    """p to f32 rounding of the sum's order, the count within one; where
    the counts differ a sum sat on ``eps`` and one more rescaling moved c by
    under 1 - eps."""
    (p, it), (p_want, it_want) = got, want
    assert p.dtype == torch.float32 and it.dtype == torch.int32
    assert abs(int(it) - int(it_want)) <= 1
    rtol = 1e-5 if int(it) == int(it_want) else 2 * (1 - eps) + 1e-5
    torch.testing.assert_close(p, p_want, rtol=rtol, atol=1e-7,
                               equal_nan=True)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("c_cap", [4_096, 233_088, 900_000, 2_500_000])
def test_poisson_scale_kernel(dev, c_cap, dense):
    """One block, a cluster of 16 in shared memory (at 900,000 candidates
    near the 229,376 bytes a block may hold), and the streamed route,
    against the plain version on the card; two calls give the same bits."""
    prob, cand, num, eps, iters = _poisson_case(dev, c_cap, dense)
    before = poisson_scale.launches
    got = poisson_scale(prob, cand, num, eps, iters)
    assert poisson_scale.launches == before + 1
    want = poisson_scale_plain(prob, cand, num, eps, iters)
    assert 0 < int(want[1]) < iters
    _assert_poisson_close(got, want, eps)
    again = poisson_scale(prob, cand, num, eps, iters)
    assert torch.equal(again[0], got[0]) and int(again[1]) == int(got[1])


@pytest.mark.parametrize("c_cap", [4_096, 233_088, 900_000, 2_500_000])
@pytest.mark.parametrize("case", ["few_candidates", "zero_probs",
                                  "out_of_iterations", "nan"])
def test_poisson_scale_kernel_edges(dev, case, c_cap):
    """n <= num (every candidate 1), s = 0 (seeds 1, the rest 0, no hit),
    a budget too short to reach eps, a NaN probability (it spreads as
    torch.clamp spreads it): the kernel as the plain version."""
    prob, cand, num, eps, iters = _poisson_case(dev, c_cap, True, case)
    got = poisson_scale(prob, cand, num, eps, iters)
    want = poisson_scale_plain(prob, cand, num, eps, iters)
    _assert_poisson_close(got, want, eps)
    p, it = got
    assert torch.equal(p[cand.is_seed], torch.ones_like(p[cand.is_seed]))
    assert not bool(p[~cand.mask].any())
    if case == "few_candidates":
        assert bool((p[cand.mask] == 1).all())
    if case in ("zero_probs", "out_of_iterations", "nan"):
        assert int(it) == int(want[1]) == iters
    if case == "zero_probs":
        assert torch.equal(p, cand.is_seed.to(torch.float32))


def test_poisson_scale_replays_in_a_cuda_graph(dev):
    """Captured, the kernel is one node of the graph; a replay equals the
    eager call, and follows new probabilities written into the input."""
    import ctypes

    prob, cand, num, eps, iters = _poisson_case(dev, 233_088, True)
    assert poisson_route(prob.shape[0]) == (16, True)
    eager = poisson_scale(prob, cand, num, eps, iters)
    static = prob.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        poisson_scale(static, cand, num, eps, iters)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = poisson_scale.launches
    with torch.cuda.graph(graph):
        p, it = poisson_scale(static, cand, num, eps, iters)
    assert poisson_scale.launches == before + 1
    nodes = ctypes.c_size_t(0)
    libcuda = ctypes.CDLL("libcuda.so.1")
    assert libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                   None, ctypes.byref(nodes)) == 0
    assert nodes.value == 1
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(p, eager[0]) and int(it) == int(eager[1])
    static.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    again = poisson_scale(static, cand, num, eps, iters)
    assert torch.equal(p, again[0]) and int(it) == int(again[1])


def _four_card_worker():
    """One of four NCCL ranks (one a card) at ``_small_training``'s size,
    32 seeds a rank: three eager DP steps from one state, after each the
    parameters, Adam's state and the arm weights gathered from every rank;
    then the chained DP step captured with its collectives, and one replay
    against an eager DP twin loaded with the same state."""
    from bliss_gnn_tpu_torch.parallel.dp import (
        make_dp_multi_train_step, make_dp_train_step)
    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh
    from bliss_gnn_tpu_torch.train import steps

    mesh = make_mesh(None, device="cuda")
    dev = mesh.device
    dg, cfg, plan, fresh = _small_training(dev, "sage")
    step = make_dp_train_step(mesh, dg, cfg, plan, False,
                              exp3_normalize=False)
    seeds = (torch.arange(32 * mesh.size, dtype=torch.int32, device=dev)
             * 37) % dg.n_nodes
    smask = torch.ones_like(seeds, dtype=torch.bool)

    def gathered_equal(t, bits):
        rows = mesh.all_gather(t.reshape(-1)).view(bits)
        return bool((rows == rows[0]).all())

    st = fresh()
    st.generator = mesh.generator(0)
    equal = []
    for _ in range(3):
        st, _ = step(st, seeds, smask)
        flat = torch.cat([v.float().reshape(-1)
                          for v in _train_tensors(st).values()])
        equal.append((gathered_equal(flat, torch.int32),
                      gathered_equal(st.exp3_weights, torch.int16)))
    multi = make_dp_multi_train_step(mesh, dg, cfg, plan, False,
                                     exp3_normalize=False)
    for _ in range(steps.CAPTURE_WARMUP_STEPS + 1):  # warm-ups, capture
        st, _ = multi(st, seeds[None], smask[None])
    twin = fresh()
    twin, _ = step(twin, seeds, smask)  # makes Adam's state
    with torch.no_grad():
        for p, q in zip(twin.model.parameters(), st.model.parameters()):
            p.copy_(q)
            for k, v in st.optimizer.state[q].items():
                twin.optimizer.state[p][k].copy_(v)
        twin.exp3_weights.copy_(st.exp3_weights)
    twin.scheduler.load_state_dict(st.scheduler.state_dict())
    twin.generator.set_state(st.generator.get_state())
    twin.step = st.step
    twin, me = step(twin, seeds, smask)
    st, mr = multi(st, seeds[None], smask[None])
    cpu = {k: v.cpu() for k, v in _train_tensors(st).items()}
    return dict(backend=mesh.backend, device=str(dev), equal=equal,
                loss_eager=float(me["train_loss"]),
                loss_replayed=float(mr["train_loss"][0]),
                replayed=cpu, eager={k: v.cpu() for k, v in
                                     _train_tensors(twin).items()},
                exp3_replayed=st.exp3_weights.float().cpu(),
                exp3_eager=twin.exp3_weights.float().cpu())


@pytest.fixture(scope="module")
def four_card_ranks():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs of one host: one NCCL rank a "
                    "card")
    from bliss_gnn_tpu_torch.parallel.multihost import run_ranks

    return run_ranks(_four_card_worker, 4, device="cuda", threads=None)


def test_dp_step_at_four_nccl_ranks_is_bit_equal_across_ranks(
        four_card_ranks):
    """Four ranks on four cards under NCCL: after every DP step the
    parameters and Adam's state (one all-reduce of the gradients) and the
    arm weights (every rank's deltas on K4's repeats route) are the same
    bits on every rank."""
    assert [r["backend"] for r in four_card_ranks] == ["nccl"] * 4
    assert [r["device"] for r in four_card_ranks] == [
        f"cuda:{i}" for i in range(4)]
    for r in four_card_ranks:
        assert r["equal"] == [(True, True)] * 3


def test_dp_replay_at_four_nccl_ranks_equals_its_eager_twin(
        four_card_ranks):
    """The chained DP step captured with its NCCL collectives, replayed
    from one state against an eager DP step: the loss within rtol 1e-5, the
    training state as ``_assert_same_training`` holds it, the arm weights
    within one bf16 ulp."""
    for r in four_card_ranks:
        assert abs(r["loss_replayed"] - r["loss_eager"]) <= (
            1e-5 * abs(r["loss_eager"]))
        _assert_same_training(r["replayed"], r["eager"])
        torch.testing.assert_close(r["exp3_replayed"], r["exp3_eager"],
                                   rtol=2.0 ** -8, atol=0)
