"""K7's src ranges on the CPU: the range plan (``ops.gat_attention.
range_plan``) keeps every dst's edges, each range's srcs inside its bounds
in their CSC order; the range count follows the head table's bytes; the
plain attention run range by range and merged with ``combine_partials``
equals one sweep. The kernel's own ranged passes are tested on the card
(``tests/test_torch_cuda.py``)."""
import pytest
import torch

from bliss_gnn_tpu_torch.graph.structure import DeviceGraph, Graph
from bliss_gnn_tpu_torch.ops.gat_attention import (
    RangePlans,
    combine_partials,
    gat_attention,
    gat_attention_plain,
    range_count,
    range_plan,
)

N = 600
HUB, EMPTY, ONE_RANGE = 5, 7, 11  # the hub, a dst with no edges, and one
# whose edges all come from the first 40 srcs


def _range_csc(plan, r):
    """Range r of a plan as a plain CSC: (indptr int32 [n + 1], src
    int32), the 16-bit ids read as unsigned."""
    n = (plan.ptr.shape[0] - 1) // plan.ranges
    ip = plan.ptr[r * n:(r + 1) * n + 1]
    ids = plan.ids[int(ip[0]):int(ip[-1])].to(torch.int32)
    if plan.ids.dtype == torch.int16:
        ids = ids & 0xFFFF
    return (ip - ip[0]).to(torch.int32), ids + r * plan.span


def _csc(seed=0, n=N, hub=3000):
    """Random CSC arrays with in-degrees 0-29, every 97th row empty, a hub
    row, a row of low srcs only, srcs uniform, 16 zeros of padding."""
    gen = torch.Generator().manual_seed(seed)
    deg = torch.randint(0, 30, (n,), generator=gen)
    deg[::97] = 0
    deg[EMPTY] = 0
    deg[HUB] = hub
    indptr = torch.zeros(n + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(deg, 0)
    e = int(indptr[-1])
    src = torch.randint(0, n, (e + 16,), generator=gen, dtype=torch.int32)
    src[e:] = 0
    a, b = int(indptr[ONE_RANGE]), int(indptr[ONE_RANGE + 1])
    src[a:b] = torch.randint(0, 40, (b - a,), generator=gen,
                             dtype=torch.int32)
    return indptr, src


@pytest.mark.parametrize("ranges", [1, 2, 3, 4, 7])
def test_range_plan_keeps_each_dsts_edges_in_order(ranges):
    """Per dst and range: exactly the CSC's edges whose src falls in the
    range, in the CSC's order (so every dst keeps the multiset of its
    srcs); the ranges' offsets run back to back over all edges."""
    indptr, src = _csc()
    plan = range_plan(indptr, src, N, ranges)
    assert plan.ranges == ranges and plan.span == -(-N // ranges)
    assert plan.ptr.dtype == torch.int32
    assert plan.ptr.shape == (ranges * N + 1,)
    assert int(plan.ptr[0]) == 0 and int(plan.ptr[-1]) == int(indptr[-1])
    assert bool((plan.ptr[1:] >= plan.ptr[:-1]).all())
    parts = [_range_csc(plan, r) for r in range(ranges)]
    for d in (0, HUB, EMPTY, ONE_RANGE, 96, 97, N - 1):
        own = src[int(indptr[d]):int(indptr[d + 1])]
        got = []
        for r, (ip, s) in enumerate(parts):
            mine = s[int(ip[d]):int(ip[d + 1])]
            lo, hi = r * plan.span, (r + 1) * plan.span
            assert bool(((mine >= lo) & (mine < hi)).all())
            assert torch.equal(mine, own[(own >= lo) & (own < hi)])
            got.append(mine)
        assert torch.equal(torch.sort(torch.cat(got)).values,
                           torch.sort(own).values)
    # the low-src dst has edges in the first range only
    for r, (ip, _) in enumerate(parts):
        n_r = int(ip[ONE_RANGE + 1] - ip[ONE_RANGE])
        assert (n_r > 0) == (r == 0)
    # every edge once: range r's CSC is the edges of src range r
    for r, (ip, s) in enumerate(parts):
        lo, hi = r * plan.span, (r + 1) * plan.span
        e = int(indptr[-1])
        assert s.shape[0] == int(((src[:e] >= lo) & (src[:e] < hi)).sum())


@pytest.mark.parametrize("n_src,ranges,dtype", [(70_000, 1, torch.int32),
                                                 (70_000, 2, torch.int16),
                                                 (65_536, 1, torch.int16)])
def test_range_ids_take_16_bits_where_a_range_fits(n_src, ranges, dtype):
    """Ids of 16 unsigned bits (in an int16) where a range holds at most
    2^16 srcs, int32 past that; either reads back as the src ids."""
    gen = torch.Generator().manual_seed(1)
    deg = torch.randint(0, 8, (3000,), generator=gen)
    indptr = torch.zeros(3001, dtype=torch.int32)
    indptr[1:] = torch.cumsum(deg, 0)
    e = int(indptr[-1])
    src = torch.randint(0, n_src, (e,), generator=gen, dtype=torch.int32)
    src[:4] = torch.tensor([0, n_src - 1, 32_767, 32_768])
    plan = range_plan(indptr, src, n_src, ranges)
    assert plan.ids.dtype == dtype
    got = torch.cat([_range_csc(plan, r)[1] for r in range(ranges)])
    assert torch.equal(torch.sort(got).values, torch.sort(src).values)


@pytest.mark.parametrize("n,h,o,dtype,want", [
    (232_965, 4, 256, torch.bfloat16, 2),
    (232_965, 1, 256, torch.bfloat16, 2),
    (232_965, 4, 256, torch.float32, 4),
    (232_965, 1, 41, torch.bfloat16, 1),
    (2_000, 4, 256, torch.bfloat16, 1),
])
def test_range_count_follows_the_head_tables_bytes(n, h, o, dtype, want):
    """One head's padded rows over the 64 MB range budget, rounded up."""
    assert range_count(n, h, o, dtype) == want


def test_range_plans_build_once_and_skip_one_range():
    indptr, src = _csc()
    plans = RangePlans(indptr, src)
    assert plans.get(N, 4, 256, torch.bfloat16) is None  # one range
    forced = RangePlans(indptr, src, ranges=3)
    first = forced.get(N, 4, 256, torch.bfloat16)
    assert first.ranges == 3
    assert forced.get(N, 1, 41, torch.bfloat16) is first
    assert forced.get(N + 5, 1, 41, torch.bfloat16) is not first


@pytest.mark.parametrize("ranges", [2, 4])
@pytest.mark.parametrize("h,o", [(4, 16), (1, 41)])
def test_ranges_merged_equal_one_sweep(ranges, h, o):
    """The plain attention over each range's CSC, merged in range order by
    ``combine_partials`` (the kernel's merge of the state it carries),
    against one sweep over the whole CSC: out, max and denominator within
    f32 tolerance, with the empty dst, the one-range dst and the hub."""
    indptr, src = _csc(seed=2)
    gen = torch.Generator().manual_seed(3)
    feat = torch.randn((N, h, o), generator=gen).to(torch.bfloat16)
    attn = torch.randn((1, h, o), generator=gen) / o ** 0.5
    want = gat_attention_plain(feat, attn, 0.2, indptr, src, partials=True)
    plan = range_plan(indptr, src, N, ranges)
    acc = None
    for r in range(ranges):
        ip, s = _range_csc(plan, r)
        part = gat_attention_plain(feat, attn, 0.2, ip, s, partials=True)
        acc = part if acc is None else combine_partials(acc, part)
    out, m, den = acc
    fin = torch.isfinite(want[1])
    assert torch.equal(fin, torch.isfinite(m))
    assert not fin[EMPTY].any() and fin[ONE_RANGE].all() and fin[HUB].all()
    torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m[fin], want[1][fin], rtol=1e-6, atol=0)
    torch.testing.assert_close(den, want[2], rtol=1e-5, atol=1e-6)
    assert not out[EMPTY].any()


@pytest.mark.parametrize("other", ["indptr", "src"])
def test_plans_of_another_csc_raise(other):
    """A call whose plans were built from other tensors than the CSC it
    passes is refused, even where the values are equal: the kernel would
    walk the plans' edges."""
    indptr, src = _csc(seed=6)
    plans = RangePlans(indptr, src, ranges=2)
    feat = torch.randn((N, 1, 8))
    attn = torch.randn((1, 8))
    ip, s = (indptr.clone(), src) if other == "indptr" else (
        indptr, src.clone())
    with pytest.raises(ValueError, match="another CSC"):
        gat_attention(feat, attn, 0.2, ip, s, ranges=plans)
    got = gat_attention(feat, attn, 0.2, indptr, src, ranges=plans)
    assert torch.equal(got, gat_attention_plain(feat, attn, 0.2, indptr,
                                                src))


def test_device_graph_keeps_one_set_of_plans():
    """``DeviceGraph.k7_ranges`` is made once and kept; on a CPU graph the
    default GATv2 aggregation is the plain version."""
    from bliss_gnn_tpu_torch.models.inference import default_gat_attn

    indptr, src = _csc(seed=4)
    e = int(indptr[-1])
    g = Graph.from_csc(indptr.numpy(), src[:e].numpy(), N)
    dg = DeviceGraph.from_graph(g, device="cpu")
    assert dg.k7_ranges is dg.k7_ranges
    assert dg.k7_ranges.csc_src is dg.csc_src
    gen = torch.Generator().manual_seed(5)
    feat = torch.randn((N, 2, 8), generator=gen)
    attn = torch.randn((2, 8), generator=gen)
    got = default_gat_attn(dg)(feat, attn, 0.2)
    assert torch.equal(got, gat_attention(feat, attn, 0.2, dg.csc_indptr,
                                          dg.csc_src))
    assert dg.k7_ranges.plans == {}  # the plain version builds no plan
