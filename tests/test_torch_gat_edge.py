"""GATv2's per-edge attention (``ops/gat_edge.py``) against the layer's
earlier math, on the CPU, and its kernels against their plain versions on
the card.

CPU: ``GATv2Conv`` (now the plain versions behind two autograd nodes) on
small padded blocks against ``_earlier_forward``, the layer's math before
the kernels (row gathers, the leaky ReLU and products over [E_cap, H*O],
``edge_softmax``, the messages' masked segment sum) with autograd's
gradients: rst, e and a, and the gradients to h_src, fc_src.weight and
attn, with masked slots inside the prefix, an empty dst, n_valid = 0, (4,
256) and (1, 41) heads, bf16 and f32, with and without dropout (drawn from
one generator in the same order). Tolerances: e bit-equal on the kept
edges (the same roundings); f32 rtol 1e-5 (the backward now sums in f32 in
another order); bf16 rtol 2e-2 of each tensor's largest value (the earlier
backward rounded every intermediate to bf16, the plain versions round
once). Also the three
segment sums a layer, the attention dropout as an ordinary call under grad
mode (the benchmark's ``Recorder`` reads its keep masks there), and zeros
on the slots that are not kept edges.

Card (marked ``cuda``; no JAX in this file): each kernel against its plain
version at the GATv2 layer-0 shape (~100,000 slots, ~60,000 valid, a hub
dst of 3,000 edges, H*O = 1024) and at (1, 41), bf16 and f32; the layer on
the card against the layer on the CPU; K5's three launch sites once each a
wide layer; run with ``python -m pytest -m cuda tests/test_torch_gat_edge.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bliss_gnn_tpu_torch.models import layers
from bliss_gnn_tpu_torch.ops import gat_edge
from bliss_gnn_tpu_torch.ops.segment import (
    edge_softmax,
    gather_rows,
    masked_segment_sum,
)
from bliss_gnn_tpu_torch.sampling.block import Block

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _block(n_src, n_dst, e_cap, n_live, seed, hub=0, device="cpu"):
    """A padded block: the prefix opens with dst 0's edges with masked slots
    among them (their ids 0, so where(e_mask, e_dst, 0) stays sorted), then
    sorted dsts in [2, n_dst) (dst 1 empty), ``hub`` more edges into one
    dst; the tail past the last kept edge masked. ``n_live`` 0: every slot
    masked."""
    rng = np.random.default_rng(seed)
    e_dst = np.zeros(e_cap, np.int32)
    e_src = np.zeros(e_cap, np.int32)
    mask = np.zeros(e_cap, bool)
    if n_live:
        lead = [0, 0, 1, 0, 1, 1]  # dst 0's run: two masked slots first
        rest = np.sort(np.concatenate([
            rng.integers(2, n_dst, n_live - 3 - hub),
            np.full(hub, n_dst // 2)])).astype(np.int32)
        n = len(lead) + len(rest)
        e_dst[len(lead):n] = rest
        mask[:len(lead)] = np.array(lead, bool)
        mask[len(lead):n] = True
        e_src[:n] = rng.integers(0, n_src, n)
        e_src[~mask] = 0
    t = lambda a: torch.from_numpy(a).to(device)
    z = torch.zeros(e_cap, device=device)
    return Block(src_gids=torch.arange(n_src, dtype=torch.int32,
                                       device=device),
                 src_mask=torch.ones(n_src, dtype=torch.bool, device=device),
                 e_src=t(e_src), e_dst=t(e_dst), e_mask=t(mask),
                 eid=torch.zeros(e_cap, dtype=torch.int32, device=device),
                 e_weight=z, e_q=z, src_node_prob=torch.zeros(n_src,
                                                              device=device),
                 n_dst_cap=n_dst)


def _earlier_forward(conv, block, h_src, generator):
    """``GATv2Conv.forward`` as it was before ``ops/gat_edge.py`` (no
    residual or activation)."""
    n_dst, H, O = block.n_dst_cap, conv.num_heads, conv.out_feats
    h_src = h_src.to(conv.dtype)
    if conv.training:
        h_src = layers.dropout(h_src, conv.feat_drop, generator)
    feat2 = layers._linear(h_src, conv.fc_src.weight)
    nv = block.n_valid_edges()
    el2 = gather_rows(feat2, block.e_src, feat2.shape[0], n_valid=nv)
    er2 = gather_rows(feat2[:n_dst], torch.clamp(block.e_dst, 0, n_dst - 1),
                      n_dst, n_valid=nv, ids_sorted=True)
    el = el2.reshape(-1, H, O)
    e_full = F.leaky_relu(el + er2.reshape(-1, H, O), conv.negative_slope)
    e = (e_full * conv.attn.to(conv.dtype)).sum(dim=-1)
    a = edge_softmax(e, block.e_dst, n_dst, block.e_mask, n_valid=nv,
                     ids_sorted=True)
    if conv.training:
        a = layers.dropout(a, conv.attn_drop, generator)
    msg2 = (el * a[..., None].to(conv.dtype)).reshape(-1, H * O)
    rst = masked_segment_sum(msg2, block.e_dst, n_dst, block.e_mask,
                             n_valid=nv, ids_sorted=True)
    return rst.reshape(n_dst, H, O), e


def _run(conv, block, h, w, forward, seed):
    """rst, e and the gradients to h_src and the parameters of one forward
    and backward of (rst * w).sum(); dropout drawn from ``seed``."""
    conv.zero_grad()
    x = h.clone().requires_grad_()
    gen = torch.Generator().manual_seed(seed)
    rst, e = forward(conv, block, x, gen)
    (rst.float() * w).sum().backward()
    return (rst.detach(), e.detach(), x.grad, conv.fc_src.weight.grad.clone(),
            conv.attn.grad.clone())


def _close(got, want, dtype, what):
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) if want.numel() else 0.0
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   msg=lambda m: f"{what}: {m}")
    else:
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2 * scale,
                                   msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", ["masked", "none_valid"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,out", [(4, 256), (1, 41)])
def test_plain_attention_equals_the_earlier_math(heads, out, dtype, case,
                                                 train):
    n_src, n_dst, e_cap = 40, 12, 160
    block = _block(n_src, n_dst, e_cap, 0 if case == "none_valid" else 110,
                   seed=heads)
    torch.manual_seed(0)
    conv = layers.GATv2Conv(24, out, heads, feat_drop=0.3, attn_drop=0.3,
                            generator=torch.Generator().manual_seed(1),
                            dtype=dtype)
    with torch.no_grad():
        conv.attn.mul_(4.0)  # logits of a few units: the softmax not flat
    conv.train(train)
    h = torch.randn(n_src, 24)
    w = torch.randn(n_dst, heads, out)
    got = _run(conv, block, h, w, lambda c, b, x, g: c(b, x, generator=g), 5)
    want = _run(conv, block, h, w, _earlier_forward, 5)
    kept = block.e_mask
    assert torch.equal(got[1][kept], want[1][kept])  # e on the kept edges
    assert not got[1][~kept].any()
    for name, g, wv in zip(("rst", "e", "h_src", "fc_src.weight", "attn"),
                           got, want):
        if name != "e":
            _close(g, wv, dtype, name)
    if case == "none_valid":
        assert not got[0].any() and not got[2].any() and not got[4].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,out", [(4, 256), (1, 41)])
def test_plain_scores_match_the_edge_softmax(heads, out, dtype):
    """a from the plain kernel F against ``edge_softmax`` of the same
    logits; e and a read 0 on the masked slots inside the prefix and past
    n_valid (here 20 slots past the last kept edge)."""
    n_src, n_dst, e_cap = 40, 12, 160
    block = _block(n_src, n_dst, e_cap, 110, seed=3, hub=40)
    feat2 = torch.randn(n_src, heads * out).to(dtype)
    attn = (2.0 * torch.randn(1, heads, out)).to(dtype)
    ids = torch.where(block.e_mask, block.e_dst, 0)
    nv = block.n_valid_edges() + 20
    e, a, stats = gat_edge.edge_scores(feat2, attn, block.e_src, ids,
                                       block.e_mask, nv, n_dst, 0.2)
    want = edge_softmax(e, block.e_dst, n_dst, block.e_mask,
                        n_valid=block.n_valid_edges(), ids_sorted=True)
    torch.testing.assert_close(a.float(), want.float(), rtol=2 ** -7,
                               atol=1e-7)
    dead = ~block.e_mask
    assert not e[dead].any() and not a[dead].any()
    assert stats.shape == (n_dst, heads, 2) and stats.dtype == torch.float32


def test_three_segment_sums_a_layer(monkeypatch):
    """The messages into the dsts (sorted), d_el into the srcs (unsorted, by
    a route with the same bits on every call) and d_er into the dsts
    (sorted): once each a layer, each [E_cap, H*O], the routes K5 takes on
    the card at H*O = 1024. (On the CPU the plain versions also take their
    softmax's per-dst sums of [E, H] through the segment ops.)"""
    calls = []

    def recorded(data, ids, n, mask=None, n_valid=None, ids_sorted=False,
                 deterministic=False):
        calls.append((tuple(data.shape), n, ids_sorted, mask is None,
                      deterministic))
        return masked_segment_sum(data, ids, n, mask, n_valid, ids_sorted,
                                  deterministic)

    monkeypatch.setattr(gat_edge, "masked_segment_sum", recorded)
    block = _block(40, 12, 160, 110, seed=2)
    conv = layers.GATv2Conv(24, 256, 4)
    rst, _ = conv(block, torch.randn(40, 24))
    rst.float().sum().backward()
    rows = [c for c in calls if c[0][1] == 1024]
    assert rows == [((160, 1024), 12, True, True, False),
                    ((160, 1024), 40, False, True, True),
                    ((160, 1024), 12, True, True, False)]
    # the rest are the plain versions' per-dst softmax sums over [E, H]
    assert all(c[0] == (160, 4) for c in calls if c not in rows)


def _f64_edges(heads, out, seed):
    """A small padded block's edge arrays and f64 rows for gradcheck."""
    block = _block(12, 5, 40, 24, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    feat2 = torch.randn(12, heads * out, generator=gen, dtype=torch.float64)
    attn = torch.randn(1, heads, out, generator=gen, dtype=torch.float64)
    edges = (block.e_src, torch.where(block.e_mask, block.e_dst, 0),
             block.e_mask, block.n_valid_edges(), block.n_dst_cap)
    return feat2.requires_grad_(), attn.requires_grad_(), edges


@pytest.mark.parametrize("heads,out", [(2, 3), (1, 5)])
def test_attention_gradcheck_through_the_dropout(heads, out):
    """autograd's gradcheck in f64 on the plain path, attention_scores ->
    ``layers.dropout`` (a fixed draw) -> attention_messages, with both rst
    and e as outputs: the messages' feat2 gradient, which travels to the
    scores' backward, is neither lost nor counted twice, and e alone is
    differentiable."""
    feat2, attn, edges = _f64_edges(heads, out, seed=3)

    def f(feat2, attn):
        e, a, link = gat_edge.attention_scores(feat2, attn, *edges, 0.2)
        a = layers.dropout(a, 0.3, torch.Generator().manual_seed(5))
        return gat_edge.attention_messages(feat2, a, *edges, link), e

    assert torch.autograd.gradcheck(f, (feat2, attn))


def test_messages_gradient_reaches_feat2_with_a_detached_a():
    """With a detached before the messages, feat2 still gets the messages'
    gradient sum over edges of a * g[dst] into its src row (the scores'
    backward runs for it with no cotangent of a), and attn none."""
    feat2, attn, edges = _f64_edges(4, 3, seed=4)
    e_src, ids, mask, nv, n_dst = edges
    _, a, link = gat_edge.attention_scores(feat2, attn, *edges, 0.2)
    a = a.detach()
    w = torch.randn(n_dst, 12, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(6))
    rst = gat_edge.attention_messages(feat2, a, *edges, link)
    (rst * w).sum().backward()
    live = mask & (torch.arange(mask.shape[0]) < int(nv))
    rows = (a[:, :, None] * w[ids.long()].reshape(-1, 4, 3)).reshape(-1, 12)
    want = torch.zeros_like(feat2).index_add_(
        0, e_src.long(), torch.where(live[:, None], rows, 0.0))
    torch.testing.assert_close(feat2.grad, want, rtol=1e-12, atol=1e-12)
    assert attn.grad is None or not attn.grad.any()


def test_a_link_serves_one_messages_call():
    feat2, attn, edges = _f64_edges(2, 3, seed=5)
    _, a, link = gat_edge.attention_scores(feat2, attn, *edges, 0.2)
    gat_edge.attention_messages(feat2, a, *edges, link)
    with pytest.raises(ValueError, match="one attention_messages"):
        gat_edge.attention_messages(feat2, a, *edges, link)


def _load_recorder():
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from bmk.train import Recorder
    return Recorder


def test_attention_dropout_is_an_ordinary_call_in_the_train_step():
    """The benchmark's ``Recorder`` wraps ``layers.dropout`` and records the
    calls made under grad mode: in a GATv2 train step each layer makes two,
    the feature dropout on its [n_src_cap, d_in] input, then the attention
    dropout on a [E_cap, H], a tensor of the autograd graph. Moved inside a
    kernel or an ``autograd.Function`` (whose forward runs without grad
    mode), the second call would go unrecorded."""
    from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
    from bliss_gnn_tpu_torch.graph.structure import (
        DeviceGraph, Graph, normalized_edata)
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig, init_exp3_weights)
    from bliss_gnn_tpu_torch.train import steps

    g, n_cls, _ = synthetic_graph(400, 4000, 16, 4, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    dg = DeviceGraph.from_graph(g, device="cpu")
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=(24, 12, 6),
                        model="gat")
    plan = CapacityPlan.build(8, cfg.fanouts, g.n_nodes, g.n_edges,
                              kind=cfg.kind)
    heads = (2, 2, 1)
    model = build_model("gat", 16, 8, n_cls, 3, dropout=0.1, num_in_heads=2,
                        attn_drop=0.1, device="cpu")
    opt, sched = steps.make_optimizer(model.parameters(), 1e-3, 1)
    state = steps.TrainState(model, opt, sched,
                             init_exp3_weights(3, g.n_edges, device="cpu"),
                             torch.Generator().manual_seed(0))
    recorder = _load_recorder()()
    try:
        step = steps.make_train_step(dg, cfg, plan, False, device="cpu")
        step(state, torch.arange(8, dtype=torch.int32),
             torch.ones(8, dtype=torch.bool))
        blocks, drops = recorder.blocks, recorder.drops
    finally:
        recorder.uninstall()
    assert recorder.calls == 1 and len(drops) == 6
    for l, (blk, hd) in enumerate(zip(blocks, heads)):
        (x, _), (a, a_out) = drops[2 * l], drops[2 * l + 1]
        assert x.shape[0] == blk.n_src_cap
        assert a.shape == (blk.e_cap, hd) and a.requires_grad
        assert a_out.grad_fn is not None
        kept = blk.e_mask
        sums = masked_segment_sum(a.detach().float(), blk.e_dst, blk.n_dst_cap,
                                  kept)
        has_edges = masked_segment_sum(torch.ones(blk.e_cap), blk.e_dst,
                                       blk.n_dst_cap, kept) > 0
        torch.testing.assert_close(sums[has_edges],
                                   torch.ones_like(sums[has_edges]),
                                   rtol=2e-2, atol=0)  # a softmax per dst
        assert not a.detach()[~kept].any()


# -- the kernels on the card ------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_SHAPES = {
    # GATv2's layer 0 on the Reddit configuration: ~60,000 kept edges of
    # 100,032 slots, a hub dst of 3,000 edges
    "layer0": dict(n_src=8064, n_dst=3712, e_cap=100_032, n_live=60_000,
                   hub=3000, heads=4, out=256),
    "out": dict(n_src=1408, n_dst=256, e_cap=4608, n_live=1819, hub=900,
                heads=1, out=41),
}


def _softmax(ef, ids, live, n_dst):
    """f32 softmax of the logits ``ef`` per dst, 0 off the kept edges, and
    its (max, denominator) pairs."""
    h = ef.shape[1]
    d = ids.long()[:, None].expand(-1, h)
    lv = live[:, None]
    m = torch.full((n_dst, h), -float("inf")).scatter_reduce(
        0, d, torch.where(lv, ef, -float("inf")), "amax")
    ex = torch.where(lv, torch.exp(ef - torch.where(torch.isfinite(m), m, 0.0)
                                   .gather(0, d)), 0.0)
    s = torch.zeros((n_dst, h)).scatter_add(0, d, ex)
    return torch.where(lv, ex / s.clamp(min=1e-38).gather(0, d), 0.0), m, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_gat_edge_kernels_match_plain(dev, shape, dtype):
    """Each kernel on the card against its plain version on the CPU, on the
    same inputs: e within one rounding (the same terms, summed in another
    order); a, the pairs and the backward from the kernel's own e; the
    messages bit-equal; every other output within two of the dtype's
    roundings. Slots that are not kept edges read 0 in e, a and d_a, and
    the prefix's masked rows 0."""
    p = _SHAPES[shape]
    h, o = p["heads"], p["out"]
    n_src, n_dst, e_cap = p["n_src"], p["n_dst"], p["e_cap"]
    blk = _block(n_src, n_dst, e_cap, p["n_live"], seed=7, hub=p["hub"])
    gen = torch.Generator().manual_seed(11)
    feat2 = torch.randn(n_src, h * o, generator=gen).to(dtype)
    attn = (torch.randn(1, h, o, generator=gen) / 4).to(dtype)
    g = torch.randn(n_dst, h * o, generator=gen).to(dtype)
    ids = torch.where(blk.e_mask, blk.e_dst, 0)
    nv = blk.n_valid_edges()
    live = blk.e_mask
    cpu = (blk.e_src, ids, blk.e_mask, nv)
    cuda = tuple(t.to(dev) for t in cpu)
    rnd = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5

    e, a, stats = gat_edge.edge_scores(feat2.to(dev), attn.to(dev), *cuda[:3],
                                       cuda[3], n_dst, 0.2)
    e, a, stats = e.cpu(), a.cpu(), stats.cpu()
    e_want, _, _ = gat_edge.edge_scores_plain(feat2, attn, *cpu, n_dst, 0.2)
    e_want = e_want.float()
    torch.testing.assert_close(e.float(), e_want, rtol=rnd,
                               atol=rnd * float(e_want.abs().max()))
    a_want, m, s = _softmax(e.float(), ids, live, n_dst)
    torch.testing.assert_close(a.float(), a_want, rtol=rnd, atol=1e-7)
    has = torch.zeros(n_dst, dtype=torch.bool).index_fill_(
        0, ids[live].long(), True)
    torch.testing.assert_close(stats[has][..., 0], m[has], rtol=0, atol=0)
    torch.testing.assert_close(stats[has][..., 1], s[has], rtol=1e-5,
                               atol=0)
    assert not e[~live].any() and not a[~live].any()

    a_drop = a * (torch.rand(a.shape, generator=gen) >= 0.1).to(dtype) / 0.9
    a_drop = a_drop.to(dtype)
    msg = gat_edge.edge_messages(feat2.to(dev), a_drop.to(dev), cuda[0],
                                 cuda[2], cuda[3]).cpu()
    want = gat_edge.edge_messages_plain(feat2, a_drop, *cpu[:1], cpu[2], nv)
    n = int(nv)
    assert torch.equal(msg[:n], want[:n])

    d_a = gat_edge.messages_grad(g.to(dev), feat2.to(dev), *cuda, h).cpu()
    want = gat_edge.messages_grad_plain(g, feat2, *cpu, h)
    torch.testing.assert_close(d_a.float(), want.float(), rtol=rnd,
                               atol=rnd * float(want.float().abs().max()))
    assert not d_a[~live].any()

    da = torch.randn(a.shape, generator=gen).to(dtype)
    de = torch.randn(a.shape, generator=gen).to(dtype)
    got = gat_edge.scores_grad(
        feat2.to(dev), attn.to(dev), *cuda, n_dst, 0.2, e.to(dev),
        stats.to(dev), da.to(dev), de.to(dev), g.to(dev), a_drop.to(dev))
    want = gat_edge.scores_grad_plain(feat2, attn, *cpu, n_dst, 0.2, e, stats,
                                      da, de, g, a_drop)
    for name, x, y in zip(("d_el", "d_er", "d_attn"), got, want):
        x, y = x.cpu().float(), y.float()
        tol = 2 * rnd
        if name == "d_attn":  # sums of 60,000 terms, in another order
            tol = max(tol, 1e-4)
        else:
            x, y = x[:n], y[:n]
            assert not x[~live[:n]].any(), name
        torch.testing.assert_close(x, y, rtol=tol,
                                   atol=tol * float(y.abs().max()), msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_gatv2_layer_on_the_card_equals_the_cpu(dev, shape, dtype):
    """One ``GATv2Conv`` forward and backward, with dropout, on the card
    (the kernels) and on the CPU (the plain versions): rst and the
    gradients to h_src, fc_src.weight and attn at bf16's tolerance (the
    kernels sum the logits in f32) or within 1e-4 in f32, e on the kept
    edges likewise, and 0 elsewhere. The dropout draws are the CPU
    generator's in both. The inputs, the projection's weights and the
    feature dropout's scale (p = 0.5) are exact in a few bits, so both
    sides project the same rows: a projection rounded otherwise can move a
    sum f_src + f_dst across 0, where leaky ReLU's slope jumps."""
    p = _SHAPES[shape]
    h, o = p["heads"], p["out"]
    blk = _block(p["n_src"], p["n_dst"], p["e_cap"], p["n_live"], seed=5,
                 hub=p["hub"])
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(-4, 5, (p["n_src"], 64), generator=gen) / 4.0
    w = torch.randn(p["n_dst"], h, o, generator=gen)
    conv = layers.GATv2Conv(64, o, h, feat_drop=0.5, attn_drop=0.1,
                            generator=torch.Generator().manual_seed(3),
                            dtype=dtype).train()
    with torch.no_grad():
        conv.fc_src.weight.copy_(torch.randint(
            -8, 9, conv.fc_src.weight.shape, generator=gen) / 64.0)
    out = {}
    for where in ("cpu", "cuda"):
        conv.to(where).zero_grad()
        b = Block(**{f: (getattr(blk, f).to(where)
                         if isinstance(getattr(blk, f), torch.Tensor)
                         else getattr(blk, f))
                     for f in ("src_gids", "src_mask", "e_src", "e_dst",
                               "e_mask", "eid", "e_weight", "e_q",
                               "src_node_prob", "n_dst_cap")})
        keep_gen = torch.Generator().manual_seed(4)
        drop = layers.dropout

        def cpu_draws(t, p_, generator):  # the same keeps on both sides
            if p_ <= 0:
                return t
            keep = (torch.rand(t.shape, generator=keep_gen) >= p_).to(t.device)
            return torch.where(keep, t / (1.0 - p_), 0.0)

        layers.dropout = cpu_draws
        try:
            xi = x.to(where).detach().requires_grad_()
            rst, e = conv(b, xi)
            (rst.float() * w.to(where)).sum().backward()
        finally:
            layers.dropout = drop
        out[where] = [t.detach().cpu().float() for t in (
            rst, e, xi.grad, conv.fc_src.weight.grad, conv.attn.grad)]
    kept = blk.e_mask
    for name, got, want in zip(("rst", "e", "h_src", "fc_src.weight", "attn"),
                               out["cuda"], out["cpu"]):
        if name == "e":
            assert not got[~kept].any()
            got, want = got[kept], want[kept]
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=tol * float(want.abs().max()),
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
def test_k5_sites_once_each_a_wide_layer(dev):
    """At H*O = 1024 on a block past K5's 2^15 rows, a GATv2 layer's
    forward and backward launch K5 at its three sites once each (the sorted
    route two kernels a call, the unsorted five) and kernel F, M and their
    backward once each."""
    from bliss_gnn_tpu_torch.ops.rowscatter import row_scatter_add

    p = _SHAPES["layer0"]
    blk = _block(p["n_src"], p["n_dst"], p["e_cap"], p["n_live"], seed=1,
                 hub=p["hub"], device=dev)
    conv = layers.GATv2Conv(64, 256, 4).to(dev)
    x = torch.randn(p["n_src"], 64, device=dev)
    k5 = dict(row_scatter_add.launches_by_shape)
    mine = dict(gat_edge.launches_by_shape)
    rst, _ = conv(blk, x)
    rst.float().sum().backward()
    torch.cuda.synchronize()
    shape = f"{p['e_cap']}x1024"

    def delta(now, before):
        return {k: v - before.get(k, 0) for k, v in now.items()
                if v != before.get(k, 0)}

    assert delta(row_scatter_add.launches_by_shape, k5) == {
        f"sorted {shape}": 4, f"unsorted {shape}": 5}
    assert delta(gat_edge.launches_by_shape, mine) == {
        f"fwd {shape}": 4, f"msg {shape}": 1, f"msg_bwd {shape}": 1,
        f"bwd {shape}": 4}
