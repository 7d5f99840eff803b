"""GATv2's per-edge attention on a sampled block, bounded by its valid prefix.

``models.layers.GATv2Conv`` projects a block's src rows to ``feat2`` [n_src,
H*O] (its first ``n_dst`` rows are the dsts'), then per edge reads the src
and dst rows: logits e = sum_O(leaky_relu(f_src + f_dst) * attn), the
softmax a over each dst's edges, and messages f_src * a summed per dst.
These are the four functions of that attention and its backward, each with
its plain PyTorch version:

- :func:`edge_scores` (kernel F): e and a [E, H] in the compute dtype, and
  per dst and head the softmax's max and denominator (f32 [n_dst, H, 2]);
- :func:`edge_messages` (kernel M): the message rows [E, H*O] that the
  segment sum into the dsts reads;
- :func:`messages_grad`: the messages' gradient in a, [E, H];
- :func:`scores_grad`: F's backward with M's row gradient folded in: the
  rows d_el (into the srcs) and d_er (into the dsts) [E, H*O] that the two
  gather backwards' segment sums read, and attn's gradient.

A CUDA tensor goes to the hand-written kernels of ``csrc/gat_edge.cu`` (the
design note is in the source); a CPU tensor goes to the plain versions,
the kernels' arithmetic in PyTorch and their oracle on the card. The
logits round where the layer's earlier math rounded (the GAT reward
divides each by its dst's sum, which amplifies a rounding); the rest
computes in f32 and rounds each output once. The
kernels walk only the valid prefix, ``n_valid`` read on the card (no host
read, so a captured step replays them), and materialise no [E_cap, H*O]
tensor but the rows the segment sums read. The JAX package leaves these
passes to XLA, so they replace no TPU kernel.

The block's edges: ``e_src`` [E], ``ids_dst`` = where(e_mask, e_dst, 0) [E],
non-decreasing on the prefix (the sorted segment sums' promise), ``e_mask``
[E] and ``n_valid`` (a 0-dim int32 tensor, or an int off capture). A slot
is live when it lies in the prefix and ``e_mask`` holds; e and a read 0 on
every other slot, and the row outputs are 0 on the prefix's dead slots. Ids
are clamped into their tables.

:func:`attention_scores` and :func:`attention_messages` are the two autograd
nodes the layer calls, its attention dropout between them, so the dropout
stays an ordinary call under grad mode. Their segment sums keep the routes
``segment.masked_segment_sum`` gives them by shape (K5 for wide rows, K3
otherwise), once each a layer: the messages into the dsts (sorted), d_er
into the dsts (sorted), d_el into the srcs (unsorted, by a route that gives
the same bits on every call: K5's, or K3's stable one, so a step is
reproducible).

``launches`` adds one per kernel launched, ``launches_by_shape`` the same by
function and shape, e.g. ``"fwd 100032x1024"`` (four kernels a call),
``"msg 100032x1024"``, ``"msg_bwd 100032x1024"``, ``"bwd 100032x1024"``
(four).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32, prefix_mask, valid_arg
from bliss_gnn_tpu_torch.ops.segment import (
    masked_segment_max,
    masked_segment_sum,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADS = 8  # csrc kHMax
MAX_ROW = 1024  # H*O, csrc kRowMax
TILE = 32  # slots a warp takes (csrc)
BLOCK_TILES = 4  # warps a block (csrc kWarps)
_TINY = torch.finfo(torch.float32).tiny

launches = 0
launches_by_shape = {}


def _count(key: str, n: int) -> None:
    """``n`` kernels launched: the total and the function and shape's."""
    global launches
    launches += n
    launches_by_shape[key] = launches_by_shape.get(key, 0) + n


# -- plain versions -----------------------------------------------------------


def _live(e_mask: torch.Tensor, n_valid) -> torch.Tensor:
    live = prefix_mask(e_mask.shape[0], n_valid, e_mask.device)
    return e_mask if live is None else e_mask & live


def _clamped(ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(ids, 0, n - 1).long()


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: f32, or f64 for f64 rows
    (which the kernels do not take; autograd's gradcheck does)."""
    return torch.promote_types(x.dtype, torch.float32)


def edge_scores_plain(feat2: torch.Tensor, attn: torch.Tensor,
                      e_src: torch.Tensor, ids_dst: torch.Tensor,
                      e_mask: torch.Tensor, n_valid, n_dst: int,
                      negative_slope: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F's plain version, the layer's earlier math: the rows' sum, its
    leaky ReLU and each product with attn in the compute dtype, summed over
    O in f32 and rounded once; the softmax in f32 from the rounded logits,
    its max and denominator per dst the segment ops' (``ops/segment.py``)."""
    h, o = _heads(feat2, attn)
    live1 = _live(e_mask, n_valid)
    live = live1[:, None]
    d = _clamped(ids_dst, n_dst)
    el = feat2[_clamped(e_src, feat2.shape[0])].reshape(-1, h, o)
    er = feat2[d].reshape(-1, h, o)
    e = (F.leaky_relu(el + er, negative_slope) * attn.reshape(1, h, o)).sum(-1)
    e = torch.where(live, e, 0.0)
    ef = e.to(_acc(feat2))
    m = masked_segment_max(ef, d, n_dst, live1)
    shift = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.where(live, torch.exp(ef - shift[d]), 0.0)
    s = masked_segment_sum(ex, d, n_dst)
    a = torch.where(live, ex / torch.clamp(s, min=_TINY)[d], 0.0)
    return e, a.to(feat2.dtype), torch.stack([m, s], dim=-1)


def edge_messages_plain(feat2: torch.Tensor, a_drop: torch.Tensor,
                        e_src: torch.Tensor, e_mask: torch.Tensor,
                        n_valid) -> torch.Tensor:
    """Kernel M's plain version: feat2[e_src] * a_drop per head, one
    rounding, 0 on the slots that are not live."""
    e, h = a_drop.shape
    el = feat2[_clamped(e_src, feat2.shape[0])].reshape(e, h, -1)
    msg = (el * a_drop[..., None]).reshape(e, -1)
    return torch.where(_live(e_mask, n_valid)[:, None], msg, 0.0)


def messages_grad_plain(g: torch.Tensor, feat2: torch.Tensor,
                        e_src: torch.Tensor, ids_dst: torch.Tensor,
                        e_mask: torch.Tensor, n_valid,
                        heads: int) -> torch.Tensor:
    """The messages' backward in a_drop: per head sum_O g[dst] * feat2[src]
    in f32, rounded once, 0 on the slots that are not live."""
    e, acc = e_src.shape[0], _acc(g)
    el = feat2[_clamped(e_src, feat2.shape[0])].to(acc)
    gd = g[_clamped(ids_dst, g.shape[0])].to(acc)
    d_a = (el * gd).reshape(e, heads, -1).sum(-1)
    return torch.where(_live(e_mask, n_valid)[:, None], d_a, 0.0).to(g.dtype)


def scores_grad_plain(feat2: torch.Tensor, attn: torch.Tensor,
                      e_src: torch.Tensor, ids_dst: torch.Tensor,
                      e_mask: torch.Tensor, n_valid, n_dst: int,
                      negative_slope: float, e: torch.Tensor,
                      stats: torch.Tensor, da: torch.Tensor,
                      de: Optional[torch.Tensor] = None,
                      g: Optional[torch.Tensor] = None,
                      a_drop: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F's backward in f32, with M's row gradient folded in: from the
    cotangents of a (``da``), e (``de``) and of the messages' sum (``g``,
    with the ``a_drop`` the messages read), the rows d_el = a_drop g[dst] +
    dz and d_er = dz, dz = d_logit attn leaky'(z), d_logit = a (da - sum over
    the dst of a da) + de, each rounded once to the compute dtype (0 on the
    slots that are not live), and attn's gradient sum d_logit leaky(z)."""
    h, o = _heads(feat2, attn)
    n, acc = e.shape[0], _acc(feat2)
    live = _live(e_mask, n_valid)[:, None]
    d = _clamped(ids_dst, n_dst)
    m, s = stats[..., 0], stats[..., 1]
    a = torch.where(live, torch.exp(e.to(acc) - m[d])
                    / torch.clamp(s, min=_TINY)[d], 0.0)
    da = da.to(acc)
    dl = a * (da - masked_segment_sum(a * da, d, n_dst)[d])
    if de is not None:
        dl = dl + de.to(acc)
    dl = torch.where(live, dl, 0.0)
    z = (feat2[_clamped(e_src, feat2.shape[0])].to(acc)
         + feat2[d].to(acc)).reshape(n, h, o)
    pos = z > 0
    dz = (dl[..., None] * attn.to(acc).reshape(1, h, o)
          * torch.where(pos, 1.0, negative_slope))
    d_attn = (dl[..., None] * torch.where(pos, z, z * negative_slope)).sum(0)
    d_el = dz
    if g is not None:
        d_el = (a_drop.to(acc)[..., None]
                * g[d].to(acc).reshape(n, h, o) + dz)
    rows = [torch.where(live, x.reshape(n, h * o), 0.0).to(feat2.dtype)
            for x in (d_el, dz)]
    return rows[0], rows[1], d_attn.reshape(-1).to(attn.dtype)


# -- the kernels ----------------------------------------------------------------


def _heads(feat2: torch.Tensor, attn: torch.Tensor) -> Tuple[int, int]:
    """(H, O) from attn [.., H, O] and feat2's rows of H*O."""
    o = attn.shape[-1]
    h = attn.numel() // o
    if feat2.dim() != 2 or feat2.shape[1] != h * o:
        raise ValueError(f"gat_edge: feat2 must be [N, {h * o}] for attn of "
                         f"shape {tuple(attn.shape)}")
    return h, o


def _check(feat2: torch.Tensor, h: int, *ts) -> None:
    """The kernels' limits for rows of ``h`` heads; every tensor of
    ``ts`` on feat2's card, every float one in its dtype."""
    dev = feat2.device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in ts):
        raise ValueError(f"gat_edge: no kernel for {dev} with the block's "
                         "tensors elsewhere")
    if feat2.dtype not in _DTYPE_CODE or any(
            t is not None and t.is_floating_point() and t.dtype != feat2.dtype
            for t in ts):
        raise TypeError(f"gat_edge: no kernel for {feat2.dtype} rows with "
                        "other float dtypes")
    if (feat2.dim() != 2 or h < 1 or h > MAX_HEADS or feat2.shape[1] % h
            or feat2.shape[1] > MAX_ROW):
        raise ValueError(f"gat_edge: rows of {tuple(feat2.shape[1:])} in {h} "
                         f"heads are past the kernels' {MAX_HEADS} heads and "
                         f"rows of {MAX_ROW}")


def _edges(e_src, ids_dst, e_mask, n_valid, dev):
    """The block's edge arrays as the C entries take them (``ids_dst``
    None: left out)."""
    if e_mask.dtype != torch.bool or e_mask.dim() != 1:
        raise TypeError("gat_edge: e_mask must be a 1-D bool tensor")
    if e_src.shape != e_mask.shape or (ids_dst is not None
                                       and ids_dst.shape != e_mask.shape):
        raise ValueError("gat_edge: e_src, ids_dst and e_mask differ in "
                         "length")
    return (index_i32(e_src, "gat_edge e_src"),
            None if ids_dst is None else index_i32(ids_dst, "gat_edge ids_dst"),
            e_mask.contiguous(), valid_arg(n_valid, dev))


def _aligned(*rows) -> int:
    """Whether every row tensor starts on a 16-byte boundary (their rows of
    whole vectors are checked in the C entry)."""
    return int(all(t is None or t.data_ptr() % 16 == 0 for t in rows))


def _scratch(e_cap: int, h: int, dev):
    """The per-dst reduce's carry records (csrc: 3 ints and 4 H floats a
    warp tile)."""
    n_tiles = BLOCK_TILES * max(1, -(-e_cap // (TILE * BLOCK_TILES)))
    return (torch.empty(3 * n_tiles, dtype=torch.int32, device=dev),
            torch.empty(4 * h * n_tiles, dtype=torch.float32, device=dev))


def edge_scores(feat2: torch.Tensor, attn: torch.Tensor, e_src: torch.Tensor,
                ids_dst: torch.Tensor, e_mask: torch.Tensor, n_valid,
                n_dst: int, negative_slope: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F: (e, a, stats). e and a [E, H] in feat2's dtype, as
    :func:`edge_scores_plain` rounds them; stats f32 [n_dst, H, 2], each
    dst's max logit and softmax denominator (rows of dsts with no live edge
    unspecified on the card)."""
    if feat2.device.type == "cpu":
        return edge_scores_plain(feat2, attn, e_src, ids_dst, e_mask, n_valid,
                                 n_dst, negative_slope)
    h, o = _heads(feat2, attn)
    _check(feat2, h, attn, e_src, ids_dst, e_mask)
    dev = feat2.device
    feat2, attn = feat2.contiguous(), attn.reshape(-1).contiguous()
    src, dst, mask, nv = _edges(e_src, ids_dst, e_mask, n_valid, dev)
    e_cap = src.shape[0]
    e = torch.empty((e_cap, h), dtype=feat2.dtype, device=dev)
    a = torch.empty_like(e)
    stats = torch.empty((n_dst, h, 2), dtype=torch.float32, device=dev)
    c_int, c_val = _scratch(e_cap, h, dev)
    err = _build.load("gat_edge").bliss_gat_edge_scores(
        feat2.data_ptr(), _DTYPE_CODE[feat2.dtype], _aligned(feat2, attn),
        feat2.shape[0], n_dst, h * o, o, h, src.data_ptr(), dst.data_ptr(),
        mask.data_ptr(), e_cap, _build.ptr(nv), attn.data_ptr(),
        ctypes.c_float(negative_slope), e.data_ptr(), stats.data_ptr(),
        a.data_ptr(), c_int.data_ptr(), c_val.data_ptr(),
        _build.stream_of(feat2))
    _count(f"fwd {e_cap}x{h * o}", 4)
    _build.check(err, "gat_edge (scores)")
    return e, a, stats


def edge_messages(feat2: torch.Tensor, a_drop: torch.Tensor,
                  e_src: torch.Tensor, e_mask: torch.Tensor,
                  n_valid) -> torch.Tensor:
    """Kernel M: the message rows [E, H*O] in feat2's dtype; on the card
    rows past the prefix are left unwritten (the sums stop there)."""
    if feat2.device.type == "cpu":
        return edge_messages_plain(feat2, a_drop, e_src, e_mask, n_valid)
    if a_drop.dim() != 2 or a_drop.shape[0] != e_src.shape[0]:
        raise ValueError("gat_edge: a_drop must be [E, H]")
    h = a_drop.shape[1]
    _check(feat2, h, e_src, e_mask, a_drop)
    o = feat2.shape[1] // h
    dev = feat2.device
    feat2, a_drop = feat2.contiguous(), a_drop.contiguous()
    src, _, mask, nv = _edges(e_src, None, e_mask, n_valid, dev)
    e_cap = src.shape[0]
    msg = torch.empty((e_cap, h * o), dtype=feat2.dtype, device=dev)
    err = _build.load("gat_edge").bliss_gat_edge_messages(
        feat2.data_ptr(), _DTYPE_CODE[feat2.dtype], _aligned(feat2, msg),
        feat2.shape[0], h * o, o, h, src.data_ptr(), mask.data_ptr(), e_cap,
        _build.ptr(nv), a_drop.data_ptr(), msg.data_ptr(),
        _build.stream_of(feat2))
    _count(f"msg {e_cap}x{h * o}", 1)
    _build.check(err, "gat_edge (messages)")
    return msg


def messages_grad(g: torch.Tensor, feat2: torch.Tensor, e_src: torch.Tensor,
                  ids_dst: torch.Tensor, e_mask: torch.Tensor, n_valid,
                  heads: int) -> torch.Tensor:
    """The messages' gradient in a_drop, [E, H] in g's dtype, from the
    cotangent g [n_dst, H*O] of their sum per dst (its rows read per dst)."""
    if feat2.device.type == "cpu":
        return messages_grad_plain(g, feat2, e_src, ids_dst, e_mask, n_valid,
                                   heads)
    _check(feat2, heads, e_src, ids_dst, e_mask, g)
    if g.dim() != 2 or g.shape[1] != feat2.shape[1]:
        raise ValueError("gat_edge: g must be [n_dst, H*O]")
    o = feat2.shape[1] // heads
    dev = feat2.device
    feat2, g = feat2.contiguous(), g.contiguous()
    src, dst, mask, nv = _edges(e_src, ids_dst, e_mask, n_valid, dev)
    e_cap = src.shape[0]
    d_a = torch.empty((e_cap, heads), dtype=feat2.dtype, device=dev)
    err = _build.load("gat_edge").bliss_gat_edge_msg_grad(
        feat2.data_ptr(), _DTYPE_CODE[feat2.dtype], _aligned(feat2, g),
        feat2.shape[0], g.shape[0], heads * o, o, heads, src.data_ptr(),
        dst.data_ptr(), mask.data_ptr(), e_cap, _build.ptr(nv), g.data_ptr(),
        d_a.data_ptr(), _build.stream_of(feat2))
    _count(f"msg_bwd {e_cap}x{heads * o}", 1)
    _build.check(err, "gat_edge (messages' backward)")
    return d_a


def scores_grad(feat2: torch.Tensor, attn: torch.Tensor, e_src: torch.Tensor,
                ids_dst: torch.Tensor, e_mask: torch.Tensor, n_valid,
                n_dst: int, negative_slope: float, e: torch.Tensor,
                stats: torch.Tensor, da: torch.Tensor,
                de: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None,
                a_drop: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F's backward with M's row gradient folded in: (d_el, d_er,
    d_attn) as :func:`scores_grad_plain` gives them; on the card the rows
    past the prefix are left unwritten. ``g`` and ``a_drop`` come together
    or not at all."""
    if feat2.device.type == "cpu":
        return scores_grad_plain(feat2, attn, e_src, ids_dst, e_mask, n_valid,
                                 n_dst, negative_slope, e, stats, da, de, g,
                                 a_drop)
    if (g is None) != (a_drop is None):
        raise ValueError("gat_edge: g and a_drop come together")
    h, o = _heads(feat2, attn)
    _check(feat2, h, attn, e_src, ids_dst, e_mask, e, da, de, g, a_drop)
    if stats.device != feat2.device or stats.dtype != torch.float32:
        raise TypeError("gat_edge: stats must be f32 on feat2's card")
    per_edge = (e_src.shape[0], h)
    if (any(t is not None and t.shape != per_edge for t in (e, da, de, a_drop))
            or stats.shape != (n_dst, h, 2)
            or (g is not None and g.shape != (n_dst, h * o))):
        raise ValueError("gat_edge: e, da, de, a_drop must be [E, H], stats "
                         "[n_dst, H, 2] and g [n_dst, H*O]")
    dev, dtype = feat2.device, feat2.dtype
    feat2, attn = feat2.contiguous(), attn.reshape(-1).contiguous()
    e, stats, da = e.contiguous(), stats.contiguous(), da.contiguous()
    de, g, a_drop = (None if t is None else t.contiguous()
                     for t in (de, g, a_drop))
    src, dst, mask, nv = _edges(e_src, ids_dst, e_mask, n_valid, dev)
    e_cap = src.shape[0]
    d_el = torch.empty((e_cap, h * o), dtype=dtype, device=dev)
    d_er = torch.empty_like(d_el)
    d_attn = torch.empty(h * o, dtype=dtype, device=dev)
    sums = torch.empty((n_dst, h, 2), dtype=torch.float32, device=dev)
    c_int, c_val = _scratch(e_cap, h, dev)
    blocks = max(1, -(-e_cap // (TILE * BLOCK_TILES)))
    part = torch.empty((blocks, h * o), dtype=torch.float32, device=dev)
    err = _build.load("gat_edge").bliss_gat_edge_grad(
        feat2.data_ptr(), _DTYPE_CODE[dtype],
        _aligned(feat2, attn, g, d_el, d_er), feat2.shape[0], n_dst, h * o, o,
        h, src.data_ptr(), dst.data_ptr(), mask.data_ptr(), e_cap,
        _build.ptr(nv), attn.data_ptr(), ctypes.c_float(negative_slope),
        e.data_ptr(), stats.data_ptr(), da.data_ptr(), _build.ptr(de),
        _build.ptr(g), _build.ptr(a_drop), d_el.data_ptr(), d_er.data_ptr(),
        d_attn.data_ptr(), sums.data_ptr(), c_int.data_ptr(),
        c_val.data_ptr(), part.data_ptr(), _build.stream_of(feat2))
    _count(f"bwd {e_cap}x{h * o}", 4)
    _build.check(err, "gat_edge (scores' backward)")
    return d_el, d_er, d_attn


# -- the layer's two autograd nodes ---------------------------------------------


class _Link:
    """The two nodes' shared state for one layer: whether the messages node
    was made (``used``: one per link), and the a_drop its backward leaves
    for the scores' backward, which adds a_drop * g[dst] into its d_el rows
    (one segment sum into the srcs takes both). g itself goes through
    autograd: the scores node's third output, a data-free token [n_dst,
    H*O], is an input of the messages node, and g is its gradient. So the
    scores' backward gets g only after the messages' backward ran, and
    differentiating e alone, rst alone or rst with a detached a loses
    nothing."""

    __slots__ = ("used", "a_drop")

    def __init__(self):
        self.used, self.a_drop = False, None


class _Scores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat2, attn, e_src, ids_dst, e_mask, n_valid, n_dst,
                negative_slope, link):
        e, a, stats = edge_scores(feat2, attn, e_src, ids_dst, e_mask,
                                  n_valid, n_dst, negative_slope)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(feat2, attn, e_src, ids_dst, e_mask, e, stats)
        ctx.n_valid, ctx.n_dst, ctx.slope, ctx.link = (n_valid, n_dst,
                                                       negative_slope, link)
        # never read: it only carries g back (no memory, no launch)
        token = feat2.new_empty(()).expand(n_dst, feat2.shape[1])
        return e, a, token

    @staticmethod
    def backward(ctx, de, da, g):
        feat2, attn, e_src, ids_dst, e_mask, e, stats = ctx.saved_tensors
        nv, n_dst, link = ctx.n_valid, ctx.n_dst, ctx.link
        a_drop = None
        if g is not None:
            a_drop, link.a_drop = link.a_drop, None
            if a_drop is None:
                raise RuntimeError("gat_edge: the messages' gradient came "
                                   "without their attention")
        if da is None:
            da = torch.zeros_like(e)
        d_el, d_er, d_attn = scores_grad(feat2, attn, e_src, ids_dst, e_mask,
                                         nv, n_dst, ctx.slope, e, stats, da,
                                         de, g, a_drop)
        d_feat = masked_segment_sum(d_el, e_src, feat2.shape[0], n_valid=nv,
                                    deterministic=True)
        d_feat[:n_dst] += masked_segment_sum(d_er, ids_dst, n_dst, n_valid=nv,
                                             ids_sorted=True)
        return (d_feat, d_attn.reshape(attn.shape), None, None, None, None,
                None, None, None)


class _Messages(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat2, a_drop, token, e_src, ids_dst, e_mask, n_valid,
                n_dst, link):
        msg = edge_messages(feat2, a_drop, e_src, e_mask, n_valid)
        ctx.save_for_backward(feat2, a_drop, e_src, ids_dst, e_mask)
        ctx.n_valid, ctx.link = n_valid, link
        return masked_segment_sum(msg, ids_dst, n_dst, n_valid=n_valid,
                                  ids_sorted=True)

    @staticmethod
    def backward(ctx, g):
        feat2, a_drop, e_src, ids_dst, e_mask = ctx.saved_tensors
        g = g.contiguous()
        d_a = None
        if ctx.needs_input_grad[1]:
            d_a = messages_grad(g, feat2, e_src, ids_dst, e_mask, ctx.n_valid,
                                a_drop.shape[1])
        if not ctx.needs_input_grad[2]:
            return None, d_a, None, None, None, None, None, None, None
        # feat2's gradient from the messages goes with the scores' rows
        ctx.link.a_drop = a_drop
        return None, d_a, g, None, None, None, None, None, None


def attention_scores(feat2: torch.Tensor, attn: torch.Tensor,
                     e_src: torch.Tensor, ids_dst: torch.Tensor,
                     e_mask: torch.Tensor, n_valid, n_dst: int,
                     negative_slope: float):
    """(e, a, link): the logits and softmax of :func:`edge_scores`,
    differentiable in feat2 and attn; ``link`` goes to one
    :func:`attention_messages` call of the same a (after its dropout)."""
    link = _Link()
    e, a, token = _Scores.apply(feat2, attn, e_src, ids_dst, e_mask, n_valid,
                                n_dst, negative_slope, link)
    return e, a, (token, link)


def attention_messages(feat2: torch.Tensor, a_drop: torch.Tensor,
                       e_src: torch.Tensor, ids_dst: torch.Tensor,
                       e_mask: torch.Tensor, n_valid, n_dst: int,
                       link) -> torch.Tensor:
    """[n_dst, H*O]: the messages feat2[e_src] * a_drop summed per dst,
    differentiable in a_drop, and in feat2 through ``link``'s scores node
    (so feat2 must be the one :func:`attention_scores` read)."""
    token, state = link
    if state.used:
        raise ValueError("gat_edge: a link serves one attention_messages "
                         "call")
    state.used = True
    return _Messages.apply(feat2, a_drop, token, e_src, ids_dst, e_mask,
                           n_valid, n_dst, state)
