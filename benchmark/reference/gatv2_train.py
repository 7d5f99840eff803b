"""Plain reference of one training step of GATv2 under the poisson-bandit
sampler (BLISS): the sampler's probabilities, the blocks' kept edges, the
model's forward and backward, the cross entropy, Adam, and the EXP3
arm-weight update with the GAT reward, in float32 plain PyTorch.

It imports nothing of the program. What it cannot draw itself it follows
from the program's own random draws, read from the step's tensors: which
candidate nodes the Bernoulli draws selected (the blocks' src tables) and
which entries each dropout kept, in the order the step draws them (per
layer the feature dropout, then the attention dropout). The attention
dropout's keep mask is read by edge id, so it does not depend on the
program's slot order. Everything else it works out again: the sampler's
side with ``sage_train.derive_block`` (frontiers, edge and node
probabilities, the Poisson scale, kept edges) on the arms scaled by a
power of two (``sampling_arms``), Adam with ``sage_train.Train``'s, and
here the layers, the loss, the gradients and the rewards.

A layer (GATv2, Brody et al., arXiv:2105.14491, as the BLISS reference's
``custom_GATv2Conv`` computes it):
- ``feat = drop(h) W^T``, one projection for the srcs and the dsts;
- ``e_ij = sum_O leaky_relu(feat_j + feat_i, slope) * attn`` per head;
- ``a_ij`` the softmax of ``e_ij`` over each dst's kept edges, per head,
  then inverted attention dropout;
- ``h'_i = sum_j a_ij feat_j`` per head; ELU and the heads flattened
  between layers, the heads averaged at the output.
The reward: ``alpha_ij = nan_to_num(abar_ij / sum_i abar_ij) * sum_i
q_ij`` over the dst's kept edges, ``abar`` the head-mean pre-softmax
logit (BLISS's GAT branch); ``r_ij = alpha^2 / k_i * ||h_j||^2 /
q_ij^2``, ``||h_j||`` the norm of the layer's input row before dropout;
each kept edge's arm times ``exp(min(delta * r_ij / p_j / n_i, 1))``, an
alpha whose square overflows giving 0.

Departures from the published description, all the BLISS reference's:
one weight matrix shared by src and dst and no bias (GATv2's W_l, W_r and
bias); no edge-weight multiply (commented out in the BLISS reference,
``model.py:92-96``); feature dropout on every layer's input, the input
features too; no residual (the CLI's default); the reward reads the
pre-softmax logits, not the attention.

The sampler's node probabilities are compared (``prob_gap``, ``p_slots``)
on each followed group's first step alone, where both sides sample from
one set of arms (the group's start). The reward of a step moves the arms
that set the next step's probabilities, and the GAT reward amplifies the
program's bf16 rounding of the logits: an arm whose exponent is clipped
at 1 on one side and near 0 on the other differs by up to a factor e a
step, so the probabilities of later steps differ by what the reward's
conditioning allows, not by what the sampler computes (on an H100 the
program read up to 0.42 on the start's later steps and 6.8 on the
replayed ones, the control 0.18 and 2.5). The later steps' blocks are
still checked (``faults``, ``edges_differ``), and their arms after the
three steps by ``exp3_gap``.

A ``Rounding`` other than float32 puts the step where the program rounds
to its stated precisions, which is the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import sage_train
from sage_train import derive_block, edges_differ


def _segment_softmax(e, dst, n_dst):
    """Softmax of ``e`` [E, H] over the edges of each dst, per head."""
    idx = dst[:, None].expand_as(e)
    top = torch.full((n_dst, e.shape[1]), -torch.inf, device=e.device)
    top = top.scatter_reduce(0, idx, e.detach(), "amax")
    ex = torch.exp(e - top[dst])
    den = torch.zeros((n_dst, e.shape[1]), device=e.device).index_add(
        0, dst, ex)
    return ex / den[dst]


def gat_alpha(abar, q, dst, n_dst):
    """BLISS's GAT alpha of each kept edge: ``nan_to_num(abar / sum_i
    abar) * sum_i q`` over the edges of its dst."""
    a_sum = torch.zeros(n_dst, device=q.device).index_add(0, dst, abar)
    q_sum = torch.zeros(n_dst, device=q.device).index_add(0, dst, q)
    return torch.nan_to_num(abar / a_sum[dst]) * q_sum[dst]


def sampling_arms(arms_row):
    """One layer's arms scaled by the power of two that puts the largest
    near 2^100, for the sampler's side: on the card ``index_add_`` adds with
    atomics, which flush subnormal floats to zero, so a dst whose bf16 arms
    are all subnormal (as the window leaves many) would read as unweighted.
    The sampler reads only ratios of one dst's arms, which a power of two
    leaves exact. The factor is applied in two halves, each a finite f32
    (it reaches 2^233 for arms that are all subnormal)."""
    top = float(arms_row.max())
    if top <= 0:
        return arms_row
    k = 100 - math.ceil(math.log2(top))
    return arms_row * 2.0 ** (k // 2) * 2.0 ** (k - k // 2)


def _keep_by_eid(keep, prog_block, eid):
    """The program's attention keep mask [e_cap, H] read at the edges
    ``eid``: each found by its id among the program block's kept edges
    (an edge the program did not keep reads as kept; ``block_faults``
    counts it)."""
    live = prog_block["e_mask"]
    p_eid = prog_block["eid"][live].long()
    p_keep = keep[live]
    order = torch.argsort(p_eid)
    p_eid, p_keep = p_eid[order], p_keep[order]
    if p_eid.numel() == 0:
        return torch.ones((eid.shape[0], keep.shape[1]), dtype=torch.bool,
                          device=eid.device)
    at = torch.searchsorted(p_eid, eid).clamp(max=p_eid.numel() - 1)
    found = p_eid[at] == eid
    return torch.where(found[:, None], p_keep[at], True)


class Train(sage_train.Train):
    """The reference's training state, as ``sage_train.Train`` keeps it
    (weights, Adam's moments and count, arm weights [L, E], the
    staircase rate); the model and the reward are GATv2's."""

    def __init__(self, cfg, g, weights, rounding=None, start=None):
        super().__init__(cfg, g, weights, rounding, start)
        m, gr = cfg["model"], cfg["graph"]
        self.heads, self.slope = m["heads"], m["negative_slope"]
        self.attn_drop = m["attn_dropout"]
        self.widths = [m["hidden"]] * (self.L - 1) + [gr["n_classes"]]
        self.steps = 0

    def _derive(self, rec):
        """Each layer's block worked out from the program's selection, and
        the checks of the program's blocks (the probabilities on the first
        step alone)."""
        first = self.steps == 0
        self.steps += 1
        g, blocks = self.g, rec["blocks"]
        derived, faults, differ, p_gap, p_slots = [], 0, 0, 0.0, []
        for l in reversed(range(self.L)):
            b = blocks[l]
            n_dst = b["n_dst_cap"]
            spec = dict(self.spec, fanout=self.fanouts[l])
            ref = derive_block(g, sampling_arms(self.arms[l]), spec,
                               b["src_gids"][:n_dst],
                               b["src_mask"][:n_dst], b["src_gids"],
                               b["src_mask"])
            if l + 1 < self.L:  # nesting: this block's dsts, the next's srcs
                nxt = blocks[l + 1]
                faults += int((b["src_mask"][:n_dst] != nxt["src_mask"]).sum()
                              + ((b["src_gids"][:n_dst] != nxt["src_gids"])
                                 & nxt["src_mask"]).sum())
            faults += ref["faults"]
            differ += edges_differ(ref, b)
            derived.insert(0, ref)
            if first:
                valid = b["src_mask"]
                pr = ref["p_slot"][valid]
                pp = b["src_node_prob"][valid].float()
                p_gap = max(p_gap, float(((pp - pr).abs() / pr).max()))
                p_slots.insert(0, ref["p_slot"])
        return derived, faults, differ, p_gap, p_slots

    def step(self, rec):
        """One step on the program's selection and dropout draws ``rec``
        (its blocks, input-most first, and keep masks): returns the loss,
        the gradients, and the checks of the program's blocks."""
        g, blocks = self.g, rec["blocks"]
        derived, faults, differ, p_gap, p_slots = self._derive(rec)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in self.params.items()}
        h = g.features[blocks[0]["src_gids"].long()]
        h = torch.where(blocks[0]["src_mask"][:, None], h, 0.0)
        keeps = iter(rec["keep"])
        norms, logits = [], []
        for l, blk in enumerate(derived):
            norms.append(torch.linalg.vector_norm(h.detach(), dim=1))
            h, e = self._layer(l, blk, h, params, keeps, blocks[l])
            logits.append(e.detach().mean(dim=1))
        top = blocks[-1]
        n_dst = top["n_dst_cap"]
        mask = top["src_mask"][:n_dst]
        labels = g.labels[top["src_gids"][:n_dst].long()]
        per = F.cross_entropy(h, torch.where(mask, labels, 0),
                              reduction="none")
        loss = torch.where(mask, per, 0.0).sum() / mask.sum().clamp(min=1)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        self._adam(grads)
        touched = self._exp3(derived, norms, logits)
        return {"loss": float(loss.detach()), "grads": grads, "faults": faults,
                "edges_differ": differ, "prob_gap": p_gap,
                "p_slots": p_slots, "touched": touched}

    def _drop(self, h, p, keeps):
        """Inverted dropout on the program's next keep mask."""
        if p <= 0:
            return h
        return self.rnd.c(torch.where(next(keeps), h / (1.0 - p), 0.0))

    def _layer(self, l, blk, h, params, keeps, prog_block):
        """Layer ``l`` on the derived block: (its output rows, the
        pre-softmax logits [E, H] of the kept edges)."""
        c = self.rnd.c
        H, O = self.heads[l], self.widths[l]
        W = c(params[f"layers.{l}.fc_src.weight"])
        attn = c(params[f"layers.{l}.attn"])
        h = self._drop(c(h), self.dropout, keeps)
        feat = c(h @ W.T)
        src, dst, n_dst = blk["e_src"], blk["e_dst"], blk["n_dst_cap"]
        el = feat[src].reshape(-1, H, O)
        er = feat[dst].reshape(-1, H, O)
        ef = c(F.leaky_relu(c(el + er), self.slope))
        e = c(c(ef * attn).sum(dim=-1))
        a = c(_segment_softmax(e, dst, n_dst))
        if self.attn_drop > 0:
            keep = _keep_by_eid(next(keeps), prog_block, blk["eid"])
            a = c(torch.where(keep, a / (1.0 - self.attn_drop), 0.0))
        msg = c(el * a[..., None]).reshape(-1, H * O)
        out = torch.zeros((n_dst, H * O), device=h.device).index_add(
            0, dst, msg)
        out = c(out).reshape(n_dst, H, O)
        if l < self.L - 1:
            return c(F.elu(out)).reshape(n_dst, H * O), e
        return c(out.mean(dim=1)), e

    @torch.no_grad()
    def _exp3(self, derived, norms, logits):
        """The GAT reward on every kept edge and the arm update; returns
        the eids it touched, by layer."""
        touched = []
        for l, (blk, norm, abar) in enumerate(zip(derived, norms, logits)):
            dst, q = blk["e_dst"], blk["q"]
            alpha = gat_alpha(abar, q, dst, blk["n_dst_cap"])
            k_i = blk["d"][dst]
            n_i = blk["n_full"][dst].clamp(min=1.0)
            hj = norm[blk["e_src"]]
            pj = blk["p_slot"][blk["e_src"]]
            r_over_p = (torch.nan_to_num(alpha * alpha, posinf=0.0)
                        * hj * hj / (q * q) / pj)
            dr = torch.clamp(r_over_p * self.delta / (k_i * n_i), max=1.0)
            eid = blk["eid"]
            self.arms[l, eid] = self.rnd.a(self.arms[l, eid] * torch.exp(dr))
            touched.append(eid[dr != 0])
        return touched
