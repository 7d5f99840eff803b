"""Plain reference of one training step of GraphSAGE under the
poisson-bandit sampler (BLISS): the sampler's probabilities, the blocks'
edges and weights, the model's forward and backward, the cross entropy,
Adam, and the EXP3 arm-weight update, in float32 plain PyTorch.

It imports nothing of the program. What it cannot draw itself it follows
from the program's own random draws, read from the step's tensors: which
candidate nodes the Bernoulli draws selected (the blocks' src tables) and
which activations dropout kept. Everything else it works out again from
the graph, the features, the labels, the weights and its own state (its
own arm weights, starting at one or at the
program's state where a check starts there): the frontier of every dst, the edge
probabilities q_ij = (1 - eta) w_ij / sum_j w_ij + eta / n_i, the node
probabilities sqrt(sum_i q_ij^2) and their Poisson scale, the kept edges
(every in-edge whose src was selected), the debiased weights, the layers,
the loss, the gradients, Adam's update, and the rewards
r_ij = alpha^2 / k_i * ||h_j||^2 / q_ij^2 with the exponent
min(delta * r_ij / p_j / n_i, 1) that multiplies each kept edge's arm.

A layer is SAGE-mean: h'_i = W_self h_i + W_neigh (sum_e a_e h_src(e) / d_i)
+ b, ReLU and inverted dropout between layers. A ``Rounding`` other than
float32 puts the step where the program rounds to its stated precisions,
which is the control.
"""
from __future__ import annotations

import torch

from precision import Rounding

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def _frontier(g, dst_gids):
    """All in-edges of ``dst_gids``: (eids, index of the dst in
    ``dst_gids``) int64."""
    dev = dst_gids.device
    deg = g.in_deg[dst_gids]
    seg = torch.repeat_interleave(torch.arange(len(dst_gids), device=dev),
                                  deg)
    first = torch.cumsum(deg, 0) - deg
    off = torch.arange(int(deg.sum()), device=dev) - first[seg]
    return g.indptr[dst_gids][seg] + off, seg


def derive_block(g, arms_row, spec, dst_gids, dst_mask, src_gids, src_mask):
    """The block of one layer from the program's selection. ``dst_*`` the
    dst slots, ``src_*`` the src table (its first slots the dsts);
    ``spec`` the sampler's settings. Returns the kept edges (eid, src slot,
    dst slot, debiased weight, q, alpha), the kept in-degree and the full
    in-degree per dst slot, the node probability per src slot, and the
    structural faults found in the selection."""
    dev = src_gids.device
    n_dst_cap = dst_gids.shape[0]
    faults = 0
    d_slot = torch.nonzero(dst_mask).squeeze(1)
    d_gid = dst_gids[d_slot].long()
    eids, seg = _frontier(g, d_gid)
    fsrc = g.src[eids].long()
    eta, num = spec["eta"], spec["fanout"]
    raw = arms_row[eids]
    nd = len(d_gid)
    sum_dst = torch.zeros(nd, device=dev).index_add_(0, seg, raw)
    w_hat = torch.where(sum_dst[seg] > 0, raw / sum_dst[seg], 0.0)
    n_i = g.in_deg[d_gid].float()
    q = (1.0 - eta) * w_hat + eta / n_i.clamp(min=1.0)[seg]
    s_i = torch.zeros(nd, device=dev).index_add_(0, seg, q)
    r = torch.where(s_i[seg] > 0, q / s_i[seg], 0.0)
    n = g.indptr.shape[0] - 1
    prob = torch.zeros(n, device=dev).index_add_(0, fsrc, r * r).sqrt()
    cand = torch.zeros(n, dtype=torch.bool, device=dev)
    cand[fsrc] = True
    cand[d_gid] = True
    is_seed = torch.zeros(n, dtype=torch.bool, device=dev)
    is_seed[d_gid] = True
    # Poisson scale: the fixed point c with sum min(c q_j, 1) ~= fanout
    pc = prob[cand]
    c = 1.0
    for _ in range(spec["poisson_iters"]):
        s = float(torch.clamp(pc * c, max=1.0).sum())
        if min(s, num) / max(s, num, 1e-30) >= spec["poisson_eps"] or s <= 0:
            break
        c = c * num / max(s, 1e-30)
    p = torch.clamp(prob * c, max=1.0)
    p[is_seed] = 1.0
    if int(cand.sum()) <= num:
        p[cand] = 1.0
    p = torch.where(cand, p, 0.0)

    # the selection: dsts first, then distinct non-seed candidates
    s_valid = torch.nonzero(src_mask).squeeze(1)
    s_gid = src_gids[s_valid].long()
    extra = s_valid >= n_dst_cap
    if len(torch.unique(s_gid)) != len(s_gid):
        faults += 1
    faults += int((~cand[s_gid[extra]] | is_seed[s_gid[extra]]).sum())
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot_of[s_gid] = s_valid
    pos = slot_of[fsrc]
    kept = pos >= 0
    k_eid = eids[kept]
    k_src = pos[kept]
    k_dst = d_slot[seg[kept]]
    p_src = p[fsrc[kept]]
    wt = q[kept] / p_src
    d = torch.bincount(k_dst, minlength=n_dst_cap).float()
    wt_sum = torch.zeros(n_dst_cap, device=dev).index_add_(0, k_dst, wt)
    e_weight = wt * d[k_dst] / wt_sum[k_dst]
    p_slot = torch.zeros(src_gids.shape[0], device=dev)
    p_slot[s_valid] = p[s_gid]
    n_full = torch.zeros(n_dst_cap, device=dev)
    n_full[d_slot] = n_i
    return {"eid": k_eid, "e_src": k_src, "e_dst": k_dst,
            "e_weight": e_weight, "q": q[kept], "alpha": g.w[k_eid],
            "d": d, "n_full": n_full, "p_slot": p_slot,
            "n_src_cap": src_gids.shape[0], "n_dst_cap": n_dst_cap,
            "faults": faults}


def edges_differ(ref, prog):
    """How many kept edges differ between the reference's block and the
    program's (eid, src slot, dst slot) triples."""
    keep = prog["e_mask"]
    a = torch.stack([ref["eid"], ref["e_src"], ref["e_dst"]], 1)
    b = torch.stack([prog["eid"][keep].long(), prog["e_src"][keep].long(),
                     prog["e_dst"][keep].long()], 1)
    a = a[torch.argsort(a[:, 0])]
    b = b[torch.argsort(b[:, 0])]
    if a.shape != b.shape:
        return abs(a.shape[0] - b.shape[0]) + int(
            (a[:min(len(a), len(b))] != b[:min(len(a), len(b))]).any(1).sum())
    return int((a != b).any(1).sum())


class Train:
    """The reference's training state: weights, Adam's moments, arm
    weights [L, E], and Adam's count: from the start (zero moments, arms
    at one, count 0) or from ``start`` ({"m", "v"} by leaf, "arms" [L, E],
    "t"). The rate is the configuration's staircase: ``lr`` times
    ``lr_gamma`` every ``lr_step_epochs`` epochs of Adam's count."""

    def __init__(self, cfg, g, weights, rounding=None, start=None):
        self.cfg, self.g = cfg, g
        rnd = self.rnd = rounding or Rounding()
        m, s = cfg["model"], cfg["sampler"]
        self.L, self.lr, self.dropout = m["layers"], m["lr"], m["dropout"]
        steps_per_epoch = max(1, cfg["graph"]["split"][0] // s["batch_size"])
        self.gamma = m["lr_gamma"]
        self.period = max(1, m["lr_step_epochs"] * steps_per_epoch)
        self.spec = {"eta": s["eta"], "poisson_eps": s["poisson_eps"],
                     "poisson_iters": s["poisson_iters"]}
        self.fanouts, self.delta = s["fanouts"], s["exp3_delta"]
        self.params = {k: rnd.p(v.float().clone())
                       for k, v in weights.items()}
        if start is None:
            self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.t = 0
            self.arms = rnd.a(torch.ones((self.L, g.src.shape[0]),
                                         device=g.src.device))
        else:
            self.m = {k: rnd.p(start["m"][k].float()) for k in self.params}
            self.v = {k: rnd.p(start["v"][k].float()) for k in self.params}
            self.t = int(start["t"])
            self.arms = rnd.a(start["arms"].float())

    def step(self, rec):
        """One step on the program's selection and dropout draws ``rec``
        (its blocks, input-most first, and keep masks): returns the loss,
        the gradients, and the checks of the program's blocks."""
        rnd, g = self.rnd, self.g
        blocks = rec["blocks"]
        derived, faults, differ, p_gap, p_slots = [], 0, 0, 0.0, []
        for l in reversed(range(self.L)):
            b = blocks[l]
            n_dst = b["n_dst_cap"]
            spec = dict(self.spec, fanout=self.fanouts[l])
            ref = derive_block(g, self.arms[l], spec, b["src_gids"][:n_dst],
                               b["src_mask"][:n_dst], b["src_gids"],
                               b["src_mask"])
            if l + 1 < self.L:  # nesting: this block's dsts, the next's srcs
                nxt = blocks[l + 1]
                faults += int((b["src_mask"][:n_dst] != nxt["src_mask"]).sum()
                              + ((b["src_gids"][:n_dst] != nxt["src_gids"])
                                 & nxt["src_mask"]).sum())
            faults += ref["faults"]
            differ += edges_differ(ref, b)
            valid = b["src_mask"]
            pr, pp = ref["p_slot"][valid], b["src_node_prob"][valid].float()
            p_gap = max(p_gap, float(((pp - pr).abs() / pr).max()))
            derived.insert(0, ref)
            p_slots.insert(0, ref["p_slot"])

        params = {k: v.clone().requires_grad_(True)
                  for k, v in self.params.items()}
        h = g.features[blocks[0]["src_gids"].long()]
        h = torch.where(blocks[0]["src_mask"][:, None], h, 0.0)
        norms = []
        for l, blk in enumerate(derived):
            norms.append(torch.linalg.vector_norm(h.detach(), dim=1))
            h = self._layer(l, blk, h, params)
            if l < self.L - 1:
                h = torch.relu(h)
                keep = rec["keep"][l]
                h = rnd.c(torch.where(keep, h / (1.0 - self.dropout), 0.0))
        top = blocks[-1]
        n_dst = top["n_dst_cap"]
        mask = top["src_mask"][:n_dst]
        labels = g.labels[top["src_gids"][:n_dst].long()]
        per = torch.nn.functional.cross_entropy(
            h, torch.where(mask, labels, 0), reduction="none")
        loss = torch.where(mask, per, 0.0).sum() / mask.sum().clamp(min=1)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        self._adam(grads)
        touched = self._exp3(derived, norms)
        return {"loss": float(loss.detach()), "grads": grads, "faults": faults,
                "edges_differ": differ, "prob_gap": p_gap,
                "p_slots": p_slots, "touched": touched}

    def _layer(self, l, blk, h, params):
        rnd = self.rnd
        Wn = rnd.c(params[f"layers.{l}.fc_neigh.weight"])
        Ws = rnd.c(params[f"layers.{l}.fc_self.weight"])
        b = rnd.c(params[f"layers.{l}.bias"])
        h = rnd.c(h)
        lin_before = Wn.shape[1] > Wn.shape[0]
        src_val = rnd.c(h @ Wn.T) if lin_before else h
        msg = rnd.c(src_val[blk["e_src"]]
                    * rnd.c(blk["e_weight"])[:, None])
        agg = torch.zeros((blk["n_dst_cap"], msg.shape[1]),
                          device=h.device).index_add(0, blk["e_dst"], msg)
        agg = rnd.c(agg / blk["d"].clamp(min=1.0)[:, None])
        h_neigh = agg if lin_before else rnd.c(agg @ Wn.T)
        h_dst = h[:blk["n_dst_cap"]]
        return rnd.c(rnd.c(h_dst @ Ws.T) + h_neigh + b)

    @torch.no_grad()
    def _adam(self, grads):
        self.t += 1
        lr = self.lr * self.gamma ** ((self.t - 1) // self.period)
        b1, b2 = BETAS
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.rnd.p(b1 * self.m[k] + (1.0 - b1) * g)
            self.v[k] = self.rnd.p(b2 * self.v[k] + (1.0 - b2) * g * g)
            upd = lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt()
                                           + ADAM_EPS)
            self.params[k] = self.rnd.p(self.params[k] - upd)

    @torch.no_grad()
    def _exp3(self, derived, norms):
        """w[eid] *= exp(min(delta * alpha^2 h_j^2 / (q^2 p_j k_i n_i), 1))
        for every kept edge; returns the eids it touched, by layer."""
        touched = []
        for l, (blk, norm) in enumerate(zip(derived, norms)):
            k_i = blk["d"][blk["e_dst"]]
            n_i = blk["n_full"][blk["e_dst"]].clamp(min=1.0)
            hj = norm[blk["e_src"]]
            pj = blk["p_slot"][blk["e_src"]]
            q = blk["q"]
            r_over_p = blk["alpha"] ** 2 * hj * hj / (q * q) / pj
            dr = torch.clamp(r_over_p * self.delta / (k_i * n_i), max=1.0)
            eid = blk["eid"]
            self.arms[l, eid] = self.rnd.a(self.arms[l, eid] * torch.exp(dr))
            touched.append(eid[dr != 0])
        return touched
