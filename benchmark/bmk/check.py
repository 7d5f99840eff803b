"""The numbers that decide ``correct``, each against its limit.

Training, for each checked group of three steps (the set-up's first
three, from the seed's weights; three replayed steps after the window,
from the program's state, under the prefix ``replay.``), which the
reference follows on the program's draws:
- ``loss_gap``: the largest |loss - reference| / |reference| of the steps;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  the step, less beta1 times the one before, over 1 - beta1), worst leaf:
  |norm - reference norm| over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``update_gap``: the parameters' change over the three steps, the same
  measure, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's;
- ``exp3_gap``: the arm weights after the three steps, worst layer:
  ||w - w_ref|| / ||w_ref - w_start|| over the entries the reference moved
  by at least ``exp3_min_change`` of their start (smaller moves are under
  a bf16 arm's resolution);
- ``exp3_stray``: arm weights the program moved and the reference did not;
- ``block_faults``: kept edges that differ from the reference's, plus
  selections that break the sampler's rules (exact: 0);
- ``prob_gap``: the largest relative gap of a selected node's sampling
  probability;
- ``stage_faults`` (replayed group only): in the state the replayed steps
  start from, leaves whose Adam count is not the number of steps run, and
  parameters or arm weights that are not finite (arms: or negative).

Inference (one pass drawn from the seed): ``logit_rms_gap``, the
Frobenius norm of the logits' difference over the reference's, and
``logit_max_gap``, the largest absolute gap over the largest |logit|.
"""
from __future__ import annotations

import statistics

import torch

BETA1 = 0.9
STILL = 1e-3  # a leaf whose reference gradient is under this share of the
# median leaf's moves under Adam by round-off alone


def _leaf_gap(prog, ref, skip=(), where=None):
    """The worst leaf's gap of norms; ``where`` gets that leaf's name and
    its two norms."""
    norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in
             ref.items()}
    floor = statistics.median(norms.values())
    gap, worst = 0.0, None
    for k, v in ref.items():
        if k in skip:
            continue
        pn = float(torch.linalg.vector_norm(prog[k].float()))
        g = abs(pn - norms[k]) / max(norms[k], floor, 1e-30)
        if g >= gap:
            gap, worst = g, (k, pn, norms[k], floor)
    if where is not None:
        where.append(worst)
    return gap


def train_numbers(prog, ref, w0, min_change, arms0=None, notes=None):
    """``prog`` and ``ref``: dicts with ``losses`` [3], ``grad1`` {leaf},
    ``params3`` {leaf}, ``arms3`` per layer (eids, values) of the entries
    that changed from ``arms0`` ([L, E]; None: all one), ``touched`` per
    layer (eids); ``ref`` also ``arms_full`` [L, E] and the block checks.
    ``w0`` the parameters the three steps start from. ``notes`` (a list)
    gets the worst leaf of the gradient and of the change: (name, the
    program's norm, the reference's, the median leaf's)."""
    out = {}
    out["loss_gap"] = max(abs(p - r) / max(abs(r), 1e-30) for p, r in
                          zip(prog["losses"], ref["losses"]))
    out["grad_gap"] = _leaf_gap(prog["grad1"], ref["grad1"], where=notes)
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in
             ref["grad1"].items()}
    med = statistics.median(gnorm.values())
    still = {k for k, v in gnorm.items() if v < STILL * med}
    dp = {k: prog["params3"][k].float() - w0[k] for k in w0}
    dr = {k: ref["params3"][k].float() - w0[k] for k in w0}
    out["update_gap"] = _leaf_gap(dp, dr, skip=still, where=notes)
    gap, stray = 0.0, 0
    for l, (eids, vals) in enumerate(prog["arms3"]):
        w_ref = ref["arms_full"][l]
        w_start = (torch.ones_like(w_ref) if arms0 is None
                   else arms0[l].float())
        w_prog = w_start.clone()
        w_prog[eids.long()] = vals.float()
        moved = (w_ref - w_start).abs() >= min_change * w_start.abs()
        den = float(torch.linalg.vector_norm((w_ref - w_start)[moved]))
        if den > 0:
            gap = max(gap, float(torch.linalg.vector_norm(
                (w_prog - w_ref)[moved])) / den)
        touched = torch.zeros_like(w_ref, dtype=torch.bool)
        for t in ref["touched"][l]:
            touched[t] = True
        stray += int((~touched[eids.long()]).sum())
    out["exp3_gap"] = gap
    out["exp3_stray"] = float(stray)
    out["block_faults"] = float(ref["block_faults"])
    out["prob_gap"] = ref["prob_gap"]
    return out


def infer_numbers(prog, ref):
    prog, ref = prog.float(), ref.float()
    diff = prog - ref
    return {
        "logit_rms_gap": float(torch.linalg.vector_norm(diff)
                               / torch.linalg.vector_norm(ref)),
        "logit_max_gap": float(diff.abs().max() / ref.abs().max()),
    }


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        if not (v == v and v <= limit):
            ok = False
    return ok, checks
