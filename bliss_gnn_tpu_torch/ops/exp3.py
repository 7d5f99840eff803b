"""K4: sparse multiplicative update of the EXP3 arm-weight state (bf16, or
f32 as the reference's ``exp3_dtype="float32"`` gives).

Counterpart of ``bliss_gnn_tpu/ops/exp3_pallas.py``. The state is flat
(``[L * (n_edges + EDGE_PAD)]`` viewed from the sampler's ``[L, E']``), and
is updated IN PLACE: the sparse update touches ~10^5 of ~3.4*10^8 entries,
so a functional copy would move the whole 690 MB state at Reddit scale.

The hand-written kernel ``csrc/exp3_apply.cu`` takes the update slots as
they come, in one launch: one thread per slot applies its factor to its
entry with a compare-and-swap loop, 16-bit on a bf16 state and 32-bit on
an f32 state (two routes), so nothing is sorted. Slots with an index
outside [0, limit) are no-ops. Distinct indices get one f32 multiply and
one rounding, bit for bit :func:`exp3_apply_plain`; an index repeated m
times rounds after each update, in the card's order, as the TPU kernel's
sequential update does, which is within m - 1 ulps (of the state's dtype)
of the plain version. No update is ever skipped.

A list that repeats an index by design (``max_repeats`` S > 1: the
all-gathered deltas of S data-parallel ranks, each rank's list distinct, so
a live index at most S times) takes the group-by route instead, so that
every replica of the state keeps the same bits: a hash table groups each
index's slots (no sort), and one thread per index multiplies its factors in
list order in the wide float and writes the entry once. That is
:func:`exp3_apply_plain`'s arithmetic, the same bits on every call and
every card. One memset and two launches; the scratch comes from the
caching allocator and nothing syncs, so it runs inside a captured step. On
a CPU tensor the wrapper checks the promise (at most S live copies of an
index) and raises where it fails; on the card it trusts the caller, as the
sorted routes trust ``ids_sorted``. ``exp3_apply.launches`` adds one per
kernel launch, ``launches_by_shape`` the same by route and length, e.g.
``"f32 186496"`` or ``"repeats bf16 745984 S=4"``.

:func:`exp3_apply_sorted_runs` is the repeats route the group-by replaced
(a stable ``torch.sort``, then one thread per run): no path of the package
calls it; the card tests hold the group-by to its bits and the timings set
the two side by side.
"""
from __future__ import annotations

import torch

from bliss_gnn_tpu_torch.ops import _build
from bliss_gnn_tpu_torch.ops._args import index_i32


def exp3_apply_plain(state: torch.Tensor, flat_idx: torch.Tensor,
                     mult: torch.Tensor, limit: int) -> None:
    """Plain PyTorch version of the kernel: per distinct index, the product
    of its factors, applied to the entry with one rounding to the state's
    dtype. Both are taken in a float wider than the state (f32 for a bf16
    state, f64 for an f32 state), so a distinct index gets the correctly
    rounded product, as the kernel's one f32 multiply does, and a repeated
    one the value the CAS route's m roundings stay within m - 1 ulps of.
    The repeats route computes the same products in the same (list) order,
    so on the CPU's sequential product the two agree to the bit."""
    wide = torch.float64 if state.dtype == torch.float32 else torch.float32
    s_idx, order = torch.sort(flat_idx.long(), stable=True)
    s_mult = mult.to(wide)[order]
    uniq, inverse = torch.unique_consecutive(s_idx, return_inverse=True)
    prod = torch.ones(uniq.shape[0], dtype=wide, device=state.device)
    prod.scatter_reduce_(0, inverse, s_mult, "prod")
    live = (uniq >= 0) & (uniq < limit)
    target, factor = uniq[live], prod[live]
    state[target] = (state[target].to(wide) * factor).to(state.dtype)


def check_repeats(flat_idx: torch.Tensor, limit: int,
                  max_repeats: int) -> None:
    """The CPU's check of the ``max_repeats`` promise: no index in
    [0, limit) more than ``max_repeats`` times (on the card it would cost a
    host sync)."""
    live = flat_idx[(flat_idx >= 0) & (flat_idx < limit)].long()
    if live.numel() == 0:
        return
    most = int(torch.unique(live, return_counts=True)[1].max())
    if most > max_repeats:
        raise ValueError(f"exp3_apply: an index repeats {most} times, over "
                         f"max_repeats={max_repeats}")


def group_table_log2(u: int) -> int:
    """log2 of the group-by route's hash-table slots for ``u`` list slots:
    the power of two at or above 2 u (load <= 1/2), at least 64."""
    if u > 1 << 29:
        raise ValueError(f"exp3_apply: {u} slots exceed the group-by "
                         f"route's 2^29")
    return max(6, (2 * u - 1).bit_length())


def _checked_args(state, flat_idx, mult, limit):
    """The card routes' checks and conversions: (route entries, int32
    indices, f32 factors, length). Kept to a few attribute reads: the call
    is on the step's host-bound path."""
    card = state.get_device()
    route = _ROUTES.get(state.dtype)
    if route is None or state.dim() != 1 or not state.is_contiguous():
        raise TypeError("exp3_apply: the state must be a flat contiguous "
                        "bf16 or f32 tensor")
    if flat_idx.get_device() != card or mult.get_device() != card:
        raise ValueError("exp3_apply: the state, indices and factors must "
                         "lie on one card")
    flat_idx = index_i32(flat_idx, "exp3_apply flat_idx")
    if mult.dtype != torch.float32 or not mult.is_contiguous():
        mult = mult.to(torch.float32).contiguous()
    u = flat_idx.numel()
    if mult.dim() != 1 or mult.numel() != u:
        raise ValueError("exp3_apply: flat_idx and mult must be 1-D of one "
                         "length")
    if not 0 <= limit <= state.numel():
        raise ValueError(f"exp3_apply: limit {limit} outside the state")
    return route, flat_idx, mult, u


def exp3_apply(state: torch.Tensor, flat_idx: torch.Tensor,
               mult: torch.Tensor, limit: int, max_repeats: int = 1) -> None:
    """state[flat_idx] *= mult in place on a flat bf16 or f32 ``state``.
    ``max_repeats`` 1 (one rank's deltas: every index at most once): the
    CAS route, one launch, no allocation. ``max_repeats`` S > 1 promises
    at most S copies of an index in [0, limit): the group-by route, the
    same bits on every call (checked on a CPU tensor)."""
    if not state.is_cuda:
        if state.device.type == "cpu":
            if max_repeats > 1:
                check_repeats(flat_idx, limit, max_repeats)
            exp3_apply_plain(state, flat_idx, mult, limit)
            return
        raise ValueError(f"exp3_apply: no kernel for {state.device}")
    (name, entry, groups_entry, _), flat_idx, mult, u = _checked_args(
        state, flat_idx, mult, limit)
    lib = _build.load("exp3_apply")
    stream = _build.stream_of(state)
    if max_repeats <= 1:
        err = getattr(lib, entry)(
            state.data_ptr(), flat_idx.data_ptr(), mult.data_ptr(), u, limit,
            stream)
        key, n = f"{name} {u}", 1
    else:
        log2_t = group_table_log2(u)
        scratch = torch.empty((2 << log2_t) + u, dtype=torch.int32,
                              device=state.device)
        err = getattr(lib, groups_entry)(
            state.data_ptr(), flat_idx.data_ptr(), mult.data_ptr(),
            scratch.data_ptr(), u, limit, log2_t, stream)
        key, n = f"repeats {name} {u} S={max_repeats}", 2
    exp3_apply.launches += n
    by = exp3_apply.launches_by_shape
    by[key] = by.get(key, 0) + n
    if err:
        _build.check(err, "exp3_apply")


def exp3_apply_sorted_runs(state: torch.Tensor, flat_idx: torch.Tensor,
                           mult: torch.Tensor, limit: int) -> None:
    """The repeats route the group-by replaced, on the card only: a stable
    sort of the flat indices (each index's slots one run, in list order),
    then one thread per run. The same bits as the group-by route; kept as
    its reference in the card tests and its yardstick in the timings."""
    if not state.is_cuda:
        raise ValueError("exp3_apply_sorted_runs: a card route")
    (_, _, _, runs_entry), flat_idx, mult, u = _checked_args(
        state, flat_idx, mult, limit)
    s_idx, order = torch.sort(flat_idx, stable=True)
    err = getattr(_build.load("exp3_apply"), runs_entry)(
        state.data_ptr(), s_idx.data_ptr(), order.data_ptr(),
        mult.data_ptr(), u, limit, _build.stream_of(state))
    exp3_apply_sorted_runs.launches += 1
    if err:
        _build.check(err, "exp3_apply_sorted_runs")


# state dtype -> (route, C entries: the CAS route, the group-by route, the
# sorted runs)
_ROUTES = {torch.bfloat16: ("bf16", "bliss_exp3_apply",
                            "bliss_exp3_apply_groups",
                            "bliss_exp3_apply_runs"),
           torch.float32: ("f32", "bliss_exp3_apply_f32",
                           "bliss_exp3_apply_groups_f32",
                           "bliss_exp3_apply_runs_f32")}
exp3_apply.launches = 0
# the same launches by route and update count, e.g. "f32 186496",
# "repeats bf16 745984 S=4"
exp3_apply.launches_by_shape = {}
exp3_apply_sorted_runs.launches = 0
