"""The sampler's Poisson fixed point: the scale c with sum(min(c*q, 1)) ~=
num over a layer's candidates, and the inclusion probabilities it gives.

A CUDA tensor goes to the hand-written kernel ``csrc/poisson_scale.cu``,
one launch for the whole loop and its epilogue (under capture, one node of
the step's graph); a CPU tensor goes to :func:`poisson_scale_plain`, the
sampler's masked-iteration loop. The kernel replaces no TPU kernel (the
JAX package leaves the loop to XLA): on the card the plain version is ~19
operations an iteration, 50 iterations a layer.

The kernel runs one cluster of blocks; :func:`poisson_route` picks its size
and where the candidates' slice lives from the candidate capacity alone.
"""
from __future__ import annotations

from typing import Tuple

import torch

from bliss_gnn_tpu_torch.ops import _build

THREADS = 1024
# the most candidates a block holds in shared memory: 56 a thread, 229,376
# bytes of the 232,448 an H100 block may opt into
SMEM_SLICE = 56 * THREADS
# the H100's largest cluster, with the non-portable size allowed
MAX_CLUSTER = 16


def poisson_route(c_cap: int) -> Tuple[int, bool]:
    """(blocks in the cluster, whether the slice lives in shared memory)
    for ``c_cap`` candidates: one block while they fit its shared memory,
    else a cluster of 16, its slices in shared memory while they fit and
    read from global memory every iteration beyond."""
    if c_cap <= SMEM_SLICE:
        return 1, True
    return MAX_CLUSTER, c_cap <= MAX_CLUSTER * SMEM_SLICE


def poisson_scale_plain(prob: torch.Tensor, cand, num: int, eps: float,
                        iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed point c with sum(min(c*q, 1)) ~= num, then p = min(c*q, 1)
    with seeds forced to 1 (all 1 when n_candidates <= num). Runs
    ``iters`` masked iterations on the device: once ``done`` is set, c
    stops moving, which is the reference's early exit. ``cand`` carries
    the candidates' ``mask``, ``is_seed`` and count ``n``. Returns p and
    the iteration at which ``done`` was set (int32, ``iters`` if never)."""
    probf = prob.to(torch.float32)
    c = torch.ones((), dtype=torch.float32, device=prob.device)
    done = torch.zeros((), dtype=torch.bool, device=prob.device)
    steps = torch.zeros((), dtype=torch.int32, device=prob.device)
    for _ in range(iters):
        s = torch.where(cand.mask, torch.clamp(probf * c, max=1.0), 0.0).sum()
        ratio = s.clamp(max=num) / s.clamp(min=num).clamp(min=1e-30)
        hit = ratio >= eps
        c_new = torch.where(hit | (s <= 0), c,
                            c * num / torch.clamp(s, min=1e-30))
        c = torch.where(done, c, c_new)
        steps = steps + (~(done | hit)).to(torch.int32)
        done = done | hit
    p = torch.clamp(probf * c, max=1.0)
    p = torch.where(cand.is_seed, 1.0, p)
    p = torch.where(cand.n <= num, 1.0, p)
    return torch.where(cand.mask, p, 0.0), steps


def poisson_scale(prob: torch.Tensor, cand, num: int, eps: float,
                  iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """p f32 [c_cap] and the int32 0-dim iteration count of
    :func:`poisson_scale_plain`. On the card one launch on the current
    stream; p agrees with the plain version up to the order of the f32
    sum (the count within one iteration where a sum sits on ``eps``)."""
    if prob.device.type == "cpu":
        return poisson_scale_plain(prob, cand, num, eps, iters)
    if (prob.device.type != "cuda" or prob.dim() != 1
            or prob.shape[0] >= 2 ** 31):
        raise ValueError(f"poisson_scale: no kernel for shape "
                         f"{tuple(prob.shape)} on {prob.device}")
    c_cap = prob.shape[0]
    mask, is_seed = cand.mask, cand.is_seed
    if (mask is None or cand.n is None
            or any(t.dtype != torch.bool or t.shape != prob.shape
                   or t.device != prob.device for t in (mask, is_seed))
            or cand.n.numel() != 1 or cand.n.device != prob.device):
        raise ValueError("poisson_scale: mask and is_seed bool [c_cap] and a "
                         "one-element count n on prob's card")
    probf = prob.to(torch.float32).contiguous()
    mask, is_seed = mask.contiguous(), is_seed.contiguous()
    n = cand.n.to(torch.int32).reshape(1)
    p = torch.empty(c_cap, dtype=torch.float32, device=prob.device)
    n_iters = torch.empty((), dtype=torch.int32, device=prob.device)
    ctas, in_smem = poisson_route(c_cap)
    err = _build.load("poisson_scale").bliss_poisson_scale(
        probf.data_ptr(), mask.data_ptr(), is_seed.data_ptr(), n.data_ptr(),
        p.data_ptr(), n_iters.data_ptr(), c_cap, ctas, int(not in_smem),
        int(num), float(eps), int(iters), _build.stream_of(probf))
    poisson_scale.launches += 1
    _build.check(err, "poisson_scale")
    return p, n_iters


poisson_scale.launches = 0
