"""The sampler's Poisson fixed point (``ops/poisson.py``) on the CPU: the
kernel's route as a function of the candidate capacity, the plain
version's probabilities and iteration count against a numpy loop of the
reference's rule, and the count's way out of the step (the metric
``poisson_iters/<l>``) into the spans summary
(``sampler.fixed_point_iters/<l>``). The kernel itself is held to the plain
version on the card in ``tests/test_torch_cuda.py``."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph.datasets import synthetic_graph
from bliss_gnn_tpu_torch.graph.structure import Graph, normalized_edata
from bliss_gnn_tpu_torch.ops import poisson
from bliss_gnn_tpu_torch.ops.poisson import (
    SMEM_SLICE,
    poisson_route,
    poisson_scale,
    poisson_scale_plain,
)
from bliss_gnn_tpu_torch.train.trainer import TrainConfig, Trainer
from bliss_gnn_tpu_torch.utils import spans

torch.set_num_threads(1)

# the H100's opt-in shared memory a block may use, and the kernel's static
# scratch (32 warp partials and 2 block partials, f32)
SMEM_OPT_IN = 232_448
STATIC_SMEM = (32 + 2) * 4


@pytest.mark.parametrize("c_cap,route", [
    (0, (1, True)), (4_096, (1, True)), (SMEM_SLICE, (1, True)),
    (SMEM_SLICE + 1, (16, True)), (233_088, (16, True)),
    (8 * SMEM_SLICE + 1, (16, True)), (900_000, (16, True)),
    (16 * SMEM_SLICE, (16, True)), (16 * SMEM_SLICE + 1, (16, False)),
    (2_449_030, (16, False)),
])
def test_route_by_candidate_capacity(c_cap, route):
    """One block while the candidates fit its shared memory, then a
    cluster of 16 holding them in shared memory, then 16 blocks streaming
    from global memory; a shared-memory slice always fits the block's
    opt-in."""
    assert poisson_route(c_cap) == route
    ctas, in_smem = route
    if in_smem:
        per = -(-c_cap // ctas)
        assert per <= SMEM_SLICE
        assert per * 4 + STATIC_SMEM <= SMEM_OPT_IN
        # a thread's mask bits fit one 64-bit register
        assert -(-per // poisson.THREADS) <= 64


def _reference_rule(prob, mask, is_seed, n, num, eps, iters):
    """The reference's loop (``benchmark/reference/sage_train.py``) in
    numpy f32: stop at the hit or at s <= 0. Returns p and the iteration
    of the hit (``iters`` if none)."""
    f32 = np.float32
    pc = prob[mask].astype(f32)
    c = f32(1.0)
    hit_at = iters
    for it in range(iters):
        s = np.minimum(pc * c, f32(1.0)).sum(dtype=f32)
        if min(s, f32(num)) / max(s, f32(num), f32(1e-30)) >= f32(eps):
            hit_at = it
            break
        if s <= 0:
            break
        c = f32(c * f32(num)) / max(s, f32(1e-30))
    p = np.minimum(prob.astype(f32) * c, f32(1.0))
    p[is_seed] = 1.0
    if n <= num:
        p[mask] = 1.0
    return np.where(mask, p, f32(0.0)), hit_at


def _case(name, c_cap=3_000, num=64, seed=0):
    rng = np.random.default_rng(seed)
    prob = (rng.pareto(1.5, c_cap) * 1e-3).astype(np.float32)
    mask = rng.random(c_cap) < 0.6
    is_seed = mask & (rng.random(c_cap) < 0.02)
    iters, eps = 50, 0.9999
    if name == "few_candidates":
        mask[:] = False
        mask[:40] = True
        is_seed = mask & (np.arange(c_cap) < 5)
    elif name == "zero_probs":
        prob[:] = 0.0
    elif name == "out_of_iterations":
        # a heavy head saturates at 1 and the tail needs many rescalings
        prob[mask] = 1e-7
        prob[np.flatnonzero(mask)[:num - 2]] = 0.5
        iters = 3
    prob = np.where(mask, prob, np.float32(0.0))
    return prob, mask, is_seed, int(mask.sum()), num, eps, iters


@pytest.mark.parametrize("name,seed", [
    ("random", 0), ("random", 1), ("random", 2), ("few_candidates", 0),
    ("zero_probs", 0), ("out_of_iterations", 0)])
def test_plain_version_follows_the_reference_rule(name, seed):
    """The plain version's p and iteration count against the reference's
    loop in numpy: the same count, p to f32 rounding; the count is
    ``iters`` when no iteration hit ``eps`` (out of iterations, or s = 0)."""
    prob, mask, is_seed, n, num, eps, iters = _case(name, seed=seed)
    cand = SimpleNamespace(mask=torch.from_numpy(mask),
                           is_seed=torch.from_numpy(is_seed),
                           n=torch.tensor(n, dtype=torch.int32))
    p, n_iters = poisson_scale_plain(torch.from_numpy(prob), cand, num, eps,
                                     iters)
    want_p, want_iters = _reference_rule(prob, mask, is_seed, n, num, eps,
                                         iters)
    assert n_iters.dtype == torch.int32 and n_iters.dim() == 0
    assert int(n_iters) == want_iters
    np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-5, atol=1e-7)
    if name in ("out_of_iterations", "zero_probs"):
        assert want_iters == iters
    if name == "random":
        assert 0 < want_iters < iters
    # the wrapper takes the plain version for a CPU tensor
    p2, it2 = poisson_scale(torch.from_numpy(prob), cand, num, eps, iters)
    assert torch.equal(p2, p) and int(it2) == int(n_iters)


def _trainer(tmp_path, sampler, **kw):
    g, nc, ml = synthetic_graph(400, 3000, 16, 4, seed=3)
    g = Graph.canonicalize(g)
    g.edata["w"] = normalized_edata(g)
    cfg = TrainConfig(dataset="synth", model="sage", sampler=sampler,
                      fan_out=(32, 16), batch_size=32, num_hidden=32,
                      num_layers=2, lr=0.01, logdir=str(tmp_path),
                      lr_step_size=100, disable_checkpoint=True, **kw)
    return Trainer(cfg, graph=g, n_classes=nc, multilabel=ml, device="cpu")


@pytest.mark.parametrize("sampler", ["poisson-bandit", "poisson-ladies",
                                     "bandit", "ladies", "neighbor"])
def test_step_metrics_carry_the_iteration_counts(tmp_path, sampler):
    """A Poisson kind's step returns ``poisson_iters/<l>`` for each layer,
    an int32 count within the budget; the other kinds return none."""
    tr = _trainer(tmp_path, sampler)
    seeds = tr._to_device(tr.train_nid[:tr.batch_size])
    mask = torch.ones(tr.batch_size, dtype=torch.bool)
    _, metrics = tr.train_step(tr.state, seeds, mask)
    keys = {k for k in metrics if k.startswith("poisson_iters/")}
    if "poisson" not in sampler:
        assert keys == set()
        return
    assert keys == {"poisson_iters/0", "poisson_iters/1"}
    for k in keys:
        assert metrics[k].dtype == torch.int32
        assert 0 <= int(metrics[k]) <= tr.sampler_cfg.poisson_iters


@pytest.mark.parametrize("sampler", ["poisson-bandit", "bandit"])
def test_spans_summary_counts_fixed_point_iterations(tmp_path, sampler):
    """With spans on, ``fit`` sums each step's ``poisson_iters/<l>`` into
    the counter ``sampler.fixed_point_iters/<l>`` beside
    ``sampler.nodes/<l>``: the sum of the counts the steps logged."""
    tr = _trainer(tmp_path, sampler, num_epochs=1)
    seen = {0: 0.0, 1: 0.0}
    log = tr._log_train_step

    def spy(metrics, prev_t, fb_time):
        for l in seen:
            seen[l] += float(metrics.get(f"poisson_iters/{l}", 0))
        return log(metrics, prev_t, fb_time)

    tr._log_train_step = spy
    spans.disable()
    spans.reset()
    spans.enable()
    try:
        tr.fit()
        counters = spans.snapshot()["counters"]
    finally:
        spans.disable()
        spans.reset()
    assert counters["sampler.nodes/0"] > 0
    if sampler == "bandit":
        assert not any(k.startswith("sampler.fixed_point_iters/")
                       for k in counters)
        return
    for l in (0, 1):
        got = counters[f"sampler.fixed_point_iters/{l}"]
        assert got == seen[l]
        assert 0 < got <= tr.sampler_cfg.poisson_iters * tr.global_step
