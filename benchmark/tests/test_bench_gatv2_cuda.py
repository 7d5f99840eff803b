"""On the card: the GATv2 training reference's sampler side on arms that
are bf16 subnormals (as a window leaves many). ``index_add_`` on the card
adds with atomics that flush subnormal floats to zero, so the unscaled
arms read as unweighted; ``sampling_arms`` lifts them into the normal
range and the card's probabilities are the CPU's."""
import types

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _graph(dev, n=300, seed=0):
    gen = torch.Generator().manual_seed(seed)
    deg = torch.randint(1, 40, (n,), generator=gen)
    indptr = torch.zeros(n + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(deg, 0)
    src = torch.randint(0, n, (int(indptr[-1]),), generator=gen)
    g = types.SimpleNamespace(indptr=indptr, src=src, in_deg=deg,
                              w=torch.ones(src.shape[0]))
    arms = torch.randint(1, 128, (src.shape[0],), dtype=torch.int16,
                         generator=gen).view(torch.bfloat16).float()
    return (types.SimpleNamespace(**{k: v.to(dev) for k, v in vars(
        g).items()}), arms.to(dev))


def _probs(dev, scale):
    import gatv2_train

    g, arms = _graph(dev)
    dst = torch.arange(0, 64, device=dev)
    src = torch.cat([dst, torch.arange(64, 200, device=dev)])
    mask = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    spec = {"eta": 0.1, "fanout": 100, "poisson_eps": 0.9999,
            "poisson_iters": 50}
    row = gatv2_train.sampling_arms(arms) if scale else arms
    out = gatv2_train.derive_block(g, row, spec, dst, mask[:64], src, mask)
    return out["p_slot"].cpu()


@pytest.mark.cuda
def test_sampler_side_on_subnormal_arms_matches_the_cpu(card):
    want = _probs("cpu", scale=False)
    assert torch.allclose(_probs("cuda", scale=True), want, rtol=1e-5)
    assert torch.allclose(_probs("cpu", scale=True), want, rtol=1e-5)
    # the card's atomics flush the unscaled arms' sums to zero
    assert not torch.allclose(_probs("cuda", scale=False), want, rtol=1e-3)
