"""The port's four CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so without a GPU these tests skip;
run them on one with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply, exp3_apply_plain
from bliss_gnn_tpu_torch.ops.gather import lut_gather, lut_gather_plain
from bliss_gnn_tpu_torch.ops.scatter import scatter_add, scatter_add_plain
from bliss_gnn_tpu_torch.ops.segsum import (
    segment_sum,
    segment_sum_diff,
    segment_sum_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("n_valid", [None, 70_000])
def test_scatter_add_kernel(dev, gen, n_valid):
    keys = torch.randint(0, 5000, (100_000,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randn(100_000, generator=gen, device=dev)
    before = scatter_add.launches
    got = scatter_add(keys, vals, 5000, n_valid)
    assert scatter_add.launches == before + 1
    want = scatter_add_plain(keys, vals, 5000, n_valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bool, torch.bfloat16, torch.int32,
                                   torch.float32, torch.int64])
def test_lut_gather_kernel(dev, gen, dtype):
    lut = torch.randint(0, 2 ** 30, (9000,), generator=gen, device=dev)
    lut = (lut % 2 == 0) if dtype == torch.bool else lut.to(dtype)
    idx = torch.randint(-5, 9005, (50_000,), generator=gen, device=dev,
                        dtype=torch.int32)  # some out of range
    got = lut_gather(lut, idx, n_valid=40_000)
    assert got.dtype == dtype
    assert torch.equal(got, lut_gather_plain(lut, idx, n_valid=40_000))


@pytest.mark.parametrize("f,dtype", [(256, torch.bfloat16),
                                     (41, torch.bfloat16),
                                     (41, torch.float32)])
def test_segment_sum_kernel(dev, gen, f, dtype):
    ids = torch.randint(-2, 300, (20_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    data = torch.randn((20_000, f), generator=gen, device=dev).to(dtype)
    got = segment_sum(data, ids, 298, n_valid=15_000).float()
    want = segment_sum_plain(data, ids, 298, n_valid=15_000).float()
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-3)


def test_segment_sum_grad_is_row_gather(dev, gen):
    ids = torch.randint(0, 80, (5000,), generator=gen, device=dev,
                        dtype=torch.int32)
    data = torch.randn((5000, 64), generator=gen, device=dev,
                       dtype=torch.bfloat16).requires_grad_()
    w = torch.randn((80, 64), generator=gen, device=dev)
    (segment_sum_diff(data, ids, 80).float() * w).sum().backward()
    torch.testing.assert_close(data.grad.float(),
                               w[ids.long()].to(torch.bfloat16).float())


def test_exp3_apply_kernel(dev, gen):
    limit = 1 << 20
    idx = torch.randint(0, limit, (30_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:5000] = idx[5000:10_000]  # duplicates compose
    idx[-3000:] = limit  # no-op slots
    mult = torch.exp(torch.rand(30_000, generator=gen, device=dev) * 0.5)
    state = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    ref = state.clone()
    assert int(exp3_apply(state, idx, mult, limit)) == 0
    exp3_apply_plain(ref, idx, mult, limit)
    torch.testing.assert_close(state.float(), ref.float(), rtol=2.0 ** -7,
                               atol=0.0)
