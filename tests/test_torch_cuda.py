"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. A CUDA kernel has no interpret mode, so these skip without a
card; run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

Dyadic values (multiples of 1/64) make every summation order exact, so the
kernels must match the plain versions bit for bit.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_kernel, split_kernel
from lightgbm_tpu_torch.ops.histogram import leaf_histogram, leaf_values
from lightgbm_tpu_torch.ops.split import SplitParams, find_best_split_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _dyadic(dev, F=28, N=50_001, B=255, seed=0):
    rng = np.random.RandomState(seed)
    bins = torch.tensor(rng.randint(0, B, (F, N)), dtype=torch.uint8, device=dev)
    vals = leaf_values(
        torch.tensor(rng.randint(-64, 65, N) / 64.0, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / 64.0, dtype=torch.float32, device=dev),
        torch.tensor(rng.rand(N) > 0.2, device=dev),
    )
    rows = torch.tensor(np.sort(rng.permutation(N)[: N // 7]).astype(np.int32), device=dev)
    return bins, vals, rows


@pytest.mark.parametrize("B", [15, 63, 255])
def test_histogram_kernel_matches_plain(dev, B):
    bins, vals, rows = _dyadic(dev, B=B)
    nf = bins.t().contiguous()
    assert torch.equal(hist_kernel.histogram(bins, vals, B), leaf_histogram(bins, vals, B))
    assert torch.equal(
        hist_kernel.histogram(nf.t(), vals, B, rows), leaf_histogram(bins, vals, B, rows)
    )


@pytest.mark.parametrize("two_way", [True, False])
def test_split_kernel_matches_plain(dev, two_way):
    B = 255
    bins, vals, rows = _dyadic(dev, B=B)
    small = leaf_histogram(bins, vals, B, rows)
    hist2 = torch.stack([small, leaf_histogram(bins, vals, B) - small]).contiguous()
    sums = hist2[:, 0].sum(dim=1).contiguous()
    cons = torch.tensor([[-np.inf, np.inf], [-1.0, 0.5]], dtype=torch.float32, device=dev)
    F = bins.shape[0]
    meta = {
        "num_bin": torch.full((F,), B, dtype=torch.int32, device=dev),
        "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.arange(F, dtype=torch.int32, device=dev) % 4,
        "monotone": (torch.arange(F, dtype=torch.int32, device=dev) % 3) - 1,
    }
    fmask = torch.arange(F, device=dev) != 5
    for pr in ((0.0, 0.0, 0.0, 20, 1e-3, 0.0), (0.5, 1.0, 0.3, 5, 0.5, 0.1)):
        kf, ki = split_kernel.find_best_split_pair(
            hist2, sums, cons, meta, fmask, SplitParams(*pr), two_way
        )
        pf, pi = find_best_split_pair(hist2, sums, cons, meta, fmask, SplitParams(*pr), two_way)
        assert bool(((kf == pf) | (kf.isnan() & pf.isnan())).all())
        assert torch.equal(ki, pi)
