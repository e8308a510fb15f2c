"""The port's CUDA kernels held against their plain PyTorch versions on the
card. Every test here is marked ``gpu`` and skips without a CUDA device (the
decision is made in a fixture, never at import). This file imports torch and
the port only, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerance: bitunpack128 exact (integer bit patterns); onehot_sum_f32 exact
for 0/1 values (counts below 2^24 are exact in f32), and for other float32
values 1e-5 of the bucket's sum of magnitudes, because atomics add in an
order that changes from run to run.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.ops import cuda_kernels as CK


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _words(n: int, bw: int, extra: int) -> np.ndarray:
    rng = np.random.default_rng(bw * 100_003 + n)
    nw = -(-n // 128) * 4 * bw + extra
    return rng.integers(-2**31, 2**31, nw, dtype=np.int64).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("bw", list(range(1, 33)))
def test_bitunpack128_kernel_matches_plain(cuda_device, bw):
    for n in (1, 127, 300, 8193, 20_000):
        for extra in (0, 4 * bw + 3):
            words = torch.from_numpy(_words(n, bw, extra)).to(cuda_device)
            cap = bucket_capacity(n)
            before = CK.launches["bitunpack128"]
            got = CK.bitunpack128(words, bw, n, cap)
            want = CK.bitunpack128_plain(words, bw, n, cap)
            torch.cuda.synchronize()
            assert CK.launches["bitunpack128"] == before + 1
            assert torch.equal(got, want), (bw, n, extra)


@pytest.mark.gpu
def test_bitunpack128_short_buffer_on_card(cuda_device):
    words = torch.from_numpy(_words(300, 7, 0)[:20]).to(cuda_device)
    got = CK.bitunpack128(words, 7, 300, 512)
    assert torch.equal(got, CK.bitunpack128_plain(words, 7, 300, 512))


@pytest.mark.gpu
def test_bitunpack128_rejects_non_contiguous(cuda_device):
    words = torch.zeros(64, dtype=torch.int32, device=cuda_device)[::2]
    with pytest.raises(ValueError):
        CK.bitunpack128(words, 4, 8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("cap,D", [(1 << 20, 12), (20_000, 4096), (4096, 1000),
                                   (1, 3), (0, 5),
                                   (3000, CK.ONEHOT_MAX_DOMAIN)])
def test_onehot_sum_f32_kernel_matches_plain(cuda_device, cap, D):
    rng = np.random.default_rng(cap + D)
    codes = torch.from_numpy(
        rng.integers(-2, D + 2, cap).astype(np.int32)).to(cuda_device)
    ones = torch.from_numpy(
        (rng.random(cap) < 0.7).astype(np.float32)).to(cuda_device)
    before = CK.launches["onehot_sum_f32"]
    got = CK.onehot_sum_f32(ones, codes, D)
    want = CK.onehot_sum_f32_plain(ones, codes, D)
    torch.cuda.synchronize()
    assert CK.launches["onehot_sum_f32"] == before + 1
    assert torch.equal(got, want), (cap, D)
    vals = torch.from_numpy(
        rng.normal(0, 10, cap).astype(np.float32)).to(cuda_device)
    got = CK.onehot_sum_f32(vals, codes, D).double()
    want = CK.onehot_sum_f32_plain(vals, codes, D).double()
    mags = CK.onehot_sum_f32_plain(vals.abs(), codes, D).double()
    assert bool(((got - want).abs() <= 1e-5 * mags).all()), (cap, D)


@pytest.mark.gpu
def test_onehot_sum_f32_rejects_non_contiguous(cuda_device):
    vals = torch.zeros(64, dtype=torch.float32, device=cuda_device)[::2]
    codes = torch.zeros(32, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        CK.onehot_sum_f32(vals, codes, 4)
