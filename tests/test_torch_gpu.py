"""The port's CUDA kernels held against their plain PyTorch versions on the
card. Every test here is marked ``gpu`` and skips without a CUDA device (the
decision is made in a fixture, never at import). This file imports torch and
the port only, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerance: bitunpack128 exact (integer bit patterns); onehot_sum_f32 exact
for 0/1 values (counts below 2^24 are exact in f32), and for other float32
values 1e-5 of the bucket's sum of magnitudes, because atomics add in an
order that changes from run to run; murmur3_words and radix_ranks exact
(integer hashes and ranks), radix_ranks also against torch's stable
argsort; hash_join_probe exact (build rows and flags), hash_join_build on
the card equal to its CPU result, and q5 over sparse supplier ids on the
card equal to the NumPy oracle (revenue within 1e-9 relative).
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


def _utf8_rows(n: int, W: int, seed: int):
    """(words, lengths) of n random byte rows, lengths 0..4W, with bytes
    >= 0x80 (UTF-8 of "é" and "日本", cut anywhere)."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(("aé日本z" * 8).encode("utf-8"), np.uint8)
    raw = pool[rng.integers(0, len(pool), (n, 4 * W))]
    lens = rng.integers(0, 4 * W + 1, n).astype(np.int32)
    raw = np.where(np.arange(4 * W)[None, :] < lens[:, None], raw, 0)
    words = np.ascontiguousarray(raw.astype(np.uint8)).view("<i4")
    return words.astype(np.int32), lens


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 2, 3, 8])
def test_murmur3_words_kernel_matches_plain(cuda_device, W):
    for n in (1, 257, 20_000):
        words, lens = _utf8_rows(n, W, n * 10 + W)
        w = torch.from_numpy(words).to(cuda_device)
        ln = torch.from_numpy(lens).to(cuda_device)
        seeds = torch.from_numpy(np.random.default_rng(n).integers(
            -2**31, 2**31, n).astype(np.int32)).to(cuda_device)
        for seed in (42, seeds):
            before = CK.launches["murmur3_words"]
            got = CK.murmur3_words(w, ln, seed)
            want = CK.murmur3_words_plain(w, ln, seed)
            torch.cuda.synchronize()
            assert CK.launches["murmur3_words"] == before + 1
            assert torch.equal(got, want), (n, W)


@pytest.mark.gpu
def test_murmur3_words_rejects_non_contiguous(cuda_device):
    words = torch.zeros((8, 2), dtype=torch.int32, device=cuda_device)
    lens = torch.zeros(16, dtype=torch.int32, device=cuda_device)[::2]
    with pytest.raises(ValueError):
        CK.murmur3_words(words, lens, 42)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 5, 9, 129, 4096])
def test_radix_ranks_kernel_matches_plain(cuda_device, lanes):
    for cap in (8, 1000, 1 << 19):
        rng = np.random.default_rng(cap + lanes)
        # -1 and ids >= lanes are outside the domain
        ids = torch.from_numpy(rng.integers(-1, lanes + 2, cap)
                               .astype(np.int32)).to(cuda_device)
        before = CK.launches["radix_ranks"]
        ranks, counts = CK.radix_ranks(ids, lanes)
        want_r, want_c = CK.radix_ranks_plain(ids, lanes)
        torch.cuda.synchronize()
        assert CK.launches["radix_ranks"] == before + 1
        assert torch.equal(ranks, want_r) and torch.equal(counts, want_c)
        inside = torch.from_numpy(rng.integers(0, lanes, cap)
                                  .astype(np.int32)).to(cuda_device)
        perm = CK.radix_partition_permutation(inside, lanes)
        assert torch.equal(perm, torch.argsort(inside, stable=True))


def _probe_inputs(n: int, n_build: int, seed: int):
    """Sparse unique int64 build keys (about 10^10 apart, negatives too)
    and n stream keys: about half of them hits, the rest misses, and some
    null rows' canonical 0 and the empty-slot key int64 min."""
    rng = np.random.default_rng(seed)
    keys = (rng.permutation(n_build).astype(np.int64) + 1) * 9_999_991_337
    keys[::3] *= -1
    stream = np.where(rng.random(n) < 0.5, rng.choice(keys, n),
                      rng.integers(-2**62, 2**62, n))
    stream[rng.random(n) < 0.05] = 0
    head = np.array([CK.HJ_EMPTY, 0], np.int64)[:n]
    stream[:len(head)] = head
    return keys, stream.astype(np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_build", [(1 << 20, 10_000), (1 << 20, 200),
                                       (1000, 10_000), (1, 200)])
def test_hash_join_probe_kernel_matches_plain(cuda_device, n, n_build):
    keys, stream = _probe_inputs(n, n_build, n + n_build)
    nb = CK.hash_join_buckets(n_build)
    k = torch.from_numpy(keys).to(cuda_device)
    tk, tr, ok = CK.hash_join_build(
        k, torch.ones(n_build, dtype=torch.bool, device=cuda_device), nb)
    assert bool(ok)
    s = torch.from_numpy(stream).to(cuda_device)
    before = CK.launches["hash_join_probe"]
    pos, found = CK.hash_join_probe(tk, tr, s, nb)
    want_pos, want_found = CK.hash_join_probe_plain(tk, tr, s, nb)
    torch.cuda.synchronize()
    assert CK.launches["hash_join_probe"] == before + 1
    assert torch.equal(pos, want_pos) and torch.equal(found, want_found)
    assert not bool(found[0])      # int64 min never matches an empty slot
    member = torch.from_numpy(np.isin(stream, keys)).to(cuda_device)
    assert torch.equal(found, member)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unique", "overfull", "duplicate",
                                  "ineligible"])
def test_hash_join_build_on_card_equals_cpu(cuda_device, case):
    rng = np.random.default_rng(len(case))
    keys, _ = _probe_inputs(1, 3000, 3)
    elig = np.ones(len(keys), bool)
    if case == "overfull":
        keys = np.arange(1, 16_385, dtype=np.int64) * 977
        elig = np.ones(len(keys), bool)
    elif case == "duplicate":
        keys[100] = keys[2000]
    elif case == "ineligible":
        elig = rng.random(len(keys)) < 0.6
    nb = 1024
    cpu = CK.hash_join_build(torch.from_numpy(keys), torch.from_numpy(elig),
                             nb)
    before = CK.launches["radix_ranks"]
    card = CK.hash_join_build(torch.from_numpy(keys).to(cuda_device),
                              torch.from_numpy(elig).to(cuda_device), nb)
    torch.cuda.synchronize()
    assert CK.launches["radix_ranks"] == before + 1
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b), case
    assert bool(card[2]) == (case in ("unique", "ineligible"))


@pytest.mark.gpu
def test_hash_join_probe_rejects_misaligned_tables(cuda_device):
    keys, stream = _probe_inputs(64, 200, 1)
    tk, tr, _ = CK.hash_join_build(
        torch.from_numpy(keys).to(cuda_device),
        torch.ones(200, dtype=torch.bool, device=cuda_device), 128)
    shifted = torch.cat([tk[:1], tk])[1:]      # 8 bytes off its allocation
    with pytest.raises(ValueError):
        CK.hash_join_probe(shifted, tr,
                           torch.from_numpy(stream).to(cuda_device), 128)


@pytest.mark.gpu
def test_q5_sparse_on_card_matches_numpy(cuda_device, tmp_path):
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.exec.joins import HashJoinExec
    from spark_rapids_tpu_torch.session import TorchSession
    paths = tpch.generate(0.01, str(tmp_path))
    spark = TorchSession(device=cuda_device)
    exp = tpch.np_q5(tpch.load_np(paths))
    for query in (tpch.q5, tpch.q5_sparse):
        plan = query(tpch.load(spark, paths)).physical_plan()
        CK.reset_launches()
        got = [tuple(r.values()) for r in plan.execute_collect().to_pylist()]
        assert [g[0] for g in got] == [e[0] for e in exp]
        for (_, a), (_, b) in zip(got, exp):
            assert a == pytest.approx(b, rel=1e-9)

        def joins(p):
            own = [p] if isinstance(p, HashJoinExec) else []
            return own + [j for c in p.children for j in joins(c)]
        hashed = [j for j in joins(plan) if j.stats["probe_mode"] == "hash"]
        if query is tpch.q5:
            assert not hashed and CK.launches["hash_join_probe"] == 0
        else:
            assert len(hashed) == 1
            assert (CK.launches["hash_join_probe"]
                    == hashed[0].stats["stream_batches"] > 0)
            assert CK.launches["radix_ranks"] >= 1
