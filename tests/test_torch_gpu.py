"""The port's CUDA kernels held against their plain PyTorch versions on the
card. Every test here is marked ``gpu`` and skips without a CUDA device (the
decision is made in a fixture, never at import). This file imports torch and
the port only, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerance: bitunpack128 and the chunk decode exact (integer bit patterns,
raw value bits and validity); onehot_sum_f32 and the fused count launch
(onehot_sums_f32) exact for 0/1 values of every type (counts below 2^24 are
exact in f32), and for other float32 values 1e-5 of the bucket's sum of
magnitudes, because atomics add in an order that changes from run to run;
murmur3_words and radix_ranks exact (integer hashes and ranks), radix_ranks
and radix_partition_permutation also against torch's stable argsort;
hash_join_probe exact (build rows and flags, also on a full bucket, the
ragged tail and int64 min in an occupied slot), the hash_join_build kernel
bit for bit its plain version and its CPU result, and q5 over sparse
supplier ids on the card equal to the NumPy oracle (revenue within 1e-9
relative). The sort-based group-by (plain torch ops, no kernel of its own)
on the card equal to the same functions on the CPU, bit for bit, and TPC-H
q3 and q18 at SF 0.1 on the card equal to the CPU run bit for bit and to
the NumPy oracles (keys exact, numbers within 1e-9 relative). The rank join
(``ops/joining.join_ranks``/``probe``, plain torch ops) on the card bit for
bit the CPU at 2^20 stream rows, over int, string and double keys, and a
three-key join through the session the same rows as the CPU run. The
official q1, q3 and q5 SQL text at SF 0.1 on the card: q3 bit for bit the
CPU run; q1 and q5 the same keys and counts, their double sums within 1e-9
relative of the CPU run (the dense aggregate sums doubles by cuBLAS matvecs
or ``index_add_`` on the card, in another order than on the CPU); all
three against the NumPy oracles within 1e-6 relative
(``tests/test_sql_tpch.py``'s bound), and q5's two-key join on the rank
path. The 17 ported TPC-DS DataFrame queries at SF 0.012 on the card equal
to the CPU run and the NumPy oracle under ``tpcds.check_rows`` (keys,
counts and decimals exact, float slots within 1e-9 relative); decimals
round-trip through the card exactly; a keyless aggregate (one partition,
four, and empty input) on the card equals the CPU run (counts and decimals
exact, a double sum within 1e-12 relative). The five TPC-DS queries of the
window exec and the nested-loop join come through the same per-query test.
The window exec (plain torch ops) for every function and frame kind over
three files on the card against the CPU run: integers, ranks, counts,
min/max and lead/lag exact, double sums and averages within rel 1e-12 and
abs 1e-9 (the card's cumsum adds in another order); the nested-loop join
for every ported type, with and without a condition, the CPU run's rows in
order. Right and full outer hash joins on an int key, a string key and two
keys, an inner join with a residual condition, and the keyless full outer
join, over a three-file stream on the card: the CPU run's rows in order;
``matched_build`` at 2^20 stream rows bit for bit the CPU's. The 27
official TPC-DS SQL texts the port lowers, at SF 0.012 on the card: the CPU
run's rows and the NumPy oracle's under ``check_rows``.
"""

import os

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


def _count_requests(rng, cap: int, k: int, dev):
    """k requests cycling through bool, int32, int64 and float32 values,
    with every fifth a count of every row (no value column), masks with
    nulls, some with no mask (a value that is its own mask); float32 values
    are random normals every eighth request, else 0/1."""
    reqs, exact = [], []
    for j in range(k):
        t = (np.bool_, np.int32, np.int64, np.float32)[j % 4]
        floats = t == np.float32 and j % 8 == 3 and j % 5 != 4
        v = (rng.normal(0, 10, cap).astype(np.float32) if floats
             else (rng.random(cap) < 0.7).astype(t))
        m = None if j % 3 == 2 else torch.from_numpy(
            rng.random(cap) < 0.8).to(dev)
        reqs.append((None if j % 5 == 4 else torch.from_numpy(v).to(dev), m))
        exact.append(not floats)
    return reqs, exact


@pytest.mark.gpu
@pytest.mark.parametrize("cap,D,k", [
    (1 << 20, 12, 6), (8, 12, 8), (20_000, 4096, 3),
    (3000, CK.ONEHOT_MAX_DOMAIN, 2), (0, 12, 3), (1, 12, 3),
    (1 << 20, 12, CK.ONEHOT_MAX_REQUESTS + 1),
    (5000, 26, CK.ONEHOT_MAX_REQUESTS + 1)])
def test_onehot_sums_kernel_matches_plain(cuda_device, cap, D, k):
    """The fused count launch against its plain version, with the rows
    that are not live given the code D (as the dense aggregate gives them)
    and without, on aligned tensors (16-byte row quads) and on slices one
    row in (one row a step); one launch per ONEHOT_MAX_REQUESTS requests."""
    rng = np.random.default_rng(cap * 7 + D + k)
    codes = torch.from_numpy(
        rng.integers(-2, D + 2, cap).astype(np.int32)).to(cuda_device)
    live = torch.from_numpy(rng.random(cap) < 0.9).to(cuda_device)
    dropped = torch.where(live, codes, D)
    reqs, exact = _count_requests(rng, cap, k, cuda_device)
    per_call = -(-k // CK.ONEHOT_MAX_REQUESTS)
    cases = [(dropped, reqs), (codes, reqs)]
    if cap > 1:
        cases.append((dropped[1:], [(None if v is None else v[1:],
                                     None if m is None else m[1:])
                                    for v, m in reqs]))
    for c, r in cases:
        before = CK.launches["onehot_sum_f32"]
        got = CK.onehot_sums_f32(c, r, D).double()
        want = CK.onehot_sums_f32_plain(c, r, D).double()
        torch.cuda.synchronize()
        assert CK.launches["onehot_sum_f32"] == before + per_call
        assert got.shape == (k, D)
        for j, ex in enumerate(exact):
            if ex:
                assert torch.equal(got[j], want[j]), (cap, D, k, j)
            else:
                mags = CK.onehot_sums_f32_plain(
                    c, [(r[j][0].abs(), r[j][1])], D)[0].double()
                assert bool(((got[j] - want[j]).abs()
                             <= 1e-5 * mags).all()), (cap, D, k, j)


@pytest.mark.gpu
def test_onehot_sums_rejects_non_contiguous(cuda_device):
    codes = torch.zeros(64, dtype=torch.int32, device=cuda_device)[::2]
    vals = torch.ones(32, dtype=torch.bool, device=cuda_device)
    before = CK.launches["onehot_sum_f32"]
    with pytest.raises(ValueError):
        CK.onehot_sums_f32(codes, [(vals, None)], 4)
    assert CK.launches["onehot_sum_f32"] == before


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


def _probe_inputs(n: int, n_build: int, seed: int, share: float = 0.5):
    """Sparse unique int64 build keys (about 10^10 apart, negatives too)
    and n stream keys, each a build key with probability share; below
    share 1 also some null rows' canonical 0 and, first, the empty-slot key
    int64 min."""
    rng = np.random.default_rng(seed)
    keys = (rng.permutation(n_build).astype(np.int64) + 1) * 9_999_991_337
    keys[::3] *= -1
    stream = np.where(rng.random(n) < share, rng.choice(keys, n),
                      rng.integers(-2**62, 2**62, n))
    if share < 1:
        stream[rng.random(n) < 0.05] = 0
        head = np.array([CK.HJ_EMPTY, 0], np.int64)[:n]
        stream[:len(head)] = head
    return keys, stream.astype(np.int64)


def _probe_on_card(tk, tr, s, nb):
    """hash_join_probe on the card against its plain version, bit for bit,
    with one launch counted; returns (pos, found)."""
    before = CK.launches["hash_join_probe"]
    pos, found = CK.hash_join_probe(tk, tr, s, nb)
    want_pos, want_found = CK.hash_join_probe_plain(tk, tr, s, nb)
    torch.cuda.synchronize()
    assert CK.launches["hash_join_probe"] == before + 1
    assert torch.equal(pos, want_pos) and torch.equal(found, want_found)
    return pos, found


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_build,share", [
    (1 << 20, 10_000, 0.5), (1 << 20, 200, 0.5), (1000, 10_000, 0.5),
    (1, 200, 0.5)] + [
    (n, n_build, share) for n in (1, 31, 33, (1 << 20) + 5)
    for n_build in (10_000, 200) for share in (0.0, 1.0)])
def test_hash_join_probe_kernel_matches_plain(cuda_device, n, n_build,
                                              share):
    seed = n + n_build + {0.5: 0, 0.0: 1, 1.0: 2}[share]
    keys, stream = _probe_inputs(n, n_build, seed, share)
    nb = CK.hash_join_buckets(n_build)
    assert nb == (4096 if n_build == 10_000 else 128)
    k = torch.from_numpy(keys).to(cuda_device)
    tk, tr, ok = CK.hash_join_build(
        k, torch.ones(n_build, dtype=torch.bool, device=cuda_device), nb)
    assert bool(ok)
    s = torch.from_numpy(stream).to(cuda_device)
    pos, found = _probe_on_card(tk, tr, s, nb)
    if share < 1:
        assert not bool(found[0])  # int64 min never matches an empty slot
    else:
        assert bool(found.all())
    member = torch.from_numpy(np.isin(stream, keys)).to(cuda_device)
    assert torch.equal(found, member)


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [128, 4096])
def test_hash_join_probe_kernel_full_bucket(cuda_device, nb):
    """A bucket of 8 keys, every slot hit, beside misses of that bucket."""
    crowd = _one_bucket_keys(40, nb)
    rng = np.random.default_rng(nb)
    h_bits = nb.bit_length() - 1
    b = int(CK.hash_join_bucket(torch.from_numpy(crowd[:1]), h_bits)[0])
    other, _ = _probe_inputs(1, 200, nb)
    other = other[CK.hash_join_bucket(torch.from_numpy(other),
                                      h_bits).numpy() != b][:100]
    keys = np.concatenate([crowd[:8], other])
    tk, tr, ok = CK.hash_join_build(
        torch.from_numpy(keys).to(cuda_device),
        torch.ones(len(keys), dtype=torch.bool, device=cuda_device), nb)
    assert bool(ok)
    slots = tr[b * CK.HJ_SLOTS:(b + 1) * CK.HJ_SLOTS]
    assert sorted(slots.tolist()) == list(range(8))
    stream = rng.permutation(np.concatenate([np.repeat(crowd[:8], 33),
                                             rng.choice(crowd[8:], 301)]))
    pos, found = _probe_on_card(tk, tr, torch.from_numpy(stream).to(
        cuda_device), nb)
    hit = np.isin(stream, crowd[:8])
    assert found.cpu().numpy().tolist() == hit.tolist()
    assert set(pos.cpu().numpy()[hit].tolist()) == set(range(8))


@pytest.mark.gpu
def test_hash_join_probe_kernel_finds_int64_min_in_an_occupied_slot(
        cuda_device):
    """A table that holds int64 min in an occupied slot (only
    hash_join_build_plain makes one: the join path keeps int64 min out of
    the build) is probed exactly: a stream key of int64 min finds that
    slot's row."""
    keys, _ = _probe_inputs(1, 200, 5)
    keys[77] = CK.HJ_EMPTY
    k = torch.from_numpy(keys).to(cuda_device)
    tk, tr, _ok = CK.hash_join_build_plain(
        k, torch.ones(200, dtype=torch.bool, device=cuda_device), 128)
    stream = torch.tensor([CK.HJ_EMPTY, int(keys[3]), 0, CK.HJ_EMPTY],
                          dtype=torch.int64, device=cuda_device)
    pos, found = _probe_on_card(tk, tr, stream, 128)
    assert found.tolist() == [True, True, False, True]
    assert pos.tolist() == [77, 3, -1, 77]


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
    before = dict(CK.launches)
    card = CK.hash_join_build(torch.from_numpy(keys).to(cuda_device),
                              torch.from_numpy(elig).to(cuda_device), nb)
    torch.cuda.synchronize()
    assert CK.launches["hash_join_build"] == before["hash_join_build"] + 1
    assert CK.launches["radix_ranks"] == before["radix_ranks"]
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b), case
    assert bool(card[2]) == (case in ("unique", "ineligible"))


def _one_bucket_keys(count: int, nb: int) -> np.ndarray:
    """count distinct int64 keys that share one Fibonacci bucket of nb."""
    cand = np.arange(1, 1 << 22, dtype=np.int64) * 7919
    h = (cand.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(
        64 - (nb.bit_length() - 1))
    return cand[h == h[0]][:count]


def _build_keys(case: str, n: int, nb: int, seed: int):
    """(keys, eligible) of a build of n rows: sparse unique keys, or the
    overfull, duplicate, ineligible, all-ineligible or extreme-key case."""
    rng = np.random.default_rng(seed)
    keys = (rng.permutation(n).astype(np.int64) + 1) * 9_999_991_337
    keys[::3] *= -1
    elig = np.ones(n, bool)
    if case == "overfull":
        # 12 keys of one bucket spread over the rows, the rest sparse
        keys[np.linspace(0, n - 1, 12).astype(int)] = _one_bucket_keys(12, nb)
    elif case == "duplicate":
        keys[n // 2] = keys[3]
    elif case == "ineligible":
        elig = rng.random(n) < 0.6
    elif case == "all_ineligible":
        elig[:] = False
    elif case == "extremes":
        keys[:2] = [np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max]
    return keys, elig


@pytest.mark.gpu
@pytest.mark.parametrize("n,nb", [(16_384, 4096), (200, 128)])
@pytest.mark.parametrize("case", ["unique", "overfull", "duplicate",
                                  "ineligible", "all_ineligible",
                                  "extremes"])
def test_hash_join_build_kernel_matches_plain(cuda_device, case, n, nb):
    keys, elig = _build_keys(case, n, nb, n + len(case))
    k = torch.from_numpy(keys).to(cuda_device)
    e = torch.from_numpy(elig).to(cuda_device)
    before = dict(CK.launches)
    got = CK.hash_join_build(k, e, nb)
    want = CK.hash_join_build_plain(k, e, nb)
    torch.cuda.synchronize()
    assert CK.launches["hash_join_build"] == before["hash_join_build"] + 1
    assert CK.launches["radix_ranks"] == before["radix_ranks"]
    for a, b in zip(got, want):
        assert a.device == k.device and torch.equal(a, b), case
    if n == 200:     # at 16,384 random keys some buckets overfill anyway
        assert bool(got[2]) == (case not in ("overfull", "duplicate")), case


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
            assert CK.launches["hash_join_build"] >= 1
            assert CK.launches["radix_ranks"] == 0


# -- the fused chunk decode -------------------------------------------------

def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b, x = x & 0x7F, x >> 7
        out.append(b | 0x80 if x else b)
        if not x:
            return bytes(out)


def _synthetic_chunk(rng, bw: int, nd: int, plans):
    """A parsed chunk (``parquet_native.ChunkPages``, INT64 dictionary) of
    v1 pages, one per plan (rows, mode, null fraction): "packed" pages hold
    bit-packed groups only, "rle" pages runs only, "mixed" pages both."""
    from spark_rapids_tpu_torch.io import parquet_native as PN
    pages = []
    for n, mode, null_frac in plans:
        dl = (rng.random(n) >= null_frac).astype(np.int32)
        n_present = int(dl.sum())
        idx = np.where(rng.random(n_present) < 0.9,
                       rng.integers(0, nd, n_present),
                       rng.integers(0, 1 << bw, n_present, dtype=np.uint64))
        idx = idx.astype(np.uint64)
        out, at = bytearray(), 0
        while at < n_present:
            if mode == "rle" or (mode == "mixed" and rng.random() < 0.5):
                count = int(min(n_present - at, rng.integers(1, 300)))
                v = int(rng.integers(0, min(1 << bw, 1 << 31)))
                out += _varint(count << 1) + v.to_bytes((bw + 7) // 8,
                                                        "little")
            else:
                count = int(min(n_present - at, 8 * rng.integers(1, 200)))
                groups = -(-count // 8)
                vals = np.zeros(groups * 8, np.uint64)
                vals[:count] = idx[at:at + count]
                bits = ((vals[:, None] >> np.arange(bw, dtype=np.uint64)) & 1)
                out += _varint((groups << 1) | 1) + np.packbits(
                    bits.astype(np.uint8).reshape(-1),
                    bitorder="little").tobytes()
            at += count
        page_bytes = b"\x00" * 5 + bytes([bw]) + bytes(out)
        segs = PN.parse_rle_hybrid(page_bytes, 6, len(page_bytes), bw,
                                   n_present)
        pages.append((n, dl, bw, page_bytes, 5, segs))
    dvals = rng.integers(-2**62, 2**62, nd).astype("<i8")
    return PN.ChunkPages("INT64", dvals, pages, sum(p[0] for p in plans))


def _packed_on_card(chunk, capacity, want, device):
    from spark_rapids_tpu_torch.io import parquet_native as PN
    dictionary = torch.from_numpy(np.asarray(chunk.dict_values)).to(want)
    packed = PN.pack_chunk(chunk, dictionary, capacity, pin=True)
    buf = packed.buf.to(device, non_blocking=True)
    return packed, PN.chunk_views(buf, packed, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bw", list(range(1, 33)))
def test_chunk_decode_kernel_matches_plain(cuda_device, bw):
    rng = np.random.default_rng(bw)
    plans = [(20_000, "packed", 0.0), (7_000, "mixed", 0.3),
             (4_100, "rle", 0.0), (20_000, "packed", 0.1),
             (513, "mixed", 1.0), (9_000, "packed", 0.0)]
    chunk = _synthetic_chunk(rng, bw, 301, plans)
    cap = bucket_capacity(chunk.num_values)
    for want in (torch.int64, torch.float64, torch.int32, torch.int16,
                 torch.int8):
        packed, (words, table, defs, dic) = _packed_on_card(
            chunk, cap, want, cuda_device)
        before = CK.launches["bitunpack128"]
        got = CK.chunk_decode(words, table, defs, dic, packed.n_rows, cap,
                              want, 0)
        want_v, want_m = CK.chunk_decode_plain(words, table, defs, dic,
                                               packed.n_rows, cap, want, 0)
        torch.cuda.synchronize()
        assert CK.launches["bitunpack128"] == before + 1
        assert torch.equal(got[0], want_v) and torch.equal(got[1], want_m)


@pytest.mark.gpu
@pytest.mark.parametrize("null_frac", [0.0, 0.35])
def test_chunk_decode_kernel_one_large_page(cuda_device, null_frac):
    """One page of 2^20 rows: with nulls, each of its 256 tiles sums the
    page's def levels before it."""
    rng = np.random.default_rng(7)
    chunk = _synthetic_chunk(rng, 17, 5000, [(1 << 20, "mixed", null_frac)])
    packed, (words, table, defs, dic) = _packed_on_card(
        chunk, 1 << 20, torch.float64, cuda_device)
    got = CK.chunk_decode(words, table, defs, dic, packed.n_rows, 1 << 20,
                          torch.float64, 0.0)
    want = CK.chunk_decode_plain(words, table, defs, dic, packed.n_rows,
                                 1 << 20, torch.float64, 0.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_chunk_decode_on_card_rejects_bad_input(cuda_device):
    w = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    page = (0, 32, 0, 32, 4, 32, 0, 0)
    d = torch.arange(7, 23, dtype=torch.int32, device=cuda_device)
    before = CK.launches["bitunpack128"]
    with pytest.raises(ValueError):
        CK.chunk_decode(w[::2], page, None, d, 32, 32, torch.int32, 0)
    table = torch.zeros(17, dtype=torch.int32, device=cuda_device)[1:] \
        .view(2, 8)                     # 4 bytes off its allocation
    with pytest.raises(ValueError):
        CK.chunk_decode(w, table, None, d, 32, 32, torch.int32, 0)
    with pytest.raises(ValueError):
        CK.chunk_decode(w, page, None, torch.zeros(4, dtype=torch.int32), 32,
                        32, torch.int32, 0)   # dictionary on the host
    assert CK.launches["bitunpack128"] == before
    v, m = CK.chunk_decode(w, page, None, d, 32, 40, torch.int32, -1)
    assert CK.launches["bitunpack128"] == before + 1
    assert bool(m[:32].all()) and not bool(m[32:].any())
    assert bool((v[:32] == 7).all()) and bool((v[32:] == -1).all())


@pytest.mark.gpu
def test_scan_on_card_equals_cpu(cuda_device, tmp_path):
    """Every lineitem row group of TPC-H SF 0.01 through the device decode
    on the card and on the CPU: equal, one launch per dictionary chunk."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.io import parquet_native as PN
    paths = tpch.generate(0.01, str(tmp_path))
    d = paths["lineitem"]
    for f in sorted(os.listdir(d)):
        path = os.path.join(d, f)
        md = pq.ParquetFile(path).metadata
        for rg in range(md.num_row_groups):
            chunks = 0
            for ci in range(md.num_columns):
                try:
                    PN.read_chunk_pages(path, rg, ci, md=md)
                    chunks += 1
                except NotImplementedError:
                    pass
            CK.reset_launches()
            card = PN.read_row_group_device(path, rg, None, cuda_device)
            torch.cuda.synchronize()
            assert CK.launches["bitunpack128"] == chunks > 0
            cpu = PN.read_row_group_device(path, rg, None, "cpu")
            for a, b in zip(card.columns, cpu.columns):
                assert torch.equal(a.data.cpu(), b.data)
                assert torch.equal(a.validity.cpu(), b.validity)


# -- the redesigned radix kernels ------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cap", [16_384, 1 << 20])
def test_radix_ranks_kernel_at_4096_lanes(cuda_device, cap):
    rng = np.random.default_rng(cap)
    for ids_np in (rng.integers(0, 4096, cap),
                   np.where(np.arange(cap) < cap * 10 // 16,
                            rng.integers(0, 4096, cap), 4096),
                   np.where(rng.random(cap) < 0.9, 17,
                            rng.integers(-1, 4097, cap))):
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(cuda_device)
        before = CK.launches["radix_ranks"]
        ranks, counts = CK.radix_ranks(ids, 4096)
        want_r, want_c = CK.radix_ranks_plain(ids, 4096)
        torch.cuda.synchronize()
        assert CK.launches["radix_ranks"] == before + 1
        assert torch.equal(ranks, want_r) and torch.equal(counts, want_c)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 9, 129, 1000, 4096])
def test_radix_partition_permutation_kernel_is_argsort(cuda_device, lanes):
    for cap in (1, 4095, 4097, 16_384, 1 << 20):
        rng = np.random.default_rng(cap * 7 + lanes)
        ids = torch.from_numpy(rng.integers(0, lanes, cap)
                               .astype(np.int32)).to(cuda_device)
        before = CK.launches["radix_ranks"]
        perm = CK.radix_partition_permutation(ids, lanes)
        want = torch.argsort(ids, stable=True)
        torch.cuda.synchronize()
        assert CK.launches["radix_ranks"] == before + 1
        assert torch.equal(perm, want), (lanes, cap)
        assert torch.equal(
            CK.radix_partition_permutation_plain(ids, lanes), want)


@pytest.mark.gpu
def test_radix_partition_permutation_on_card_rejects_bad_input(cuda_device):
    ids = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    before = CK.launches["radix_ranks"]
    with pytest.raises(ValueError):
        CK.radix_partition_permutation(ids[::2], 4)
    with pytest.raises(ValueError):
        CK.radix_partition_permutation(ids, 0)
    assert CK.launches["radix_ranks"] == before


# -- the sort-based group-by and the TPC-H ladder on the card ----------------

def _segment_columns(rng, cap: int, n: int, kind: str):
    """A key column of ``kind`` and value columns of every type, from a
    seed: nulls, NaN, -0.0 and 0.0, ints across their whole range."""
    from spark_rapids_tpu_torch import types as T
    if kind == "int64":
        keys, kt = rng.integers(-50, 50, cap).astype(np.int64), T.LONG
    elif kind == "float64":
        keys = rng.choice(np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 7.0]),
                          cap)
        kt = T.DOUBLE
    else:
        keys, kt = rng.integers(0, 5, cap).astype(np.int32), T.STRING
    kvalid = (rng.random(cap) >= 0.1) & (np.arange(cap) < n)
    keys[~kvalid] = 0
    floats = rng.normal(0, 100, cap)
    floats[rng.random(cap) < 0.05] = np.nan
    floats[rng.random(cap) < 0.05] = -0.0
    values = [(rng.integers(-2**63, 2**63 - 1, cap, dtype=np.int64,
                            endpoint=True), T.LONG),
              (rng.integers(-2**31, 2**31, cap).astype(np.int32), T.INT),
              (floats, T.DOUBLE), (rng.random(cap) < 0.5, T.BOOLEAN)]
    out = []
    for v, t in values:
        valid = (rng.random(cap) >= 0.15) & (np.arange(cap) < n)
        v = v.copy()
        v[~valid] = 0
        out.append((v, valid, t))
    return (keys, kvalid, kt), out


def _segment_results(key, values, n: int, cap: int, dev,
                     presorted: bool = False):
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import grouping as G

    def col(v, m, t):
        return Col(torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev),
                   t)
    perm, ids, bnd, live = G.group_segments([col(*key)], n, cap,
                                            presorted=presorted)
    ctx = G.segment_structure(ids, cap)
    out = [perm, ids, bnd, live, ctx.seg_start, ctx.seg_end]
    for v, m, t in values:
        c = col(v, m, t)
        out.append(G.segment_count(c.validity, ctx))
        if t.torch_dtype != torch.bool:
            out.extend(G.segment_sum(c.values, c.validity, ctx))
        out.append(G.segment_min(c.values, c.validity, ctx, t))
        out.append(G.segment_max(c.values, c.validity, ctx, t))
        for ign in (False, True):
            out.extend(G.segment_first(c.values, c.validity, ctx, ign))
            out.extend(G.segment_last(c.values, c.validity, ctx, ign))
    return [o.cpu() for o in out]


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int64", "float64", "string"])
@pytest.mark.parametrize("cap", [8, 4096, 1 << 20])
def test_segment_functions_on_card_equal_cpu(cuda_device, cap, kind):
    """Every segment function and the float range-sum tree: the card's
    results equal the CPU's bit for bit, padding rows included."""
    rng = np.random.default_rng([cap, len(kind)])
    for n in (0, cap * 3 // 4, cap):
        key, values = _segment_columns(rng, cap, n, kind)
        card = _segment_results(key, values, n, cap, cuda_device)
        cpu = _segment_results(key, values, n, cap, "cpu")
        for i, (a, b) in enumerate(zip(card, cpu)):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), \
                (n, i)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1 << 17, 1 << 20])
def test_presorted_segments_on_card(cuda_device, cap):
    """Sorted int64 keys with no null: skipping the sort gives the sorted
    result on the card."""
    from spark_rapids_tpu_torch import types as T
    rng = np.random.default_rng(cap)
    n = cap - 5
    keys = np.zeros(cap, np.int64)
    keys[:n] = np.sort(rng.integers(0, cap // 4, n))
    kvalid = np.arange(cap) < n
    _key, values = _segment_columns(rng, cap, n, "int64")
    a = _segment_results((keys, kvalid, T.LONG), values, n, cap,
                         cuda_device)
    b = _segment_results((keys, kvalid, T.LONG), values, n, cap,
                         cuda_device, presorted=True)
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.fixture(scope="module")
def ladder_paths(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from spark_rapids_tpu_torch.benchmarks import tpch
    return tpch.generate(0.1, str(tmp_path_factory.mktemp("tpch_sf0.1")))


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q3", "q18"])
def test_ladder_query_on_card(cuda_device, ladder_paths, q):
    """q3 and q18 at SF 0.1 on the card: the CPU run's rows bit for bit,
    and the NumPy oracle (q18 has 3 rows at SF 0.1)."""
    import datetime
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.session import TorchSession
    card = tpch.QUERIES[q](tpch.load(TorchSession(), ladder_paths)) \
        .collect().to_pylist()
    cpu = tpch.QUERIES[q](tpch.load(TorchSession(device="cpu"),
                                    ladder_paths)).collect().to_pylist()
    assert card == cpu
    exp = getattr(tpch, "np_" + q)(tpch.load_np(ladder_paths))
    assert len(card) == len(exp) == (10 if q == "q3" else 3)
    epoch = datetime.date(1970, 1, 1)
    for g, e in zip(card, exp):
        g = [(v - epoch).days if isinstance(v, datetime.date) else v
             for v in g.values()]
        if q == "q3":
            assert g[:3] == list(e[:3])
            assert g[3] == pytest.approx(e[3], rel=1e-9)
        else:
            assert g[:3] == list(e[:3])
            assert g[3:] == pytest.approx(list(e[3:]), rel=1e-9)


# -- the rank join and the SQL text ------------------------------------------

def _rank_keys(rng, cap: int, n: int, side: str):
    """Key columns (long, string, double) of one join side at ``cap``
    rows, ``n`` live, about 5 % nulls; the sides' dictionaries differ."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.core import Col
    import pyarrow as pa
    live = np.arange(cap) < n
    words = ["w%03d" % i for i in range(0, 300)] if side == "build" else \
        ["w%03d" % i for i in range(100, 400)]
    cols = []
    for kind in ("long", "str", "double"):
        valid = (rng.random(cap) < 0.95) & live
        if kind == "long":
            vals, t, d = rng.integers(0, 1 << 12, cap), T.LONG, None
        elif kind == "str":
            vals = rng.integers(0, len(words), cap).astype(np.int32)
            t, d = T.STRING, pa.array(words, pa.string())
        else:
            vals = rng.choice(np.array([0.0, -0.0, 0.25, np.nan, 7.5]), cap)
            t, d = T.DOUBLE, None
        vals = np.where(valid, vals, np.zeros_like(vals))
        cols.append(Col(torch.from_numpy(vals), torch.from_numpy(valid), t,
                        d))
    return cols


@pytest.mark.gpu
@pytest.mark.parametrize("n_keys", [2, 3])
def test_rank_join_on_card_equals_cpu(cuda_device, n_keys):
    """join_ranks and probe at (2^18 build, 2^20 stream) rows."""
    from spark_rapids_tpu_torch.exec.joins import _align_string_keys
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import joining as J
    rng = np.random.default_rng(n_keys)
    bcap, scap = 1 << 18, 1 << 20
    nb, ns = bcap - 1000, scap - 3
    b = _rank_keys(rng, bcap, nb, "build")[:n_keys]
    st = _rank_keys(rng, scap, ns, "stream")[:n_keys]

    def run(dev):
        bb = [Col(c.values.to(dev), c.validity.to(dev), c.dtype,
                  c.dictionary) for c in b]
        ss = [Col(c.values.to(dev), c.validity.to(dev), c.dtype,
                  c.dictionary) for c in st]
        bb, ss = _align_string_keys(bb, ss)
        rb, rs = J.join_ranks(bb, nb, bcap, ss, ns, scap)
        perm, lo, hi = J.probe(rb, rs)
        counts = J.pair_counts(lo, hi, ns, scap, J.INNER)
        return [t.cpu() for t in (rb, rs, perm, lo, hi, counts)]
    card = run(cuda_device)
    cpu = run(torch.device("cpu"))
    for a, c in zip(card, cpu):
        assert torch.equal(a, c)
    assert int(cpu[-1].sum()) > 0


@pytest.mark.gpu
def test_three_key_join_on_card_equals_cpu(cuda_device, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(3)
    for name, n in (("a", 1 << 20), ("b", 1 << 12)):
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 64, n)),
            "s": pa.array(np.array(["x", "y", "z"])[rng.integers(0, 3, n)]),
            "x": pa.array(rng.choice(np.array([0.0, -0.0, 1.5]), n)),
            name + "_id": pa.array(np.arange(n))}),
            str(tmp_path / f"{name}.parquet"))

    def run(spark):
        a = spark.read_parquet(str(tmp_path / "a.parquet"))
        b = spark.read_parquet(str(tmp_path / "b.parquet"))
        return a.join(b, on=["k", "s", "x"]).collect().to_pylist()
    card = run(TorchSession())
    assert card == run(TorchSession(device="cpu"))
    assert len(card) > 1 << 20


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q1", "q3", "q5"])
def test_sql_query_on_card(cuda_device, ladder_paths, q):
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.exec.joins import HashJoinExec
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.sql.tpch_queries import SQL_QUERIES

    def run(spark):
        tpch.load(spark, ladder_paths)
        plan = spark.sql(SQL_QUERIES[q]).physical_plan()
        return plan, plan.execute_collect().to_pylist()
    plan, card = run(TorchSession())
    _, cpu = run(TorchSession(device="cpu"))
    exp = getattr(tpch, "np_" + q)(tpch.load_np(ladder_paths))
    assert len(card) == len(cpu) == len(exp) > 0
    if q == "q3":
        assert card == cpu
    for g, c in zip(card, cpu):
        for k, v in g.items():
            if isinstance(v, float):
                assert v == pytest.approx(c[k], rel=1e-9)
            else:
                assert v == c[k]
    num = [[v for v in r.values() if isinstance(v, float)] for r in card]
    want = [[v for v in e if isinstance(v, float)] for e in exp]
    for g, e in zip(num, want):
        assert g == pytest.approx(e, rel=1e-6)

    def joins(p):
        own = [p] if isinstance(p, HashJoinExec) else []
        return own + [j for c in p.children for j in joins(c)]
    ranked = [j for j in joins(plan) if j.stats["probe_mode"] == "rank"]
    assert len(ranked) == (1 if q == "q5" else 0)


# -- the native chunk scanner and the arrow reader path ----------------------

def _native_scan_file(tmp_path, codec: str, version: str) -> str:
    """Nulls, a sorted low-cardinality column (RLE pages), short repeats
    (RLE runs between bit-packed runs), strings and doubles in pages of
    4,096 bytes, two row groups."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(17)
    n = 200_000
    k = n // 8
    bursts = np.resize(np.repeat(rng.integers(0, 50, k),
                                 rng.integers(1, 20, k)), n)
    t = pa.table({
        "i32": pa.array(rng.integers(0, 300, n).astype(np.int32),
                        mask=rng.random(n) < 0.1),
        "sorted": pa.array(np.sort(rng.integers(0, 12, n)).astype(np.int32)),
        "bursts": pa.array(bursts.astype(np.int64), mask=rng.random(n) < 0.05),
        "d": pa.array(np.round(rng.uniform(0, 100, n), 1)),
        "s": pa.array(np.array(["x", "yy", "zzz", "a", ""])[
            rng.integers(0, 5, n)], mask=rng.random(n) < 0.3),
    })
    path = str(tmp_path / f"{codec}-{version}.parquet")
    pq.write_table(t, path, compression=codec, data_page_version=version,
                   data_page_size=4096, row_group_size=n // 2)
    return path


@pytest.mark.gpu
@pytest.mark.parametrize("codec,version", [("NONE", "1.0"), ("SNAPPY", "1.0"),
                                           ("ZSTD", "2.0")])
def test_chunk_decode_of_native_packed_chunks(cuda_device, tmp_path, codec,
                                              version):
    """Every chunk the native scanner reads and packs decodes on the card
    bit for bit as on the CPU, one launch each; so does each row group
    through read_row_group_device."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io import parquet_native as PN
    path = _native_scan_file(tmp_path, codec, version)
    md = pq.ParquetFile(path).metadata
    PN.reset_routes()
    for rg in range(md.num_row_groups):
        cap = bucket_capacity(md.row_group(rg).num_rows)
        for ci in range(md.num_columns):
            chunk = PN.read_chunk_pages(path, rg, ci, md=md)
            _st, want, default, dictionary, _sd = PN.chunk_column(chunk, None)
            packed = PN.pack_chunk(chunk, dictionary, cap, pin=True)
            views = PN.chunk_views(packed.buf.to(cuda_device,
                                                 non_blocking=True),
                                   packed, want)
            before = CK.launches["bitunpack128"]
            got = CK.chunk_decode(*views, packed.n_rows, cap, want, default)
            cpu = CK.chunk_decode(*PN.chunk_views(packed.buf, packed, want),
                                  packed.n_rows, cap, want, default)
            torch.cuda.synchronize()
            assert CK.launches["bitunpack128"] == before + 1
            assert torch.equal(got[0].cpu(), cpu[0])
            assert torch.equal(got[1].cpu(), cpu[1])
        CK.reset_launches()
        card = PN.read_row_group_device(path, rg, None, cuda_device)
        torch.cuda.synchronize()
        assert CK.launches["bitunpack128"] == md.num_columns
        host = PN.read_row_group_device(path, rg, None, "cpu")
        for a, b in zip(card.columns, host.columns):
            assert torch.equal(a.data.cpu(), b.data)
            assert torch.equal(a.validity.cpu(), b.validity)
    native = "native_chunk" if codec == "NONE" else "native_pages"
    assert PN.routes[native] == 3 * md.num_row_groups * md.num_columns
    assert PN.routes["python"] == PN.routes["arrow"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["PERFILE", "MULTITHREADED",
                                      "COALESCING"])
def test_arrow_path_on_card_equals_cpu(cuda_device, tmp_path, strategy):
    """The arrow reader path stages each column from pinned memory in one
    copy: the card's batches equal the CPU's, capacity and padding
    included."""
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.io.filescan import (FileScanNode,
                                                    FileSourceScanExec)
    path = _native_scan_file(tmp_path, "SNAPPY", "1.0")
    conf = RapidsConf({"spark.rapids.tpu.sql.parquet.deviceDecode.enabled":
                       "false",
                       "spark.rapids.tpu.sql.format.parquet.reader.type":
                       strategy})

    def batches(device):
        ex = FileSourceScanExec(FileScanNode(path), conf=conf, device=device)
        out = list(ex.execute_partition(0))
        assert ex.stats["device_batches"] == 0 < ex.stats["arrow_batches"]
        return out
    card, cpu = batches(cuda_device), batches("cpu")
    torch.cuda.synchronize()
    assert len(card) == len(cpu)
    for cb, hb in zip(card, cpu):
        assert cb.num_rows == hb.num_rows
        for a, b in zip(cb.columns, hb.columns):
            assert a.data.device.type == "cuda"
            assert torch.equal(a.data.cpu(), b.data)
            assert torch.equal(a.validity.cpu(), b.validity)
            assert (a.dictionary is None) == (b.dictionary is None)
            if a.dictionary is not None:
                assert a.dictionary.equals(b.dictionary)


@pytest.mark.gpu
def test_q1_over_hive_directories_on_card(cuda_device, ladder_paths,
                                          tmp_path):
    """q1 over lineitem rewritten as l_returnflag=A|N|R directories: the
    card's rows equal the CPU run's (keys and counts exact, sums within
    1e-9 relative) and the NumPy oracle's (1e-6 relative)."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.session import TorchSession
    li = pq.read_table(ladder_paths["lineitem"])
    root = str(tmp_path / "lineitem_hive")
    for flag in ("A", "N", "R"):
        d = os.path.join(root, f"l_returnflag={flag}")
        os.makedirs(d)
        pq.write_table(li.filter(pc.equal(li["l_returnflag"], flag))
                       .drop_columns(["l_returnflag"]),
                       os.path.join(d, "part-0000.parquet"))

    def run(spark):
        return tpch.q1({"lineitem": spark.read_parquet(root)}) \
            .collect().to_pylist()
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    exp = tpch.np_q1(tpch.load_np({"lineitem": ladder_paths["lineitem"]}))
    assert len(card) == len(cpu) == len(exp) == 4
    for g, c, e in zip(card, cpu, exp):
        for (k, v), w in zip(g.items(), e):
            if isinstance(v, float):
                assert v == pytest.approx(c[k], rel=1e-9)
                assert v == pytest.approx(w, rel=1e-6)
            else:
                assert v == c[k] == w


# -- the TPC-DS DataFrame queries, decimals and keyless aggregates ------------

@pytest.fixture(scope="module")
def tpcds_paths(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from spark_rapids_tpu_torch.benchmarks import tpcds
    return tpcds.generate(0.012, str(tmp_path_factory.mktemp("tpcds")))


def _tpcds_names():
    from spark_rapids_tpu_torch.benchmarks import tpcds
    return sorted(tpcds.QUERIES)


@pytest.mark.gpu
@pytest.mark.parametrize("q", _tpcds_names())
def test_tpcds_query_on_card(cuda_device, tpcds_paths, q):
    """Each ported TPC-DS query at SF 0.012 on the card: the CPU run's rows
    (keys, counts and decimals exact, float slots within 1e-9 relative:
    the dense aggregate sums doubles in another order on the card) and the
    NumPy oracle's, under check_rows and FLOAT_COLS."""
    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.session import TorchSession

    def run(spark):
        return [tuple(r.values()) for r in tpcds.QUERIES[q](
            tpcds.load(spark, tpcds_paths)).collect().to_pylist()]
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    exp = [tuple(r) for r in tpcds.NP_QUERIES[q](tpcds.load_np(tpcds_paths))]
    assert exp
    tpcds.check_rows(card, cpu, tpcds.FLOAT_COLS[q])
    tpcds.check_rows(card, exp, tpcds.FLOAT_COLS[q])


@pytest.mark.gpu
@pytest.mark.parametrize("p,s", [(7, 2), (18, 4)])
def test_decimal_round_trip_on_card(cuda_device, p, s):
    """arrow → card → arrow for decimals with nulls and negatives: the same
    values back, and the same scaled int64 on the card as on the CPU."""
    from decimal import Decimal
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    rng = np.random.default_rng(p)
    top = 10 ** p - 1
    v = rng.integers(-top, top + 1, 5000, dtype=np.int64)
    arr = pa.array([None if i % 9 == 0 else Decimal(int(x)).scaleb(-s)
                    for i, x in enumerate(v)], pa.decimal128(p, s))
    card = array_to_device(arr, None, 8192, cuda_device)
    cpu = array_to_device(arr, None, 8192, "cpu")
    assert card.data.is_cuda
    assert torch.equal(card.data.cpu(), cpu.data)
    assert torch.equal(card.validity.cpu(), cpu.validity)
    assert card.to_arrow(len(arr)).to_pylist() == arr.to_pylist()


@pytest.mark.gpu
@pytest.mark.parametrize("parts", [1, 4])
def test_keyless_aggregate_on_card(cuda_device, tpcds_paths, parts):
    """df.agg over store_sales (one partition, and one per file) on the
    card: count and the decimal sum exact, the double sum within 1e-12
    relative of the CPU run; and over input a filter empties, one row."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    d = tpcds_paths["store_sales"]
    src = d if parts == 1 else sorted(
        os.path.join(d, f) for f in os.listdir(d) if f.endswith(".parquet"))

    def run(spark, empty):
        df = spark.read_parquet(src)
        if empty:
            df = df.filter(F.col("ss_quantity") > F.lit(1000))
        return df.agg(F.count().alias("n"),
                      F.sum(F.col("ss_net_profit")).alias("profit"),
                      F.avg(F.col("ss_net_paid")).alias("paid"),
                      F.sum(F.col("ss_sales_price")).alias("price")
                      ).collect().to_pylist()
    for empty in (False, True):
        (card,), (cpu,) = run(TorchSession(), empty), run(
            TorchSession(device="cpu"), empty)
        assert card["n"] == cpu["n"] and card["profit"] == cpu["profit"]
        assert card["paid"] == cpu["paid"]
        if empty:
            assert card == {"n": 0, "profit": None, "paid": None,
                            "price": None}
        else:
            assert card["price"] == pytest.approx(cpu["price"], rel=1e-12)


# -- the window exec and the nested-loop join (plain torch ops) ---------------

def _window_exprs():
    """(case name, maker of Alias(WindowExpression) lists) over columns g
    (partition), o (unique int order key), f (double order key with NaN and
    nulls), v (double with nulls), b (bool), s (string) and d (decimal(7,2)
    order key with nulls, its offsets in whole units): every ranking
    and offset function, and sum/count/min/max/avg over every frame kind."""
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr import windows as WX
    from spark_rapids_tpu_torch.expr.aggregates import (Average, Count, Max,
                                                        Min, Sum)
    c = E.col

    def spec(frame=WX.DEFAULT_FRAME, order="o", asc=True, parts=("g",)):
        ob = ((c(order), asc, True),) if order else ()
        return WX.WindowSpec(tuple(c(p) for p in parts), ob, frame)

    def aggs(sp, col="v"):
        return [E.Alias(WX.WindowExpression(f(c(col)), sp), n)
                for f, n in ((Sum, "s"), (Count, "c"), (Min, "mn"),
                             (Max, "mx"), (Average, "av"))]

    def w(f, sp, n):
        return E.Alias(WX.WindowExpression(f, sp), n)
    return [
        ("row_number", lambda: [w(WX.RowNumber(), spec(), "rn")]),
        ("rank_over_ties", lambda: [w(WX.Rank(), spec(order="f"), "rk"),
                                    w(WX.DenseRank(), spec(order="f"),
                                      "dr")]),
        ("lead_lag", lambda: [w(WX.Lead(c("v"), 2), spec(), "ld"),
                              w(WX.Lag(c("o"), 3, default=-1), spec(), "lg"),
                              w(WX.Lead(c("s"), 1), spec(), "ls")]),
        ("rows_to_current", lambda: aggs(spec(WX.WindowFrame("rows", None,
                                                             0)))),
        ("rows_sliding", lambda: aggs(spec(WX.WindowFrame("rows", 3, 2)))),
        ("rows_unbounded_both", lambda: aggs(spec(WX.FULL_FRAME))),
        ("range_to_current", lambda: aggs(spec(order="f"))),
        ("range_bounded_asc", lambda: aggs(spec(WX.WindowFrame("range", 3,
                                                               5)))),
        ("range_bounded_desc", lambda: aggs(spec(WX.WindowFrame("range", 2,
                                                                4),
                                                 asc=False))),
        ("range_float_key", lambda: aggs(spec(WX.WindowFrame("range", 1, 1),
                                              order="f"))),
        ("range_one_sided", lambda: aggs(spec(WX.WindowFrame("range", None,
                                                             4)))),
        ("range_decimal_key", lambda: aggs(spec(WX.WindowFrame("range", 1,
                                                               2),
                                                order="d"))),
        ("no_order_full", lambda: aggs(spec(WX.FULL_FRAME, order=None))),
        ("no_partition", lambda: aggs(spec(WX.WindowFrame("rows", 5, 5),
                                           parts=()))),
        ("bool_string_min_max", lambda: [
            w(Min(c("b")), spec(WX.FULL_FRAME), "bmin"),
            w(Max(c("s")), spec(WX.WindowFrame("rows", 1, 1)), "smax"),
            w(Min(c("s")), spec(), "smin")]),
    ]


def _window_table(n):
    from decimal import Decimal

    import pyarrow as pa
    r = np.random.default_rng(n)
    f = r.integers(0, 40, n).astype(np.float64) / 2
    f[r.random(n) < 0.05] = np.nan
    return pa.table({
        "g": pa.array(r.integers(0, 16, n), pa.int64()),
        "o": pa.array(r.permutation(n).astype(np.int32)),
        "f": pa.array([None if m else x for x, m in
                       zip(f, r.random(n) < 0.05)], pa.float64()),
        "v": pa.array([None if m else x for x, m in
                       zip(r.normal(0, 10, n), r.random(n) < 0.1)],
                      pa.float64()),
        "b": pa.array([None if m else bool(x) for x, m in
                       zip(r.integers(0, 2, n), r.random(n) < 0.1)]),
        "s": pa.array([None if i % 11 == 0 else f"s{i % 37}"
                       for i in range(n)]),
        "d": pa.array([None if m else Decimal(int(x)).scaleb(-2) for x, m in
                       zip(r.integers(0, 4000, n), r.random(n) < 0.05)],
                      pa.decimal128(7, 2)),
    })


def _sorted_rows(tbl):
    import math

    def key(v):
        if v is None:
            return (0, 0)
        if isinstance(v, float) and math.isnan(v):
            return (2, 0)
        return (1, v)
    return sorted((tuple(r.values()) for r in tbl.to_pylist()),
                  key=lambda r: tuple(key(v) for v in r))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[0] for c in _window_exprs()])
def test_window_on_card_equals_cpu(cuda_device, tmp_path, case):
    """The window exec over three files (the hash exchange on the partition
    key) on the card against the same call on the CPU: integers, ranks,
    counts, min/max and lead/lag exact, double sums and averages within
    rel 1e-12 and abs 1e-9 (the card's cumsum adds in another order)."""
    import math
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.session import TorchSession
    t = _window_table(6000)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"w{i}.parquet")
        pq.write_table(t.slice(i * 2000, 2000), p)
        paths.append(p)
    make = dict(_window_exprs())[case]

    def run(spark):
        return _sorted_rows(spark.read_parquet(paths).window(make())
                            .collect())
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    assert len(card) == len(cpu) == 6000
    for a, b in zip(card, cpu):
        for x, y in zip(a, b):
            if isinstance(y, float) and math.isnan(y):
                assert isinstance(x, float) and math.isnan(x), (a, b)
            elif isinstance(y, float) and x is not None:
                assert x == pytest.approx(y, rel=1e-12, abs=1e-9), (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["cross", "inner", "left", "leftsemi",
                                 "leftanti", "full"])
@pytest.mark.parametrize("cond", [False, True])
def test_nested_loop_join_on_card_equals_cpu(cuda_device, tmp_path, how,
                                             cond):
    """Every ported nested-loop join type over a three-file stream and a
    700-row broadcast build, in chunks of 2^20 pairs (1.4M pairs), on the
    card: the CPU run's rows, in order."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    r = np.random.default_rng(len(how) + cond)
    left = pa.table({"a": pa.array([None if m else int(x) for x, m in zip(
        r.integers(0, 1000, 2000), r.random(2000) < 0.05)], pa.int64()),
        "ls": pa.array([f"l{i % 13}" for i in range(2000)])})
    right = pa.table({"b": pa.array(r.normal(500, 300, 700)),
                      "rs": pa.array([None if i % 7 == 0 else f"r{i % 5}"
                                      for i in range(700)])})
    lpaths = []
    for i in range(3):
        p = str(tmp_path / f"l{i}.parquet")
        pq.write_table(left.slice(i * 667, 667), p)
        lpaths.append(p)
    rpath = str(tmp_path / "r.parquet")
    pq.write_table(right, rpath)

    def run(spark):
        c = (F.col("a") > F.col("b") + F.lit(400.0)) if cond else None
        df = spark.read_parquet(lpaths).join(spark.read_parquet(rpath),
                                             how=how, condition=c)
        return [tuple(x.values()) for x in df.collect().to_pylist()]
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    assert card == cpu
    if how in ("cross", "inner") and not cond:
        assert len(card) == 2000 * 700


# -- right and full outer joins, residual conditions, the SQL texts ----------

def _outer_tables(tmp_path, seed):
    """A three-file left stream and a one-file right side, an int key and
    a string key with nulls and duplicates on both."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    r = np.random.default_rng(seed)

    def table(n, prefix):
        return pa.table({
            "k": pa.array([None if m else int(x) for x, m in zip(
                r.integers(0, n // 3, n), r.random(n) < 0.05)], pa.int64()),
            "s": pa.array([None if m else f"v{x}" for x, m in zip(
                r.integers(0, 40, n), r.random(n) < 0.05)]),
            f"{prefix}_x": pa.array(r.normal(size=n))})
    lpaths = []
    left = table(30_000, "l")
    for i in range(3):
        p = str(tmp_path / f"l{i}.parquet")
        pq.write_table(left.slice(i * 10_000, 10_000), p)
        lpaths.append(p)
    rpath = str(tmp_path / "r.parquet")
    pq.write_table(table(6_000, "r"), rpath)
    return lpaths, rpath


@pytest.mark.gpu
@pytest.mark.parametrize("on", ["k", "s", "k,s"])
@pytest.mark.parametrize("how", ["right", "full", "inner_condition"])
def test_outer_hash_join_on_card_equals_cpu(cuda_device, tmp_path, how, on):
    """Right and full outer joins (the full one over a three-partition
    stream, its unmatched build rows emitted once) and an inner join with a
    residual condition, on the card: the CPU run's rows, in order."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    lpaths, rpath = _outer_tables(tmp_path, len(how) * 7 + len(on))
    keys = on.split(",")

    def run(spark):
        cond = (F.col("l_x") < F.col("r_x")
                if how == "inner_condition" else None)
        df = spark.read_parquet(lpaths).join(
            spark.read_parquet(rpath), on=keys,
            how="inner" if how == "inner_condition" else how,
            condition=cond)
        t = df.collect()
        return list(zip(*[c.to_pylist() for c in t.columns]))
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    assert card == cpu and card


@pytest.mark.gpu
def test_matched_build_on_card_equals_cpu(cuda_device):
    from spark_rapids_tpu_torch.ops import joining as J
    r = np.random.default_rng(5)
    cap, n = 1 << 16, 1 << 20
    perm = torch.from_numpy(r.permutation(cap).astype(np.int64))
    lo = torch.from_numpy(r.integers(0, cap + 1, n))
    hi = torch.clamp(lo + torch.from_numpy(r.integers(0, 3, n)), max=cap)
    cpu = J.matched_build(perm, lo, hi, cap)
    card = J.matched_build(perm.to(cuda_device), lo.to(cuda_device),
                           hi.to(cuda_device), cap)
    assert torch.equal(card.cpu(), cpu)


def _sql_ported():
    from spark_rapids_tpu_torch.benchmarks import tpcds
    return list(tpcds.SQL_PORTED)


@pytest.mark.gpu
@pytest.mark.parametrize("q", _sql_ported())
def test_tpcds_sql_text_on_card(cuda_device, tpcds_paths, q):
    """Each of the 27 official texts the port lowers, at SF 0.012 on the
    card: the CPU run's rows and the NumPy oracle's under check_rows (keys,
    counts and decimals exact, float slots within 1e-9 relative)."""
    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.sql.tpcds_queries import SQL_QUERIES
    oracle, float_cols = tpcds.sql_suite_oracles()[q]

    def run(spark):
        tpcds.load(spark, tpcds_paths)
        return [tuple(r.values())
                for r in spark.sql(SQL_QUERIES[q]).collect().to_pylist()]
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    exp = [tuple(r) for r in oracle(tpcds.load_np(tpcds_paths))]
    assert exp
    tpcds.check_rows(card, cpu, float_cols)
    tpcds.check_rows(card, exp, float_cols)
