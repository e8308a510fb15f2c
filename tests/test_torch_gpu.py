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
``matched_build`` at 2^20 stream rows bit for bit the CPU's. The 40
official TPC-DS SQL texts, at SF 0.012 on the card: the CPU run's rows and
the NumPy oracle's under ``check_rows``. A ROLLUP Expand on the card bit
for bit the CPU's batches; UNION ALL, INTERSECT, EXCEPT ALL and a ROLLUP
over a union on the card the CPU run's rows (integer sums, exact). The
ORC stripe decode and the CSV parse on the card: the CPU route's batches
bit for bit (values, validity, dictionaries); each native writer's file
from a card batch byte for byte its file from the same CPU batch; a write
and its read-back through the session on the card: the source's rows.
``RangeExec``'s batches on the card bit for bit the CPU's; a local sort
with the row and partition ids and the aggregates over them, windows over
several specs in the DataFrame and SQL forms, the input-file family over
the parquet device decode, and the repaired round/bround and signed-zero
cast: the CPU run's rows (all exact). Every nested op of
``ops/nested.py`` (gather, concat, a row slice, the explode mapping, the
three ways to make a list column) on the card bit for bit the same call
on the CPU (lengths, validity, flat values and validity); the collects, PivotFirst, explode,
split, the struct/map/array expressions, pivot and the row buffer through
the session on the card: the CPU run's rows (exact). The threefry stream
of ``rand()`` on the card bit for bit the CPU's, and ``F.rand`` through
the session the CPU run's rows; the nested ops over nested elements and
fields (gather, concat, a slice, ``select_rows``, ``equiv``,
``interleave``) bit for bit the CPU's, every tensor on the card; explode,
the collects, ``first``/``last``, the conditionals, equality, the
extractions, ROLLUP and a hash exchange over arrays of structs, arrays of
arrays and structs of arrays: the CPU run's rows; their parquet and ORC
files written on the card: the source's rows (all exact). A probe
chain of a dense and a hash hop under a hoisted filter and projection on
the card: the CPU run's rows and the unchained route's, in order, bit for
bit, with one ``hash_join_probe`` a stream batch; q1 on the card with
each chunk decoded at its first read bit for bit every chunk decoded at
the scan, one decode a vector; a pushed
filter's residual over NaN, -0.0 and 0.0 on the card: the CPU run's rows.
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
            # a probe chain's hops are its joins
            own = ([p] if isinstance(p, HashJoinExec) else
                   list(getattr(p, "hops", [])))
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
            cpu = PN.read_row_group_device(path, rg, None, "cpu")
            # a chunk decodes at its column's first read
            for a, b in zip(card.columns, cpu.columns):
                assert torch.equal(a.data.cpu(), b.data)
                assert torch.equal(a.validity.cpu(), b.validity)
            torch.cuda.synchronize()
            assert CK.launches["bitunpack128"] == chunks > 0


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
        host = PN.read_row_group_device(path, rg, None, "cpu")
        # a chunk decodes at its column's first read
        for a, b in zip(card.columns, host.columns):
            assert torch.equal(a.data.cpu(), b.data)
            assert torch.equal(a.validity.cpu(), b.validity)
        torch.cuda.synchronize()
        assert CK.launches["bitunpack128"] == md.num_columns
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
    """Each of the 40 official texts, at SF 0.012 on the
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


def _rollup_table(seed, n):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    miss = rng.random(n) < 0.1
    return pa.table({
        "g": pa.array([None if m else f"g{v}" for v, m in
                       zip(rng.integers(0, 4, n), miss)], pa.string()),
        "h": pa.array(rng.integers(0, 5, n), pa.int64()),
        "x": pa.array(rng.integers(0, 100, n), pa.int64()),
    })


def _write_parts(tmp_path, name, tables):
    import pyarrow.parquet as pq
    paths = []
    for i, t in enumerate(tables):
        p = str(tmp_path / f"{name}{i}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    return paths


@pytest.mark.gpu
def test_expand_exec_on_card_equals_cpu(cuda_device, tmp_path):
    """A ROLLUP Expand (three projections, string and int keys with NULLs)
    on the card: every batch's values, validity and dictionaries bit for
    bit the CPU run's."""
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.plan import nodes as NN
    from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
    from spark_rapids_tpu_torch.session import TorchSession
    paths = _write_parts(tmp_path, "t", [_rollup_table(1, 5000),
                                         _rollup_table(2, 77)])

    def run(spark):
        plan = spark.read_parquet(paths)._plan
        keys = [E.BoundReference(0, plan.output[0].data_type, True, "g"),
                E.BoundReference(1, plan.output[1].data_type, True, "h")]
        ex = TorchOverrides(spark.conf, spark.device).apply(
            NN.build_rollup_expand(plan, keys)[0])
        return [b for split in range(ex.num_partitions)
                for b in ex.execute_partition(split)]
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    assert len(card) == len(cpu) == 2
    for bc, bh in zip(card, cpu):
        assert bc.num_rows == bh.num_rows and bc.capacity == bh.capacity
        for cc, ch in zip(bc.columns, bh.columns):
            assert cc.data.is_cuda
            assert torch.equal(cc.data.cpu(), ch.data)
            assert torch.equal(cc.validity.cpu(), ch.validity)
            assert (cc.dictionary is None) == (ch.dictionary is None)
            if ch.dictionary is not None:
                assert cc.dictionary.equals(ch.dictionary)


@pytest.mark.gpu
def test_union_and_set_operations_on_card_equal_cpu(cuda_device, tmp_path):
    """UNION ALL of two tables (their string dictionaries differ), and the
    set operations over them (INTERSECT, EXCEPT ALL) and a ROLLUP over the
    union (PARTIAL → exchange → FINAL on the card): the CPU run's rows,
    sorted (integer sums exact)."""
    from spark_rapids_tpu_torch.session import TorchSession
    a = _write_parts(tmp_path, "a", [_rollup_table(3, 3000),
                                     _rollup_table(4, 900)])
    b = _write_parts(tmp_path, "b", [_rollup_table(5, 2000)])
    texts = [
        "select g, h from a union all select g, h from b",
        "select g, h from a intersect select g, h from b",
        "select g, h from a except all select g, h from b",
        "select g, h, sum(x) s, count(*) n from (select * from a union all "
        "select * from b) u group by rollup(g, h)",
    ]

    def run(spark):
        spark.create_or_replace_temp_view("a", spark.read_parquet(a))
        spark.create_or_replace_temp_view("b", spark.read_parquet(b))
        return [sorted(map(str, spark.sql(t).collect().to_pylist()))
                for t in texts]
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    for c, h in zip(card, cpu):
        assert c == h and c


def _io_table(n: int, seed: int):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    words = np.zeros((n, 2), np.int64)
    words[:, 0] = rng.integers(-10**6, 10**6, n)
    words[:, 1] = words[:, 0] >> 63
    nulls = rng.random(n) < 0.1
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "l": pa.array(rng.integers(-2**62, 2**62, n)),
        # two decimals, as money: the CSV device parse reads them exactly
        "d": pa.array(np.round(rng.normal(0, 1e4, n), 2),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(["apple", "b,c", "zz", "ä€"], n),
                      mask=rng.random(n) < 0.1),
        "dt": pa.array(rng.integers(-5000, 30000, n).astype(np.int32),
                       mask=rng.random(n) < 0.1).cast(pa.date32()),
        "m": pa.Array.from_buffers(
            pa.decimal128(7, 2), n,
            [pa.py_buffer(np.packbits(~nulls, bitorder="little").tobytes()),
             pa.py_buffer(words.tobytes())]),
    })


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["uncompressed", "zlib", "snappy"])
def test_orc_device_decode_on_card_equals_cpu(cuda_device, tmp_path, codec):
    """The ORC stripe decode (RLEv2 unpack, zigzag, null spread, both string
    encodings) on the card: the CPU route's batches bit for bit."""
    import pyarrow.orc as orc
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import orc_native as ON
    t = _io_table(40_000, 1)
    t = t.append_column("w", __import__("pyarrow").array(
        np.random.default_rng(2).integers(-2**62, 2**62, t.num_rows)))
    p = str(tmp_path / "t.orc")
    orc.write_table(t, p, compression=codec, stripe_size=256 * 1024,
                    dictionary_key_size_threshold=1.0 if codec == "zlib"
                    else 0.0)
    schema = T.StructType.from_arrow(t.schema)
    meta = ON.read_meta(p)
    assert len(meta.stripes) > 1
    for si in range(len(meta.stripes)):
        card = ON.read_stripe_device(p, meta, si, schema, cuda_device)
        cpu = ON.read_stripe_device(p, meta, si, schema, "cpu")
        for cc, ch in zip(card.columns, cpu.columns):
            assert cc.data.is_cuda
            assert torch.equal(cc.data.cpu(), ch.data)
            assert torch.equal(cc.validity.cpu(), ch.validity)
            if ch.dictionary is not None:
                assert cc.dictionary.equals(ch.dictionary)


@pytest.mark.gpu
def test_csv_parse_on_card_equals_cpu(cuda_device, tmp_path):
    """The CSV field parse (int32, int64, double) on the card: the CPU
    route's values and validity bit for bit, malformed fields included."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import csv_native as CN
    rng = np.random.default_rng(3)
    n = 50_000
    bad = np.array(["", "x1", "-", "1.2.3", "+5", "--1", "7."])
    rows = ["a,b,c"]
    for k in range(n):
        a = str(rng.integers(-2**31, 2**31)) if rng.random() < 0.9 else \
            rng.choice(bad)
        b = str(rng.integers(-2**63, 2**63 - 1, dtype=np.int64))
        c = f"{rng.uniform(-1e6, 1e6):.{int(rng.integers(0, 9))}f}" \
            if rng.random() < 0.95 else rng.choice(bad)
        rows.append(f"{a},{b},{c}")
    p = tmp_path / "t.csv"
    p.write_text("\n".join(rows) + "\n")
    schema = T.StructType([T.StructField("a", T.INT),
                           T.StructField("b", T.LONG),
                           T.StructField("c", T.DOUBLE)])
    shape = CN.try_scan_for_device(str(p), schema, ",", True, True)
    assert shape is not None
    card = CN.decode_shape_device(shape, schema, cuda_device)
    cpu = CN.decode_shape_device(shape, schema, "cpu")
    for cc, ch in zip(card.columns, cpu.columns):
        assert cc.data.is_cuda
        assert torch.equal(cc.validity.cpu(), ch.validity)
        got, want = cc.data.cpu(), ch.data
        if got.dtype == torch.float64:
            got, want = got.view(torch.int64), want.view(torch.int64)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,codec", [("parquet", "snappy"),
                                       ("parquet", "gzip"), ("orc", "zlib"),
                                       ("orc", "snappy"), ("csv", None)])
def test_writer_prep_on_card_equals_cpu(cuda_device, tmp_path, fmt, codec):
    """The writers' device prep (null compaction, null count, min/max, one
    copy a column) on the card: each native writer's file from a card batch
    is byte for byte its file from the same CPU batch."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import table_to_device
    from spark_rapids_tpu_torch.io import csv_write_native as CW
    from spark_rapids_tpu_torch.io import orc_write_native as OW
    from spark_rapids_tpu_torch.io import parquet_write_native as PW
    t = _io_table(30_000, 4)
    schema = T.StructType.from_arrow(t.schema)
    mod = {"parquet": PW, "orc": OW, "csv": CW}[fmt]
    out = []
    for dev in (cuda_device, "cpu"):
        b = table_to_device(t, dev, schema=schema)
        p = str(tmp_path / f"{dev}.{fmt}")
        args = (p, b, schema) if codec is None else (p, b, schema, codec)
        mod.write_batch_file(*args)
        out.append(open(p, "rb").read())
    assert out[0] == out[1]


@pytest.mark.gpu
def test_read_write_round_trip_on_card(cuda_device, tmp_path):
    """A write through the session on the card and its read-back on every
    route: the source's rows."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import csv_native as CN
    from spark_rapids_tpu_torch.io import orc_native as ON
    from spark_rapids_tpu_torch.session import TorchSession
    t = _io_table(20_000, 5)
    src = str(tmp_path / "src.parquet")
    pq.write_table(t, src)
    spark = TorchSession({"spark.rapids.tpu.sql.csv.read.float.enabled":
                          "true"})
    df = spark.read_parquet(src)
    for fmt in ("parquet", "orc", "csv"):
        out = str(tmp_path / fmt)
        st = (df.write_csv(out) if fmt == "csv"
              else getattr(df, f"write_{fmt}")(out))
        assert st.num_rows == t.num_rows
        ON.reset_routes()
        CN.reset_routes()
        if fmt == "parquet":
            back = spark.read_parquet(out).collect()
        elif fmt == "orc":
            back = spark.read_orc(out).collect()
            # DATE, DECIMAL and BOOLEAN columns through arrow
            assert ON.routes == {"device_columns": 4, "arrow_columns": 3,
                                 "arrow_files": 0}
        else:
            back = spark.read_csv(out, schema=T.StructType.from_arrow(
                t.schema)).collect()
            assert CN.routes == {"device_files": 0, "arrow_files": 1}
        assert back.equals(t), fmt
    # the numeric columns of the CSV file take the device parse
    num = T.StructType([T.StructField("i", T.INT), T.StructField("l", T.LONG),
                        T.StructField("d", T.DOUBLE)])
    CN.reset_routes()
    back = spark.read_csv(str(tmp_path / "csv"), schema=num).collect()
    assert CN.routes == {"device_files": 1, "arrow_files": 0}
    assert back.equals(t.select(["i", "l", "d"]))


# -- the expression slice: narrow and float chunks, hash() of strings --------

@pytest.mark.gpu
@pytest.mark.parametrize("arrow_type,width", [("int8", 1), ("int16", 2),
                                              ("float32", 4)])
def test_sweep_chunk_decode_widths_match_plain(cuda_device, tmp_path,
                                               arrow_type, width):
    """``chunk_decode`` on pyarrow-written tinyint, smallint and float
    chunks (the sweep's value widths 1, 2 and 4-float) against its plain
    version, bit for bit, values and validity."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import parquet_native as PN
    rng = np.random.default_rng(width)
    n = 200_000
    vals = (rng.integers(0, 11, n) / 100).astype(np.float32) \
        if arrow_type == "float32" else rng.integers(
            -100 if width == 1 else -30_000, 100 if width == 1 else 30_000,
            n).astype(arrow_type)
    p = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"c": pa.array(vals, mask=rng.random(n) < 0.1)}),
                   p)
    st = T.from_arrow_type(getattr(pa, arrow_type)())
    pages = PN.read_chunk_pages(p, 0, 0)
    cap = bucket_capacity(pages.num_values)
    before = CK.launches["bitunpack128"]
    got = PN.chunk_to_device(pages, st, cap, cuda_device)
    want = PN.chunk_to_device(pages, st, cap, "cpu")
    assert CK.launches["bitunpack128"] == before     # decoded at first read
    assert got.decode()
    torch.cuda.synchronize()
    assert CK.launches["bitunpack128"] == before + 1
    assert got.data.dtype == st.torch_dtype and got.data.element_size() \
        == width
    assert torch.equal(got.data.cpu(), want.data)
    assert torch.equal(got.validity.cpu(), want.validity)


def _np_murmur3():
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_hash_of_strings_matches_numpy_murmur3(cuda_device):
    """Spark's hash() of a string column and an int column on the card
    (the murmur3_words kernel under Murmur3Hash) against a numpy Murmur3
    written from Spark's Murmur3_x86_32, bit for bit."""
    import pyarrow as pa
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    cs = _np_murmur3()
    rng = np.random.default_rng(42)
    words = ["", "a", "ab", "abc", "abcd", "déjà vu", "x" * 37,
             "Customer#000012345", "日本語テキスト"]
    s = [None if rng.random() < 0.1 else words[k]
         for k in rng.integers(0, len(words), 5000)]
    i = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    t = pa.table({"s": pa.array(s, pa.string()), "i": pa.array(i)})
    before = CK.launches["murmur3_words"]
    got = TorchSession().create_dataframe(t).select(
        F.hash("s", "i").alias("h")).collect().column("h").to_numpy()
    assert CK.launches["murmur3_words"] > before
    h = np.full(len(s), 42, np.uint64)
    hs = cs.np_murmur3_bytes([x or "" for x in s], 42)
    valid = np.array([x is not None for x in s])
    h = np.where(valid, hs, h)
    h = cs.np_murmur3_int(i, h)
    np.testing.assert_array_equal(got, cs._signed32(h))


# -- the DataFrame API's remainder, several window specs, context ------------

@pytest.mark.gpu
@pytest.mark.parametrize("args,slices", [((0, 3_000_000, 1), 3),
                                         ((10, -7, -3), 2), ((5, 5), 2),
                                         ((0, 3), 5)])
def test_range_exec_on_card_equals_cpu(cuda_device, args, slices):
    """``RangeExec``'s batches on the card: the CPU's bit for bit (values,
    validity, the zero padding, row counts and capacities)."""
    from spark_rapids_tpu_torch.exec.basic import RangeExec
    card = RangeExec(*args, num_slices=slices, device=cuda_device)
    cpu = RangeExec(*args, num_slices=slices, device="cpu")
    for split in range(slices):
        cbs = list(card.execute_partition(split))
        pbs = list(cpu.execute_partition(split))
        assert len(cbs) == len(pbs)
        for cb, pb in zip(cbs, pbs):
            assert (cb.num_rows, cb.capacity) == (pb.num_rows, pb.capacity)
            assert cb.columns[0].data.is_cuda
            assert torch.equal(cb.columns[0].data.cpu(), pb.columns[0].data)
            assert torch.equal(cb.columns[0].validity.cpu(),
                               pb.columns[0].validity)


def _dfapi_table(n=20_000, seed=16):
    import pyarrow as pa
    r = np.random.default_rng(seed)
    k = [None if m else int(v) for v, m in zip(r.integers(0, 50, n),
                                               r.random(n) < 0.05)]
    return pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                     "k": pa.array(k, pa.int64()),
                     "g": pa.array([f"g{v}" for v in r.integers(0, 7, n)]),
                     "v": pa.array(r.integers(-1000, 1000, n)),
                     "x": pa.array(np.round(r.normal(0, 100, n), 2))})


@pytest.mark.gpu
def test_local_sort_and_context_on_card_equal_cpu(cuda_device):
    """``sort_within_partitions`` over four partitions, then the partition
    and row ids, and the keyless aggregates over them: the CPU run's rows,
    in order."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession

    def run(spark):
        df = spark.range(0, 1 << 20, num_slices=4).sort_within_partitions(
            F.col("id") % 1000, "id", ascending=[False, True]).with_column(
            "m", F.monotonically_increasing_id()).with_column(
            "p", F.spark_partition_id())
        sample = df.filter(F.col("id") % 9973 == 0).collect()
        aggs = df.agg(F.max("m").alias("mx"), F.sum("m").alias("sm"),
                      F.sum("p").alias("sp")).collect()
        counts = df.with_column("k", F.col("id") % 4096).group_by(
            "k").count().order_by("k").collect()
        return sample, aggs, counts, df.count()
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    for a, b in zip(card[:3], cpu[:3]):
        assert a.equals(b)
    assert card[3] == cpu[3] == 1 << 20
    assert card[1].column("mx")[0].as_py() == (3 << 33) + (1 << 18) - 1


@pytest.mark.gpu
def test_chained_window_execs_on_card_equal_cpu(cuda_device, tmp_path):
    """Four specs over three files, in the DataFrame and the SQL form: the
    card's rows are the CPU's, in order (integers exact)."""
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    t = _dfapi_table()
    paths = []
    for i in range(3):
        p = str(tmp_path / f"w{i}.parquet")
        pq.write_table(t.slice(i * 7000, 7000), p)
        paths.append(p)
    text = ("select id, k, g, v, "
            "row_number() over (partition by k order by id) rn, "
            "lag(v) over (partition by k order by id) lg, "
            "rank() over (partition by g order by v desc) rk, "
            "sum(v) over (partition by id % 100) s, "
            "dense_rank() over (order by k) dr from t")

    def run(spark):
        df = spark.read_parquet(paths)
        w = df.window([
            F.alias(F.over(F.row_number(), ["k"], ["id"]), "rn"),
            F.alias(F.over(F.lag("v"), ["k"], ["id"]), "lg"),
            F.alias(F.over(F.rank(), ["g"], [("v", False, False)]), "rk"),
            F.alias(F.over(F.sum("v"), [F.col("id") % 100]), "s"),
            F.alias(F.over(F.dense_rank(), [], ["k"]), "dr")]).drop("x")
        spark.create_or_replace_temp_view("t", df)
        return (sorted(tuple(r.values()) for r in w.collect().to_pylist()),
                sorted(tuple(r.values())
                       for r in spark.sql(text).collect().to_pylist()))
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    assert card == cpu
    assert card[0] == card[1]


@pytest.mark.gpu
def test_input_files_on_card_equal_cpu(cuda_device, tmp_path):
    """The input-file family and the partition/row ids over the parquet
    device decode on the card: the CPU run's rows; ``""`` and -1 after a
    repartition."""
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    t = _dfapi_table()
    paths = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(t.slice(i * 7000, 7000), p, row_group_size=3000)
        paths.append(p)

    def run(spark):
        df = spark.read_parquet(paths)
        cols = df.select(F.input_file_name().alias("f"),
                         F.input_file_block_start().alias("s"),
                         F.input_file_block_length().alias("l"),
                         F.spark_partition_id().alias("p"),
                         F.monotonically_increasing_id().alias("m"),
                         "id").collect()
        files = df.group_by(F.input_file_name().alias("f")).count() \
            .order_by("f").collect()
        after = df.repartition(2).group_by(
            F.input_file_name().alias("f")).count().collect()
        return cols, files, after
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    for a, b in zip(card, cpu):
        assert a.equals(b)
    assert card[1].column("count").to_pylist() == [7000, 7000, 6000]
    assert card[2].to_pylist() == [{"f": "", "count": 20_000}]


@pytest.mark.gpu
def test_round_and_signed_zero_cast_on_card(cuda_device):
    """The repaired round/bround (large doubles, decimals at Spark's type)
    and the cast of -0.0 and 0.0 to string on the card: the CPU's."""
    from decimal import Decimal as D

    import pyarrow as pa
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.session import TorchSession
    t = pa.table({"d": pa.array([1e300, -1e27, 0.0, -0.0, 2.5, 1.005, None,
                                 123456789012.5]),
                  "m": pa.array([D("1.25"), D("99999.99"), D("-2.35"), None,
                                 D("0.05"), D("7.00"), D("1.00"),
                                 D("-0.50")], pa.decimal128(7, 2))})

    def run(spark):
        return spark.create_dataframe(t, 2).select(
            F.round("d", 1).alias("r1"), F.round("d", -2).alias("r2"),
            F.bround("d", 2).alias("b2"), F.round("m", 1).alias("m1"),
            F.bround("m", -1).alias("m2"),
            F.col("d").cast(T.STRING).alias("s")).collect()
    card, cpu = run(TorchSession()), run(TorchSession(device="cpu"))
    assert card.equals(cpu)
    assert card.column("s").to_pylist()[2:4] == ["0.0", "-0.0"]
    assert card.column("r1").to_pylist()[:2] == [1e300, -1e27]
    assert card.schema.field("m1").type == pa.decimal128(7, 1)
    assert card.column("m1").to_pylist()[:2] == [D("1.3"), D("100000.0")]


# -- nested columns (plain torch ops) -----------------------------------------

def _nested_table(seed: int, n: int):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "", "déjà vu", "x y"]

    def lst(pool):
        r = rng.random()
        if r < 0.1:
            return None
        if r < 0.2:
            return []
        return [None if rng.random() < 0.1 else pool()
                for _ in range(int(rng.integers(1, 5)))]
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n), pa.int64()),
        "i": pa.array([None if rng.random() < 0.1 else int(x)
                       for x in rng.integers(-5, 40, n)], pa.int64()),
        "s": pa.array([None if rng.random() < 0.1 else words[int(x)]
                       for x in rng.integers(0, 6, n)]),
        "w": pa.array([None if rng.random() < 0.1 else " ".join(
            words[int(x)] for x in rng.integers(0, 6, 3)) for _ in range(n)]),
        "a": pa.array([lst(lambda: int(rng.integers(0, 9)))
                       for _ in range(n)], pa.list_(pa.int64())),
        "b": pa.array([lst(lambda: words[int(rng.integers(0, 6))])
                       for _ in range(n)], pa.list_(pa.string())),
    })


def _same_vec(a, b):
    """Two nested (or flat) vectors, one on the card, bit for bit."""
    assert type(a) is type(b)
    assert torch.equal(a.data.cpu(), b.data.cpu())
    assert torch.equal(a.validity.cpu(), b.validity.cpu())
    for name in ("flat", "values"):
        if hasattr(a, name):
            _same_vec(getattr(a, name), getattr(b, name))
    for fa, fb in zip(getattr(a, "fields", ()), getattr(b, "fields", ())):
        _same_vec(fa, fb)
    if getattr(a, "dictionary", None) is not None:
        assert a.dictionary.equals(b.dictionary)


@pytest.mark.gpu
def test_nested_ops_on_card_equal_cpu(cuda_device):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import nested as N
    t = _nested_table(7, 5000)
    cap = bucket_capacity(t.num_rows)
    rng = np.random.default_rng(8)
    idx = torch.from_numpy(rng.integers(0, t.num_rows, cap))
    live = torch.from_numpy(rng.random(cap) < 0.8)
    for name, dt in (("a", T.ArrayType(T.LONG)),
                     ("b", T.ArrayType(T.STRING))):
        on = {d: array_to_device(t.column(name), dt, cap, d)
              for d in ("cpu", cuda_device)}
        outs = {d: N.gather(v, idx.to(v.data.device),
                            live.to(v.data.device)) for d, v in on.items()}
        _same_vec(outs[cuda_device], outs["cpu"])
        cat = {d: N.concat([v, outs[d]], [t.num_rows, 3000], 1 << 14)
               for d, v in on.items()}
        _same_vec(cat[cuda_device], cat["cpu"])
        sl = {d: N.take_rows(v, 100, 900, 1024) for d, v in on.items()}
        _same_vec(sl[cuda_device], sl["cpu"])
        for outer in (False, True):
            m = {d: N.explode_mapping(v.data, t.num_rows, outer)
                 for d, v in on.items()}
            for x, y in zip(m[cuda_device], m["cpu"]):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x.cpu(), y)
                else:
                    assert x == y
    vals = Col.from_vector(array_to_device(t.column("i"), T.LONG, cap, "cpu"))
    rows = torch.from_numpy(np.sort(rng.integers(0, 64, t.num_rows)))
    for dedupe in (False, True):
        b = {d: N.from_tagged_elements(
            Col(vals.values.to(d), vals.validity.to(d), T.LONG),
            rows.to(d), t.num_rows, 64, T.ArrayType(T.LONG), dedupe)
            for d in ("cpu", cuda_device)}
        _same_vec(b[cuda_device], b["cpu"])
    cols = {d: [Col.from_vector(array_to_device(t.column(c), T.LONG, cap, d))
                for c in ("k", "i")] for d in ("cpu", cuda_device)}
    fc = {d: N.from_columns(T.ArrayType(T.LONG), c, t.num_rows, cap)
          for d, c in cols.items()}
    _same_vec(fc[cuda_device], fc["cpu"])
    mp = {d: N.from_columns(T.MapType(T.LONG, T.LONG), c[:1], t.num_rows,
                            cap, values=c[1:]) for d, c in cols.items()}
    _same_vec(mp[cuda_device], mp["cpu"])
    s = {d: Col.from_vector(array_to_device(t.column("w"), T.STRING, cap, d))
         for d in ("cpu", cuda_device)}
    lists = [e.split(" ") for e in s["cpu"].dictionary.to_pylist()]
    sp = {d: N.from_dictionary(c, lists, t.num_rows, T.ArrayType(T.STRING))
          for d, c in s.items()}
    _same_vec(sp[cuda_device], sp["cpu"])


NESTED_JOBS = {
    "collect": lambda df, F, E: df.group_by("k").agg(
        F.collect_list("i").alias("l"), F.collect_set("s").alias("st"),
        F.count().alias("n")).sort("k"),
    "pivot-first": lambda df, F, E: df.group_by("k").agg(E.Alias(
        __import__("spark_rapids_tpu_torch.expr.aggregates", fromlist=["x"])
        .PivotFirst(E.col("i"), E.col("s"), ["alpha", "beta"]), "pf")
    ).sort("k"),
    "explode": lambda df, F, E: df.explode("a", outer=True, pos=True),
    "explode-str": lambda df, F, E: df.explode("b"),
    "split": lambda df, F, E: df.select(
        "k", F.split("w", " ").alias("ws"),
        F.size(F.split("w", " ")).alias("n"),
        F.element_at0(F.split("w", " "), 1).alias("w1")),
    "struct-map-array": lambda df, F, E: df.select(
        F.struct("p", "i", "q", "s").alias("st"),
        F.create_map(E.lit("x"), E.col("i")).alias("m"),
        F.array("k", "i").alias("ar"), F.size("a").alias("na"),
        F.element_at("b", -1).alias("lb"),
        F.array_contains("a", 3).alias("c3")),
    "repartition": lambda df, F, E: df.repartition(3, "k").sort(
        "k", "i", "s", "w"),
    "pivot": lambda df, F, E: df.group_by("s").pivot(
        "k", [1, 2, 3]).agg(F.sum("i"), F.count()).sort("s"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("job", sorted(NESTED_JOBS))
def test_nested_jobs_on_card_equal_cpu(cuda_device, job):
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.session import TorchSession
    t = _nested_table(11, 3000)
    out = [NESTED_JOBS[job](TorchSession(device=d).create_dataframe(t, 3),
                            F, E).collect()
           for d in ("cpu", "cuda")]
    assert out[0].to_pylist() == out[1].to_pylist()


@pytest.mark.gpu
def test_row_buffer_on_card_equals_cpu(cuda_device):
    from spark_rapids_tpu_torch.session import TorchSession
    t = _nested_table(13, 2000).select(["k", "i", "s"])
    res = []
    for d in ("cpu", "cuda"):
        spark = TorchSession(device=d)
        (w, off), schema = spark.create_dataframe(t, 2).collect_row_buffer()
        res.append((w, off, spark.create_dataframe_from_rows(
            (w, off), schema).collect()))
    assert np.array_equal(res[0][0], res[1][0])
    assert np.array_equal(res[0][1], res[1][1])
    assert res[0][2].equals(res[1][2]) and res[1][2].equals(t)


def deep_nested_table(seed: int, n: int, maps: bool = True):
    """Nested elements and fields: ``as_`` (array<struct<x, y, z>>),
    ``aa`` (array<array<bigint>>), ``sa`` (struct<f: array<bigint>, g,
    h: struct<u: string>>), ``ss`` (array<array<string>>) and, with
    ``maps``, ``ms`` (map<string, array<bigint>>); ``as2``, ``aa2`` and
    ``sa2`` equal their twin in about half the rows. Null rows, empty
    lists, null elements and null fields throughout; ``k`` a small key and
    ``i`` an int with nulls. No NaN (Python's list equality would not
    hold NaN equal in the comparisons)."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "", "déjà vu", "x y"]

    def maybe(f, p=0.1):
        return None if rng.random() < p else f()

    def lst(f, hi=4):
        r = rng.random()
        if r < 0.1:
            return None
        if r < 0.2:
            return []
        return [f() for _ in range(int(rng.integers(1, hi)))]

    def st():
        return maybe(lambda: {
            "x": maybe(lambda: int(rng.integers(0, 6))),
            "y": maybe(lambda: words[int(rng.integers(0, 5))]),
            "z": maybe(lambda: float(rng.choice([0.5, -0.0, 0.0, 2.25])))})

    def ints():
        return maybe(lambda: lst(lambda: maybe(
            lambda: int(rng.integers(0, 5)))))

    def strs():
        return maybe(lambda: lst(lambda: maybe(
            lambda: words[int(rng.integers(0, 5))])))

    def sa():
        return maybe(lambda: {"f": ints(), "g": maybe(
            lambda: int(rng.integers(0, 9))), "h": maybe(
            lambda: {"u": maybe(lambda: words[int(rng.integers(0, 5))])})})
    make = {"as_": lambda: lst(st), "aa": lambda: lst(ints),
            "sa": sa, "ss": lambda: lst(strs)}
    cols = {k: [f() for _ in range(n)] for k, f in make.items()}
    for k in ("as_", "aa", "sa"):
        cols[k.rstrip("_") + "2"] = [v if rng.random() < 0.5 else make[k]()
                                     for v in cols[k]]
    st_t = pa.struct([("x", pa.int64()), ("y", pa.string()),
                      ("z", pa.float64())])
    types = {"as_": pa.list_(st_t), "as2": pa.list_(st_t),
             "aa": pa.list_(pa.list_(pa.int64())),
             "aa2": pa.list_(pa.list_(pa.int64())),
             "sa": pa.struct([("f", pa.list_(pa.int64())),
                              ("g", pa.int64()),
                              ("h", pa.struct([("u", pa.string())]))]),
             "ss": pa.list_(pa.list_(pa.string()))}
    types["sa2"] = types["sa"]
    out = {"k": pa.array(rng.integers(0, 6, n), pa.int64()),
           "i": pa.array([maybe(lambda: int(rng.integers(-3, 20)))
                          for _ in range(n)], pa.int64())}
    out.update({k: pa.array(cols[k], types[k]) for k in types})
    if maps:
        out["ms"] = pa.array([maybe(lambda: [
            (w, ints()) for w in sorted(set(
                words[int(rng.integers(0, 5))]
                for _ in range(int(rng.integers(0, 3)))))])
            for _ in range(n)], pa.map_(pa.string(), pa.list_(pa.int64())))
    return pa.table(out)


@pytest.mark.gpu
def test_rand_on_card_equals_cpu(cuda_device):
    """The threefry stream on the card bit for bit the CPU's, and
    ``F.rand`` through the session (two partitions, a filter and an
    aggregate above a projection) the CPU run's rows."""
    import pyarrow as pa
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.ops import random as R
    from spark_rapids_tpu_torch.session import TorchSession
    for seed in (0, 42, -3):
        key = R.fold_in(R.prng_key(seed), 777)
        on = R.uniform(key, 1 << 20, cuda_device)
        assert on.device.type == "cuda"
        assert torch.equal(on.cpu().view(torch.int64),
                           R.uniform(key, 1 << 20, "cpu").view(torch.int64))
    rng = np.random.default_rng(4)
    t = pa.table({"k": pa.array(rng.integers(0, 5, 5000), pa.int64())})
    outs = []
    for d in ("cpu", "cuda"):
        df = TorchSession(device=d).create_dataframe(t, 2)
        outs.append((df.select("k", F.rand(7).alias("r")).collect(),
                     df.filter(F.rand(3) < 0.2).collect(),
                     df.select("k", F.rand(1).alias("r")).group_by("k").agg(
                         F.count().alias("n")).order_by("k").collect()))
    for a, b in zip(*outs):
        assert a.equals(b)


@pytest.mark.gpu
def test_deep_nested_ops_on_card_equal_cpu(cuda_device):
    """``ops/nested.py`` over nested elements and fields on the card bit
    for bit the CPU: gather, concat, a row slice, ``select_rows``,
    ``equiv``, ``interleave``; every tensor stays on the card."""
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import nested as N
    t = deep_nested_table(5, 4000)
    n = t.num_rows
    cap = bucket_capacity(n)
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, n, cap))
    live = torch.from_numpy(rng.random(cap) < 0.8)
    choice = torch.from_numpy(rng.integers(0, 2, cap))

    def on_card(v):
        assert v.data.device.type == "cuda"
        for name in ("flat", "values"):
            if hasattr(v, name):
                on_card(getattr(v, name))
        for f in getattr(v, "fields", ()):
            on_card(f)
    for a, b in (("as_", "as2"), ("aa", "aa2"), ("sa", "sa2"),
                 ("ss", "ss"), ("ms", "ms")):
        on = {d: (array_to_device(t.column(a), None, cap, d),
                  array_to_device(t.column(b), None, cap, d))
              for d in ("cpu", cuda_device)}
        outs = {}
        for d, (va, vb) in on.items():
            dev = va.data.device
            g = N.gather(va, idx.to(dev), live.to(dev))
            outs[d] = [g, N.concat([va, g], [n, 3000], 1 << 13),
                       N.take_rows(va, 100, 900, 1024),
                       N.select_rows([va, vb], choice.to(dev), n, cap),
                       N.interleave([Col.from_vector(va),
                                     Col.from_vector(vb)], n)[0].to_vector()]
            if a != "ms":
                outs[d].append(N.equiv(Col.from_vector(va),
                                       Col.from_vector(vb)))
        for x, y in zip(outs[cuda_device], outs["cpu"]):
            if isinstance(x, torch.Tensor):
                assert x.device.type == "cuda"
                assert torch.equal(x.cpu(), y)
            else:
                on_card(x)
                _same_vec(x, y)


DEEP_JOBS = {
    "explode-structs": lambda df, F, E: df.explode("as_", outer=True,
                                                   pos=True),
    "explode-arrays": lambda df, F, E: df.explode("aa").explode("col"),
    "collect-nested": lambda df, F, E: df.group_by("k").agg(
        F.collect_list("as_").alias("l1"), F.collect_list("sa").alias("l2"),
        F.collect_list(F.struct("a", "aa", "i", "i")).alias("l3"),
        F.first("aa").alias("f"), F.last("sa", True).alias("l")).sort("k"),
    "conditional": lambda df, F, E: df.select(
        "k", F.when(E.col("k") > 2, E.col("as_")).alias("w"),
        F.if_(E.col("i") > 5, E.col("aa"), E.col("aa2")).alias("f"),
        F.coalesce("sa", "sa2").alias("c")),
    "equality": lambda df, F, E: df.select(
        (E.col("as_") == E.col("as2")).alias("e1"),
        (E.col("aa") != E.col("aa2")).alias("e2"),
        E.col("sa").eqNullSafe(E.col("sa2")).alias("e3")).filter(
        E.col("e1").is_not_null()),
    "extract": lambda df, F, E: df.select(
        F.get_field(F.element_at0("as_", 0), "y").alias("y"),
        F.size(F.element_at("aa", -1)).alias("n"),
        F.element_at0(F.get_field("sa", "f"), 1).alias("f1"),
        F.get_field(F.get_field("sa", "h"), "u").alias("u"),
        F.element_at0(F.element_at0("ss", 0), 0).alias("w")),
    "rollup": lambda df, F, E: df.rollup("k").agg(
        F.count().alias("n"), F.collect_list("aa").alias("l")).sort("k"),
    "payload": lambda df, F, E: df.repartition(3, "k").sort("k", "i").limit(
        1500),
}


@pytest.mark.gpu
@pytest.mark.parametrize("job", sorted(DEEP_JOBS))
def test_deep_nested_jobs_on_card_equal_cpu(cuda_device, job):
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.session import TorchSession
    t = deep_nested_table(12, 3000)
    out = [DEEP_JOBS[job](TorchSession(device=d).create_dataframe(t, 3),
                          F, E).collect()
           for d in ("cpu", "cuda")]
    assert out[0].to_pylist() == out[1].to_pylist()


@pytest.mark.gpu
def test_deep_nested_files_on_card(cuda_device, tmp_path):
    """Nested-of-nested columns written by the arrow writer on the card
    (parquet and ORC) and read back: the source's rows."""
    import pyarrow.orc as porc
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.session import TorchSession
    t = deep_nested_table(14, 2000)
    spark = TorchSession(device="cuda")
    df = spark.create_dataframe(t, 2)
    df.write_parquet(str(tmp_path / "p"), mode="overwrite")
    df.drop("ms").write_orc(str(tmp_path / "o"), mode="overwrite")
    key = lambda r: repr(sorted(r.items()))
    want = sorted(t.to_pylist(), key=key)
    assert sorted(pq.read_table(str(tmp_path / "p")).to_pylist(),
                  key=key) == want
    back = spark.read_parquet(str(tmp_path / "p")).collect()
    assert sorted(back.to_pylist(), key=key) == want
    orc = [porc.read_table(str(p)) for p in sorted((tmp_path / "o").glob(
        "*.orc"))]
    got = [r for o in orc for r in o.to_pylist()]
    assert sorted(got, key=key) == sorted(t.drop(["ms"]).to_pylist(),
                                          key=key)


# -- the order over whole nested values and the group-by's remainder ---------

ORDER_JOBS = {
    "max-min": lambda df, F, E: df.group_by("k").agg(
        F.max("aa").alias("hi"), F.min("aa").alias("lo"),
        F.max(F.get_field("sa", "f")).alias("hf")).sort("k"),
    "collect-set": lambda df, F, E: df.group_by("k").agg(
        F.collect_set("as_").alias("s1"), F.collect_set("sa").alias("s2"),
        F.collect_set("aa").alias("s3")).sort("k"),
    "sort-array": lambda df, F, E: df.sort("aa", "k", "i"),
    "sort-array-desc": lambda df, F, E: df.order_by(
        "ss", "k", "i", ascending=[False, True, True]),
    "having": lambda df, F, E: df.group_by("k").agg(
        F.count().alias("n"), F.sum("i").alias("s")).filter(
        E.col("n") > 400).sort("k"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("job", sorted(ORDER_JOBS))
def test_nested_order_jobs_on_card_equal_cpu(cuda_device, job):
    """max/min of arrays, collect_set of nested values, a sort by an array
    key and a fused HAVING on the card, bit for bit the CPU session's."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.session import TorchSession
    t = deep_nested_table(21, 3000, maps=False)
    out = [ORDER_JOBS[job](TorchSession(device=d).create_dataframe(t, 3),
                           F, E).collect()
           for d in ("cpu", "cuda")]
    assert out[0].to_pylist() == out[1].to_pylist()


@pytest.mark.gpu
def test_order_ranks_on_card_equal_cpu(cuda_device):
    import pyarrow as pa
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import nested as N
    t = deep_nested_table(22, 5000, maps=False)
    for name in ("as_", "aa", "sa", "ss"):
        arr = t.column(name).combine_chunks()
        dt = T.from_arrow_type(arr.type)
        r = [N.order_ranks(Col.from_vector(array_to_device(arr, dt, None,
                                                            d))).cpu()
             for d in ("cpu", "cuda")]
        assert torch.equal(r[0], r[1]), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int", "long", "long-hint", "double",
                                  "dict"])
def test_sort_tiers_on_card_equal_cpu(cuda_device, kind):
    """Every tier's permutation on the card is the CPU's (and the multi-pass
    one's)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import sorting as S
    rng = np.random.default_rng(7)
    cap, n = 1 << 20, 1_000_003
    valid = rng.random(cap) > 0.1
    valid[n:] = False
    hint = None
    dictionary = None
    if kind == "int":
        v, dt = rng.integers(-50, 50, cap).astype(np.int32), T.INT
    elif kind == "double":
        v, dt = rng.choice([np.nan, -0.0, 0.0, 1.0, -3.5], cap), T.DOUBLE
    elif kind == "dict":
        v, dt = rng.integers(0, 700, cap).astype(np.int32), T.STRING
        dictionary = pa.array([f"w{i:04d}" for i in range(700)])
    else:
        v, dt = rng.integers(-(1 << 50), 1 << 50, cap), T.LONG
        if kind == "long-hint":
            v = v % 100_000 + 12345
            hint = (12345, True)
    v = np.where(valid, v, np.zeros((), v.dtype))
    perms = []
    for d in ("cpu", "cuda"):
        c = Col(torch.from_numpy(v).to(d), torch.from_numpy(valid).to(d), dt,
                dictionary)
        for asc in (True, False):
            o = [S.SortOrder(asc)]
            perms.append(S.sort_permutation([c], o, n, cap,
                                            range_hint=hint).cpu())
            perms.append(S.multi_permutation([c], o, n, cap).cpu())
    assert all(torch.equal(perms[i], perms[i % 4]) for i in range(8))
    assert torch.equal(perms[0], perms[1]) and torch.equal(perms[2],
                                                           perms[3])


@pytest.mark.gpu
def test_chained_group_by_on_card_equals_cpu(cuda_device, tmp_path):
    """The chained group-by with the range hint and the right-sizing on the
    card, bit for bit the CPU session's and the unchained route's."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(8)
    n = 600_000
    t = pa.table({"k": pa.array(rng.integers(0, 200_000, n) * 7 - (1 << 40),
                                pa.int64()),
                  "x": pa.array(rng.normal(size=n)),
                  "y": pa.array(rng.integers(0, 9, n), pa.int64())})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=150_000)
    res = []
    for d, chain in (("cpu", "true"), ("cuda", "true"), ("cuda", "false")):
        spark = TorchSession({
            "spark.rapids.tpu.sql.reader.batchSizeRows": "150000",
            "spark.rapids.tpu.sql.stageFusion.groupBy.chain.enabled":
                chain}, device=d)
        df = spark.read_parquet(path).group_by("k").agg(
            F.sum("x").alias("s"), F.max("y").alias("m"),
            F.count().alias("c")).filter(F.col("c") > 3).sort("k")
        res.append(df.collect())
    x = [np.asarray(r.column("s")).view(np.int64) for r in res]
    assert res[0].num_rows > 0
    assert all(np.array_equal(x[0], xi) for xi in x[1:])
    assert res[0].drop(["s"]).equals(res[1].drop(["s"]))
    assert res[0].drop(["s"]).equals(res[2].drop(["s"]))


def _chain_files(tmp_path):
    """A three-file stream with null keys, a dense unique build on ``k``
    and a hash-mode build on sparse int64 ``sp`` (3,000 unique keys about
    10^10 apart: the direct table refuses the range)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(21)
    n = 300_000
    sparse = (rng.permutation(3000).astype(np.int64) + 1) * 9_999_991_337
    sparse[::3] *= -1
    sp = np.where(rng.random(n) < 0.7, rng.choice(sparse, n),
                  rng.integers(-2**60, 2**60, n))
    stream = pa.table({
        "k": pa.array(rng.integers(0, 5000, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "g": pa.array(rng.integers(0, 10, n), pa.int64()),
        "sp": pa.array(sp, pa.int64()),
        "v": pa.array(rng.normal(size=n)),
        "s": pa.array([f"s{i % 37}" for i in range(n)])})
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"stream{i}.parquet"))
        pq.write_table(stream.slice(i * 100_000, 100_000), files[-1],
                       row_group_size=40_000)
    keys = np.arange(4000, dtype=np.int64)
    pq.write_table(pa.table({"k": pa.array(keys), "w": pa.array(keys / 3)}),
                   str(tmp_path / "dense.parquet"))
    pq.write_table(pa.table({"sp": pa.array(sparse),
                             "t": pa.array(np.arange(3000) % 11,
                                           pa.int64())}),
                   str(tmp_path / "sparse.parquet"))
    return files, str(tmp_path / "dense.parquet"), \
        str(tmp_path / "sparse.parquet")


@pytest.mark.gpu
def test_join_chain_on_card_equals_cpu(cuda_device, tmp_path):
    """A chain of a dense hop and a hash hop under a hoisted filter and
    projection, on the card: the CPU session's rows in order, bit for bit,
    and the unchained route's; the hash hop launches hash_join_probe once a
    stream batch."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.exec import joins as XJ
    from spark_rapids_tpu_torch.session import TorchSession
    files, dense, sparse = _chain_files(tmp_path)
    c = F.col
    res = []
    for d, fusion in (("cpu", "true"), ("cuda", "true"), ("cuda", "false")):
        spark = TorchSession({"spark.rapids.tpu.sql.stageFusion.enabled":
                              fusion}, device=d)
        df = (spark.read_parquet(files, files_per_partition=1)
              .filter(c("g") != F.lit(3))
              .select(c("k"), c("sp"), (c("v") * F.lit(2.0)).alias("v2"),
                      c("s"))
              .join(spark.read_parquet(dense), on="k")
              .join(spark.read_parquet(sparse), on="sp"))
        plan = df.physical_plan()
        before = CK.launches["hash_join_probe"]
        res.append(plan.execute_collect())
        if d == "cuda" and fusion == "true":
            (chain,) = [p for p in _walk(plan)
                        if isinstance(p, XJ.BroadcastHashJoinChainExec)]
            modes = [h.stats["probe_mode"] for h in chain.hops]
            assert modes == ["dense", "hash"]
            assert chain.stats["chained_batches"] == \
                chain.stats["stream_batches"] > 3
            assert CK.launches["hash_join_probe"] - before == \
                chain.stats["stream_batches"]
    assert res[0].num_rows > 0
    assert res[0].equals(res[1]) and res[0].equals(res[2])


def _walk(plan):
    yield plan
    for ch in plan.children:
        yield from _walk(ch)


@pytest.mark.gpu
def test_encoded_q1_on_card_equals_dense(cuda_device, tmp_path, monkeypatch):
    """q1 on the card with each chunk decoded at its first read: the rows of
    every chunk decoded at the scan, bit for bit, with one chunk decode
    launch per encoded vector either way."""
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import encoded as EN
    from spark_rapids_tpu_torch.io import parquet_native as PN
    from spark_rapids_tpu_torch.session import TorchSession
    paths = tpch.generate(0.05, str(tmp_path))
    read = PN.read_row_group_device

    def at_scan(*args, **kw):
        batch = read(*args, **kw)
        for c in batch.columns:
            if isinstance(c, EN.EncodedColumnVector):
                c.decode()
        return batch
    out = {}
    for route in ("first read", "at the scan"):
        if route == "at the scan":
            monkeypatch.setattr(PN, "read_row_group_device", at_scan)
        plan = tpch.q1(tpch.load(TorchSession(), paths)).physical_plan()
        EN.reset_counts()
        before = CK.launches["bitunpack128"]
        out[route] = plan.execute_collect()
        torch.cuda.synchronize()
        decodes = CK.launches["bitunpack128"] - before
        assert decodes > 0
        assert EN.counts == {"made": decodes, "decoded": decodes}
    assert out["first read"].equals(out["at the scan"])


@pytest.mark.gpu
def test_pushed_filter_residual_on_card_equals_cpu(cuda_device, tmp_path):
    """A pushed filter whose double conjuncts are the residual (NaN, -0.0,
    0.0 and nulls among the values) on the card: the CPU run's rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(9)
    n = 50_000
    xs = rng.choice([1.0, float("nan"), -0.0, 0.0, 3.5, -2.0, None], n)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(-50, 50, n), pa.int64()),
        "x": pa.array(xs.tolist(), pa.float64()),
        "s": pa.array([f"s{i % 13}" for i in range(n)])}), path,
        row_group_size=10_000)
    c = F.col
    pred = ((c("k") > F.lit(0)) & (c("x") >= F.lit(-0.0))
            & (c("s") != F.lit("s3")))
    got = [TorchSession(device=d).read_parquet(path, pushed_filter=pred)
           .collect() for d in ("cpu", "cuda")]
    assert got[0].num_rows > 0
    assert repr(got[0].to_pylist()) == repr(got[1].to_pylist())


# -- the memory runtime on the card -------------------------------------------

def _kinds_on(device, seed=3, n=5000):
    """A batch of every column kind the port has, on ``device``."""
    import decimal

    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    r = np.random.default_rng(seed)
    t = pa.table({
        "i8": pa.array(r.integers(-100, 100, n), pa.int8()),
        "i16": pa.array(r.integers(-3000, 3000, n), pa.int16()),
        "f32": pa.array(r.normal(size=n).astype(np.float32)),
        "f64": pa.array(r.normal(size=n), mask=r.random(n) < 0.1),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                         r.integers(-10**12, 10**12, n)],
                        pa.decimal128(18, 2)),
        "ts": pa.array(r.integers(0, 10**15, n),
                       pa.timestamp("us", tz="UTC")),
        "s": pa.array([None if i % 5 == 0 else f"w{i % 17}"
                       for i in range(n)]),
        "arr": pa.array([None if i % 11 == 0 else list(range(i % 4))
                         for i in range(n)], pa.list_(pa.int64())),
        "st": pa.array([{"x": i, "y": f"v{i % 3}"} if i % 6 else None
                        for i in range(n)],
                       pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "m": pa.array([[("k", i)] if i % 4 else None for i in range(n)],
                      pa.map_(pa.string(), pa.int64())),
    })
    return t, ColumnarBatch.from_arrow(t, device)


@pytest.mark.gpu
@pytest.mark.parametrize("direct", [False, True])
def test_spill_round_trip_of_every_kind_on_card(cuda_device, tmp_path,
                                                direct):
    """Every column kind spilled from the card to the host and to disk and
    back: every tensor bit for bit the registered one, on the card."""
    from spark_rapids_tpu_torch.runtime import memory as M
    t, b = _kinds_on(cuda_device)
    cat = M.BufferCatalog(device_budget=1 << 40, host_budget=0,
                          spill_dir=str(tmp_path), direct_spill=direct)
    bid = cat.add_batch(b)
    assert cat.synchronous_spill(0) == b.device_memory_size()
    assert cat.get_tier(bid) == "DISK"
    back = cat.acquire_batch(bid)

    def tensors(v):
        out = [v.data, v.validity]
        for f in ("flat", "values"):
            if getattr(v, f, None) is not None:
                out += tensors(getattr(v, f))
        for f in getattr(v, "fields", ()):
            out += tensors(f)
        return out

    for c, d in zip(b.columns, back.columns):
        for x, y in zip(tensors(c), tensors(d)):
            assert y.device.type == "cuda"
            assert torch.equal(x, y)
    assert back.to_arrow().equals(t)
    cat.remove(bid)


@pytest.mark.gpu
def test_encoded_spill_on_card_decodes_once(cuda_device, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar import encoded as EN
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    from spark_rapids_tpu_torch.runtime import memory as M
    from spark_rapids_tpu_torch.session import TorchSession
    r = np.random.default_rng(5)
    path = str(tmp_path / "e.parquet")
    pq.write_table(pa.table({"k": pa.array(r.integers(0, 40, 20_000)),
                             "s": pa.array([f"n{i % 23}"
                                            for i in range(20_000)])}),
                   path, row_group_size=5000)
    plan = TorchSession().read_parquet(path).physical_plan()
    batches = list(plan.execute_partition(0))
    cat = M.BufferCatalog(device_budget=1 << 40, host_budget=0,
                          spill_dir=str(tmp_path / "sp"))
    ids = [cat.add_batch(b) for b in batches]
    cat.synchronous_spill(0)
    want = [b.to_arrow() for b in batches]
    CK.reset_launches()
    back = [cat.acquire_batch(i) for i in ids]
    n_enc = sum(isinstance(c, EN.EncodedColumnVector) and c._mat is None
                for b in back for c in b.columns)
    assert n_enc > 0 and CK.launches["bitunpack128"] == 0
    assert all(b.to_arrow().equals(w) for b, w in zip(back, want))
    assert CK.launches["bitunpack128"] == n_enc


@pytest.mark.gpu
def test_card_oom_inside_with_retry_is_a_split(cuda_device):
    """An allocation the card cannot hold raises torch.cuda.OutOfMemoryError
    inside the attempt; the ladder takes it as a DeviceOomError, splits the
    batch and gives the clean result."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.runtime import retry as R
    t = pa.table({"v": pa.array(np.arange(4096, dtype=np.int64))})
    b = ColumnarBatch.from_arrow(t, cuda_device)
    total = torch.cuda.mem_get_info(cuda_device)[1]
    tried = []

    def fn(x):
        if not tried:
            tried.append(x.num_rows)
            torch.empty(2 * total, dtype=torch.uint8, device=cuda_device)
        return ColumnarBatch([type(c)(c.dtype, c.data * 2, c.validity)
                              for c in x.columns], x.num_rows, x.schema)

    R.reset_counts()
    pieces = list(R.with_retry([b], fn, split_floor_bytes=1))
    assert tried == [4096] and [p.num_rows for p in pieces] == [2048, 2048]
    got = pa.concat_tables([p.to_arrow() for p in pieces])
    assert got.column("v").to_pylist() == [2 * i for i in range(4096)]
    assert R.counts["oom_retries"] == 1 and R.counts["split_retries"] == 1


@pytest.mark.gpu
def test_device_budget_reads_mem_get_info(cuda_device):
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.runtime import memory as M
    from spark_rapids_tpu_torch.session import TorchSession
    total = torch.cuda.mem_get_info(cuda_device)[1]
    TorchSession()
    assert M.DeviceManager.get().catalog.device_budget == int(total * 0.9)
    TorchSession({"spark.rapids.tpu.memory.hbm.allocFraction": "0.5"})
    assert M.DeviceManager.get().catalog.device_budget == int(total * 0.5)
    assert M.device_budget_bytes(RapidsConf(
        {"spark.rapids.tpu.memory.hbm.limitBytes": "1g"}), cuda_device) == (
        1 << 30)
    TorchSession()


@pytest.mark.gpu
def test_runtime_paths_on_card_equal_cpu(cuda_device, tmp_path):
    """The serializing shuffle, a range exchange and a spilling exchange on
    the card: the CPU run's rows, in order."""
    import pyarrow as pa
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.plan import nodes as NN
    from spark_rapids_tpu_torch.session import DataFrame, TorchSession
    r = np.random.default_rng(12)
    n = 200_000
    t = pa.table({"k": pa.array(r.integers(0, 500, n)),
                  "x": pa.array(np.round(r.normal(size=n), 3)),
                  "s": pa.array([f"g{i % 7}" for i in range(n)])})

    def frames(spark):
        df = spark.create_dataframe(t, num_partitions=4)
        ranged = DataFrame(NN.ExchangeNode(df._plan, "range", 8,
                                           keys=[F.col("x")]), spark)
        return [df.repartition(6, "s").group_by("s").agg(
                    F.sum(F.col("k")).alias("sk")).sort("s"),
                ranged.sort_within_partitions("x", "k")]

    confs = [{}, {"spark.rapids.tpu.shuffle.enabled": "false"},
             {"spark.rapids.tpu.memory.hbm.limitBytes": "2m",
              "spark.rapids.tpu.memory.host.spillStorageSize": "1m",
              "spark.rapids.tpu.memory.spill.dirs": str(tmp_path)}]
    for conf in confs:
        cpu = [f.collect() for f in frames(TorchSession(conf, device="cpu"))]
        card = [f.collect() for f in frames(TorchSession(conf))]
        for a, b in zip(cpu, card):
            assert repr(a.to_pylist()) == repr(b.to_pylist())
    TorchSession()
