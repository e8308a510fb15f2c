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
hash_join_probe exact (build rows and flags), the hash_join_build kernel
bit for bit its plain version and its CPU result, and q5 over sparse
supplier ids on the card equal to the NumPy oracle (revenue within 1e-9
relative).
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
