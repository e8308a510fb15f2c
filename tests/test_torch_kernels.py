"""The port's kernels (ops/cuda_kernels.py) held against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_pallas.py runs them).
Inputs come from a numpy seed and cross between the packages as numpy arrays.

- bitunpack128, also against both packages' byte-wise plain unpack.
  Tolerance: exact (integer bit patterns).
- onehot_sum_f32, and the dense group-by sums that call it. Tolerance:
  exact for 0/1 values (counts below 2^24 are exact in f32) and integer
  sums; for other float32 values 1e-5 of the bucket's sum of magnitudes,
  and for f64 sums 1e-12 relative, because the two add in different orders.
- murmur3_words, also against both packages' host hash
  (``murmur3_bytes_host``) and the JAX package's jnp string hash; and the
  port's scalar column hashes against the JAX package's. Tolerance: exact
  (integer hashes).
- radix_ranks and radix_partition_permutation, also against a numpy stable
  argsort, and the exchange's partition_permutation against the JAX
  package's with its radix kernel forced on. Tolerance: exact.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py
holds them against their plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_rapids_tpu.ops import grouping as G
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.ops import pallas_kernels as PK
from spark_rapids_tpu.ops import parquet_decode as PD
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.ops import grouping as TG
from spark_rapids_tpu_torch.ops import hashing as TH
from spark_rapids_tpu_torch.ops import parquet_decode as TPD

BIT_WIDTHS = [1, 2, 3, 5, 7, 8, 11, 13, 16, 20, 24, 31, 32]  # test_pallas.py:51
COUNTS = [1, 127, 128, 300, 8193]


def _words(n: int, bw: int, extra: int = 0, seed: int = 0) -> np.ndarray:
    """Random packed words at the TPU kernel's input length
    ceil(n/128)*4*bw, plus ``extra`` trailing words the values do not need."""
    rng = np.random.default_rng(seed * 1000 + bw * 10 + n)
    nw = -(-n // 128) * 4 * bw + extra
    return rng.integers(-2**31, 2**31, nw, dtype=np.int64).astype(np.int32)


def _capacity(n: int) -> int:
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    return bucket_capacity(n)


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("bw", BIT_WIDTHS)
def test_bitunpack128_matches_jax(bw, n):
    words = _words(n, bw)
    cap = _capacity(n)
    want = np.asarray(PK.bitunpack128(jnp.asarray(words), bw, n, cap))
    got = CK.bitunpack128(torch.from_numpy(words), bw, n, cap).numpy()
    assert got.dtype == np.int32 and got.shape == (cap,)
    np.testing.assert_array_equal(got, want)
    # and against the byte-wise plain unpack of both packages
    packed = words.view(np.uint8)
    ref = np.asarray(PD.unpack_bits_device(jnp.asarray(packed), bw, n, cap))
    np.testing.assert_array_equal(got, ref)
    port_ref = TPD.unpack_bits_device(torch.from_numpy(packed.copy()), bw, n,
                                      cap).numpy()
    np.testing.assert_array_equal(port_ref, ref)


@pytest.mark.parametrize("bw", BIT_WIDTHS)
def test_bitunpack128_truncates_long_buffer(bw):
    """A legal chunk's last bit-packed run may declare more groups than values
    remain: the buffer is longer than needed, and its tail must not leak."""
    n = 300
    words = _words(n, bw, extra=4 * bw + 3, seed=1)
    cap = _capacity(n)
    want = np.asarray(PK.bitunpack128(jnp.asarray(words), bw, n, cap))
    got = CK.bitunpack128(torch.from_numpy(words), bw, n, cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[n:] == 0).all()


def test_bitunpack128_short_buffer_reads_zeros():
    """Words past the end of a buffer shorter than the values need read as 0,
    as the Pallas kernel's zero padding gives."""
    n, bw, cap = 300, 7, 512
    words = _words(n, bw)[:20]
    want = np.asarray(PK.bitunpack128(jnp.asarray(words), bw, n, cap))
    got = CK.bitunpack128(torch.from_numpy(words), bw, n, cap).numpy()
    np.testing.assert_array_equal(got, want)


def test_bitunpack128_rejects_bad_input():
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        CK.bitunpack128(w, 0, 4, 8)
    with pytest.raises(ValueError):
        CK.bitunpack128(w, 33, 4, 8)
    with pytest.raises(TypeError):
        CK.bitunpack128(w.to(torch.int64), 4, 4, 8)
    with pytest.raises(TypeError):
        CK.bitunpack128(w.reshape(2, 4), 4, 4, 8)


def test_cpu_tensor_takes_plain_version_without_counting():
    CK.reset_launches()
    words = torch.from_numpy(_words(300, 9))
    out = CK.bitunpack128(words, 9, 300, 512)
    assert torch.equal(out, CK.bitunpack128_plain(words, 9, 300, 512))
    assert CK.launches["bitunpack128"] == 0


ONEHOT_SHAPES = [(4096, 12), (2048, 1000), (1500, 300), (100, 5), (8192, 1024),
                 (1, 3)]   # test_pallas.py:150, and a one-row batch


@pytest.mark.parametrize("cap,D", ONEHOT_SHAPES)
def test_onehot_sum_f32_matches_jax(cap, D):
    rng = np.random.default_rng(cap * 7 + D)
    # -1 and D are outside the domain and must drop
    codes = rng.integers(-1, D + 1, cap).astype(np.int32)
    vals = rng.normal(0, 10, cap).astype(np.float32)
    want = np.asarray(PK.onehot_sum_f32(jnp.asarray(vals),
                                        jnp.asarray(codes), D))
    got = CK.onehot_sum_f32(torch.from_numpy(vals), torch.from_numpy(codes),
                            D).numpy()
    assert got.dtype == np.float32 and got.shape == (D,)
    inside = (codes >= 0) & (codes < D)
    mags = np.zeros(D, np.float64)
    np.add.at(mags, codes[inside], np.abs(vals[inside]).astype(np.float64))
    assert (np.abs(got.astype(np.float64) - want) <= 1e-5 * mags).all()
    # 0/1 values: exact, against JAX and against a numpy histogram
    ones = (rng.random(cap) < 0.8).astype(np.float32)
    want = np.asarray(PK.onehot_sum_f32(jnp.asarray(ones),
                                        jnp.asarray(codes), D))
    got = CK.onehot_sum_f32(torch.from_numpy(ones), torch.from_numpy(codes),
                            D).numpy()
    np.testing.assert_array_equal(got, want)
    hist = np.bincount(codes[inside], weights=ones[inside], minlength=D)
    np.testing.assert_array_equal(got, hist.astype(np.float32))


@pytest.mark.parametrize("count_like", [True, False])
def test_dense_group_sum_matches_jax(count_like):
    """The dense group-by's bucket sum (the integer scatter-add), port
    against the JAX package's CPU branch with count_like either way: counts
    exact, f64 sums within 1e-12."""
    rng = np.random.default_rng(12 + count_like)
    cap, D = 4096, 700
    codes = rng.integers(0, D + 1, cap).astype(np.int32)   # D: the pad bucket
    mask = rng.random(cap) < 0.9
    if count_like:
        vals = np.ones(cap, np.int64)
    else:
        vals = rng.normal(0, 100, cap)
    want = np.asarray(G.dense_group_sum(jnp.asarray(vals), jnp.asarray(mask),
                                        jnp.asarray(codes), D, False,
                                        count_like=count_like))
    got = TG.dense_group_sum(torch.from_numpy(vals), torch.from_numpy(mask),
                             torch.from_numpy(codes), D).numpy()
    assert got.dtype == want.dtype and got.shape == (D,)
    if count_like:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("D", [12, 300])   # stacked matvecs; scatter only
def test_resolve_dense_group_sums_matches_jax(D):
    """One batch's bucket sums as the aggregate records them — float sums
    (one repeated, as sum(x) and avg(x) pass it), count-likes and an int64
    sum — port against the JAX package's CPU executor. Counts and integer
    sums exact, f64 sums within 1e-12."""
    rng = np.random.default_rng(D)
    cap = 4096
    codes = rng.integers(0, D + 1, cap).astype(np.int32)
    live = rng.random(cap) < 0.95
    # the rows that are not live carry the pad code D, as both packages'
    # aggregates give them; the port's count route reads no liveness
    codes = np.where(live, codes, D).astype(np.int32)
    f1, f2 = rng.normal(0, 100, cap), rng.normal(0, 1, cap)
    ones = np.ones(cap, np.int64)
    ints = rng.integers(-1000, 1000, cap)
    m1, m2 = rng.random(cap) < 0.9, rng.random(cap) < 0.8
    spec = [(f1, m1, "float64", False), (f2, m2, "float64", False),
            (f1, m1, "float64", False), (ones, m1, "int64", True),
            (ones, m2, "int64", True), (ints, m2, "int64", False)]
    jarr = {id(a): jnp.asarray(a) for a in (f1, f2, ones, ints, m1, m2)}
    tarr = {id(a): torch.from_numpy(a) for a in (f1, f2, ones, ints, m1, m2)}
    want = G.resolve_dense_group_sums(
        [(jarr[id(v)], jarr[id(m)], jnp.dtype(acc), cl)
         for v, m, acc, cl in spec], jnp.asarray(codes), D, jnp.asarray(live))
    got = TG.resolve_dense_group_sums(
        [(tarr[id(v)], tarr[id(m)], getattr(torch, acc), cl)
         for v, m, acc, cl in spec], torch.from_numpy(codes), D,
        torch.from_numpy(live))
    for (_v, _m, acc, _cl), g, w in zip(spec, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.dtype(acc) and g.shape == (D,)
        if acc == "int64":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9)


def test_onehot_sum_f32_rejects_bad_input():
    v = torch.zeros(8, dtype=torch.float32)
    c = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        CK.onehot_sum_f32(v, c, CK.ONEHOT_MAX_DOMAIN + 1)
    with pytest.raises(ValueError):
        CK.onehot_sum_f32(v, c, -1)
    with pytest.raises(TypeError):
        CK.onehot_sum_f32(v.to(torch.float64), c, 4)
    with pytest.raises(TypeError):
        CK.onehot_sum_f32(v, c.to(torch.int64), 4)
    with pytest.raises(TypeError):
        CK.onehot_sum_f32(v, c[:4], 4)


def test_onehot_cpu_tensor_takes_plain_version_without_counting():
    CK.reset_launches()
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.random(500).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 12, 500).astype(np.int32))
    assert torch.equal(CK.onehot_sum_f32(v, c, 12),
                       CK.onehot_sum_f32_plain(v, c, 12))
    assert CK.launches["onehot_sum_f32"] == 0


# -- murmur3 string hash -----------------------------------------------------

MURMUR_STRINGS = ["", "a", "ab", "abc", "abcd", "hello world", "ünïcødé",
                  "é", "日本", "日本語", "x" * 37, "tail3_", "padded to sixteen"]


def _byte_rows(n: int, W: int, seed: int):
    """n random byte rows of lengths 0..4W (both ends included), drawn from
    the UTF-8 of ASCII, "é" and "日本", so rows end mid-character too."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(("aé日本z" * 8).encode("utf-8"), np.uint8)
    raw = pool[rng.integers(0, len(pool), (n, 4 * W))]
    lens = rng.integers(0, 4 * W + 1, n).astype(np.int32)
    lens[:2] = [0, 4 * W][:n]
    raw = np.where(np.arange(4 * W)[None, :] < lens[:, None], raw, 0)
    words = np.ascontiguousarray(raw.astype(np.uint8)).view("<i4")
    return words.astype(np.int32), lens


@pytest.mark.parametrize("W", [1, 2, 3, 5, 8])
def test_murmur3_words_matches_jax_and_host(W):
    words, lens = _byte_rows(400, W, seed=W)
    seeds = np.random.default_rng(W + 100).integers(
        -2**31, 2**31, 400).astype(np.int32)
    for seed in (42, seeds):
        jseed = jnp.asarray(seed) if isinstance(seed, np.ndarray) else seed
        tseed = (torch.from_numpy(seed) if isinstance(seed, np.ndarray)
                 else seed)
        want = np.asarray(PK.murmur3_words(jnp.asarray(words),
                                           jnp.asarray(lens), jseed))
        got = CK.murmur3_words(torch.from_numpy(words),
                               torch.from_numpy(lens), tseed).numpy()
        assert got.dtype == np.int32 and got.shape == (400,)
        np.testing.assert_array_equal(got, want)
        jnp_ref = np.asarray(JH.hash_string_words(
            jnp.asarray(words), jnp.asarray(lens),
            jnp.asarray(seed, jnp.int32)))
        np.testing.assert_array_equal(got, jnp_ref)
        raw = words.view(np.uint8)
        host = [TH.murmur3_bytes_host(bytes(raw[i, :lens[i]]),
                                      int(seed if np.isscalar(seed)
                                          else seed[i]))
                for i in range(400)]
        np.testing.assert_array_equal(got, host)


def test_murmur3_words_on_packed_dictionary():
    """Both packages pack a dictionary alike, and its hashes equal Spark's
    host hash of each string (test_pallas.py:17's cases)."""
    words, lens = TH.pack_utf8_words(MURMUR_STRINGS)
    jwords, jlens = JH.pack_utf8_words(MURMUR_STRINGS)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(lens, jlens)
    got = TH.hash_string_words(torch.from_numpy(words),
                               torch.from_numpy(lens), 42).tolist()
    assert got == [JH.murmur3_bytes_host(s.encode("utf-8"), 42)
                   for s in MURMUR_STRINGS]
    assert got == [TH.murmur3_bytes_host(s.encode("utf-8"), 42)
                   for s in MURMUR_STRINGS]


def test_murmur3_words_rejects_bad_input():
    w = torch.zeros((4, 2), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        CK.murmur3_words(w.to(torch.int64), n, 42)
    with pytest.raises(TypeError):
        CK.murmur3_words(w.reshape(8), n, 42)
    with pytest.raises(TypeError):
        CK.murmur3_words(w, n[:3], 42)
    with pytest.raises(TypeError):
        CK.murmur3_words(w, n, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        CK.murmur3_words(torch.zeros((4, 0), dtype=torch.int32), n, 42)
    CK.reset_launches()
    CK.murmur3_words(w, n, 42)
    assert CK.launches["murmur3_words"] == 0   # CPU: the plain version


@pytest.mark.parametrize("name", ["hash_int", "hash_long", "hash_double",
                                  "hash_float"])
def test_column_hashes_match_jax(name):
    rng = np.random.default_rng(len(name))
    special = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -5e-324, 1e-310,
               2.2250738585072014e-308, 1.1754944e-38, 1e-45, -1e-40]
    values = {
        "hash_int": rng.integers(-2**31, 2**31, 300).astype(np.int32),
        "hash_long": rng.integers(-2**63, 2**63, 300, dtype=np.int64),
        "hash_double": np.concatenate([rng.normal(0, 1e6, 288), special]),
        "hash_float": np.concatenate([rng.normal(0, 1e3, 288),
                                      special]).astype(np.float32),
    }[name]
    seed = rng.integers(-2**31, 2**31, 300).astype(np.int32)
    want = np.asarray(getattr(JH, name)(jnp.asarray(values),
                                        jnp.asarray(seed)))
    got = getattr(TH, name)(torch.from_numpy(values),
                            torch.from_numpy(seed)).numpy()
    np.testing.assert_array_equal(got, want)
    want42 = np.asarray(getattr(JH, name)(jnp.asarray(values), jnp.int32(42)))
    np.testing.assert_array_equal(
        getattr(TH, name)(torch.from_numpy(values), 42).numpy(), want42)


def test_pmod_matches_jax():
    h = np.random.default_rng(9).integers(-2**31, 2**31, 500).astype(np.int32)
    for n in (1, 4, 7, 200):
        np.testing.assert_array_equal(
            TH.pmod(torch.from_numpy(h), n).numpy(),
            np.asarray(JH.pmod(jnp.asarray(h), n)))


# -- radix ranks -------------------------------------------------------------

def _np_stable_ranks(ids, lanes):
    """tests/test_pallas.py's oracle: rank = earlier rows with the same id;
    out-of-range ids rank 0 and are not counted."""
    ranks = np.zeros(len(ids), np.int32)
    seen = {}
    for i, v in enumerate(ids):
        if 0 <= v < lanes:
            ranks[i] = seen.get(int(v), 0)
            seen[int(v)] = ranks[i] + 1
    counts = np.array([seen.get(lane, 0) for lane in range(lanes)], np.int32)
    return ranks, counts


@pytest.mark.parametrize("shape", ["uniform", "skewed", "single", "empty",
                                   "out_of_range"])
@pytest.mark.parametrize("lanes", [2, 9, 129])
def test_radix_ranks_matches_jax_and_numpy(shape, lanes):
    rng = np.random.default_rng(lanes)
    if shape == "uniform":
        ids = rng.integers(0, lanes, 700).astype(np.int32)
    elif shape == "skewed":        # one partition takes almost everything
        ids = np.where(rng.random(700) < 0.95, 1,
                       rng.integers(0, lanes, 700)).astype(np.int32)
    elif shape == "single":
        ids = np.full(300, lanes - 1, np.int32)
    elif shape == "empty":         # every row out of range (all padding)
        ids = np.full(128, lanes, np.int32)
    else:
        ids = rng.integers(-3, lanes + 3, 700).astype(np.int32)
    want_r, want_c = PK.radix_ranks(jnp.asarray(ids), lanes)
    got_r, got_c = CK.radix_ranks(torch.from_numpy(ids), lanes)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np_r, np_c = _np_stable_ranks(ids, lanes)
    np.testing.assert_array_equal(got_r.numpy(), np_r)
    np.testing.assert_array_equal(got_c.numpy(), np_c)


@pytest.mark.parametrize("nparts", [1, 2, 5, 64, 300])
def test_radix_partition_permutation_is_stable_argsort(nparts):
    rng = np.random.default_rng(nparts)
    ids = rng.integers(0, nparts, 1000).astype(np.int32)
    got = CK.radix_partition_permutation(torch.from_numpy(ids), nparts)
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(ids, kind="stable"))
    want = PK.radix_partition_permutation(jnp.asarray(ids), nparts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nparts", [3, 4095, 5000])
def test_partition_permutation_matches_jax(nparts):
    """The exchange's partition step, padding sunk to the end: the radix
    kernel up to 4,095 partitions (4,096 lanes with the sentinel), a stable
    argsort beyond, in both packages."""
    from spark_rapids_tpu.ops.sorting import partition_permutation as jpp
    from spark_rapids_tpu_torch.ops.sorting import partition_permutation
    rng = np.random.default_rng(nparts)
    cap, n = 512, 389
    ids = rng.integers(0, nparts, cap).astype(np.int32)
    PK.set_mode(True)
    try:
        want = np.asarray(jpp(jnp.asarray(ids), nparts, n, cap))
    finally:
        PK.set_mode(None)
    CK.reset_launches()
    got = partition_permutation(torch.from_numpy(ids), nparts, n, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert CK.launches["radix_ranks"] == 0   # CPU: the plain version


def test_radix_ranks_rejects_bad_input():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        CK.radix_ranks(ids, CK.RADIX_MAX_PARTS + 1)
    with pytest.raises(ValueError):
        CK.radix_ranks(ids, -1)
    with pytest.raises(TypeError):
        CK.radix_ranks(ids.to(torch.int64), 4)
    with pytest.raises(TypeError):
        CK.radix_ranks(ids.reshape(2, 4), 4)
