"""The dense group-by's count route: one ``onehot_sums_f32`` call takes all of
an aggregate batch's count-like requests over its codes. Its plain version
(the CPU path) is held request by request against the JAX package's Pallas
kernel ``pallas_kernels.onehot_sum_f32`` of ``where(mask, vals, 0)`` as
float32, run in interpret mode on the CPU as tests/test_pallas.py runs it.
Inputs come from a numpy seed and cross between the packages as numpy
arrays.

Tolerance: exact for 0/1 values of every type and for counts of every row
(counts below 2^24 are exact in float32); for other float32 values 1e-5 of
each bucket's sum of magnitudes, because the two add in different orders.
The rows that are not live carry a code outside the domain, as the dense
aggregate gives them; the count route reads no liveness.

Also here: ``resolve_dense_group_sums`` makes one fused call per batch for
its count-like requests, and the CPU path counts no launch; the hash build's
CPU path is its plain version, held against the Pallas build on the cases
tests/test_torch_joins.py does not cover. The CUDA kernels run only on the
card: tests/test_torch_gpu.py holds them against these plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_rapids_tpu.ops import pallas_kernels as PK
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.ops import grouping as TG

# None: no value column, a count of every row (the rows per group)
_TYPES = (np.bool_, np.int32, np.int64, np.float32, None)


def _requests(rng, cap: int, k: int, floats: bool):
    """k requests cycling through the value types and counts of every row,
    0/1 values (random normals for float32 when ``floats``), masks with
    nulls, and some requests whose values are their own mask (mask None)."""
    reqs = []
    for j in range(k):
        t = _TYPES[j % len(_TYPES)]
        if t is None:
            vals = None
        elif floats and t == np.float32:
            vals = rng.normal(0, 10, cap).astype(np.float32)
        else:
            vals = (rng.random(cap) < 0.7).astype(t)
        mask = None if j % 3 == 2 else rng.random(cap) < 0.8
        reqs.append((vals, mask))
    return reqs


def _live_codes(rng, cap: int, D: int):
    """Codes from -2 to D + 1 (-2, -1, D and D + 1 lie outside the domain
    and drop), a tenth of the rows not live and given the code D."""
    codes = rng.integers(-2, D + 2, cap).astype(np.int32)
    return np.where(rng.random(cap) < 0.9, codes, D).astype(np.int32)


def _pallas_rows(codes, reqs, D: int):
    """Per request, the Pallas kernel over its values as float32 (ones for
    a count of every row) with the rows outside its mask zeroed (zeros for
    an empty batch, which the Pallas grid cannot take)."""
    rows = []
    for vals, mask in reqs:
        v = np.ones(len(codes), np.float32) if vals is None else vals
        if mask is not None:
            v = np.where(mask, v, 0)
        v = v.astype(np.float32)
        if len(codes) == 0:
            rows.append(np.zeros(D, np.float32))
            continue
        rows.append(np.asarray(PK.onehot_sum_f32(jnp.asarray(v),
                                                 jnp.asarray(codes), D)))
    return rows


def _torch_reqs(reqs):
    return [(None if v is None else torch.from_numpy(v),
             None if m is None else torch.from_numpy(m)) for v, m in reqs]


def _assert_rows(got, want, codes, reqs, D: int):
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(reqs), D)
    inside = (codes >= 0) & (codes < D)
    for j, ((vals, mask), w) in enumerate(zip(reqs, want)):
        g = got[j].numpy()
        if (vals is None or vals.dtype != np.float32
                or set(np.unique(vals)) <= {0, 1}):
            np.testing.assert_array_equal(g, w)
            continue
        keep = inside if mask is None else mask & inside
        mags = np.zeros(D, np.float64)
        np.add.at(mags, codes[keep], np.abs(vals[keep]).astype(np.float64))
        assert (np.abs(g.astype(np.float64) - w) <= 1e-5 * mags).all(), j


@pytest.mark.parametrize("D", [12, 26, 4096, CK.ONEHOT_MAX_DOMAIN])
@pytest.mark.parametrize("cap", [0, 1, 8, 1 << 14])
def test_onehot_sums_matches_pallas(cap, D):
    rng = np.random.default_rng(cap * 31 + D)
    codes = _live_codes(rng, cap, D)
    reqs = _requests(rng, cap, 5, floats=True)
    got = CK.onehot_sums_f32(torch.from_numpy(codes), _torch_reqs(reqs), D)
    _assert_rows(got, _pallas_rows(codes, reqs, D), codes, reqs, D)


@pytest.mark.parametrize("k", list(range(1, CK.ONEHOT_MAX_REQUESTS + 2)))
def test_onehot_sums_any_request_count_matches_pallas(k):
    """k from one request to one above what a launch takes (the card splits
    there), every value type, 0/1 values: exact."""
    rng = np.random.default_rng(100 + k)
    cap, D = 300, 26
    codes = _live_codes(rng, cap, D)
    reqs = _requests(rng, cap, k, floats=False)
    got = CK.onehot_sums_f32(torch.from_numpy(codes), _torch_reqs(reqs), D)
    _assert_rows(got, _pallas_rows(codes, reqs, D), codes, reqs, D)


def test_onehot_sums_without_liveness_and_the_one_request_call():
    """Codes with no row dropped as not live reads every row in the
    domain; a count of every row with no mask counts each code's rows;
    ``onehot_sum_f32`` is the one-request call of the same plain version
    (no mask)."""
    rng = np.random.default_rng(7)
    cap, D = 4096, 12
    codes = rng.integers(-2, D + 2, cap).astype(np.int32)
    reqs = _requests(rng, cap, 5, floats=True) + [(None, None)]
    got = CK.onehot_sums_f32(torch.from_numpy(codes), _torch_reqs(reqs), D)
    _assert_rows(got, _pallas_rows(codes, reqs, D), codes, reqs, D)
    inside = codes[(codes >= 0) & (codes < D)]
    np.testing.assert_array_equal(
        got[-1].numpy(), np.bincount(inside, minlength=D).astype(np.float32))
    vals = torch.from_numpy(reqs[3][0])
    one = CK.onehot_sum_f32(vals, torch.from_numpy(codes), D)
    assert torch.equal(one, CK.onehot_sums_f32(torch.from_numpy(codes),
                                               [(vals, None)], D)[0])


def test_onehot_sums_rejects_bad_input():
    c = torch.zeros(8, dtype=torch.int32)
    b = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        CK.onehot_sums_f32(c, [(b, None)], CK.ONEHOT_MAX_DOMAIN + 1)
    with pytest.raises(TypeError):
        CK.onehot_sums_f32(c.long(), [(b, None)], 4)
    with pytest.raises(TypeError):
        CK.onehot_sums_f32(c, [(b.to(torch.int16), None)], 4)
    with pytest.raises(TypeError):
        CK.onehot_sums_f32(c, [(b[:4], None)], 4)
    with pytest.raises(TypeError):
        CK.onehot_sums_f32(c, [(b, c)], 4)           # an int mask
    with pytest.raises(TypeError):
        CK.onehot_sums_f32(c, [(None, c)], 4)        # a row count, int mask
    assert CK.onehot_sums_f32(c, [], 4).shape == (0, 4)


def test_resolve_makes_one_fused_call_per_batch(monkeypatch):
    """Every count-like request of a batch goes through one onehot_sums_f32
    call (equal ones once, a value that is its mask as one read, the rows
    per group with no column), beside the float and integer sums; the CPU
    path counts no launch. Results equal each request's own bucket sum.
    The rows that are not live carry the code D, as the aggregate gives
    them."""
    rng = np.random.default_rng(3)
    cap, D = 2048, 12
    live = torch.from_numpy(rng.random(cap) < 0.9)
    codes = torch.where(live, torch.from_numpy(
        rng.integers(0, D + 1, cap).astype(np.int32)), D)
    valid_a = torch.from_numpy(rng.random(cap) < 0.8)
    valid_b = torch.from_numpy(rng.random(cap) < 0.6)
    f1 = torch.from_numpy(rng.normal(0, 10, cap))
    ints = torch.from_numpy(rng.integers(-9, 9, cap))
    reqs = [(None, None, torch.int32, True), (f1, valid_a, torch.float64,
                                              False),
            (valid_a, valid_a, torch.int64, True),
            (valid_a, valid_a, torch.int64, True),     # count(x) beside sum(x)
            (f1, valid_b, torch.float64, False),
            (valid_b, valid_b, torch.int64, True),
            (ints, valid_b, torch.int64, False)]
    calls = []
    fused = CK.onehot_sums_f32

    def counting(codes_, reqs_, n_domain):
        calls.append([(v, m) for v, m in reqs_])
        return fused(codes_, reqs_, n_domain)
    monkeypatch.setattr(CK, "onehot_sums_f32", counting)
    CK.reset_launches()
    outs = TG.resolve_dense_group_sums(reqs, codes, D, live)
    assert len(calls) == 1
    assert [(v, m) for v, m in calls[0]] == [
        (None, None), (valid_a, None), (valid_b, None)]
    assert CK.launches["onehot_sum_f32"] == 0
    for (v, m, acc, _cl), got in zip(reqs, outs):
        if v is None:
            v, m = torch.ones(cap, dtype=acc), torch.ones(cap, dtype=torch.bool)
        want = TG.dense_group_sum(v.to(acc), m & live, codes, D)
        assert got.dtype == acc
        if acc.is_floating_point:
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-9)
        else:
            assert torch.equal(got, want)


def test_resolve_counts_at_2_24_rows_take_the_exact_scatter(monkeypatch):
    """From 2^24 rows a bucket could hold more ones than float32 counts
    exactly, so the count-likes skip the fused call and take the int64
    scatter-add: the rows per group (no column) and a validity."""
    n, D = 1 << 24, 12
    rng = np.random.default_rng(11)
    codes = torch.from_numpy(rng.integers(0, D + 1, n, dtype=np.int32))
    valid = torch.from_numpy(rng.random(n, dtype=np.float32) < 0.5)
    live = codes < D
    monkeypatch.setattr(CK, "onehot_sums_f32", None)   # never called
    rows, cnt = TG.resolve_dense_group_sums(
        [(None, None, torch.int32, True), (valid, valid, torch.int64, True)],
        codes, D, live)
    c = codes[live].long()
    assert rows.dtype == torch.int32 and cnt.dtype == torch.int64
    assert torch.equal(rows, torch.bincount(c, minlength=D).to(torch.int32))
    assert torch.equal(cnt, torch.bincount(c[valid[live]], minlength=D))


def test_q1_session_makes_one_count_call_per_aggregate_batch(tmp_path,
                                                             monkeypatch):
    """q1 through TorchSession(device="cpu"): one fused count call for each
    batch the dense aggregate reduces (updates and merges), and the answer
    of the NumPy oracle."""
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.session import TorchSession
    paths = tpch.generate(0.002, str(tmp_path))
    batches, calls = [], []
    resolve, fused = TG.resolve_dense_group_sums, CK.onehot_sums_f32

    def counting_resolve(reqs, codes, n_domain, live):
        batches.append(len(reqs))
        return resolve(reqs, codes, n_domain, live)

    def counting_fused(*a, **kw):
        calls.append(len(a[1]))
        return fused(*a, **kw)
    monkeypatch.setattr(TG, "resolve_dense_group_sums", counting_resolve)
    monkeypatch.setattr(CK, "onehot_sums_f32", counting_fused)
    got = tpch.q1(tpch.load(TorchSession(device="cpu"), paths)).collect()
    exp = tpch.np_q1(tpch.load_np({"lineitem": paths["lineitem"]}))
    assert len(batches) >= 2 and len(calls) == len(batches)
    assert all(k >= 2 for k in calls)
    rows = got.to_pylist()
    assert [tuple(r.values())[:2] for r in rows] == [tuple(e[:2]) for e in exp]


@pytest.mark.parametrize("case", ["extremes", "all_ineligible", "empty"])
def test_hash_join_build_plain_matches_pallas(case):
    """The build's CPU path is its plain version and counts no launch;
    against the Pallas build on keys at int64 min + 1 and int64 max, with
    no eligible key, and on an empty build."""
    rng = np.random.default_rng(len(case))
    n, nb = (0 if case == "empty" else 256), 128
    keys = rng.permutation(np.arange(1, n + 1, dtype=np.int64)) * 2**40
    elig = np.ones(n, bool)
    if case == "extremes":
        keys[:2] = [np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max]
    elif case == "all_ineligible":
        elig[:] = False
    CK.reset_launches()
    got = CK.hash_join_build(torch.from_numpy(keys), torch.from_numpy(elig),
                             nb)
    plain = CK.hash_join_build_plain(torch.from_numpy(keys),
                                     torch.from_numpy(elig), nb)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert CK.launches["hash_join_build"] == 0
    if n:
        want = PK.hash_join_build(jnp.asarray(keys), jnp.asarray(elig), nb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2])
    assert int((got[1] >= 0).sum()) == int(elig.sum())
