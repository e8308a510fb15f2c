"""The port's join slice held against the JAX package on the same inputs
(numpy seeds, parquet files both packages read), on the CPU:

- the hash table: the port's plain ``hash_join_build`` (tables and ``ok``)
  and ``hash_join_probe`` against the Pallas kernels (``set_mode(True)``,
  interpret mode), and the Fibonacci bucket against numpy ``uint64``
  arithmetic over the whole int64 range. Tolerance: exact;
- ``_JoinCore``: the probe mode it picks, and its ``lo``/``hi``/counts, against
  the reference's ``_JoinCore`` with the Pallas kernels forced on (the
  reference's ``pallas_hash`` is the port's ``hash``). Tolerance: exact;
- joins through ``TorchSession(device="cpu")`` against ``TpuSession``, row
  for row (both emit in stream order): the ``tests/test_pallas.py:298-332``
  shape for inner/left/leftsemi/leftanti, q5's intermediate joins, and q5
  and q5-sparse against ``np_q5`` too. Tolerance: exact, except revenue,
  within 1e-9 relative (sums in another order);
- the comparison predicates (int, long, date, double, strings against
  literals and against each other, with nulls) against the reference.
  Tolerance: exact;
- the join shapes that are not ported (key pairs of unlike types among
  them) raise ``NotImplementedError`` while
  the plan is built.
"""


import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exec import joins as JJ
from spark_rapids_tpu.expr.core import BoundReference as JBound
from spark_rapids_tpu.ops import pallas_kernels as PK
from spark_rapids_tpu.session import TpuSession

import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.expr.core import BoundReference
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.01
# the reference's name of each probe mode, by the port's name
REF_MODE = {"hash": "pallas_hash", "dense": "dense", "one": "one",
            "two": "two"}


@pytest.fixture
def pallas_forced():
    """The reference's Pallas kernels on (interpret mode on the CPU), as
    tests/test_pallas.py forces them; restored afterwards."""
    PK.set_mode(True)
    try:
        yield
    finally:
        PK.set_mode(None)


# -- the hash table ---------------------------------------------------------

def _sparse_keys(rng, n):
    return rng.permutation(np.arange(0, 2**44, 2**44 // n)[:n]).astype(
        np.int64)


def _build_case(case, n_buckets, rng):
    n = n_buckets * 2           # 0.25 load of the H x 8 table
    if case == "unique":
        return _sparse_keys(rng, n), np.ones(n, bool)
    if case == "overfull":      # 8 keys per bucket on average
        return (np.arange(1, 8 * n_buckets + 1, dtype=np.int64) * 977,
                np.ones(8 * n_buckets, bool))
    if case == "duplicate":
        keys = _sparse_keys(rng, n)
        keys[n // 2] = keys[3]
        return keys, np.ones(n, bool)
    if case == "ineligible":    # nulls / rows past the build's count
        return _sparse_keys(rng, n), rng.random(n) < 0.6
    raise AssertionError(case)


@pytest.mark.parametrize("n_buckets", [128, 1024])
@pytest.mark.parametrize("case", ["unique", "overfull", "duplicate",
                                  "ineligible"])
def test_hash_join_build_matches_pallas(pallas_forced, case, n_buckets):
    rng = np.random.default_rng(n_buckets + len(case))
    keys, elig = _build_case(case, n_buckets, rng)
    want_k, want_r, want_ok = PK.hash_join_build(
        jnp.asarray(keys), jnp.asarray(elig), n_buckets)
    got_k, got_r, got_ok = CK.hash_join_build(
        torch.from_numpy(keys), torch.from_numpy(elig), n_buckets)
    assert bool(got_ok) == bool(want_ok) == (case in ("unique", "ineligible"))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def _full_bucket_keys(rng, n_buckets):
    """Build keys whose bucket 0 is full: 8 keys of that bucket, then 100
    sparse keys of other buckets; and 32 more keys of bucket 0 (misses that
    read the full bucket)."""
    cand = np.arange(1, 1 << 22, dtype=np.int64) * 7919
    h_bits = n_buckets.bit_length() - 1
    bucket = (cand.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> \
        np.uint64(64 - h_bits)
    crowd = cand[bucket == 0][:40]
    other = _sparse_keys(rng, 400) + 1
    ob = (other.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> \
        np.uint64(64 - h_bits)
    return np.concatenate([crowd[:8], other[ob != 0][:100]]), crowd[8:]


def _probe_case(case, n_buckets, rng):
    """(build keys, eligibility, stream) of a probe case: ``mixed`` (hits,
    misses and negative misses, 90 % of the build eligible), ``full_bucket``
    (a bucket of 8 keys hit in every slot, and misses of that bucket) or
    ``all_miss`` (no stream key is a build key)."""
    if case == "full_bucket":
        keys, misses = _full_bucket_keys(rng, n_buckets)
        stream = np.concatenate([np.repeat(keys[:8], 64),
                                 rng.choice(misses, 512), keys[8:]])
        return keys, np.ones(len(keys), bool), rng.permutation(stream)
    n_build = n_buckets * 2
    keys = np.concatenate([_sparse_keys(rng, n_build // 2),
                           -_sparse_keys(rng, n_build // 2) - 1])
    if case == "all_miss":
        # every non-negative build key is even (a multiple of 2^44 // n)
        # and every negative one odd (minus such a multiple, less one):
        # odd non-negative and even negative stream keys miss them all
        stream = rng.integers(-2**62, 2**62, 4096, dtype=np.int64)
        stream = np.where(stream >= 0, stream | 1, stream & ~1)
        return keys, np.ones(n_build, bool), stream
    elig = rng.random(n_build) < 0.9
    stream = np.concatenate([
        rng.choice(keys, 2048),                                # hits
        rng.integers(-2**62, 2**62, 1024, dtype=np.int64),     # misses
        -rng.choice(np.abs(keys) + 1, 1024)]).astype(np.int64)  # negatives
    return keys, elig, stream


@pytest.mark.parametrize("n_buckets,case", [
    (128, "mixed"), (1024, "mixed"), (128, "full_bucket"),
    (1024, "full_bucket"), (128, "all_miss"), (1024, "all_miss")],
    ids=["128", "1024", "full_bucket-128", "full_bucket-1024",
         "all_miss-128", "all_miss-1024"])
def test_hash_join_probe_matches_pallas(pallas_forced, n_buckets, case):
    rng = np.random.default_rng(7 + n_buckets)
    keys, elig, stream = _probe_case(case, n_buckets, rng)
    tk, tr, ok = PK.hash_join_build(jnp.asarray(keys), jnp.asarray(elig),
                                    n_buckets)
    assert bool(ok)
    want_pos, want_found = PK.hash_join_probe(tk, tr, jnp.asarray(stream),
                                              n_buckets)
    got_pos, got_found = CK.hash_join_probe(
        torch.from_numpy(np.array(tk)), torch.from_numpy(np.array(tr)),
        torch.from_numpy(stream), n_buckets)
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    member = np.isin(stream, keys[elig])
    np.testing.assert_array_equal(got_found.numpy(), member)
    if case == "mixed":
        assert member.sum() > 1000 and (~member).sum() > 1000
    elif case == "all_miss":
        assert not member.any()
        assert (got_pos.numpy() == -1).all()
    else:
        # every slot of the full bucket occupied, and each one hit
        assert (np.array(tr)[:8] >= 0).all()
        assert set(got_pos.numpy()[member]) >= set(range(8))
        assert (~member).sum() == 512


def test_hash_join_probe_never_matches_an_empty_slot():
    """A stream key equal to the empty-slot sentinel (int64 min) finds
    nothing: a slot counts only when its row is >= 0. (The Pallas kernel
    compares keys alone, so it reports such a key as found at row -1.)"""
    keys = np.arange(1, 201, dtype=np.int64) * 1_000_003
    tk, tr, ok = CK.hash_join_build(torch.from_numpy(keys),
                                    torch.ones(200, dtype=torch.bool), 128)
    assert bool(ok)
    stream = torch.tensor([CK.HJ_EMPTY, int(keys[5]), 0], dtype=torch.int64)
    pos, found = CK.hash_join_probe(tk, tr, stream, 128)
    assert found.tolist() == [False, True, False]
    assert pos.tolist() == [-1, 5, -1]


def test_int64_min_stream_key_joins_nothing(tmp_path):
    """Through the session, a stream key of int64 min against a sparse
    build that takes the hash table: the port gives the reference's answer
    on its sorted probe (the Pallas kernels off). With them on, the
    reference pairs that key with build row 0 (ROADMAP, Queue 3)."""
    keys = np.arange(1, 201, dtype=np.int64) * 1_000_003
    sk = np.concatenate([[-2**63], keys[3:4], np.arange(300) * 7 + 1])
    pq.write_table(pa.table({"k": keys, "b": np.arange(200)}),
                   str(tmp_path / "b.parquet"))
    pq.write_table(pa.table({"k": sk.astype(np.int64),
                             "s": np.arange(len(sk))}),
                   str(tmp_path / "s.parquet"))

    def run(spark):
        return (spark.read_parquet(str(tmp_path / "s.parquet"))
                .join(spark.read_parquet(str(tmp_path / "b.parquet")),
                      on="k"))
    plan = run(TorchSession(device="cpu")).physical_plan()
    got = _rows(plan.execute_collect())
    assert plan.child.stats["probe_mode"] == "hash"
    assert got == _rows(run(TpuSession()).collect()) == [
        (int(keys[3]), 1, 3)]


def test_fibonacci_bucket_matches_numpy_uint64():
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        rng.integers(-2**63, 2**63 - 1, 200_000, dtype=np.int64),
        np.array([-2**63, -2**63 + 1, -1, 0, 1, 2**63 - 1], np.int64)])
    for h_bits in range(7, 13):
        with np.errstate(over="ignore"):
            want = ((keys.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
                    >> np.uint64(64 - h_bits)).astype(np.int32)
        got = CK.hash_join_bucket(torch.from_numpy(keys), h_bits).numpy()
        np.testing.assert_array_equal(got, want)
        # and the reference's own bucket
        np.testing.assert_array_equal(
            got, np.asarray(PK._hj_bucket(jnp.asarray(keys), h_bits)))


def test_hash_join_buckets_matches_the_reference():
    for n in (0, 1, 100, 2000, 4096, 10_000, 16_384, 16_385, 50_000):
        assert CK.hash_join_buckets(n) == PK.hash_join_buckets(n), n
    assert CK.hash_join_buckets(10_000) == 4096
    assert CK.hash_join_buckets(16_385) == 0


def test_sparse_supplier_ids_fit_the_hash_table(tmp_path):
    """The SF1 supplier table of q5-sparse (its ids do not depend on the
    seed: s_suppkey is 1..10,000) builds a table the reference accepts."""
    ids = np.arange(1, 10_001, dtype=np.int64) * tpch.SPARSE_SUPPKEY_STRIDE
    nb = PK.hash_join_buckets(len(ids))
    assert nb == 4096
    PK.set_mode(True)
    try:
        _, _, ok = PK.hash_join_build(jnp.asarray(ids),
                                      jnp.ones(len(ids), bool), nb)
    finally:
        PK.set_mode(None)
    assert bool(ok)
    _, _, ok = CK.hash_join_build(torch.from_numpy(ids),
                                  torch.ones(len(ids), dtype=torch.bool), nb)
    assert bool(ok)


# -- _JoinCore: the probe mode and the probe ---------------------------------

def _core_case(case, rng):
    if case == "dense":
        keys = rng.permutation(np.arange(1000, 4000, dtype=np.int64))
    elif case == "sparse-unique":
        keys = _sparse_keys(rng, 3000)
    elif case == "sparse-duplicate":
        keys = _sparse_keys(rng, 3000)
        keys[100] = keys[2000]
    elif case == "sparse-over-16384":
        keys = _sparse_keys(rng, 16_385)
    elif case == "wide-duplicate":     # too wide for the packed sort
        keys = rng.integers(-2**61, 2**61, 3000)
        keys[7] = keys[1500]
    elif case == "sparse-int32":
        keys = rng.permutation(np.arange(-2**30, 2**30, 2**30 // 1500)
                               [:3000]).astype(np.int32)
    elif case in ("all-null", "empty"):
        keys = np.arange(0 if case == "empty" else 300, dtype=np.int64)
    else:
        raise AssertionError(case)
    n = len(keys)
    null = rng.random(n) < (1.0 if case == "all-null" else 0.05)
    build = pa.table({"k": pa.array(keys, mask=null),
                      "v": pa.array(np.arange(n, dtype=np.int64))})
    skeys = (rng.integers(-5, 400, 4000) if n == 0 else np.concatenate([
        rng.choice(keys, 2000),
        rng.integers(keys.min(), keys.max(), 2000)])).astype(keys.dtype)
    stream = pa.table({"k": pa.array(skeys, mask=rng.random(4000) < 0.05)})
    return build, stream


@pytest.mark.parametrize("case,mode", [
    ("dense", "dense"), ("sparse-unique", "hash"),
    ("sparse-duplicate", "two"), ("sparse-over-16384", "one"),
    ("wide-duplicate", "two"), ("all-null", "dense"), ("empty", "dense"),
    ("sparse-int32", "hash")])
@pytest.mark.parametrize("jt", ["inner", "leftouter", "leftanti"])
def test_join_core_mode_and_probe_match_reference(pallas_forced, case, mode,
                                                  jt):
    rng = np.random.default_rng(len(case))
    build, stream = _core_case(case, rng)
    dtype = T.from_arrow_type(build.schema.field("k").type)
    jdtype = JT.from_arrow_type(build.schema.field("k").type)
    ref = JJ._JoinCore(JBatch.from_arrow(build), [JBound(0, jdtype)],
                       [JBound(0, jdtype)], jt)
    port = XJ._JoinCore(ColumnarBatch.from_arrow(build, "cpu"),
                        [BoundReference(0, dtype)],
                        [BoundReference(0, dtype)], jt, "cpu")
    assert port.probe_mode == mode
    assert ref._probe_mode == REF_MODE[mode]
    want = ref.probe_batch(JBatch.from_arrow(stream))
    got = port.probe_batch(ColumnarBatch.from_arrow(stream, "cpu"))
    # (build_perm, lo, hi, counts, total)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


# -- joins through the sessions ---------------------------------------------

def _rows(table):
    """Rows as tuples, NaN as a string so that equal rows compare equal."""
    return [tuple("NaN" if isinstance(v, float) and v != v else v
                  for v in r.values()) for r in table.to_pylist()]


@pytest.fixture(scope="module")
def pallas_shape(tmp_path_factory):
    """tests/test_pallas.py:298-332: int64 keys 2^44/3000 apart, nulls on
    both sides, as parquet files."""
    d = tmp_path_factory.mktemp("pallas_shape")
    rng = np.random.default_rng(9)
    bk = _sparse_keys(rng, 3000)
    sk = np.concatenate([rng.choice(bk, 2000),
                         rng.integers(0, 2**44, 1000)]).astype(np.int64)
    paths = {}
    for name, keys, col in (("build", bk, "b"), ("stream", sk, "s")):
        t = pa.table({"k": pa.array(keys, mask=rng.random(3000) < 0.05),
                      col: pa.array(np.arange(3000, dtype=np.int64))})
        paths[name] = str(d / f"{name}.parquet")
        pq.write_table(t, paths[name])
    return paths


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_pallas_shape_joins_match_tpu_session(pallas_forced, pallas_shape,
                                              how):
    def run(spark):
        stream = spark.read_parquet(pallas_shape["stream"])
        build = spark.read_parquet(pallas_shape["build"])
        return stream.join(build, on="k", how=how)
    port_df = run(TorchSession(device="cpu"))
    plan = port_df.physical_plan()
    got = plan.execute_collect()
    want = run(TpuSession()).collect()
    assert got.column_names == want.column_names
    assert _rows(got) == _rows(want)
    join = plan if isinstance(plan, XJ.HashJoinExec) else plan.child
    assert join.stats["probe_mode"] == "hash"
    assert join.stats["hash_buckets"] == 2048
    assert join.exchange._batch is None     # released by its last reader


def test_multi_partition_stream_probes_one_broadcast(pallas_shape):
    """A stream of two partitions probes one broadcast build and gives the
    reference's rows."""
    spark = TorchSession(device="cpu")
    two = spark.read_parquet([pallas_shape["stream"]] * 2)
    build = spark.read_parquet(pallas_shape["build"])
    df = two.join(build, on="k", how="left")
    assert isinstance(df.physical_plan().child, XJ.BroadcastHashJoinExec)
    got = df.collect()
    want = (TpuSession().read_parquet([pallas_shape["stream"]] * 2)
            .join(TpuSession().read_parquet(pallas_shape["build"]),
                  on="k", how="left").collect())
    assert _rows(got) == _rows(want)


def test_broadcast_shared_by_map_threads(pallas_shape):
    """Eight stream partitions probe one broadcast from an exchange's map
    threads (more threads than this box has cores, a short switch
    interval): the build runs once, every row comes out once, the stream
    batches are all counted, and the last reader releases the build."""
    import collections
    import sys
    spark = TorchSession({"spark.rapids.tpu.sql.localScheduler.numThreads":
                          8}, device="cpu")
    stream = spark.read_parquet([pallas_shape["stream"]] * 8)
    build = spark.read_parquet(pallas_shape["build"])
    plan = (stream.join(build, on="k", how="left").repartition(3, "s")
            .physical_plan())
    join = plan.child.child
    assert isinstance(join, XJ.BroadcastHashJoinExec)
    scan = join.exchange.child
    built = []
    run_scan = scan.execute_partition

    def counted(split):
        built.append(split)
        return run_scan(split)
    scan.execute_partition = counted
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = plan.execute_collect()
    finally:
        sys.setswitchinterval(old)
    want = (stream.join(build, on="k", how="left")).collect()
    assert collections.Counter(_rows(got)) == collections.Counter(
        _rows(want))
    assert got.num_rows == want.num_rows > 8 * 2000
    assert built == [0]
    assert join.stats["stream_batches"] == 8
    assert join.exchange._batch is None


def test_left_join_null_extends_and_anti_keeps_unmatched(tmp_path):
    spark = TorchSession(device="cpu")
    pq.write_table(pa.table({"k": pa.array([1, None, 3, 4], pa.int64()),
                             "a": ["x", "y", "z", "w"]}),
                   str(tmp_path / "l.parquet"))
    pq.write_table(pa.table({"k": pa.array([3, 1, None], pa.int64()),
                             "b": [30.0, 10.0, 99.0]}),
                   str(tmp_path / "r.parquet"))
    left = spark.read_parquet(str(tmp_path / "l.parquet"))
    right = spark.read_parquet(str(tmp_path / "r.parquet"))
    assert _rows(left.join(right, on="k", how="left").collect()) == [
        (1, "x", 10.0), (None, "y", None), (3, "z", 30.0), (4, "w", None)]
    assert _rows(left.join(right, on="k", how="left_anti").collect()) == [
        (None, "y"), (4, "w")]
    assert _rows(left.join(right, on="k", how="left_semi").collect()) == [
        (1, "x"), (3, "z")]


def test_duplicate_sparse_build_keys_take_the_sorted_probe(tmp_path):
    """A sparse build with a duplicate key: the hash build refuses it at run
    time (ok=False) and the two-searchsorted probe gives every pair."""
    rng = np.random.default_rng(5)
    keys = _sparse_keys(rng, 500)
    keys[10] = keys[20]
    pq.write_table(pa.table({"k": keys, "b": np.arange(500)}),
                   str(tmp_path / "b.parquet"))
    pq.write_table(pa.table({"k": np.concatenate([keys[:50], keys[:5]]),
                             "s": np.arange(55)}),
                   str(tmp_path / "s.parquet"))

    def run(spark):
        return (spark.read_parquet(str(tmp_path / "s.parquet"))
                .join(spark.read_parquet(str(tmp_path / "b.parquet")),
                      on="k"))
    plan = run(TorchSession(device="cpu")).physical_plan()
    got = plan.execute_collect()
    join = plan.child
    assert join.stats["hash_refused"] == 1
    assert join.stats["probe_mode"] == "two"
    assert _rows(got) == _rows(run(TpuSession()).collect())
    assert got.num_rows == 57


# -- q5 and q5-sparse --------------------------------------------------------

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return jtpch.generate(SF, str(tmp_path_factory.mktemp("tpch_q5")))


def _ref_q5_sparse(dfs):
    """The reference's frames of the port's ``tpch.q5_sparse``."""
    c = JF.col
    stride = JF.lit(tpch.SPARSE_SUPPKEY_STRIDE)
    d0 = JF.cast(JF.lit("1994-01-01"), JT.DATE)
    d1 = JF.cast(JF.lit("1995-01-01"), JT.DATE)
    asia = dfs["region"].filter(c("r_name") == JF.lit("ASIA")).select(
        c("r_regionkey").alias("n_regionkey"))
    nations = (dfs["nation"].join(asia, on="n_regionkey")
               .select(c("n_nationkey"), c("n_name")))
    supp = dfs["supplier"].select((c("s_suppkey") * stride).alias("s_id"),
                                  c("s_nationkey").alias("n_nationkey"))
    orders = (dfs["orders"]
              .filter((c("o_orderdate") >= d0) & (c("o_orderdate") < d1))
              .select(c("o_orderkey").alias("l_orderkey"),
                      c("o_custkey").alias("c_custkey")))
    co = orders.join(dfs["customer"].select(c("c_custkey"),
                                            c("c_nationkey")),
                     on="c_custkey")
    li = dfs["lineitem"].select(c("l_orderkey"),
                                (c("l_suppkey") * stride).alias("s_id"),
                                c("l_extendedprice"), c("l_discount"))
    j = (li.join(co, on="l_orderkey")
         .join(supp, on="s_id")
         .filter(c("c_nationkey") == c("n_nationkey"))
         .join(nations, on="n_nationkey"))
    return (j.select(c("n_name"),
                     (c("l_extendedprice") * (JF.lit(1.0) - c("l_discount")))
                     .alias("volume"))
            .group_by(c("n_name"))
            .agg(JF.sum(c("volume")).alias("revenue"))
            .sort(c("revenue"), ascending=False))


def _assert_q5_equal(got, exp):
    assert [r[0] for r in got] == [r[0] for r in exp]
    for (_, a), (_, b) in zip(got, exp):
        assert a == pytest.approx(b, rel=1e-9)


def _joins(plan):
    """The hash joins of an exec tree, top down; a probe chain's hops count
    as its joins, the top hop first."""
    out = [plan] if isinstance(plan, XJ.HashJoinExec) else []
    if isinstance(plan, XJ.BroadcastHashJoinChainExec):
        out = plan.hops[::-1]
    for c in plan.children:
        out += _joins(c)
    return out


@pytest.mark.parametrize("query", ["q5", "q5_sparse"])
def test_q5_matches_tpu_session_and_numpy(paths, query):
    port_q, ref_q = ((tpch.q5, jtpch.q5) if query == "q5"
                     else (tpch.q5_sparse, _ref_q5_sparse))
    plan = port_q(tpch.load(TorchSession(device="cpu"), paths)) \
        .physical_plan()
    got = _rows(plan.execute_collect())
    want = _rows(ref_q(jtpch.load(TpuSession(), paths)).collect())
    exp = tpch.np_q5(tpch.load_np(paths))
    assert len(exp) == 5
    _assert_q5_equal(got, want)
    _assert_q5_equal(got, exp)
    joins = _joins(plan)
    assert len(joins) == 5
    modes = [j.stats["probe_mode"] for j in joins]
    if query == "q5":
        assert modes == ["dense"] * 5
        assert [j.stats["build_rows"] for j in joins][3:] == [5, 1]
    else:
        # top down: nations, the supplier ids, co, customer, asia
        assert modes == ["dense", "hash", "dense", "dense", "dense"]
        sparse = joins[1]
        assert sparse.stats["build_rows"] == 100
        assert sparse.stats["hash_buckets"] == 128
        assert sparse.build_side == "right"
        assert all(j.build_side == "right" for j in joins)


def test_q5_intermediate_joins_match_row_for_row(paths):
    """q5's joins below the aggregate, each against the reference row for
    row: the build sides are the same, so the stream orders are."""
    def frames(dfs, Fm, sparse):
        c = Fm.col
        asia = dfs["region"].filter(c("r_name") == Fm.lit("ASIA")).select(
            c("r_regionkey").alias("n_regionkey"))
        nations = dfs["nation"].join(asia, on="n_regionkey")
        orders = dfs["orders"].select(c("o_orderkey").alias("l_orderkey"),
                                      c("o_custkey").alias("c_custkey"))
        co = orders.join(dfs["customer"], on="c_custkey")
        key = (c("l_suppkey") * Fm.lit(tpch.SPARSE_SUPPKEY_STRIDE)
               if sparse else c("l_suppkey")).alias("s_id")
        li = dfs["lineitem"].select(c("l_orderkey"), key, c("l_discount"))
        supp = dfs["supplier"].select(
            (c("s_suppkey") * Fm.lit(tpch.SPARSE_SUPPKEY_STRIDE)
             if sparse else c("s_suppkey")).alias("s_id"), c("s_nationkey"))
        lico = li.join(co, on="l_orderkey")
        return {"nations": nations, "co": co, "li-co": lico,
                "li-co-supp": lico.join(supp, on="s_id")}
    for sparse in (False, True):
        port = frames(tpch.load(TorchSession(device="cpu"), paths), F, sparse)
        ref = frames(jtpch.load(TpuSession(), paths), JF, sparse)
        for name in port:
            got, want = port[name].collect(), ref[name].collect()
            assert got.column_names == want.column_names, name
            assert _rows(got) == _rows(want), (name, sparse)
            assert got.num_rows > 0, name


# -- predicates --------------------------------------------------------------

@pytest.fixture(scope="module")
def typed_table(tmp_path_factory):
    rng = np.random.default_rng(11)
    n = 400
    days = rng.integers(8000, 10000, n).astype(np.int32)
    t = pa.table({
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "l": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.1),
        "d": pa.array(days, mask=rng.random(n) < 0.1).cast(pa.date32()),
        "x": pa.array(np.where(rng.random(n) < 0.05, np.nan,
                               rng.normal(0, 20, n).round(0)),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(np.array(["apple", "kiwi", "fig", "date", "plum"])
                      [rng.integers(0, 5, n)], mask=rng.random(n) < 0.1),
        "t": pa.array(np.array(["fig", "zest", "apple", "lime"])
                      [rng.integers(0, 4, n)], mask=rng.random(n) < 0.1),
    })
    path = str(tmp_path_factory.mktemp("typed") / "t.parquet")
    pq.write_table(t, path)
    return path


_PREDICATES = {
    "i==lit": lambda c, m: c("i") == m.lit(7),
    "i<lit": lambda c, m: c("i") < m.lit(3),
    "i>lit": lambda c, m: c("i") > m.lit(-4),
    "i>=lit": lambda c, m: c("i") >= m.lit(0),
    "i==l": lambda c, m: c("i") == c("l"),
    "l<i": lambda c, m: c("l") < c("i"),
    "l>=bigint": lambda c, m: c("l") >= m.lit(-2**40),
    "d>=date": lambda c, m: c("d") >= m.cast(m.lit("1994-01-01"), DATE[m]),
    "d<date": lambda c, m: c("d") < m.cast(m.lit("1995-06-17"), DATE[m]),
    "x==x": lambda c, m: c("x") == c("x"),
    "x>lit": lambda c, m: c("x") > m.lit(1.0),
    "x<lit": lambda c, m: c("x") < m.lit(-3.0),
    "s==lit": lambda c, m: c("s") == m.lit("fig"),
    "s<lit": lambda c, m: c("s") < m.lit("date"),
    "s>=lit": lambda c, m: c("s") >= m.lit("grape"),
    "s>t": lambda c, m: c("s") > c("t"),
    "s==t": lambda c, m: c("s") == c("t"),
}
DATE = {F: T.DATE, JF: JT.DATE}


@pytest.mark.parametrize("name", sorted(_PREDICATES))
def test_predicates_match_reference(typed_table, name):
    pred = _PREDICATES[name]
    got = (TorchSession(device="cpu").read_parquet(typed_table)
           .filter(pred(F.col, F)).collect())
    want = (TpuSession().read_parquet(typed_table)
            .filter(pred(JF.col, JF)).collect())
    assert _rows(got) == _rows(want)
    assert 0 < got.num_rows < 400


def test_predicates_projected_with_nulls_match_reference(typed_table):
    """The comparison's own value (null where an operand is null)."""
    def run(spark, Fm):
        c = Fm.col
        return (spark.read_parquet(typed_table)
                .select((c("i") < c("l")).alias("a"),
                        (c("s") == Fm.lit("kiwi")).alias("b"),
                        (c("x") >= Fm.lit(0.0)).alias("c")).collect())
    got = run(TorchSession(device="cpu"), F)
    want = run(TpuSession(), JF)
    assert _rows(got) == _rows(want)
    assert any(None in r for r in _rows(got))


# -- what is not ported raises while the plan is built ----------------------

@pytest.fixture
def two_tables(tmp_path):
    spark = TorchSession(device="cpu")
    pq.write_table(pa.table({"k": pa.array([1, 2], pa.int64()),
                             "j": pa.array([1, 2], pa.int32()),
                             "s": ["a", "b"], "x": [1.0, 2.0]}),
                   str(tmp_path / "a.parquet"))
    pq.write_table(pa.table({"k": pa.array([2, 3], pa.int64()),
                             "j": pa.array([1, 5], pa.int32()),
                             "s": ["b", "c"], "x": [2.0, 3.0]}),
                   str(tmp_path / "b.parquet"))
    return (spark.read_parquet(str(tmp_path / "a.parquet")),
            spark.read_parquet(str(tmp_path / "b.parquet")))


@pytest.mark.parametrize("shape", [
    "two keys", "string key", "double key", "right", "full", "condition",
    "keyless", "cross"])
def test_unported_join_shapes_raise_at_planning(two_tables, shape):
    a, b = two_tables
    # several keys and string or double keys take the rank path
    # (tests/test_torch_rank_join.py); a key pair of unlike types does not
    # plan
    def unlike(lk, rk):
        from spark_rapids_tpu_torch.plan import nodes as NN
        from spark_rapids_tpu_torch.session import DataFrame
        return DataFrame(NN.JoinNode(a._plan, b._plan,
                                     [F.col(x) for x in lk],
                                     [F.col(x) for x in rk]), a.session)
    build = {
        "two keys": lambda: unlike(["k", "j"], ["k", "s"]),
        "string key": lambda: unlike(["s"], ["k"]),
        "double key": lambda: unlike(["x"], ["k"]),
        # right and full outer joins and an inner join's residual condition
        # are ported (tests/test_torch_outer_joins.py); a residual condition
        # on an outer equi-join is not, as in the reference's tag_join
        "right": lambda: a.join(b, on="k", how="right",
                                condition=F.col("x") <= F.lit(2.0)),
        "full": lambda: a.join(b, on="k", how="full",
                               condition=F.col("x") <= F.lit(2.0)),
        "condition": lambda: a.join(b, on="k", how="left",
                                    condition=F.col("x") <= F.lit(2.0)),
        # keyless and cross joins plan the nested-loop join
        # (tests/test_torch_nested_loop.py); its right outer shape does not
        "keyless": lambda: a.join(b, how="right"),
        "cross": lambda: a.join(b, how="right",
                                condition=F.col("x") <= F.lit(2.0)),
    }[shape]
    with pytest.raises(NotImplementedError):
        build().physical_plan()


def test_mesh_and_unported_operators_raise():
    with pytest.raises(NotImplementedError):
        TorchSession({"spark.rapids.tpu.mesh.enabled": "true"}, device="cpu")
    # NotEqual, Or and Not are ported with the SQL slice, / with the window
    # slice, unary minus with the outer joins; these are not
    with pytest.raises(NotImplementedError):
        _ = (-(F.col("x") <= F.lit(1.0))).dtype
    # the untyped null is ported since the expression slice; a list literal
    # is not
    with pytest.raises(NotImplementedError):
        F.lit([1, 2])


def test_comparing_a_string_with_a_number_raises_at_planning(two_tables):
    a, _ = two_tables
    with pytest.raises(NotImplementedError):
        a.filter(F.col("s") == F.lit(1)).physical_plan()


def test_ported_join_plans_a_broadcast_over_the_smaller_side(two_tables,
                                                             tmp_path):
    a, b = two_tables
    plan = a.join(b, on="k").physical_plan()
    join = plan.child
    assert isinstance(join, XJ.BroadcastHashJoinExec)
    assert join.build_side == "right"     # equal estimates: the right one
    pq.write_table(pa.table({"k": pa.array(np.arange(10), pa.int64())}),
                   str(tmp_path / "big.parquet"))
    big = TorchSession(device="cpu").read_parquet(str(tmp_path / "big.parquet"))
    assert a.join(big, on="k").physical_plan().child.build_side == "left"
    assert _rows(a.join(big, on="k").collect()) == [(1, 1, "a", 1.0),
                                                     (2, 2, "b", 2.0)]
