"""The group-by's remainder in the PyTorch port on the CPU, held against the
JAX package and against the port's own unpacked, unchained route.

- ``ops/sorting.py``'s three tiers: ``_packed_key`` bit for bit the
  reference's (the key operand itself), and the packed and wide tiers'
  permutations bit for bit the reference's ``sort_permutation`` and the
  port's multi-pass one, on random keys with nulls, NaN, -0.0, padding,
  descending order, nulls last, dictionaries of several sizes and the
  range hint at the edge of what fits;
- the aggregate's key probe with its range hint, the right-sizing
  (``ops/filtering.maybe_host_resize``), the group-by chain and HAVING
  fusion: each bit for bit the route that ``stageFusion.enabled=false``
  (or the chain's own conf) gives, and equal to ``TpuSession``; a
  forced capacity mispredict redone unchained; no ``FilterExec`` under a
  fused HAVING.

The numpy inputs come from a seed. Tolerance: none (integer and float
results are compared bit for bit).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (64-bit jax)
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr.core import Col as JCol
from spark_rapids_tpu.ops import sorting as RS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.ops import concat as CC
from spark_rapids_tpu_torch.ops import filtering as FL
from spark_rapids_tpu_torch.ops import sorting as S
from spark_rapids_tpu_torch.session import TorchSession

FUSION = "spark.rapids.tpu.sql.stageFusion.enabled"
CHAIN = "spark.rapids.tpu.sql.stageFusion.groupBy.chain.enabled"
BATCH_ROWS = "spark.rapids.tpu.sql.reader.batchSizeRows"


# -- the sort tiers --------------------------------------------------------------

KINDS = {
    # (port dtype, reference dtype, numpy values for a capacity)
    "int": (T.INT, JT.INT, lambda g, n: g.integers(-2**31, 2**31, n,
                                                   dtype=np.int32)),
    "int-few": (T.INT, JT.INT, lambda g, n: g.integers(-3, 3, n,
                                                       dtype=np.int32)),
    "short": (T.SHORT, JT.SHORT, lambda g, n: g.integers(-5, 5, n,
                                                         dtype=np.int16)),
    "date": (T.DATE, JT.DATE, lambda g, n: g.integers(0, 9, n,
                                                      dtype=np.int32)),
    "bool": (T.BOOLEAN, JT.BOOLEAN, lambda g, n: g.random(n) < 0.5),
    "long": (T.LONG, JT.LONG, lambda g, n: g.choice(
        np.array([np.iinfo(np.int64).min, -1, 0, 7, np.iinfo(np.int64).max],
                 np.int64), n)),
    "timestamp": (T.TIMESTAMP, JT.TIMESTAMP, lambda g, n: g.integers(
        -2**62, 2**62, n, dtype=np.int64)),
    "double": (T.DOUBLE, JT.DOUBLE, lambda g, n: g.choice(
        np.array([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf]), n)),
}
DICT_SIZES = {"dict1": 1, "dict2": 2, "dict3": 3, "dict300": 300,
              "dict70000": 70000}


def _keys(rng, kind: str, capacity: int, num_rows: int):
    """A key column in both packages: nulls among the live rows, padding
    rows invalid and at the canonical default."""
    valid = rng.random(capacity) > 0.2
    valid[num_rows:] = False
    if kind in DICT_SIZES:
        d = DICT_SIZES[kind]
        dictionary = pa.array([f"w{i:06d}" for i in range(d)])
        v = rng.integers(0, d, capacity).astype(np.int32)
        v[~valid] = 0
        return (Col(torch.from_numpy(v), torch.from_numpy(valid), T.STRING,
                    dictionary),
                JCol(jnp.asarray(v), jnp.asarray(valid), JT.STRING,
                     dictionary))
    pt, jt, make = KINDS[kind]
    v = make(rng, capacity)
    v = np.where(valid, v, np.zeros((), v.dtype))
    return (Col(torch.from_numpy(v.copy()), torch.from_numpy(valid), pt),
            JCol(jnp.asarray(v), jnp.asarray(valid), jt))


CASES = [("int",), ("int-few",), ("short",), ("date",), ("bool",),
         ("dict1",), ("dict2",), ("dict3",), ("dict300",), ("dict70000",),
         ("dict3", "int-few"), ("bool", "dict300", "short"),
         ("long",), ("timestamp",), ("double",), ("int-few", "long"),
         ("dict3", "double"), ("int", "int")]
ORDERS = [(True, None), (False, None), (True, False), (False, True)]


@pytest.mark.parametrize("asc,nf", ORDERS)
@pytest.mark.parametrize("kinds", CASES, ids="-".join)
def test_sort_permutation_tiers_match_reference(kinds, asc, nf):
    rng = np.random.default_rng(abs(hash((kinds, asc, nf))) % 2**32)
    capacity, num_rows = 256, 201
    cols = [_keys(rng, k, capacity, num_rows) for k in kinds]
    mine = [c[0] for c in cols]
    orders = [S.SortOrder(asc, nf) for _ in kinds]
    got = S.sort_permutation(mine, orders, num_rows, capacity).numpy()
    want = np.asarray(RS.sort_permutation(
        [c[1] for c in cols], [RS.SortOrder(asc, nf) for _ in kinds],
        num_rows, capacity))
    assert np.array_equal(got, want)
    multi = S.multi_permutation(mine, orders, num_rows, capacity).numpy()
    assert np.array_equal(got, multi)
    packed = RS._packed_key([c[1] for c in cols],
                            [RS.SortOrder(asc, nf) for _ in kinds],
                            num_rows, capacity)
    tier = S.sort_tier(mine, capacity)
    if packed is None:
        assert tier == ("wide" if len(kinds) == 1
                        and kinds[0] in ("long", "timestamp") else "multi")
    else:
        key, bits = S._packed_key(mine, orders, num_rows, capacity)
        assert bits == packed[1] and tier == "packed"
        assert np.array_equal(key.numpy(), np.asarray(packed[0]))


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("edge", ["fits", "one-over"])
def test_range_hint_at_the_edge_of_fits(asc, edge):
    """A 64-bit key whose range is exactly the packed key's value bits
    (``2^w - 1``) packs as ``value - vmin`` bit for bit the reference's;
    one more and the aggregate's probe says it does not fit, so the wide
    tier takes it. Both give the multi-pass permutation."""
    rng = np.random.default_rng(3)
    capacity, num_rows = 1 << 17, 100_003
    w = 62 - S._iota_bits(capacity) - 1
    span = (1 << w) - 1 + (edge == "one-over")
    vmin = -(1 << 40)
    v = vmin + rng.integers(0, span + 1, capacity, dtype=np.int64)
    v[:2] = [vmin, vmin + span]
    valid = rng.random(capacity) > 0.1
    valid[:2] = True
    valid[num_rows:] = False
    v = np.where(valid, v, 0)
    mine = Col(torch.from_numpy(v), torch.from_numpy(valid), T.LONG)
    ref = JCol(jnp.asarray(v), jnp.asarray(valid), JT.LONG)
    fits = span < (1 << w)
    hint = (vmin, True) if fits else None
    o = [S.SortOrder(asc)]
    got = S.sort_permutation([mine], o, num_rows, capacity, range_hint=hint)
    assert S.sort_tier([mine], capacity, hint) == ("packed" if fits
                                                   else "wide")
    want = RS.sort_permutation([ref], [RS.SortOrder(asc)], num_rows,
                               capacity, range_hint=(
                                   jnp.int64(vmin), True) if fits else None)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, S.multi_permutation([mine], o, num_rows,
                                                capacity))
    if fits:
        key, _ = S._packed_key([mine], o, num_rows, capacity, hint)
        rkey, _ = RS._packed_key([ref], [RS.SortOrder(asc)], num_rows,
                                 capacity, (jnp.int64(vmin), True))
        assert np.array_equal(key.numpy(), np.asarray(rkey))


def test_sort_by_a_nested_key_packs():
    """A single array key sorts as its int32 rank column: the packed tier,
    one operand."""
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    at = pa.list_(pa.int64())
    vec = array_to_device(pa.array([[2], None, [1, 1], [], [1]], at),
                          T.from_arrow_type(at), None, "cpu")
    c = Col.from_vector(vec)
    assert S.sort_tier([c], vec.capacity) == "packed"
    perm = S.sort_permutation([c], [S.SortOrder()], 5, vec.capacity)
    assert perm[:5].tolist() == [1, 3, 4, 2, 0]
    assert torch.equal(perm, S.multi_permutation([c], [S.SortOrder()], 5,
                                                 vec.capacity))


# -- right-sizing and the device-count concat ---------------------------------

def test_maybe_host_resize():
    cap = 1 << 16
    vals = torch.zeros(cap, dtype=torch.int64)
    vals[:10] = torch.arange(10)
    valid = torch.arange(cap) < 10
    col = Col(vals, valid, T.LONG)
    out, n = FL.maybe_host_resize([col], 10)
    assert n == 10 and out[0].values.shape[0] == 16
    assert torch.equal(out[0].values, vals[:16])
    assert FL.maybe_host_resize([col], (1 << 14) + 1) is None  # under 4x
    small = Col(vals[:cap // 2], valid[:cap // 2], T.LONG)
    assert FL.maybe_host_resize([small], 10) is None         # under 2^16
    assert FL.maybe_host_resize([small], 10, min_capacity=0)[0][0]. \
        values.shape[0] == 16


def test_concat_at_matches_concat_cols():
    rng = np.random.default_rng(4)
    a_vals = torch.from_numpy(rng.integers(0, 3, 16).astype(np.int32))
    b_vals = torch.from_numpy(rng.integers(0, 2, 32).astype(np.int32))
    a = Col(a_vals, torch.arange(16) < 11, T.STRING, pa.array(["a", "c",
                                                                "e"]))
    b = Col(b_vals, torch.arange(32) < 20, T.STRING, pa.array(["b", "c"]))
    a = a.canonicalized()
    b = b.canonicalized()
    want = CC.concat_cols([a, b], [11, 20], 32)
    got = CC.concat_at(a, b, 11, torch.tensor(20), 32)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.validity, want.validity)
    assert got.dictionary.equals(want.dictionary)


# -- the aggregate: probe, chain, right-sizing, HAVING -----------------------------

def _frame(spark, path):
    c = F.col
    return spark.read_parquet(path).group_by(c("k")).agg(
        F.sum(c("x")).alias("sx"), F.avg(c("x")).alias("ax"),
        F.count(c("x")).alias("n"), F.min(c("x")).alias("lo"),
        F.max(c("y")).alias("hi"), F.first(c("s")).alias("f"),
        F.last(c("y")).alias("l"), F.stddev_samp(c("x")).alias("sd"))


def _ref_frame(path):
    c = JF.col
    return TpuSession().read_parquet(path).group_by(c("k")).agg(
        JF.sum(c("x")).alias("sx"), JF.avg(c("x")).alias("ax"),
        JF.count(c("x")).alias("n"), JF.min(c("x")).alias("lo"),
        JF.max(c("y")).alias("hi"), JF.first(c("s")).alias("f"),
        JF.last(c("y")).alias("l"), JF.stddev_samp(c("x")).alias("sd"))


def _bits(t: pa.Table) -> list:
    """Rows by key, every double as its bits."""
    t = t.sort_by("k")
    out = []
    for name in t.column_names:
        col = t.column(name).combine_chunks()
        if pa.types.is_floating(col.type):
            out.append((name, col.is_null().to_pylist(),
                        np.asarray(col.fill_null(0.0)).view(
                            np.int64).tolist()))
        else:
            out.append((name, col.to_pylist()))
    return out


def _agg(plan) -> HashAggregateExec:
    (agg,) = [p for p in _walk(plan) if isinstance(p, HashAggregateExec)]
    return agg


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def _run(conf: dict, path, make=_frame):
    spark = TorchSession({BATCH_ROWS: "3000", **conf}, device="cpu")
    plan = make(spark, path).physical_plan()
    return plan.execute_collect(), _agg(plan)


def _table(rng, n: int, keys) -> pa.Table:
    x = rng.normal(size=n) * 1e6
    x[rng.random(n) < 0.05] = np.nan
    x[rng.random(n) < 0.05] = -0.0
    return pa.table({
        "k": pa.array(keys, pa.int64()),
        "x": pa.array(np.where(rng.random(n) < 0.1, None, x).tolist(),
                      pa.float64()),
        "y": pa.array(rng.integers(-9, 9, n), pa.int64()),
        "s": pa.array(np.array(["a", "b", None, "d"], object)[
            rng.integers(0, 4, n)].tolist())})


@pytest.fixture(scope="module")
def chain_files(tmp_path_factory):
    """Two files: ``steady`` (every batch of 3000 rows over the same ~700
    keys, so the chain's prediction holds) and ``burst`` (a first batch
    of 4 keys, then batches of ~2900 fresh keys each: the first chained
    step's predicted bucket is too small)."""
    d = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(19)
    n = 12_000
    steady = _table(rng, n, rng.integers(0, 700, n))
    burst_keys = np.concatenate([rng.integers(0, 4, 3000),
                                 rng.integers(10, 9000, n - 3000)])
    burst = _table(rng, n, burst_keys)
    out = {}
    for name, t in (("steady", steady), ("burst", burst)):
        path = str(d / f"{name}.parquet")
        pq.write_table(t, path, row_group_size=3000)
        out[name] = path
    return out


@pytest.mark.parametrize("name", ["steady", "burst"])
def test_chained_group_by_is_the_unchained_one_bit_for_bit(chain_files,
                                                           name):
    path = chain_files[name]
    got, agg = _run({}, path)
    want, plain = _run({CHAIN: "false"}, path)
    assert _bits(got) == _bits(want)
    st = agg.stats
    # a mispredicted step counts its update and merge, and so does its redo
    assert st["updates"] == 4 + st["mispredicted"]
    assert st["merges"] == 3 + st["mispredicted"]
    assert plain.stats["chained"] == 0
    if name == "steady":
        assert st["chained"] == 3 and st["mispredicted"] == 0
        # one readback a chained step, one group count a call otherwise
        assert st["syncs"] == 1 + 3
    else:
        assert st["mispredicted"] >= 1 and st["chained"] >= 1
    # the reference's stddev takes another order of float adds (held to it
    # within a tolerance in tests/test_torch_stat_aggs.py)
    ref = _ref_frame(path).collect()
    assert _bits(got.drop(["sd"])) == _bits(ref.drop(["sd"]))


def test_a_forced_mispredict_is_redone_unchained(chain_files):
    """A predicted bucket other than the true one is refused by the step
    itself; the caller then redoes the batch unchained."""
    spark = TorchSession({BATCH_ROWS: "3000"}, device="cpu")
    plan = _frame(spark, chain_files["steady"]).physical_plan()
    agg = _agg(plan)
    batches = list(agg.child.execute_partition(0))
    acc = agg._aggregate_batch(batches[0], merge=False)
    A = acc.num_rows
    accepted, merged, mg_n, upd_n = agg._chain_step(acc, batches[1], A,
                                                    pred_P=100_000)
    assert not accepted and merged is None
    assert bucket_capacity(A + 100_000) != bucket_capacity(A + upd_n)
    assert agg.stats["mispredicted"] == 1
    ok, merged, mg_n2, _ = agg._chain_step(acc, batches[1], A, upd_n)
    assert ok and mg_n2 == mg_n
    from spark_rapids_tpu_torch.ops.concat import concat_batches
    part = agg._aggregate_batch(batches[1], merge=False)
    want = agg._aggregate_batch(concat_batches([acc, part]), merge=True)
    assert want.num_rows == merged.num_rows
    for a, b in zip(merged.columns, want.columns):
        bits = (lambda t: t.view(torch.int64) if t.is_floating_point()
                else t)
        assert torch.equal(bits(a.data), bits(b.data))
        assert torch.equal(a.validity, b.validity)


def test_chain_leaves_nested_and_final_aggregates_unchained(chain_files):
    spark = TorchSession({BATCH_ROWS: "3000"}, device="cpu")
    df = spark.read_parquet(chain_files["steady"]).group_by("k").agg(
        F.collect_list("y").alias("ys"))
    plan = df.physical_plan()
    plan.execute_collect()
    assert _agg(plan).stats["chained"] == 0
    two = spark.read_parquet([chain_files["steady"], chain_files["burst"]])
    plan = two.group_by("k").agg(F.sum("y").alias("s")).physical_plan()
    plan.execute_collect()
    final = [p for p in _walk(plan) if isinstance(p, HashAggregateExec)
             and p.mode == "final"]
    assert final and all(a.stats["chained"] == 0 for a in final)


@pytest.fixture(scope="module")
def big_file(tmp_path_factory):
    """150,000 rows in one batch (capacity 2^18): an unsorted int64 key
    whose range fits the packed key, a timestamp key, and a key already
    sorted."""
    rng = np.random.default_rng(23)
    n = 150_000
    k = rng.integers(-(1 << 45), -(1 << 45) + 40_000, n)
    t = pa.table({
        "k": pa.array(k, pa.int64()),
        "ts": pa.array(k * 1000, pa.timestamp("us", tz="UTC")),
        "o": pa.array(np.sort(rng.integers(0, 50_000, n)), pa.int64()),
        "x": pa.array(rng.normal(size=n), pa.float64())})
    path = str(tmp_path_factory.mktemp("big") / "big.parquet")
    pq.write_table(t, path)
    return path


@pytest.mark.parametrize("key,want_path", [("k", "packed"),
                                           ("ts", "packed"),
                                           ("o", "presorted")])
def test_range_hint_packs_a_wide_key(big_file, key, want_path):
    """The probe's range packs the 64-bit key into one operand (the
    sorted key skips the sort); the result is the unpacked route's bit for
    bit (``stageFusion.enabled=false``: the wide tier), and the partial is
    right-sized at its group count."""
    def make(spark, path):
        return spark.read_parquet(path).group_by(key).agg(
            F.sum("x").alias("s"), F.count("x").alias("n"))
    spark = TorchSession({BATCH_ROWS: str(1 << 20)}, device="cpu")
    plan = make(spark, big_file).physical_plan()
    got = plan.execute_collect()
    agg = _agg(plan)
    off = TorchSession({BATCH_ROWS: str(1 << 20), FUSION: "false"},
                       device="cpu")
    plan_off = make(off, big_file).physical_plan()
    want = plan_off.execute_collect()
    assert got.sort_by(key).equals(want.sort_by(key))
    st, st_off = agg.stats, _agg(plan_off).stats
    assert st["probes"] == 1 and st_off["probes"] == 0
    if want_path == "presorted":
        assert st["presorted"] == 1 and st["hinted"] == 0
    else:
        assert st["tiers"]["packed"] == 1 and st["hinted"] == 1
        assert st_off["tiers"]["wide"] == 1
    assert st["syncs"] == 2 and st_off["syncs"] == 1


def test_right_sizing_lands_the_partial_at_its_bucket(big_file):
    spark = TorchSession({BATCH_ROWS: str(1 << 20)}, device="cpu")
    df = spark.read_parquet(big_file).group_by("o").agg(
        F.count("x").alias("n"))
    plan = df.physical_plan()
    agg = _agg(plan)
    batch = next(iter(agg.child.execute_partition(0)))
    out = agg._aggregate_batch(batch, merge=False)
    assert batch.capacity == 1 << 18
    assert out.capacity == bucket_capacity(out.num_rows) < batch.capacity


# -- HAVING fusion -------------------------------------------------------------------

def _having(fns, df):
    c = fns.col
    return df.group_by(c("k")).agg(fns.sum(c("y")).alias("s"),
                                   fns.count(c("x")).alias("n")).filter(
        (c("s") > 5) & (c("n") >= 3))


@pytest.mark.parametrize("parts", [1, 3])
def test_having_folds_into_the_aggregate(chain_files, parts):
    """No FilterExec in the plan, the predicate on the (COMPLETE or FINAL)
    aggregate, and the reference's rows; ``stageFusion.enabled=false``
    plans the FilterExec and gives the same rows."""
    t = pq.read_table(chain_files["burst"])
    port = _having(F, TorchSession(device="cpu").create_dataframe(t, parts))
    plan = port.physical_plan()
    assert not [p for p in _walk(plan) if isinstance(p, XB.FilterExec)]
    fused = [p for p in _walk(plan) if isinstance(p, HashAggregateExec)
             and p.postfilter is not None]
    assert len(fused) == 1 and fused[0].mode in ("complete", "final")
    got = plan.execute_collect()
    want = _having(JF, TpuSession().create_dataframe(t, parts)).collect()
    assert got.sort_by("k").to_pylist() == want.sort_by("k").to_pylist()
    assert 0 < got.num_rows < len(set(t.column("k").to_pylist()))
    off = _having(F, TorchSession({FUSION: "false"}, device="cpu")
                  .create_dataframe(t, parts))
    plan_off = off.physical_plan()
    assert [p for p in _walk(plan_off) if isinstance(p, XB.FilterExec)]
    assert plan_off.execute_collect().sort_by("k").equals(got.sort_by("k"))


def test_having_over_a_partial_or_with_rand_stays_a_filter(chain_files):
    t = pq.read_table(chain_files["steady"])
    spark = TorchSession(device="cpu")
    df = spark.create_dataframe(t, 1).group_by("k").agg(
        F.sum("y").alias("s")).filter(F.rand(3) < 0.5)
    plan = df.physical_plan()
    assert isinstance(plan, XB.FilterExec)
    assert plan.child.postfilter is None


def test_having_on_sql_text(chain_files):
    t = pq.read_table(chain_files["steady"])
    spark = TorchSession(device="cpu")
    spark.create_or_replace_temp_view("t", spark.create_dataframe(t, 2))
    q = "select k, count(*) c from t group by k having count(*) > 18"
    df = spark.sql(q)
    plan = df.physical_plan()
    assert not [p for p in _walk(plan) if isinstance(p, XB.FilterExec)]
    got = plan.execute_collect()
    counts = pa.table({"k": t.column("k")}).group_by("k").aggregate(
        [("k", "count")])
    want = {k: c for k, c in zip(counts.column("k").to_pylist(),
                                 counts.column("k_count").to_pylist())
            if c > 18}
    assert dict(zip(got.column("k").to_pylist(),
                    got.column("c").to_pylist())) == want


# -- float grouping keys (ROADMAP Queue 3) -----------------------------------

@pytest.mark.parametrize("dtype", [pa.float64(), pa.float32()])
@pytest.mark.parametrize("first", [0.0, -0.0])
def test_gap_float_group_keys_are_normalized(dtype, first):
    """Spark's NormalizeFloatingNumbers: -0.0 and 0.0 group together and the
    key comes out 0.0, and every NaN comes out as the canonical NaN,
    whichever row comes first; in ``group_by`` and in ``distinct()``. The
    reference outputs the first row's key."""
    import struct
    import spark_rapids_tpu.functions as JF_
    from spark_rapids_tpu.session import TpuSession
    import spark_rapids_tpu_torch.functions as F_
    from spark_rapids_tpu_torch.session import TorchSession
    other = 0.0 if first == -0.0 else -0.0
    # two NaN payloads: the quiet one and one with its sign bit set
    nan2 = struct.unpack("<d", struct.pack("<Q", 0xFFF8000000000001))[0]
    vals = [first, other, other, first, float("nan"), nan2, 1.5]
    t = pa.table({"x": pa.array(vals, dtype),
                  "v": pa.array(range(len(vals)), pa.int64())})

    def bits(xs):
        fmt, code = ("<d", "<Q") if dtype == pa.float64() else ("<f", "<I")
        return [struct.unpack(code, struct.pack(fmt, x))[0] for x in xs]

    spark = TorchSession(device="cpu")
    df = spark.create_dataframe(t, num_partitions=2)
    grouped = df.group_by("x").agg(F_.sum(F_.col("v")).alias("s")).collect()
    distinct = df.select("x").distinct().collect()
    canon = sorted(bits([0.0, float("nan"), 1.5]))
    assert sorted(bits(grouped.column("x").to_pylist())) == canon
    assert sorted(bits(distinct.column("x").to_pylist())) == canon
    # by key bits: 0.0 (rows 0-3), 1.5 (row 6), NaN (rows 4-5)
    by_key = sorted(zip(bits(grouped.column("x").to_pylist()),
                        grouped.column("s").to_pylist()))
    assert [s for _, s in by_key] == [6, 6, 9]
    ref = TpuSession().create_dataframe(t).group_by("x").agg(
        JF_.sum(JF_.col("v")).alias("s")).collect()
    zero = [x for x in ref.column("x").to_pylist() if x == 0.0]
    # the reference keeps the sign of the first row's zero
    assert struct.pack("<d", zero[0]) == struct.pack("<d", first)
