"""The order over whole nested values in the PyTorch port on the CPU, held
against the JAX package's host path and against Spark's ordering.

- ``ops/nested.order_ranks`` against a Python implementation of Spark's
  interpreted ordering (arrays element by element, a null element first,
  a prefix before the longer array; structs field by field, a null field
  first; NaN largest, -0.0 equal to 0.0) on random nested values, against
  ``ops/nested.equiv``, and its rank passes (prefix doubling);
- ``max``/``min`` of arrays of ints, doubles, strings and dates and of
  arrays of arrays, ``collect_set`` of arrays, structs and arrays of
  structs, and a sort by an array key in every direction and null order,
  through ``TorchSession(device="cpu")`` and ``TpuSession`` on the same
  arrow tables: one partition, three partitions (PARTIAL -> exchange ->
  FINAL) and several batches a partition (a parquet file read in small
  batches); null rows, empty arrays, prefixes and -0.0 throughout;
- the refusals this slice keeps, at planning;
- ``test_gap_*``: Spark's answer beside the reference's where they differ
  (its host comparator raises on a null element and mis-orders NaN, and
  its ``collect_set`` keeps the first-seen order and tells -0.0 from 0.0).

The numpy inputs come from a seed. Tolerance: none (every value is
compared exactly).
"""

from __future__ import annotations

import datetime
import functools
import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.plan import nodes as JNN
from spark_rapids_tpu.session import DataFrame as JDataFrame
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import array_to_device
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.ops import nested as N
from spark_rapids_tpu_torch.ops.sorting import SortOrder
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.session import DataFrame, TorchSession


def spark_cmp(a, b) -> int:
    """Spark's interpreted ordering of two values (ascending, a null
    first at every level)."""
    if a is None or b is None:
        return (a is not None) - (b is not None)
    if isinstance(a, list):
        for x, y in zip(a, b):
            c = spark_cmp(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    if isinstance(a, dict):
        for k in a:
            c = spark_cmp(a[k], b[k])
            if c:
                return c
        return 0
    if isinstance(a, float):
        an, bn = math.isnan(a), math.isnan(b)
        if an or bn:
            return an - bn
    return (a > b) - (a < b)


WORDS = ["alpha", "beta", "", "déjà vu", "x y"]
DAY0 = datetime.date(2020, 1, 1)


def nested_values(seed: int, n: int, null_elements: bool = False,
                  nan: bool = False) -> dict:
    """Columns of ``n`` rows as Python lists: ``k`` (a group key in 0..5),
    ``ai`` (array<bigint>), ``ad`` (array<double> with -0.0), ``aw``
    (array<string>), ``at`` (array<date>), ``aa`` (array<array<bigint>>),
    ``st`` (struct<x: bigint, y: string>) and ``as_`` (array<struct>).
    Null rows, empty arrays and short arrays (so prefixes are frequent);
    null elements with ``null_elements``, NaN with ``nan``."""
    rng = np.random.default_rng(seed)

    def maybe(f, p=0.1):
        return None if rng.random() < p else f()

    def elem(f):
        return maybe(f, 0.15) if null_elements else f()

    def lst(f, hi=4, nullable=True):
        r = rng.random()
        if r < 0.1:
            return None if nullable else []
        if r < 0.2:
            return []
        return [f() for _ in range(int(rng.integers(1, hi)))]

    doubles = [0.5, -0.0, 0.0, 2.25, -1.0] + ([float("nan")] if nan else [])
    st = lambda: maybe(lambda: {  # noqa: E731
        "x": maybe(lambda: int(rng.integers(0, 3))),
        "y": maybe(lambda: WORDS[int(rng.integers(0, 3))])})
    make = {
        "ai": lambda: lst(lambda: elem(lambda: int(rng.integers(0, 3)))),
        "ad": lambda: lst(lambda: elem(
            lambda: float(doubles[int(rng.integers(0, len(doubles)))]))),
        "aw": lambda: lst(lambda: elem(
            lambda: WORDS[int(rng.integers(0, len(WORDS)))])),
        "at": lambda: lst(lambda: elem(
            lambda: DAY0 + datetime.timedelta(int(rng.integers(0, 4))))),
        "aa": lambda: lst(lambda: elem(lambda: lst(
            lambda: elem(lambda: int(rng.integers(0, 3))), 3,
            null_elements)), 3),
        "st": st,
        "as_": lambda: lst(st, 3),
    }
    cols = {"k": [int(x) for x in rng.integers(0, 6, n)]}
    cols.update({c: [f() for _ in range(n)] for c, f in make.items()})
    return cols


ARROW = {"k": pa.int64(), "ai": pa.list_(pa.int64()),
         "ad": pa.list_(pa.float64()), "aw": pa.list_(pa.string()),
         "at": pa.list_(pa.date32()),
         "aa": pa.list_(pa.list_(pa.int64())),
         "st": pa.struct([("x", pa.int64()), ("y", pa.string())])}
ARROW["as_"] = pa.list_(ARROW["st"])


def to_table(cols: dict) -> pa.Table:
    return pa.table({c: pa.array(v, ARROW[c]) for c, v in cols.items()})


def _key(r) -> str:
    return repr(sorted(r.items()))


def _by_key(t: pa.Table) -> list:
    return sorted(t.to_pylist(), key=_key)


@pytest.fixture(scope="module")
def table():
    """Arrays without null elements or NaN: the shapes the reference's host
    comparator answers."""
    return to_table(nested_values(31, 300))


@pytest.fixture(scope="module")
def batched(table, tmp_path_factory):
    """The table in a parquet file of small row groups, read in batches
    of 64 rows by the port."""
    d = tmp_path_factory.mktemp("nested_order")
    path = str(d / "t.parquet")
    pq.write_table(table, path, row_group_size=64)
    return path


def _sessions(parts: int, table, batched):
    """(port frame, reference frame, port session) over one partition,
    three partitions, or the batched parquet file (one partition, several
    batches)."""
    ref = TpuSession().create_dataframe(table, max(parts, 1))
    if parts == 0:
        spark = TorchSession({"spark.rapids.tpu.sql.reader.batchSizeRows":
                              "64"}, device="cpu")
        return spark.read_parquet(batched), ref, spark
    spark = TorchSession(device="cpu")
    return spark.create_dataframe(table, parts), ref, spark


LAYOUTS = {"one-partition": 1, "three-partitions": 3, "batches": 0}


# -- order_ranks ---------------------------------------------------------------

def _device_col(values: list, at: pa.DataType) -> Col:
    t = T.from_arrow_type(at)
    return Col.from_vector(array_to_device(pa.array(values, at), t, None,
                                           "cpu"))


@pytest.mark.parametrize("name", ["ai", "ad", "aw", "at", "aa", "st", "as_"])
def test_order_ranks_follow_spark_ordering(name):
    vals = nested_values(5, 160, null_elements=True, nan=True)[name]
    ranks = N.order_ranks(_device_col(vals, ARROW[name])).numpy()
    n = len(vals)
    assert ranks.min() >= 0 and ranks.max() <= len(ranks)
    for i in range(n):
        for j in range(n):
            want = spark_cmp(vals[i], vals[j])
            got = int(ranks[i] > ranks[j]) - int(ranks[i] < ranks[j])
            assert got == want, (vals[i], vals[j])
        assert (ranks[i] == 0) == (vals[i] is None)


@pytest.mark.parametrize("name", ["ai", "ad", "aa", "st", "as_"])
def test_order_ranks_agree_with_equiv(name):
    """Two rows rank equal exactly where ``equiv`` calls them equal (as a
    nested-value comparison of a column against a shifted copy)."""
    vals = nested_values(7, 200, null_elements=True, nan=True)[name]
    other = vals[1:] + vals[:1]
    both = _device_col(vals + other, ARROW[name])
    ranks = N.order_ranks(both).numpy()
    n = len(vals)
    a = _device_col(vals, ARROW[name])
    b = _device_col(other, ARROW[name])
    eq = N.equiv(a, b).numpy()[:n]
    assert np.array_equal(eq, ranks[:n] == ranks[n:2 * n])
    assert eq.any() and not eq.all()


def test_order_ranks_descending_reverses_values_only():
    vals = [[1, 2], None, [], [1], [0, 5], [1, 2]]
    c = _device_col(vals, pa.list_(pa.int64()))
    up = N.order_ranks(c).numpy()[:6]
    down = N.order_ranks(c, SortOrder(ascending=False)).numpy()[:6]
    assert down[1] == up[1] == 0
    live = [0, 2, 3, 4, 5]
    for i in live:
        for j in live:
            assert (up[i] < up[j]) == (down[i] > down[j])


def test_order_ranks_take_log2_passes_a_list_level():
    """Prefix doubling: a list level of longest length L takes
    ceil(log2(L)) pair passes beside its element pass and its row pass."""
    for longest, rounds in ((1, 0), (2, 1), (5, 3), (16, 4), (17, 5)):
        vals = [list(range(longest)), [3], None, []]
        N.rank_stats.update(calls=0, passes=0)
        N.order_ranks(_device_col(vals, pa.list_(pa.int64())))
        assert N.rank_stats == {"calls": 1, "passes": 2 + rounds}


def test_order_ranks_refuse_a_map():
    c = _device_col([{"a": 1}], pa.map_(pa.string(), pa.int64()))
    with pytest.raises(NotImplementedError, match="map"):
        N.order_ranks(c)


# -- max and min against the reference ---------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", ["ai", "ad", "aw", "at", "aa"])
def test_max_min_of_arrays_match_reference(table, batched, layout, name):
    port, ref, _ = _sessions(LAYOUTS[layout], table, batched)
    got = port.group_by("k").agg(F.max(name).alias("hi"),
                                 F.min(name).alias("lo")).collect()
    want = ref.group_by("k").agg(JF.max(name).alias("hi"),
                                 JF.min(name).alias("lo")).collect()
    assert _by_key(got) == _by_key(want)


def test_max_min_run_over_several_batches(table, batched):
    """The batched layout really aggregates batch by batch (update, concat,
    merge), with min/max of a nested state merged."""
    port, _, _ = _sessions(0, table, batched)
    df = port.group_by("k").agg(F.max("aa").alias("hi"))
    plan = df.physical_plan()
    plan.execute_collect()
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    (agg,) = [p for p in _walk(plan) if isinstance(p, HashAggregateExec)]
    assert agg.stats["updates"] > 1 and agg.stats["merges"] > 0


def test_keyless_max_min_of_arrays(table):
    port = TorchSession(device="cpu").create_dataframe(table, 2)
    ref = TpuSession().create_dataframe(table, 2)
    got = port.agg(F.max("ai").alias("hi"), F.min("aw").alias("lo"))
    want = ref.agg(JF.max("ai").alias("hi"), JF.min("aw").alias("lo"))
    assert got.collect().to_pylist() == want.collect().to_pylist()


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


# -- collect_set against the reference ---------------------------------------

def _as_sets(t: pa.Table, col: str) -> dict:
    return {r["k"]: sorted(map(repr, r[col])) for r in t.to_pylist()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", ["ai", "aw", "aa", "st", "as_"])
def test_collect_set_of_nested_matches_reference(table, batched, layout,
                                                 name):
    """The same set a group (the reference keeps the first-seen order,
    see ``test_gap_collect_set_order``); the port's in Spark's order."""
    port, ref, _ = _sessions(LAYOUTS[layout], table, batched)
    got = port.group_by("k").agg(F.collect_set(name).alias("s")).collect()
    want = ref.group_by("k").agg(JF.collect_set(name).alias("s")).collect()
    assert _as_sets(got, "s") == _as_sets(want, "s")
    for r in got.to_pylist():
        s = r["s"]
        assert all(spark_cmp(a, b) < 0 for a, b in zip(s, s[1:]))


# -- a sort by an array key against the reference ------------------------------

def _sorted(port, ref, name, asc, nf):
    got = DataFrame(NN.SortNode([(E.col(name), asc, nf)], port._plan),
                    port.session).collect()
    want = JDataFrame(JNN.SortNode([(JE.col(name), asc, nf)], ref._plan),
                      ref.session).collect()
    return got, want


@pytest.mark.parametrize("nf", [True, False])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("name", ["ai", "ad", "aw", "at", "aa"])
def test_sort_by_array_key_matches_reference(table, name, asc, nf):
    """Every row in the reference's order, ties in input order (both sorts
    are stable), over three partitions gathered into one."""
    port = TorchSession(device="cpu").create_dataframe(table, 3)
    ref = TpuSession().create_dataframe(table, 3)
    got, want = _sorted(port, ref, name, asc, nf)
    assert got.to_pylist() == want.to_pylist()


def test_sort_by_array_key_and_a_second_key(table):
    port = TorchSession(device="cpu").create_dataframe(table, 2)
    ref = TpuSession().create_dataframe(table, 2)
    got = port.order_by("aa", "k", ascending=[False, True]).collect()
    want = ref.order_by("aa", "k", ascending=[False, True]).collect()
    assert got.to_pylist() == want.to_pylist()


def test_sort_within_partitions_by_array_key(table):
    port = TorchSession(device="cpu").create_dataframe(table, 3)
    ref = TpuSession().create_dataframe(table, 3)
    got = port.sort_within_partitions("ai").collect()
    want = ref.sort_within_partitions("ai").collect()
    assert got.to_pylist() == want.to_pylist()


# -- the refusals this slice keeps -------------------------------------------

def test_kept_refusals_raise_at_planning(table):
    port = TorchSession(device="cpu").create_dataframe(table, 2)
    dim = port.session.create_dataframe(table.select(["ai"]))
    cases = {
        "grouping key": lambda: port.group_by("ai").count(),
        "join key": lambda: port.join(dim, on="ai"),
        "window key": lambda: port.window([F.alias(F.over(
            F.row_number(), ["ai"], ["k"]), "r")]),
        "window order key": lambda: port.window([F.alias(F.over(
            F.row_number(), ["k"], ["ai"]), "r")]),
        "hash partitioning key": lambda: port.repartition(2, "aa"),
        "IN": lambda: port.filter(E.col("ai").isin([[1]])),
        "order comparison": lambda: port.select(
            (E.col("ai") < E.col("ai")).alias("x")),
        "map comparison": lambda: port.select((F.create_map(
            F.lit("a"), F.col("k")) == F.create_map(
            F.lit("a"), F.col("k"))).alias("x")),
        "struct sort key": lambda: port.sort("st"),
        "array<struct> sort key": lambda: port.sort("as_"),
        "min of a struct": lambda: port.group_by("k").agg(F.min("st")),
        "max of an array<struct>": lambda: port.group_by("k").agg(
            F.max("as_")),
        "collect_set of a map": lambda: port.group_by("k").agg(
            F.collect_set(F.create_map(F.lit("a"), F.col("k")))),
    }
    for what, make in cases.items():
        with pytest.raises(NotImplementedError):
            make().physical_plan()
            pytest.fail(f"{what} planned")


# -- where Spark and the reference differ ----------------------------------------

def _spark_extreme(vals, largest: bool):
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    best = vals[0]
    for v in vals[1:]:
        c = spark_cmp(v, best)
        if (c > 0) if largest else (c < 0):
            best = v
    return best


def test_gap_max_min_with_null_elements():
    """Spark orders a null element before every value; the reference's host
    comparator compares ``None < int`` and raises TypeError."""
    cols = nested_values(11, 120, null_elements=True)
    t = to_table({"k": cols["k"], "ai": cols["ai"]})
    ref = TpuSession().create_dataframe(t, 2)
    with pytest.raises(TypeError):
        ref.group_by("k").agg(JF.max("ai").alias("hi")).collect()
    got = TorchSession(device="cpu").create_dataframe(t, 2).group_by(
        "k").agg(F.max("ai").alias("hi"), F.min("ai").alias("lo")).collect()
    for r in got.to_pylist():
        vals = [v for k, v in zip(cols["k"], cols["ai"]) if k == r["k"]]
        assert r["hi"] == _spark_extreme(vals, True)
        assert r["lo"] == _spark_extreme(vals, False)


def test_gap_max_min_with_nan():
    """Spark: NaN is larger than every double, so ``max([1.0], [NaN])`` is
    ``[NaN]``; Python's ``<`` on NaN is always false, and the reference
    keeps the first value it saw."""
    t = to_table({"k": [1, 1, 2, 2], "ad": [[1.0], [float("nan")],
                                           [float("nan"), 0.0], [2.0]]})
    want = TpuSession().create_dataframe(t).group_by("k").agg(
        JF.max("ad").alias("hi"), JF.min("ad").alias("lo")).collect()
    got = TorchSession(device="cpu").create_dataframe(t).group_by("k").agg(
        F.max("ad").alias("hi"), F.min("ad").alias("lo")).sort("k").collect()
    ref = {r["k"]: (r["hi"], r["lo"]) for r in want.to_pylist()}
    assert ref[1] == ([1.0], [1.0])            # the reference
    hi, lo = got.column("hi").to_pylist(), got.column("lo").to_pylist()
    assert math.isnan(hi[0][0]) and lo[0] == [1.0]        # Spark
    assert math.isnan(hi[1][0]) and lo[1] == [2.0]


def test_gap_sort_with_null_elements():
    """A sort by an array key with null elements: Spark orders them first;
    the reference's comparator raises TypeError."""
    cols = nested_values(13, 80, null_elements=True)
    t = to_table({"k": cols["k"], "ai": cols["ai"]})
    port = TorchSession(device="cpu").create_dataframe(t, 2)
    ref = TpuSession().create_dataframe(t, 2)
    with pytest.raises(TypeError):
        ref.sort("ai").collect()
    got = port.sort("ai").collect().column("ai").to_pylist()
    want = sorted(cols["ai"], key=functools.cmp_to_key(spark_cmp))
    assert got == want


def test_gap_collect_set_order():
    """The same set; the reference keeps the first-seen order, the port
    Spark's order of the values (Spark leaves a set's order unspecified)."""
    t = to_table({"k": [1, 1, 1, 1], "ai": [[2], [1, 5], [2], []]})
    want = TpuSession().create_dataframe(t).group_by("k").agg(
        JF.collect_set("ai").alias("s")).collect()
    got = TorchSession(device="cpu").create_dataframe(t).group_by("k").agg(
        F.collect_set("ai").alias("s")).collect()
    assert want.column("s").to_pylist() == [[[2], [1, 5], []]]
    assert got.column("s").to_pylist() == [[[], [1, 5], [2]]]


def test_gap_collect_set_negative_zero():
    """The reference dedupes on ``repr``, so ``[-0.0]`` and ``[0.0]`` stay
    two values; the port dedupes on the order's equality (``equiv``: -0.0
    equals 0.0), as its scalar ``collect_set`` does."""
    t = to_table({"k": [1, 1, 1], "ad": [[-0.0], [0.0], [-0.0]]})
    want = TpuSession().create_dataframe(t).group_by("k").agg(
        JF.collect_set("ad").alias("s")).collect()
    got = TorchSession(device="cpu").create_dataframe(t).group_by("k").agg(
        F.collect_set("ad").alias("s")).collect()
    assert [list(map(repr, v)) for v in want.column("s")[0].as_py()] == \
        [["-0.0"], ["0.0"]]
    assert len(got.column("s")[0].as_py()) == 1
