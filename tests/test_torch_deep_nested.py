"""Nested elements and fields in the PyTorch port on the CPU (arrays of
structs, arrays of arrays, structs of arrays, maps of arrays), held against
the JAX package.

- the types and the arrow bridge: nested types to any depth both ways,
  a map key kept scalar; a list of lists' buffers level for level the
  reference's ``ListVector``;
- ``ops/nested.py`` over nested children (gather, concat, a row slice,
  ``select_rows``, ``equiv``, ``interleave``) against pyarrow on the host;
- through ``TorchSession(device="cpu")`` and ``TpuSession`` on the same
  arrow tables (the reference's host path answers these): explode and
  posexplode, ``outer`` or not, of ``array<struct>`` and ``array<array>``;
  ``collect_list``, ``first`` and ``last`` of nested values; ``If``,
  ``CaseWhen`` and ``Coalesce`` over them; equality and null-safe
  equality over arrays of arrays and of doubles; the extractions through nested levels;
  ``struct(..)`` and ``array(..)`` over nested arguments; ROLLUP, CUBE and
  GROUPING SETS carrying a nested column; nested payload through filter, sort, limit, a join and
  a hash exchange;
- Parquet and ORC round trips of nested-of-nested columns, held to their
  source under pyarrow's reader (the reference reads no map);
- every refusal this slice keeps raises ``NotImplementedError`` at
  planning;
- ``test_gap_*``: Spark's answer where the reference's differs (its host
  equality raises on structs and on a null inner array, and calls an
  array holding a NaN equal to other values).

The numpy inputs come from a seed. Tolerance: none (integers, strings,
doubles without arithmetic, lists and structs are compared exactly).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.orc as porc
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.expr.predicates import EqualNullSafe as JEqualNullSafe
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import array_to_device
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.expr.predicates import EqualNullSafe
from spark_rapids_tpu_torch.ops import nested as N
from spark_rapids_tpu_torch.session import TorchSession
from test_torch_gpu import deep_nested_table


def _key(r) -> str:
    return repr(sorted(r.items()))


def _rows(t: pa.Table) -> list:
    return sorted(t.to_pylist(), key=_key)


@pytest.fixture(scope="module")
def table():
    return deep_nested_table(31, 400)


@pytest.fixture(scope="module")
def frames(table):
    """The port over the table (maps included), the reference over the
    table without its map column (it reads no map), three partitions."""
    return (TorchSession(device="cpu").create_dataframe(table, 3),
            TpuSession().create_dataframe(table.drop(["ms"]), 3))


# -- types and the arrow bridge ------------------------------------------------

_ST = pa.struct([("x", pa.int64()), ("y", pa.string())])


@pytest.mark.parametrize("at", [
    pa.list_(pa.list_(pa.int64())), pa.list_(_ST),
    pa.struct([("f", pa.list_(pa.int64())), ("g", _ST)]),
    pa.map_(pa.string(), pa.list_(pa.int64())),
    pa.list_(pa.list_(pa.list_(pa.string()))),
    pa.list_(pa.map_(pa.string(), _ST))], ids=str)
def test_nested_types_map_both_ways(at):
    assert T.to_arrow_type(T.from_arrow_type(at)) == at


def test_a_nested_map_key_is_refused():
    with pytest.raises(NotImplementedError, match="map key"):
        T.from_arrow_type(pa.map_(pa.list_(pa.int64()), pa.int64()))
    with pytest.raises(NotImplementedError, match="map key"):
        T.MapType(T.StructDataType(["a"], [T.LONG]), T.LONG)


def test_arrow_bridge_round_trips_every_column(table):
    b = ColumnarBatch.from_arrow(table, "cpu")
    assert b.to_arrow().to_pylist() == table.to_pylist()
    assert b.device_memory_size() > sum(
        c.data.numel() for c in b.columns)
    empty = ColumnarBatch.empty(b.schema, "cpu")
    assert empty.to_arrow().num_rows == 0
    assert empty.to_arrow().schema.types == table.schema.types


@pytest.mark.parametrize("name", ["aa", "ss"])
def test_list_of_lists_buffers_match_reference(table, name):
    """Row lengths, validity, offsets and the flat values of each level
    1:1 the reference's ``ListVector``s."""
    mine = ColumnarBatch.from_arrow(table.select([name]), "cpu").columns[0]
    ref = JBatch.from_arrow(table.select([name])).columns[0]
    n = table.num_rows
    for _level in range(2):
        assert np.array_equal(mine.data.numpy(), np.asarray(ref.data))
        assert np.array_equal(mine.validity.numpy(),
                              np.asarray(ref.validity))
        assert np.array_equal(mine.offsets[:n + 1], ref.offsets)
        n = int(ref.offsets[-1])
        mine, ref = mine.flat, ref.flat
    assert np.array_equal(mine.validity.numpy(), np.asarray(ref.validity))
    if name == "aa":
        assert np.array_equal(mine.data.numpy(), np.asarray(ref.data))
    else:
        got = mine.to_arrow(n).to_pylist()
        assert got == ref.to_arrow(n).to_pylist()


# -- ops/nested.py over nested children -------------------------------------------

@pytest.mark.parametrize("a,b", [("as_", "as2"), ("aa", "aa2"),
                                 ("sa", "sa2"), ("ss", "ss"), ("ms", "ms")])
def test_nested_ops_against_pyarrow(table, a, b):
    n = table.num_rows
    cap = bucket_capacity(n)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, n, cap)
    live = rng.random(cap) < 0.8
    choice = rng.integers(0, 2, cap)
    va = array_to_device(table.column(a), None, cap, "cpu")
    vb = array_to_device(table.column(b), None, cap, "cpu")
    ca, cb = table.column(a).to_pylist(), table.column(b).to_pylist()
    g = N.gather(va, torch.from_numpy(idx), torch.from_numpy(live))
    assert g.to_arrow(cap).to_pylist() == [ca[i] if ok else None
                                           for i, ok in zip(idx, live)]
    cat = N.concat([va, g], [n, 100], bucket_capacity(n + 100))
    assert cat.to_arrow(n + 100).to_pylist() == ca + [
        ca[i] if ok else None for i, ok in zip(idx[:100], live[:100])]
    sl = N.take_rows(va, 30, 50, 64)
    assert sl.to_arrow(50).to_pylist() == ca[30:80]
    sel = N.select_rows([va, vb], torch.from_numpy(choice), n, cap)
    assert sel.to_arrow(n).to_pylist() == [
        (ca if c == 0 else cb)[i] for i, c in enumerate(choice[:n])]
    il, total = N.interleave([Col.from_vector(va), Col.from_vector(vb)], n)
    assert il.to_vector().to_arrow(total).to_pylist() == [
        x for i in range(n) for x in (ca[i], cb[i])]
    if a != "ms":
        eq = N.equiv(Col.from_vector(va), Col.from_vector(vb))
        assert eq[:n].tolist() == [x == y for x, y in zip(ca, cb)]


def test_equiv_holds_nan_and_signed_zeros_equal():
    """Spark's ordering equivalence inside nested values: NaN equals NaN
    and -0.0 equals 0.0 (``SQLOrderingUtil.compareDoubles``)."""
    nan = float("nan")
    a = pa.array([[nan, 1.0], [-0.0], [None], [nan], None],
                 pa.list_(pa.float64()))
    b = pa.array([[nan, 1.0], [0.0], [None], [1.0], None],
                 pa.list_(pa.float64()))
    va, vb = (Col.from_vector(array_to_device(x, None, None, "cpu"))
              for x in (a, b))
    assert N.equiv(va, vb)[:5].tolist() == [True, True, True, False, True]


# -- the session against the reference ------------------------------------------

class _Api:
    """One package's builders, so a job is written once for both."""

    def __init__(self, functions, core, ens):
        self.F, self.col, self.lit, self.ens = (functions, core.col, core.lit,
                                                ens)


PORT = _Api(F, E, EqualNullSafe)
REF = _Api(JF, JE, JEqualNullSafe)

JOBS = {
    # explode / posexplode, outer or not, of array<struct> and array<array>
    **{f"{'pos' if pos else ''}explode{'-outer' if outer else ''}-{c}": (
        lambda df, A, c=c, pos=pos, outer=outer:
        df.explode(c, outer=outer, pos=pos).select("k", "i", *(
            ["pos"] if pos else []), "col"))
       for c in ("as_", "aa") for pos in (False, True)
       for outer in (False, True)},
    "explode-twice": lambda df, A: df.explode("ss").explode("col").select(
        "k", "col"),
    "collect-list": lambda df, A: df.group_by("k").agg(
        A.F.collect_list("as_").alias("l1"),
        A.F.collect_list("aa").alias("l2"),
        A.F.collect_list("sa").alias("l3"),
        A.F.collect_list(A.F.struct("a", A.col("aa"), "i", A.col("i"))
                         ).alias("l4")),
    "first-last": lambda df, A: df.group_by("k").agg(
        A.F.first("aa").alias("f1"), A.F.last("as_").alias("l1"),
        A.F.first("sa", True).alias("f2"), A.F.last("ss", True).alias("l2")),
    "if-case-coalesce": lambda df, A: df.select(
        "k", A.F.if_(A.col("i") > 5, A.col("aa"), A.col("aa2")).alias("f"),
        A.F.when(A.col("k") > 3, A.col("as_")).alias("w"),
        A.F.when(A.col("k") == 1, A.col("sa")).when(
            A.col("k") == 2, A.col("sa2")).otherwise(A.col("sa")).alias("c"),
        A.F.coalesce(A.col("as_"), A.col("as2")).alias("co"),
        A.F.coalesce(A.col("ss"), A.col("ss")).alias("cs")),
    "extract": lambda df, A: df.select(
        A.F.element_at0("as_", 0).alias("s0"),
        A.F.get_field(A.F.element_at0("as_", 0), "y").alias("y"),
        A.F.element_at("aa", -1).alias("last"),
        A.F.size(A.F.element_at("aa", 1)).alias("n1"),
        A.F.element_at0(A.F.element_at0("aa", 0), 1).alias("a01"),
        A.F.get_field("sa", "f").alias("f"),
        A.F.size(A.F.get_field("sa", "f")).alias("nf"),
        A.F.element_at(A.F.get_field("sa", "f"), 1).alias("f1"),
        A.F.get_field(A.F.get_field("sa", "h"), "u").alias("u"),
        A.F.size("ss").alias("ns")),
    "builders": lambda df, A: df.select(
        A.F.struct("a", A.col("aa"), "s", A.col("sa")).alias("st"),
        A.F.array(A.col("aa"), A.col("aa2")).alias("ar"),
        A.F.get_field(A.F.struct("a", A.col("as_"), "k", A.col("k")),
                      "a").alias("fused")),
    "rollup": lambda df, A: df.rollup("k", "i").agg(
        A.F.count().alias("n"), A.F.collect_list("aa").alias("l")),
    "payload-filter-sort-limit": lambda df, A: df.filter(
        A.col("i") > 3).sort("k", "i").limit(60).select(
        "k", "i", "as_", "aa", "sa", "ss"),
    "payload-exchange": lambda df, A: df.repartition(4, "k").select(
        "k", "as_", "aa", "sa", "ss"),
}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_job_matches_reference(frames, job):
    port, ref = frames
    got = JOBS[job](port, PORT).collect()
    exp = JOBS[job](ref, REF).collect()
    assert got.column_names == exp.column_names
    assert _rows(got) == _rows(exp)


@pytest.mark.parametrize("q", [
    "select k, count(*) as n, first(aa) as f, last(sa) as l from t "
    "group by cube(k)",
    "select k, i, count(*) as n, last(as_) as l from t "
    "group by grouping sets ((k), (k, i), ())"])
def test_cube_and_grouping_sets_carry_nested_values(table, q):
    """The SQL forms of the Expand (one partition, so ``first``/``last``
    see the rows in one order in both)."""
    out = []
    for spark in (TorchSession(device="cpu"), TpuSession()):
        spark.create_or_replace_temp_view(
            "t", spark.create_dataframe(table.drop(["ms"]), 1))
        out.append(spark.sql(q).collect())
    assert _rows(out[0]) == _rows(out[1]) and out[0].num_rows > 6


def test_join_carries_nested_payload(frames, table):
    port, ref = frames
    dim = pa.table({"k": pa.array([1, 3, 4], pa.int64()),
                    "w": ["a", "b", "c"]})
    got = port.join(port.session.create_dataframe(dim), on="k").collect()
    exp = ref.join(ref.session.create_dataframe(dim), on="k").collect()
    assert _rows(got.drop(["ms"])) == _rows(exp)


def test_a_null_literal_of_a_nested_type(frames):
    port, _ = frames
    got = port.select("k", F.coalesce(E.lit(None), E.col("aa")).alias("a"),
                      F.if_(E.col("k") > 9, E.col("sa"), E.lit(None)).alias(
                          "s")).collect()
    t = port.collect()
    assert got.column("a").to_pylist() == t.column("aa").to_pylist()
    assert got.column("s").null_count == got.num_rows


def test_first_last_ignore_nulls_pick_the_nested_row():
    t = pa.table({"k": pa.array([1, 1, 1, 2], pa.int64()),
                  "a": pa.array([None, [[1]], [[2], None], None],
                                pa.list_(pa.list_(pa.int64())))})
    got = TorchSession(device="cpu").create_dataframe(t).group_by("k").agg(
        F.first("a").alias("f"), F.first("a", True).alias("fi"),
        F.last("a").alias("l"), F.last("a", True).alias("li")).order_by(
        "k").collect()
    assert got.to_pylist() == [
        {"k": 1, "f": None, "fi": [[1]], "l": [[2], None], "li": [[2], None]},
        {"k": 2, "f": None, "fi": None, "l": None, "li": None}]


# -- files ------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_nested_of_nested_round_trip(tmp_path, table, fmt):
    """The arrow writer by schema (no native encoder takes a nested
    column); the files read by pyarrow's reader equal the source, and the
    port reads them back equal too (ORC: no map column, which pyarrow's
    ORC writer refuses)."""
    from spark_rapids_tpu_torch.io import writer as W
    src = table if fmt == "parquet" else table.drop(["ms"])
    spark = TorchSession(device="cpu")
    out = str(tmp_path / fmt)
    W.reset_routes()
    getattr(spark.create_dataframe(src, 2), f"write_{fmt}")(
        out, mode="overwrite")
    assert W.routes["native_files"] == 0 and W.routes["arrow_files"] >= 1
    files = sorted(str(p) for p in (tmp_path / fmt).glob(f"*.{fmt}"))
    read = (pq.read_table if fmt == "parquet" else porc.read_table)
    assert _rows(pa.concat_tables([read(p) for p in files])) == _rows(src)
    back = getattr(spark, f"read_{fmt}")(out).collect()
    assert _rows(back) == _rows(src)


# -- refusals kept -----------------------------------------------------------------

def test_nested_keys_still_refused(frames):
    port, _ = frames
    dim = port.session.create_dataframe(
        pa.table({"sa": deep_nested_table(2, 3).column("sa")}))
    cases = {
        "HashAggregateExec": lambda: port.group_by("as_").count(),
        "SortExec": lambda: port.sort("sa"),
        "ShuffleExchangeExec": lambda: port.repartition(2, "aa"),
        "BroadcastHashJoinExec": lambda: port.join(dim, on="sa"),
        "WindowExec": lambda: port.window([F.alias(F.over(
            F.row_number(), ["ss"], ["k"]), "r")]),
        "IN": lambda: port.filter(E.col("sa").isin([None])),
    }
    for op, make in cases.items():
        with pytest.raises(NotImplementedError, match=op):
            make().physical_plan()


@pytest.mark.parametrize("agg", ["min", "max", "collect_set"])
@pytest.mark.parametrize("c", ["as_", "aa", "sa"])
def test_order_and_hash_aggregates_of_nested_refused(frames, agg, c):
    """min/max of a type that holds a struct stays refused at planning;
    min/max of an array of arrays and collect_set of every one of these
    types plan (their values are held to the reference in
    ``tests/test_torch_nested_order.py``)."""
    port, _ = frames
    make = lambda: port.group_by("k").agg(  # noqa: E731
        getattr(F, agg)(c)).physical_plan()
    if agg in ("min", "max") and c in ("as_", "sa"):
        with pytest.raises(NotImplementedError, match="HashAggregateExec"):
            make()
    else:
        make()


def test_order_comparisons_and_map_equality_refused(frames):
    port, _ = frames
    for make in (lambda: E.col("aa") < E.col("aa2"),
                 lambda: E.col("sa") >= E.col("sa2"),
                 lambda: E.col("ms") == E.col("ms"),
                 lambda: E.col("aa") == E.col("as_"),
                 lambda: F.array_contains("aa", 1)):
        with pytest.raises(NotImplementedError):
            port.select(make().alias("x")).physical_plan()


def test_map_explode_row_format_and_csv_still_refused(frames, tmp_path):
    from spark_rapids_tpu_torch.plan import nodes as NN
    from spark_rapids_tpu_torch.session import DataFrame
    port, _ = frames
    node = NN.GenerateNode("ms", port._plan,
                           element_type=T.ArrayType(T.LONG))
    with pytest.raises(NotImplementedError, match="GenerateExec"):
        DataFrame(node, port.session).physical_plan()
    with pytest.raises(NotImplementedError):
        port.select("k", "aa").collect_row_buffer()
    with pytest.raises(NotImplementedError, match="CSV"):
        port.select("k", "as_").write_csv(str(tmp_path / "c"),
                                          mode="overwrite")


# -- where Spark and the reference differ ----------------------------------------

def test_gap_equality_over_structs(frames, table):
    """Spark compares structs and arrays of structs for equality field by
    field (``ordering.equiv``: two nulls equal); the reference's host path
    raises ``TypeError`` ('>' between two dicts)."""
    port, ref = frames
    got = port.select((E.col("sa") == E.col("sa2")).alias("e1"),
                      (E.col("as_") == E.col("as2")).alias("e2"),
                      EqualNullSafe(E.col("as_"), E.col("as2")).alias("e3"),
                      (E.col("sa") != E.col("sa2")).alias("e4")).collect()
    sa, sa2 = table.column("sa").to_pylist(), table.column("sa2").to_pylist()
    as_, as2 = table.column("as_").to_pylist(), table.column(
        "as2").to_pylist()

    def eq(x, y):
        return None if x is None or y is None else x == y
    assert got.column("e1").to_pylist() == [eq(x, y) for x, y in zip(sa, sa2)]
    assert got.column("e2").to_pylist() == [eq(x, y)
                                            for x, y in zip(as_, as2)]
    assert got.column("e3").to_pylist() == [x == y for x, y in zip(as_, as2)]
    assert got.column("e4").to_pylist() == [
        None if v is None else not v for v in got.column("e1").to_pylist()]
    with pytest.raises(TypeError):
        ref.select((JE.col("sa") == JE.col("sa2")).alias("e")).collect()
    with pytest.raises(TypeError):
        ref.filter(JE.col("as_") == JE.col("as2")).collect()


def _arrays_without_null_elements(seed: int, n: int) -> pa.Table:
    """``aa``/``aa2`` (array<array<bigint>>) and ``d``/``d2``
    (array<double>, -0.0 among them) with null rows and empty lists but no
    null element and no NaN: the shape the reference's host equality
    answers as Spark does."""
    rng = np.random.default_rng(seed)

    def inner():
        return [int(x) for x in rng.integers(0, 3, int(rng.integers(0, 3)))]

    def outer():
        r = rng.random()
        return None if r < 0.1 else [inner() for _ in range(
            int(rng.integers(0, 3)))]

    def dbl():
        r = rng.random()
        return None if r < 0.1 else [float(rng.choice(
            [0.5, -0.0, 0.0])) for _ in range(
            int(rng.integers(0, 3)))]
    aa = [outer() for _ in range(n)]
    d = [dbl() for _ in range(n)]
    return pa.table({
        "k": pa.array(rng.integers(0, 4, n), pa.int64()),
        "aa": pa.array(aa, pa.list_(pa.list_(pa.int64()))),
        "aa2": pa.array([v if rng.random() < 0.5 else outer() for v in aa],
                        pa.list_(pa.list_(pa.int64()))),
        "d": pa.array(d, pa.list_(pa.float64())),
        "d2": pa.array([v if rng.random() < 0.5 else dbl() for v in d],
                       pa.list_(pa.float64()))})


@pytest.mark.parametrize("a,b", [("aa", "aa2"), ("d", "d2")])
def test_array_equality_matches_reference(a, b):
    """``=``, ``!=`` and ``<=>`` over arrays of one type, and a filter on
    ``=``: the reference's rows (-0.0 equals 0.0 in both, Spark's
    ``ordering.equiv``)."""
    t = _arrays_without_null_elements(5, 300)
    out = []
    for spark, A in ((TorchSession(device="cpu"), PORT),
                     (TpuSession(), REF)):
        df = spark.create_dataframe(t, 2)
        out.append((df.select("k", (A.col(a) == A.col(b)).alias("eq"),
                              (A.col(a) != A.col(b)).alias("ne"),
                              A.ens(A.col(a), A.col(b)).alias("ns")
                              ).collect(),
                    df.filter(A.col(a) == A.col(b)).select("k", a).collect()))
    for got, exp in zip(*out):
        assert _rows(got) == _rows(exp)
    assert 0 < out[0][1].num_rows < t.num_rows


def test_gap_equality_over_nan_elements():
    """Spark holds NaN equal to NaN and to nothing else
    (``compareDoubles``); the reference's host equality calls an array
    holding a NaN equal to an array of another value, or of another
    length."""
    nan = float("nan")
    t = pa.table({"a": pa.array([[nan], [nan, 1.0], [nan, 0.5], [0.5]],
                                pa.list_(pa.float64())),
                  "b": pa.array([[0.0], [nan, 1.0], [0.5], [0.5]],
                                pa.list_(pa.float64()))})
    got = TorchSession(device="cpu").create_dataframe(t).select(
        (E.col("a") == E.col("b")).alias("e")).collect()
    assert got.column("e").to_pylist() == [False, True, False, True]
    exp = TpuSession().create_dataframe(t).select(
        (JE.col("a") == JE.col("b")).alias("e")).collect()
    assert exp.column("e").to_pylist() == [True, True, True, True]


def test_gap_equality_over_null_elements():
    """Spark holds two null elements of arrays equal (``ordering.equiv``);
    the reference's host equality raises ``TypeError`` on an array of
    arrays with a null inner array."""
    t = pa.table({"a": pa.array([[[1], None], [None], [[2]], None],
                                pa.list_(pa.list_(pa.int64()))),
                  "b": pa.array([[[1], None], [[1]], [[2]], [[2]]],
                                pa.list_(pa.list_(pa.int64())))})
    got = TorchSession(device="cpu").create_dataframe(t).select(
        (E.col("a") == E.col("b")).alias("e"),
        EqualNullSafe(E.col("a"), E.col("b")).alias("n")).collect()
    assert got.column("e").to_pylist() == [True, False, True, None]
    assert got.column("n").to_pylist() == [True, False, True, False]
    with pytest.raises(TypeError):
        TpuSession().create_dataframe(t).select(
            (JE.col("a") == JE.col("b")).alias("e")).collect()
