"""Arrays, structs and maps as device columns in the PyTorch port, on the
CPU, held against the JAX package.

- the types and the arrow bridge: ``from_arrow_type``/``to_arrow_type`` as
  the reference's; a list column's buffers (flat elements, offsets, row
  lengths, validity) 1:1 the reference's ``ListVector``;
- the fused create+extract forms bit for bit ``TpuSession``'s;
- materialized structs, arrays and maps, and extractions from real nested
  columns, equal to ``TpuSession``'s (its host path answers those);
- nested payload columns through filter, sort, limit, union, a join and a
  hash exchange, equal to ``TpuSession``'s;
- nested scans and writes (the arrow reader, the arrow writer by schema);
- planning refusals (nested keys, nested element types) and the
  ``test_gap_*`` cases where Spark and the reference differ.

The inputs are made with numpy from a seed. Tolerance: none (integers,
strings, dates, lists, structs and maps are compared exactly).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.session import TorchSession


def nested_table(seed: int = 17, n: int = 240) -> pa.Table:
    """Ints with nulls, strings, a list<bigint> and a list<string> with
    null rows, empty lists and null elements."""
    rng = np.random.default_rng(seed)

    def lst(pool):
        r = rng.random()
        if r < 0.1:
            return None
        if r < 0.2:
            return []
        return [None if rng.random() < 0.1 else pool(rng)
                for _ in range(int(rng.integers(1, 5)))]
    words = ["alpha", "beta", "gamma", "", "déjà vu", "x y"]
    return pa.table({
        "k": pa.array(rng.integers(0, 12, n), pa.int64()),
        "i": pa.array([None if rng.random() < 0.1 else int(x)
                       for x in rng.integers(-5, 40, n)], pa.int64()),
        "s": pa.array([None if rng.random() < 0.1 else words[int(x)]
                       for x in rng.integers(0, len(words), n)]),
        "a": pa.array([lst(lambda g: int(g.integers(0, 9)))
                       for _ in range(n)], pa.list_(pa.int64())),
        "b": pa.array([lst(lambda g: words[int(g.integers(0, 6))])
                       for _ in range(n)], pa.list_(pa.string())),
    })


@pytest.fixture(scope="module")
def frames():
    t = nested_table()
    return (TorchSession(device="cpu").create_dataframe(t, 3),
            TpuSession().create_dataframe(t, 3), t)


def _same(port, ref):
    got, want = port.collect(), ref.collect()
    assert got.column_names == want.column_names
    assert got.to_pylist() == want.to_pylist()
    return got


# -- types and the arrow bridge ------------------------------------------------

@pytest.mark.parametrize("at", [
    pa.list_(pa.int64()), pa.large_list(pa.string()), pa.list_(pa.date32()),
    pa.struct([("a", pa.int32()), ("b", pa.string())]),
    pa.map_(pa.string(), pa.float64())])
def test_arrow_types_as_the_reference(at):
    mine = T.from_arrow_type(at)
    back = T.to_arrow_type(mine)
    if pa.types.is_map(at):
        # the reference maps no arrow map type; its MapType goes out as one
        assert back == at
        assert JT.to_arrow_type(JT.MapType(JT.STRING, JT.DOUBLE)) == back
        return
    ref = JT.from_arrow_type(at)
    assert repr(mine) == repr(ref)
    assert back == JT.to_arrow_type(ref)


def test_list_buffers_as_the_reference():
    from spark_rapids_tpu.columnar import arrow as JA
    from spark_rapids_tpu_torch.columnar import arrow as TA
    t = nested_table(3, 50)
    for name, dt, jdt in (("a", T.ArrayType(T.LONG), JT.ArrayType(JT.LONG)),
                          ("b", T.ArrayType(T.STRING),
                           JT.ArrayType(JT.STRING))):
        arr = t.column(name).combine_chunks().slice(5, 40)
        mine = TA.array_to_device(arr, dt, None, "cpu")
        ref = JA.array_to_device(arr, jdt)
        n = len(arr)
        assert np.array_equal(mine.offsets[:n + 1], ref.offsets)
        assert np.array_equal(mine.data.numpy(), np.asarray(ref.data))
        assert np.array_equal(mine.validity.numpy(), np.asarray(ref.validity))
        assert np.array_equal(mine.flat.data.numpy(),
                              np.asarray(ref.flat.data))
        assert np.array_equal(mine.flat.validity.numpy(),
                              np.asarray(ref.flat.validity))
        assert mine.to_arrow(n).equals(ref.to_arrow(n))
        assert mine.to_arrow(n).equals(arr)


def test_struct_and_map_round_trip():
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    t = pa.table({
        "st": pa.array([{"x": 1, "y": "a"}, None, {"x": None, "y": "b"}]),
        "m": pa.array([[("k", 1)], None, [("a", 2), ("b", None)]],
                      pa.map_(pa.string(), pa.int64()))})
    b = ColumnarBatch.from_arrow(t, "cpu")
    assert b.to_arrow().equals(t)
    assert ColumnarBatch.empty(b.schema, "cpu").to_arrow().num_rows == 0


# -- the fused forms ------------------------------------------------------------

FUSED = {
    "struct-field": lambda f, e: f.get_field(
        f.struct("p", "i", "q", "s"), "q"),
    "array-item": lambda f, e: f.element_at0(f.array("i", "k"), 1),
    "array-item-out": lambda f, e: f.element_at0(f.array("i", "k"), 5),
    "array-item-col": lambda f, e: f.element_at0(f.array("i", "k"),
                                                 e.col("k") % 2),
    "array-size": lambda f, e: f.size(f.array("i", "k", "i")),
    "element-at": lambda f, e: f.element_at(f.array("i", "k"), -1),
    "element-at-1": lambda f, e: f.element_at(f.array("i", "k"), 1),
    "array-contains": lambda f, e: f.array_contains(f.array("i", "k"), 3),
    "array-contains-str": lambda f, e: f.array_contains(
        f.array("s", e.lit("beta")), "gamma"),
    "map-value": lambda f, e: f.map_value(
        f.create_map(e.lit("x"), e.col("i"), e.lit("y"), e.col("k")),
        e.lit("y")),
    "map-value-absent": lambda f, e: f.map_value(
        f.create_map(e.lit("x"), e.col("i")), e.lit("z")),
}


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_forms_bit_for_bit(frames, case):
    port, ref, _ = frames
    _same(port.select("k", E.Alias(FUSED[case](F, E), "r")),
          ref.select("k", JE.Alias(FUSED[case](JF, JE), "r")))


# -- materialized values and extractions from real nested columns ----------------

MATERIALIZED = {
    "struct": lambda f, e: f.struct("p", "i", "q", "s"),
    "array": lambda f, e: f.array("i", "k"),
    "array-str": lambda f, e: f.array("s", e.lit("z")),
    "map": lambda f, e: f.create_map(e.lit("x"), e.col("i"), e.lit("y"),
                                     e.col("k")),
    "size": lambda f, e: f.size("a"),
    "size-str": lambda f, e: f.size("b"),
    "item": lambda f, e: f.element_at0("a", 1),
    "item-col": lambda f, e: f.element_at0("a", e.col("k") % 4),
    "element-at": lambda f, e: f.element_at("a", 2),
    "element-at-neg": lambda f, e: f.element_at("b", -1),
    "contains": lambda f, e: f.array_contains("a", 3),
    "contains-str": lambda f, e: f.array_contains("b", "gamma"),
    "contains-col": lambda f, e: f.array_contains("a", e.col("k")),
}


@pytest.mark.parametrize("case", sorted(MATERIALIZED))
def test_materialized_and_real_columns(frames, case):
    port, ref, _ = frames
    _same(port.select("k", E.Alias(MATERIALIZED[case](F, E), "r")),
          ref.select("k", JE.Alias(MATERIALIZED[case](JF, JE), "r")))


def test_extraction_from_materialized_columns(frames):
    port, _, t = frames
    m = port.select("i", "k", F.struct("p", "i", "q", "k").alias("st"),
                    F.create_map(E.lit("x"), E.col("i"), E.lit("y"),
                                 E.col("k")).alias("m"),
                    F.array("i", "k").alias("ar"))
    out = m.select(F.get_field("st", "q").alias("q"),
                   F.map_value("m", E.lit("x")).alias("x"),
                   F.element_at("ar", -1).alias("last"),
                   F.size("m").alias("n")).collect()
    assert out.column("q").to_pylist() == t.column("k").to_pylist()
    assert out.column("x").to_pylist() == t.column("i").to_pylist()
    assert out.column("last").to_pylist() == t.column("k").to_pylist()
    assert set(out.column("n").to_pylist()) == {2}


def test_map_value_from_a_real_map_column():
    t = pa.table({"m": pa.array([[("a", 1), ("b", 2)], None, [],
                                 [("b", None), ("c", 3)]],
                                pa.map_(pa.string(), pa.int64())),
                  "key": ["b", "a", "a", "b"]})
    df = TorchSession(device="cpu").create_dataframe(t)
    out = df.select(F.map_value("m", E.col("key")).alias("v"),
                    F.map_value("m", E.lit("c")).alias("c"),
                    F.size("m").alias("n")).collect()
    assert out.column("v").to_pylist() == [2, None, None, None]
    assert out.column("c").to_pylist() == [None, None, None, 3]
    assert out.column("n").to_pylist() == [2, -1, 0, 2]


def test_size_of_null_is_minus_one(frames):
    port, ref, t = frames
    got = _same(port.select(F.size("a").alias("n")),
                ref.select(JE.Alias(JF.size("a"), "n")))
    assert got.column("n").null_count == 0
    nulls = [v is None for v in t.column("a").to_pylist()]
    assert all(n == -1 for n, z in zip(got.column("n").to_pylist(), nulls)
               if z)


# -- nested payload through the operators ---------------------------------------

OPERATORS = {
    "filter": lambda d, f, e: d.filter(e.col("k") > 4),
    "sort": lambda d, f, e: d.sort("k", "i", "s"),
    "limit": lambda d, f, e: d.sort("k", "i", "s").limit(17),
    "union": lambda d, f, e: d.union(d.filter(e.col("k") < 3)).sort(
        "k", "i", "s"),
    "repartition": lambda d, f, e: d.repartition(4, "k").sort("k", "i", "s"),
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_nested_payload_through_operators(frames, op):
    port, ref, _ = frames
    got = OPERATORS[op](port, F, E).collect()
    want = OPERATORS[op](ref, JF, JE).collect()
    key = lambda r: (r["k"], r["i"] is None, r["i"] or 0, r["s"] or "",
                     repr(r["a"]), repr(r["b"]))
    if op in ("filter", "repartition", "union"):
        assert sorted(got.to_pylist(), key=key) == sorted(want.to_pylist(),
                                                           key=key)
    else:
        assert got.to_pylist() == want.to_pylist()


def test_nested_payload_through_a_join(frames):
    port, ref, t = frames
    dim = pa.table({"k": pa.array(range(0, 12, 2), pa.int64()),
                    "tag": [f"t{i}" for i in range(6)]})
    for how in ("inner", "left"):
        got = port.join(port.session.create_dataframe(dim), on="k",
                        how=how).collect()
        want = ref.join(ref.session.create_dataframe(dim), on="k",
                        how=how).collect()
        key = lambda r: (r["k"], r["i"] is None, r["i"] or 0, r["s"] or "",
                         repr(r["a"]), repr(r["b"]))
        assert sorted(got.to_pylist(), key=key) == sorted(
            want.to_pylist(), key=key)
    # the nested column on the build side, null-extended by a left join
    lists = port.select(E.Alias(E.col("k") + 100, "k"), "a").limit(5)
    out = port.select("k").limit(3).join(lists, on="k", how="left").collect()
    assert out.column("a").to_pylist() == [None, None, None]


def test_a_hash_exchange_gathers_nested_columns():
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.shuffle import partitioning as SP
    t = nested_table(5, 100)
    b = ColumnarBatch.from_arrow(t, "cpu")
    p = SP.HashPartitioner([E.col("k")], 3).bind(b.schema)
    pieces = p.partition(b)
    back = pa.concat_tables([pb.to_arrow() for _, pb in pieces])
    key = lambda r: repr(sorted(r.items()))
    assert sorted(back.to_pylist(), key=key) == sorted(t.to_pylist(),
                                                       key=key)


# -- nested columns in files ---------------------------------------------------

def test_nested_scan_and_write(tmp_path, frames):
    from spark_rapids_tpu_torch.io import writer as W
    port, ref, t = frames
    spark = port.session
    out = str(tmp_path / "nested")
    W.reset_routes()
    framed = port.select("k", "a", "b", F.struct("p", "i", "q", "s")
                         .alias("st"), F.create_map(E.lit("x"), E.col("i"))
                         .alias("m"))
    framed.write_parquet(out, mode="overwrite")
    assert W.routes == {"native_files": 0, "arrow_files": 3}
    back = spark.read_parquet(out)
    got = back.collect()
    want_rows = framed.collect().to_pylist()
    key = lambda r: repr(sorted(r.items()))
    assert sorted(got.to_pylist(), key=key) == sorted(want_rows, key=key)
    assert sorted(pq.read_table(out).to_pylist(), key=key) == sorted(
        want_rows, key=key)
    # the reference reads the lists the same (it maps no arrow map type)
    lists = str(tmp_path / "lists")
    port.select("k", "a", "b").write_parquet(lists, mode="overwrite")
    assert sorted(TpuSession().read_parquet(lists).collect().to_pylist(),
                  key=key) == sorted(spark.read_parquet(lists).collect()
                                     .to_pylist(), key=key)
    W.reset_routes()
    framed.write_orc(str(tmp_path / "orc"), mode="overwrite")
    assert W.routes["native_files"] == 0
    assert sorted(spark.read_orc(str(tmp_path / "orc")).collect().to_pylist(),
                  key=key) == sorted(want_rows, key=key)
    with pytest.raises(NotImplementedError, match="CSV"):
        framed.write_csv(str(tmp_path / "csv"), mode="overwrite")


def test_a_failing_native_encoder_still_raises(tmp_path, monkeypatch):
    """The route is chosen by the schema; a native write that fails is not
    retried through arrow."""
    from spark_rapids_tpu_torch.io import parquet_write_native as PW
    from spark_rapids_tpu_torch.io import writer as W
    df = TorchSession(device="cpu").create_dataframe(
        pa.table({"x": pa.array([1, 2], pa.int64())}))

    def boom(*a, **k):
        raise RuntimeError("encoder failed")
    monkeypatch.setattr(PW, "write_batch_file", boom)
    W.reset_routes()
    with pytest.raises(RuntimeError, match="encoder failed"):
        df.write_parquet(str(tmp_path / "p"), mode="overwrite")
    assert W.routes["arrow_files"] == 0


# -- refusals at planning ---------------------------------------------------------

def test_nested_keys_refused_at_planning(frames):
    port, _, _ = frames
    dim = port.session.create_dataframe(
        pa.table({"a": pa.array([[1]], pa.list_(pa.int64()))}))
    cases = {
        "HashAggregateExec": lambda: port.group_by("a").count(),
        # an array sort key is ported; a struct holding one is not
        "SortExec": lambda: port.sort(F.struct("x", "k", "y", "a")),
        "ShuffleExchangeExec": lambda: port.repartition(2, "a"),
        "BroadcastHashJoinExec": lambda: port.join(dim, on="a"),
        "WindowExec": lambda: port.window([F.alias(F.over(
            F.row_number(), ["a"], ["k"]), "r")]),
        "IN": lambda: port.filter(E.col("a").isin([[1]])),
    }
    for op, make in cases.items():
        with pytest.raises(NotImplementedError, match=op):
            make().physical_plan()


def test_nested_elements_refused_when_built():
    """Nested elements, fields and values are ported (they were refused
    here before), and so are min/max/collect_set of an array; a nested map
    key, an order comparison over a nested value and min/max of a struct
    are still refused at planning."""
    assert T.from_arrow_type(pa.list_(pa.list_(pa.int64()))) == T.ArrayType(
        T.ArrayType(T.LONG))
    assert T.from_arrow_type(pa.list_(pa.struct([("a", pa.int64())]))) == \
        T.ArrayType(T.StructDataType(["a"], [T.LONG]))
    assert T.ArrayType(T.ArrayType(T.LONG)).element_type == T.ArrayType(
        T.LONG)
    with pytest.raises(NotImplementedError):
        T.MapType(T.ArrayType(T.LONG), T.LONG)
    with pytest.raises(NotImplementedError):
        T.from_arrow_type(pa.map_(pa.list_(pa.int64()), pa.int64()))
    t = pa.table({"a": pa.array([[1], None, [1]], pa.list_(pa.int64())),
                  "k": [1, 1, 2]})
    df = TorchSession(device="cpu").create_dataframe(t)
    got = df.group_by("k").agg(F.collect_list("a").alias("l")).sort(
        "k").collect()
    assert got.column("l").to_pylist() == [[[1]], [[1]]]
    got = df.select(F.array("a", "a").alias("x"),
                    (E.col("a") == E.col("a")).alias("e")).collect()
    assert got.column("x").to_pylist() == [[[1], [1]], [None, None],
                                           [[1], [1]]]
    assert got.column("e").to_pylist() == [True, None, True]
    # an operator that needs an order over a nested value
    with pytest.raises(NotImplementedError):
        df.select((E.col("a") < E.col("a")).alias("x")).physical_plan()
    got = df.group_by("k").agg(F.min("a").alias("lo"),
                               F.max("a").alias("hi"),
                               F.collect_set("a").alias("s")).sort(
        "k").collect()
    assert got.to_pylist() == [{"k": 1, "lo": [1], "hi": [1], "s": [[1]]},
                               {"k": 2, "lo": [1], "hi": [1], "s": [[1]]}]
    for agg in (F.min, F.max):
        with pytest.raises(NotImplementedError, match="HashAggregateExec"):
            df.group_by("k").agg(agg(F.struct("x", "k", "y", "a"))).physical_plan()


# -- where Spark and the reference differ ----------------------------------------

def test_gap_element_at_zero(frames):
    """Spark's ElementAt raises INVALID_INDEX_OF_ZERO for index 0 in every
    release; the reference's default 3.5 shim answers null."""
    port, ref, _ = frames
    want = ref.select(JE.Alias(JF.element_at(JF.array("i", "k"), 0),
                               "r")).collect()
    assert set(want.column("r").to_pylist()) == {None}
    with pytest.raises(RuntimeError, match="INVALID_INDEX_OF_ZERO"):
        port.select(F.element_at(F.array("i", "k"), 0).alias("r")).collect()
    with pytest.raises(RuntimeError, match="INVALID_INDEX_OF_ZERO"):
        port.select(F.element_at("a", 0).alias("r")).collect()


def test_gap_duplicate_map_key(frames):
    """Spark 3's default spark.sql.mapKeyDedupPolicy=EXCEPTION raises on a
    duplicate map key; the reference takes the last pair."""
    port, ref, _ = frames
    want = ref.select(JE.Alias(JF.map_value(JF.create_map(
        JE.lit("x"), JE.col("i"), JE.lit("x"), JE.col("k")), JE.lit("x")),
        "r")).collect()
    assert want.column("r").to_pylist() == ref.select("k").collect().column(
        "k").to_pylist()
    for e in (F.map_value(F.create_map(E.lit("x"), E.col("i"), E.lit("x"),
                                       E.col("k")), E.lit("x")),
              F.create_map(E.lit("x"), E.col("i"), E.lit("x"), E.col("k"))):
        with pytest.raises(RuntimeError, match="DUPLICATED_MAP_KEY"):
            port.select(e.alias("r")).collect()
