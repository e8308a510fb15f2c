"""The scalar types the expression slice adds to the PyTorch port — byte,
short, float, timestamp and the untyped NULL — on the CPU, held against the
JAX package.

- the arrow ↔ Spark type maps and the canonical defaults of each type;
- the arrow conversion in both directions, nulls and padding included,
  bit for bit the reference's device buffers;
- the parquet chunk decode of INT32 chunks annotated INT(8)/INT(16) and of
  FLOAT chunks (``chunk_decode`` at value widths 1, 2 and 4-float, its
  plain version here), bit for bit the reference's ``chunk_to_device`` on
  pyarrow-written files, and the route each scan takes (a timestamp
  output sends the partition to arrow);
- the ORC stripe decode of SHORT and FLOAT columns;
- the CSV parse of tinyint, smallint and float;
- the places where the reference differs from Spark (ROADMAP Queue 3).

Tolerance: none.
"""

from __future__ import annotations

import math

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import arrow as JA
from spark_rapids_tpu.io import orc_native as JON
from spark_rapids_tpu.io import parquet_native as JPN
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import arrow as PA
from spark_rapids_tpu_torch.io import csv_native as CN
from spark_rapids_tpu_torch.io import orc_native as ON
from spark_rapids_tpu_torch.io import parquet_native as PN
from spark_rapids_tpu_torch.session import TorchSession

CAP = 64

NEW = [(pa.int8(), T.BYTE, JT.BYTE, "tinyint", 0),
       (pa.int16(), T.SHORT, JT.SHORT, "smallint", 0),
       (pa.float32(), T.FLOAT, JT.FLOAT, "float", 0.0),
       (pa.timestamp("us", tz="UTC"), T.TIMESTAMP, JT.TIMESTAMP,
        "timestamp", 0),
       (pa.null(), T.NULL, JT.NULL, "void", 0)]


@pytest.mark.parametrize("at,pt,rt,name,default", NEW,
                         ids=[n[3] for n in NEW])
def test_type_maps_match_reference(at, pt, rt, name, default):
    assert T.from_arrow_type(at) == pt
    assert JT.from_arrow_type(at) == rt
    assert pt.sql_name == rt.sql_name == name
    assert pt.default_value() == default
    if not isinstance(pt, T.NullType):
        assert T.to_arrow_type(pt) == JT.to_arrow_type(rt)
        assert T.to_numpy_dtype(pt) == JT.to_numpy_dtype(rt)


def test_timestamps_of_every_unit_map_to_micros():
    for unit in ("s", "ms", "us", "ns"):
        assert T.from_arrow_type(pa.timestamp(unit)) == T.TIMESTAMP
        per = {"s": 10**6, "ms": 10**3, "us": 1, "ns": 10**-3}[unit]
        raw = [1000, None, -3000] if unit == "ns" else [1, None, -3]
        arr = pa.array(raw, pa.int64()).cast(pa.timestamp(unit))
        cv = PA.array_to_device(arr, None, CAP, "cpu")
        want = [int(raw[0] * per), 0, int(raw[2] * per)]
        assert cv.data.numpy()[:3].tolist() == want
        assert cv.validity.numpy()[:3].tolist() == [True, False, True]


def _arrays(rng, n=50):
    def m():
        return rng.random(n) < 0.2
    return {
        "tinyint": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                            mask=m()),
        "smallint": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16),
                             mask=m()),
        "float": pa.array(np.concatenate([
            rng.normal(0, 1e3, n - 4), [np.nan, -0.0, np.inf, 1e-40]]
        ).astype(np.float32), mask=m()),
        "timestamp": pa.array(rng.integers(-2**50, 2**50, n),
                              mask=m()).cast(pa.timestamp("us", tz="UTC")),
    }


@pytest.mark.parametrize("name", ["tinyint", "smallint", "float",
                                  "timestamp"])
def test_arrow_round_trip_matches_reference_buffers(name):
    arr = _arrays(np.random.default_rng(3))[name]
    pc = PA.array_to_device(arr, None, CAP, "cpu")
    rc = JA.array_to_device(arr, None, CAP)
    np.testing.assert_array_equal(pc.validity.numpy(), np.asarray(rc.validity))
    pv, rv = pc.data.numpy(), np.asarray(rc.data)
    assert pv.dtype == rv.dtype
    np.testing.assert_array_equal(pv.view(np.uint8), rv.view(np.uint8))
    back = pc.to_arrow(len(arr))
    assert back.type == arr.type
    assert back.equals(arr) or all(
        (a is None and b is None) or a == b or (
            isinstance(a, float) and math.isnan(a) and math.isnan(b))
        for a, b in zip(back.to_pylist(), arr.to_pylist()))


def test_null_type_column_round_trips():
    cv = PA.array_to_device(pa.nulls(5), None, 8, "cpu")
    assert cv.dtype == T.NULL and not cv.validity.numpy().any()
    assert cv.to_arrow(5).to_pylist() == [None] * 5


# -- the scans ----------------------------------------------------------------

@pytest.fixture(scope="module")
def typed_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("typed")
    rng = np.random.default_rng(9)
    n = 3000
    t = pa.table({
        "b": pa.array(rng.integers(1, 51, n).astype(np.int8),
                      mask=rng.random(n) < 0.1),
        "s": pa.array((rng.integers(0, 2000, n) - 1000).astype(np.int16),
                      mask=rng.random(n) < 0.1),
        "f": pa.array((rng.integers(0, 11, n) / 100).astype(np.float32),
                      mask=rng.random(n) < 0.1),
        "ts": pa.array(rng.integers(0, 2**45, n),
                       mask=rng.random(n) < 0.1).cast(
            pa.timestamp("us", tz="UTC")),
    })
    p = str(d / "t.parquet")
    pq.write_table(t, p, row_group_size=1000)
    o = str(d / "t.orc")
    orc.write_table(t, o)
    return t, p, o, d


@pytest.mark.parametrize("col,width", [("b", 1), ("s", 2), ("f", 4)])
def test_chunk_decode_of_narrow_and_float_chunks_matches_reference(
        typed_files, col, width):
    """``chunk_decode`` at value width 1, 2 and 4 (float): the dictionary
    converted to the column's dtype on the host, bit for bit the
    reference's decode of the same pyarrow chunk."""
    t, p, _, _ = typed_files
    md = pq.ParquetFile(p).metadata
    ci = t.column_names.index(col)
    pt = T.from_arrow_type(t.schema.field(col).type)
    jt = JT.from_arrow_type(t.schema.field(col).type)
    for rg in range(md.num_row_groups):
        pages = PN.read_chunk_pages(p, rg, ci, md=md)
        jpages = JPN.read_chunk_pages(p, rg, ci, md=md)
        cap = 1024
        tc = PN.chunk_to_device(pages, pt, cap, "cpu")
        jc = JPN.chunk_to_device(jpages, jt, cap)
        assert tc.data.dtype.itemsize == width
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))


def test_parquet_routes_narrow_types_native_and_timestamps_arrow(
        typed_files):
    t, p, _, _ = typed_files
    spark = TorchSession({"spark.rapids.tpu.sql.parquet.deviceDecode.enabled":
                          "true"}, device="cpu")
    PN.reset_routes()
    got = spark.read_parquet(p).select("b", "s", "f").collect()
    assert PN.routes.get("arrow", 0) == 0
    assert got.equals(t.select(["b", "s", "f"]))
    df = spark.read_parquet(p)
    scan = df.physical_plan()
    while scan.children:
        scan = scan.children[0]
    assert scan._device_decode_batches(0, 1 << 20, 1 << 30) is None
    back = df.collect()
    assert back.column("ts").cast(pa.int64()).equals(
        t.column("ts").cast(pa.int64()))


def test_orc_reads_short_on_the_device_as_smallint(typed_files):
    """ORC SHORT reads as smallint (Spark's type) on the device decode; the
    reference maps SHORT to INT in its kind table, which never matches the
    smallint its schema gives the column, so it reads the column through
    arrow. Both give the same values; the port's route is the device."""
    t, _, o, _ = typed_files
    schema = T.StructType([T.StructField("s", T.SHORT),
                           T.StructField("f", T.FLOAT)])
    meta = ON.read_meta(o)
    ON.reset_routes()
    batch = ON.read_stripe_device(o, meta, 0, schema, "cpu")
    assert ON.routes.get("device_columns", 0) == 2
    assert ON.routes.get("arrow_columns", 0) == 0
    n = batch.num_rows
    assert batch.columns[0].dtype == T.SHORT
    assert batch.to_arrow().column("s").to_pylist() == \
        t.column("s").to_pylist()[:n]
    assert batch.to_arrow().column("f").to_pylist() == \
        t.column("f").to_pylist()[:n]
    assert JON._KIND_TO_TYPE[JON.K_SHORT] == JT.INT
    assert ON._KIND_TO_TYPE[ON.K_SHORT] == T.SHORT


def test_csv_parses_narrow_integers_and_floats_on_the_device(tmp_path):
    """tinyint and smallint parse on the device, out-of-range values null
    (Spark); float parses when the float conf allows it."""
    p = tmp_path / "x.csv"
    p.write_text("b,s,f\n12,-300,0.5\n200,40000,1.25\n,7,\n-128,-32768,-2\n")
    schema = T.StructType([T.StructField("b", T.BYTE),
                           T.StructField("s", T.SHORT),
                           T.StructField("f", T.FLOAT)])
    shape = CN.try_scan_for_device(str(p), schema, ",", True, True)
    assert shape is not None
    b = CN.decode_shape_device(shape, schema, "cpu").to_arrow()
    assert b.column("b").to_pylist() == [12, None, None, -128]
    assert b.column("s").to_pylist() == [-300, None, 7, -32768]
    assert b.column("f").to_pylist() == [0.5, 1.25, None, -2.0]
    assert b.schema.field("f").type == pa.float32()
    # a timestamp column sends the file to arrow, as in the reference
    ts = T.StructType([T.StructField("b", T.BYTE),
                       T.StructField("t", T.TIMESTAMP)])
    assert not CN.column_in_scope(T.TIMESTAMP, True)
    del ts


def test_gap_csv_timestamp_without_a_zone_reads_as_utc(tmp_path):
    """Spark reads ``2020-01-01T10:00:00.000000`` in the session zone
    (UTC). The reference asks arrow for a zoned timestamp, which refuses
    text without an offset, so its scan fails; the port parses it naive and
    takes it as UTC."""
    p = tmp_path / "t.csv"
    p.write_text("t,x\n2020-01-01T10:00:00.000000,1\n,2\n"
                 "1999-12-31 23:59:59,3\n")
    got = TorchSession(device="cpu").read_csv(
        str(p), schema=T.StructType([T.StructField("t", T.TIMESTAMP),
                                     T.StructField("x", T.INT)])
    ).collect().column("t").to_pylist()
    assert [v.isoformat() if v else v for v in got] == [
        "2020-01-01T10:00:00+00:00", None, "1999-12-31T23:59:59+00:00"]
    with pytest.raises(Exception):
        TpuSession().read_csv(str(p), schema=JT.StructType(
            [JT.StructField("t", JT.TIMESTAMP),
             JT.StructField("x", JT.INT)])).collect()


def test_hash_of_negative_zero_and_nan_is_sparks():
    """Spark 3.2+ (SPARK-35207) hashes -0.0 as 0.0 and a NaN by its
    canonical bits; the reference does the same. A subnormal hashes by its
    bits in Spark and in ``hash()``; the exchange's partitioner flushes it
    to 0.0, as the reference's XLA does."""
    from spark_rapids_tpu import functions as JF
    t = pa.table({"f": pa.array([0.0, -0.0, float("nan"), 1e-40],
                                pa.float32()),
                  "d": pa.array([0.0, -0.0, float("nan"), 5e-324])})
    port = TorchSession(device="cpu").create_dataframe(t)
    ref = TpuSession().create_dataframe(t)
    for c in ("f", "d"):
        got = port.select(F.hash(c).alias("h")).collect().column(
            "h").to_pylist()
        exp = ref.select(JF.hash(c).alias("h")).collect().column(
            "h").to_pylist()
        assert got[0] == got[1] and got[:3] == exp[:3]
        assert got[3] != got[0]       # the subnormal keeps its bits


def test_csv_writer_takes_a_column_past_pyarrows_numpy_chunk(tmp_path):
    """A formatted column of more than pyarrow's numpy chunk (about 64 MB
    of UCS-4 text: 700,000 timestamps of 26 characters) comes back from
    ``pa.array`` as a ChunkedArray; the writer joins it into one array
    (sweep-sf1's CSV copy of 1.5M rows failed on the card without)."""
    import pyarrow.csv as pcsv
    n = 700_000
    ts = pa.array(np.arange(n, dtype=np.int64) * 1_000_001).cast(
        pa.timestamp("us", tz="UTC"))
    out = str(tmp_path / "o")
    st = TorchSession(device="cpu").create_dataframe(
        pa.table({"t": ts})).write_csv(out, mode="overwrite")
    assert st.num_rows == n
    f = next(x for x in __import__("os").listdir(out) if x.endswith(".csv"))
    back = pcsv.read_csv(f"{out}/{f}", convert_options=pcsv.ConvertOptions(
        column_types={"t": pa.timestamp("us")}))
    assert back.column("t").cast(pa.int64()).equals(
        pa.chunked_array([ts.cast(pa.int64())]))
