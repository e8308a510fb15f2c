"""The packed row format of the PyTorch port (``columnar/rows.py``, its own
copy of the reference's) on the CPU, held against the JAX package.

numpy-seeded tables (bool, int, bigint, float, double, date, timestamp,
decimal, strings; 10 % nulls) are packed by both modules and the words
compared bit for bit, in the fixed-width layout (``pack_arrow``,
``pack_rows``) and the UnsafeRow-style variable layout
(``pack_arrow_var``); each unpacks both modules' words back to the source.
Then ``DataFrame.collect_row_buffer`` and
``TorchSession.create_dataframe_from_rows`` both ways against
``TpuSession``'s. Tolerance: none (words and values exact).
"""

from __future__ import annotations

import datetime

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import rows as JR
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import rows as R
from spark_rapids_tpu_torch.session import TorchSession


def table(seed: int, n: int, strings: bool) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.1
    cols = {
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=nulls()),
        "l": pa.array(rng.integers(-2**62, 2**62, n), mask=nulls()),
        "f": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=nulls()),
        "d": pa.array(np.append(rng.standard_normal(n - 1), np.nan),
                      mask=nulls()),
        "dt": pa.array(rng.integers(-1000, 30000, n).astype(np.int32),
                       mask=nulls()).cast(pa.date32()),
        "ts": pa.array(rng.integers(-2**40, 2**50, n),
                       mask=nulls()).cast(pa.timestamp("us", tz="UTC")),
        "dec": pa.array([None if rng.random() < 0.1 else
                         __import__("decimal").Decimal(int(x)).scaleb(-2)
                         for x in rng.integers(-10**9, 10**9, n)],
                        pa.decimal128(12, 2)),
    }
    if strings:
        words = ["", "a", "déjà vu", "x" * 19, "hello world"]
        cols["s"] = pa.array([None if rng.random() < 0.1 else
                              words[int(k)] for k in
                              rng.integers(0, len(words), n)])
        cols["s2"] = pa.array([f"r{k}" for k in range(n)])
    return pa.table(cols)


def same(a: pa.Table, b: pa.Table) -> bool:
    """Equal schemas and values, NaN equal to NaN (``Table.equals`` holds
    NaN unequal to itself)."""
    return a.schema == b.schema and repr(a.to_pylist()) == repr(
        b.to_pylist())


@pytest.mark.parametrize("n", [1, 7, 300])
def test_fixed_width_words_as_the_reference(n):
    t = table(81 + n, n, strings=False)
    schema, jschema = T.StructType.from_arrow(t.schema), \
        JT.StructType.from_arrow(t.schema)
    assert R.is_fixed_width(schema) and not R.is_fixed_width(
        T.StructType.from_arrow(table(1, 2, True).schema))
    mine, ref = R.pack_arrow(t, schema), JR.pack_arrow(t, jschema)
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    assert same(R.unpack_rows_arrow(ref, schema), t)
    assert same(JR.unpack_rows_arrow(mine, jschema), t)


def test_pack_rows_of_a_device_batch_as_the_reference():
    from spark_rapids_tpu.columnar import arrow as JA
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    t = table(91, 120, strings=False)
    mine = R.pack_rows(ColumnarBatch.from_arrow(t, "cpu"))
    ref = JR.pack_rows(JA.table_to_device(t))
    assert np.array_equal(mine, ref)
    back = R.unpack_rows(mine, T.StructType.from_arrow(t.schema), "cpu")
    assert same(back.to_arrow(), t)


@pytest.mark.parametrize("n", [1, 5, 250])
def test_variable_width_words_as_the_reference(n):
    t = table(97 + n, n, strings=True)
    schema, jschema = T.StructType.from_arrow(t.schema), \
        JT.StructType.from_arrow(t.schema)
    assert R.is_packable(schema)
    (w, off), (jw, joff) = (R.pack_arrow_var(t, schema),
                            JR.pack_arrow_var(t, jschema))
    assert np.array_equal(w, jw) and np.array_equal(off, joff)
    assert same(R.unpack_rows_arrow_var(jw, joff, schema), t)


def test_row_buffer_round_trips_through_both_sessions():
    t = table(101, 200, strings=False)
    port = TorchSession(device="cpu").create_dataframe(t, 2)
    ref = TpuSession().create_dataframe(t, 2)
    rows, schema = port.collect_row_buffer()
    jrows, jschema = ref.collect_row_buffer()
    assert np.array_equal(rows, jrows)
    back = port.session.create_dataframe_from_rows(rows, schema,
                                                   num_partitions=3)
    assert back._plan.num_partitions == 3
    assert same(back.collect(), t)
    jback = ref.session.create_dataframe_from_rows(jrows, jschema,
                                                   num_partitions=3)
    assert repr(back.collect().to_pylist()) == repr(
        jback.collect().to_pylist())


def test_variable_row_buffer_round_trips_through_both_sessions():
    t = table(103, 150, strings=True)
    port = TorchSession(device="cpu").create_dataframe(t)
    ref = TpuSession().create_dataframe(t)
    (w, off), schema = port.collect_row_buffer()
    (jw, joff), _ = ref.collect_row_buffer()
    assert np.array_equal(w, jw) and np.array_equal(off, joff)
    back = port.session.create_dataframe_from_rows((w, off), schema)
    assert same(back.collect(), t)
    # q-shaped work over the rows: a filter and a group-by
    import spark_rapids_tpu_torch.functions as F
    got = back.filter(F.col("i") > 0).group_by("s").agg(
        F.count().alias("n")).collect()
    want = {}
    for r in t.to_pylist():
        if r["i"] is not None and r["i"] > 0:
            want[r["s"]] = want.get(r["s"], 0) + 1
    assert dict(zip(got.column("s").to_pylist(),
                    got.column("n").to_pylist())) == want


def test_nested_columns_have_no_row_format():
    df = TorchSession(device="cpu").create_dataframe(pa.table(
        {"a": pa.array([[1]], pa.list_(pa.int64())),
         "d": [datetime.date(2020, 1, 1)]}))
    with pytest.raises(NotImplementedError):
        df.collect_row_buffer()
