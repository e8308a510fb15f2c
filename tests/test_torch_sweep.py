"""The reference's SQL sweep through the port.

All 41 statements of ``tests/test_sql_sweep.py`` (the qa_nightly role: a
broad battery of SELECTs over a mixed-type table with nulls) run through
``TpuSession.sql`` and ``TorchSession(device="cpu").sql`` over the sweep's
own 500-row table (two partitions in the port, one in the reference), and
must give the same rows under
the sweep's ``_norm`` (floats to 10 significant digits; statements without
ORDER BY compared as sorted rows).

Then the small ``qa`` table (about 4,000 rows, the recipe ``chip_smoke.py``
uses at SF1): the typed columns of the qa_nightly tables with 10 % nulls,
written as parquet by pyarrow and by each package's native writer, as ORC
and as CSV, and scanned by both packages; every column must be equal.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.session import TorchSession

from test_sql_sweep import QUERIES, _norm  # noqa: E402  (tests/ is on sys.path)


def _sweep_table():
    """The sweep's table, as its fixture builds it."""
    n = 500
    r = np.random.default_rng(7)
    mask = lambda p: r.random(n) < p   # noqa: E731

    def witness(vals, m):
        return pa.array([None if mm else v
                         for v, mm in zip(vals.tolist(), m)])
    return pa.table({
        "i": witness(r.integers(-100, 100, n), mask(0.1)),
        "l": witness(r.integers(-10**12, 10**12, n), mask(0.1)),
        "d": witness(np.round(r.normal(0, 50, n), 3), mask(0.1)),
        "s": pa.array([None if m else ["alpha", "Beta", "gamma", "",
                                       "déjà vu", "x" * 20][v % 6]
                       for v, m in zip(r.integers(0, 6, n), mask(0.1))]),
        "b": witness(r.random(n) < 0.5, mask(0.15)),
        "g": pa.array([["u", "v", "w"][v % 3] for v in range(n)]),
    })


@pytest.fixture(scope="module")
def sessions():
    """The port over the sweep's two partitions; the reference over one:
    its fused projection races when two partitions' threads trace an
    untraceable expression (``cast(l as string)``) at once
    (``runtime/fuse.call_fused``). The rows are the same."""
    t = _sweep_table()
    ref = TpuSession()
    ref.create_or_replace_temp_view("t", ref.create_dataframe(
        t, num_partitions=1))
    port = TorchSession(device="cpu")
    port.create_or_replace_temp_view("t", port.create_dataframe(
        t, num_partitions=2))
    return ref, port


def _rows(tbl):
    cols = [c.to_pylist() for c in tbl.columns]
    return [tuple(_norm(v) for v in row) for row in zip(*cols)] \
        if cols else []


@pytest.mark.parametrize("sql", QUERIES)
def test_sweep_statement_matches_reference(sessions, sql):
    """Equal under ``_norm``: 10 significant digits for floats (the sums
    run in another order), everything else exact."""
    ref, port = sessions
    exp = _rows(ref.sql(sql).collect())
    got = _rows(port.sql(sql).collect())
    if "order by" not in sql:
        got, exp = sorted(got, key=repr), sorted(exp, key=repr)
    assert got == exp, f"{sql}\n{got[:5]}\nvs\n{exp[:5]}"
    assert exp or "i > 1000" in sql or "where" in sql


# -- the small qa table, written and scanned by both packages -----------------

QA_STRINGS = ["alpha", "Beta", "gamma", "", "déjà vu", "x" * 20]


def qa_table(n: int, seed: int = 15) -> pa.Table:
    """The sweep-sf1 recipe over synthetic lineitem-like columns: one row
    per 'lineitem' row; every column but ``longF`` has 10 % nulls."""
    rng = np.random.default_rng(seed)
    orderkey = np.sort(rng.integers(1, 6_000_000, n)).astype(np.int64)
    quantity = rng.integers(1, 51, n).astype(np.int8)
    suppkey = rng.integers(1, 10_001, n).astype(np.int32)
    discount = (rng.integers(0, 11, n) / 100.0).astype(np.float32)
    price = np.round(rng.uniform(900.0, 105000.0, n), 2)
    shipdate = rng.integers(8036, 10561, n).astype(np.int32)
    retflag = rng.integers(0, 3, n)

    def nulls(arr):
        return pa.array(arr, mask=rng.random(n) < 0.1)
    secs = (orderkey * 7919) % 86400
    ts = shipdate.astype(np.int64) * 86_400_000_000 + secs * 1_000_000
    names = [f"Customer#{(int(k) * 2654435761) % 150000:09d}"
             for k in orderkey]
    return pa.table({
        "strF": nulls(np.array(QA_STRINGS, dtype=object)[orderkey % 6]),
        "nameF": nulls(np.array(names, dtype=object)),
        "byteF": nulls(quantity),
        "shortF": nulls(((orderkey * 7919) % 65536 - 32768).astype(
            np.int16)),
        "intF": nulls(suppkey),
        "longF": pa.array(orderkey),
        "floatF": nulls(discount),
        "doubleF": nulls(price),
        "decimalF": pa.array([None if m else __import__("decimal").Decimal(
            f"{p:.2f}") for p, m in zip(price, rng.random(n) < 0.1)],
            pa.decimal128(12, 2)),
        "booleanF": nulls(retflag == 2),
        "dateF": nulls(shipdate).cast(pa.date32()),
        "timestampF": pa.array(ts, mask=rng.random(n) < 0.1).cast(
            pa.timestamp("us", tz="UTC")),
    })


@pytest.fixture(scope="module")
def qa_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qa")
    t = qa_table(4000)
    pdir = d / "parquet"
    pdir.mkdir()
    for i in range(2):
        pq.write_table(t.slice(i * 2000, 2000), pdir / f"part-{i}.parquet",
                       row_group_size=1000)
    import pyarrow.orc as orc
    odir = d / "orc"
    odir.mkdir()
    orc.write_table(t, str(odir / "part-0.orc"))
    return t, str(pdir), str(odir), d


def _same_table(got: pa.Table, exp: pa.Table):
    assert got.column_names == exp.column_names
    assert got.num_rows == exp.num_rows
    for name in exp.column_names:
        g, e = got.column(name), exp.column(name)
        if pa.types.is_timestamp(e.type):
            us = pa.timestamp("us", tz="UTC")
            g = g.cast(us).cast(pa.int64())
            e = e.cast(us).cast(pa.int64())
        assert g.to_pylist() == e.to_pylist(), name


def test_qa_parquet_scan_matches_source_and_reference(qa_files):
    """Both packages scan pyarrow's dictionary-encoded files to the source
    table, every column exact; the port's route is the native decode for
    every column but the timestamp (arrow)."""
    t, pdir, _, _ = qa_files
    port = TorchSession({"spark.rapids.tpu.sql.parquet.deviceDecode.enabled":
                         "true"}, device="cpu")
    ref = TpuSession()
    no_ts = [c for c in t.column_names if c != "timestampF"]
    got = port.read_parquet(pdir).select(*no_ts).collect()
    exp = ref.read_parquet(pdir).select(*no_ts).collect()
    _same_table(got, t.select(no_ts))
    _same_table(exp, t.select(no_ts))
    _same_table(port.read_parquet(pdir).collect(), t)


def test_qa_orc_scan_matches_source_and_reference(qa_files):
    t, _, odir, _ = qa_files
    port = TorchSession({"spark.rapids.tpu.sql.orc.deviceDecode.enabled":
                         "true"}, device="cpu")
    ref = TpuSession({"spark.rapids.tpu.sql.orc.deviceDecode.enabled":
                      "true"})
    got = port.read_orc(odir).collect()
    exp = ref.read_orc(odir).collect()
    _same_table(got, t)
    no_ts = [c for c in t.column_names if c != "timestampF"]
    _same_table(exp.select(no_ts), t.select(no_ts))


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_qa_native_writers_round_trip(qa_files, fmt):
    """The port's native parquet and ORC writers write all twelve types;
    pyarrow reads each file back to the source, and the JAX package's
    native writer gives the same table."""
    t, pdir, _, d = qa_files
    port = TorchSession(device="cpu")
    out = str(d / f"port_{fmt}")
    getattr(port.create_dataframe(t), f"write_{fmt}")(out, mode="overwrite")
    files = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f.endswith("." + fmt))
    assert files
    if fmt == "parquet":
        back = pa.concat_tables([pq.read_table(f) for f in files])
    else:
        import pyarrow.orc as orc
        back = pa.concat_tables([orc.read_table(f) for f in files])
    _same_table(back, t)
    ref = TpuSession()
    rout = str(d / f"ref_{fmt}")
    getattr(ref.create_dataframe(t), f"write_{fmt}")(rout, mode="overwrite")
    rfiles = sorted(os.path.join(rout, f) for f in os.listdir(rout)
                    if f.endswith("." + fmt))
    if fmt == "parquet":
        rback = pa.concat_tables([pq.read_table(f) for f in rfiles])
    else:
        import pyarrow.orc as orc
        rback = pa.concat_tables([orc.read_table(f) for f in rfiles])
    _same_table(rback, t)


def test_qa_csv_write_and_typed_read(qa_files):
    """The port's CSV writer writes every type; ``read_csv`` with the typed
    schema reads it back to the source (the integers parsed on the
    device, the timestamp through arrow as UTC)."""
    from spark_rapids_tpu_torch import types as T
    t, _, _, d = qa_files
    port = TorchSession({"spark.rapids.tpu.sql.csv.deviceDecode.enabled":
                         "true"}, device="cpu")
    out = str(d / "port_csv")
    port.create_dataframe(t).write_csv(out, mode="overwrite")
    schema = T.StructType.from_arrow(t.schema)
    back = port.read_csv(out, schema=schema).collect()
    # CSV holds no difference between an empty string and a null one
    exp = t.set_column(0, "strF", pa.array(
        [None if v == "" else v for v in t.column("strF").to_pylist()]))
    _same_table(back, exp)
