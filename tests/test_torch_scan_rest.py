"""The scan's remainder in the PyTorch port on the CPU: encoded upload,
pushed scan filters and the Alluxio path rewrite, held against the port's
own dense route and against the JAX package.

- encoded upload (``columnar/encoded.py``): q1 and q3 at SF 0.01 with the
  device decode set explicitly (as the reference's
  ``tests/test_scan_fusion.py`` sets it), each chunk decoded at its first
  read against every chunk decoded at the scan, bit for bit, and with the
  reference's encoded-upload and scan-fusion confs set false (the same
  route); encoded columns through an exchange, a broadcast, a sort and a
  concat; each encoded vector decoded exactly once (``encoded.counts``:
  the kernel's plain version counts no launch);
- pushed filters against ``TpuSession``: translated predicates (integer,
  string, date, null tests), a residual double predicate over NaN, -0.0,
  0.0 and nulls (Spark's order: NaN above every value, NaN = NaN), a
  string predicate, ORC, and hive partition directories, where a conjunct
  over the partition column makes the reference raise
  (``test_gap_*``);
- the Alluxio rewrite: a rule mapping a fake prefix to the real directory,
  and a rule without ``->``, which raises ``ValueError`` in both packages.

The inputs come from a numpy seed or from the TPC-H generator at SF 0.01.
Tolerance: none (rows compared exactly, floats included).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import encoded as EN
from spark_rapids_tpu_torch.io import parquet_native as PN
from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
from spark_rapids_tpu_torch.session import TorchSession

FUSION = "spark.rapids.tpu.sql.stageFusion.enabled"
SCAN_FUSION = "spark.rapids.tpu.sql.stageFusion.scan.enabled"
ENCODED = "spark.rapids.tpu.sql.parquet.encodedUpload.enabled"
DEVICE_DECODE = "spark.rapids.tpu.sql.parquet.deviceDecode.enabled"
ALLUXIO = "spark.rapids.tpu.alluxio.pathsToReplace"

ON = {DEVICE_DECODE: "true", ENCODED: "true", SCAN_FUSION: "true"}


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def _rows(tbl):
    return list(zip(*[c.to_pylist() for c in tbl.columns]))


def _same(a, b) -> bool:
    """Row lists equal as multisets, NaN equal to NaN (by ``repr``)."""
    return sorted(map(repr, a)) == sorted(map(repr, b))


# -- encoded upload ---------------------------------------------------------

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return tpch.generate(0.01, str(tmp_path_factory.mktemp("tpch_scan")))


def _run(plan):
    EN.reset_counts()
    rows = _rows(plan.execute_collect())
    return rows, dict(EN.counts)


def _decoded_at_scan(read):
    """``read_row_group_device`` with every chunk decoded as the scan yields
    its batch: the dense route the lazy vector replaces."""
    def at_scan(*args, **kw):
        batch = read(*args, **kw)
        for c in batch.columns:
            if isinstance(c, EN.EncodedColumnVector):
                assert c.decode()
        return batch
    return at_scan


def _run_dense(plan, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(PN, "read_row_group_device",
                  _decoded_at_scan(PN.read_row_group_device))
        return _run(plan)


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_encoded_against_dense(paths, query, monkeypatch):
    def plan(conf):
        spark = TorchSession(conf, device="cpu")
        return tpch.QUERIES[query](tpch.load(spark, paths)).physical_plan()
    on_plan = plan(ON)
    on, on_counts = _run(on_plan)
    dense, dense_counts = _run_dense(plan(ON), monkeypatch)
    assert on == dense and on
    # one decode per encoded vector, no more, wherever it decodes
    assert on_counts["made"] == on_counts["decoded"] > 0
    assert dense_counts == on_counts
    scans = [p for p in _walk(on_plan) if isinstance(p, FileSourceScanExec)]
    assert sum(s.stats["encoded_vectors"] for s in scans) == on_counts["made"]
    # the reference's two confs select nothing in the port
    off, off_counts = _run(plan({**ON, ENCODED: "false",
                                 SCAN_FUSION: "false"}))
    assert off == on and off_counts == on_counts


@pytest.fixture(scope="module")
def dict_files(tmp_path_factory):
    """Two small tables of dictionary-encoded chunks, several row groups."""
    d = tmp_path_factory.mktemp("encoded")
    rng = np.random.default_rng(5)
    n = 4000
    facts = pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "f": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        "s": pa.array([None if i % 11 == 0 else f"v{i % 9}"
                       for i in range(n)]),
        "x": pa.array(rng.integers(0, 20, n) / 4.0),
    })
    dim = pa.table({"k": pa.array(np.arange(50), pa.int64()),
                    "name": pa.array([f"n{i % 6}" for i in range(50)])})
    pq.write_table(facts, str(d / "facts.parquet"), row_group_size=1000)
    pq.write_table(dim, str(d / "dim.parquet"))
    return str(d / "facts.parquet"), str(d / "dim.parquet")


def test_encoded_columns_through_every_consumer(dict_files, monkeypatch):
    """An exchange, a broadcast (a join's build), a sort and a concat (a
    union gathered by the sort) each read encoded columns, once each."""
    c = F.col
    facts, dim = dict_files

    def frame(conf):
        spark = TorchSession(conf, device="cpu")
        joined = spark.read_parquet(facts).repartition(3, "f").join(
            spark.read_parquet(dim), on="k")
        return joined.union(joined).sort(c("k"), c("f"), c("s"), c("x"))
    rows, counts = _run(frame(ON).physical_plan())
    dense, _ = _run_dense(frame(ON).physical_plan(), monkeypatch)
    assert repr(rows) == repr(dense) and rows
    # the union scans each table twice: 2 x (4 row groups x 4 columns of
    # facts + 2 columns of dim), each decoded once
    assert counts == {"made": 36, "decoded": 36}


# -- pushed filters -----------------------------------------------------------

@pytest.fixture(scope="module")
def table(tmp_path_factory):
    d = tmp_path_factory.mktemp("pushed")
    rng = np.random.default_rng(8)
    n = 600
    xs = rng.choice([1.0, float("nan"), -0.0, 0.0, 3.5, -2.0, None], n)
    t = pa.table({
        "k": pa.array(np.where(rng.random(n) < 0.1, None,
                               rng.integers(-50, 50, n)).tolist(),
                      pa.int64()),
        "x": pa.array(xs.tolist(), pa.float64()),
        "s": pa.array([None if i % 9 == 0 else f"s{i % 13}"
                       for i in range(n)]),
        "dt": pa.array([datetime.date(1993, 1, 1)
                        + datetime.timedelta(days=int(v))
                        for v in rng.integers(0, 900, n)], pa.date32()),
    })
    path = str(d / "t.parquet")
    pq.write_table(t, path, row_group_size=100)
    orc_path = str(d / "t.orc")
    orc.write_table(t, orc_path)
    hive = d / "hive"
    for p in ("a", "b"):
        os.makedirs(hive / f"p={p}")
        pq.write_table(t.slice(0 if p == "a" else 300, 300),
                       str(hive / f"p={p}" / "f.parquet"))
    return {"parquet": path, "orc": orc_path, "hive": str(hive), "dir": str(d)}


D94 = datetime.date(1994, 1, 1)


def _pred(Fm, Tm, name, plain=False):
    """The predicate ``name``; with ``plain`` the date literal is its day
    number, which a device evaluation takes (a ``datetime.date`` literal is
    evaluated by neither package; pushed, both hand it to arrow)."""
    c, lit = Fm.col, Fm.lit
    day = (D94 - datetime.date(1970, 1, 1)).days if plain else D94
    return {
        "int": (c("k") >= lit(10)) & (c("k") < lit(40)),
        "string": c("s") >= lit("s5"),
        "date": c("dt") < lit(day, Tm.DATE),
        "double": c("x") > lit(0.5),
        "double_nan": c("x") == lit(float("nan")),
        "double_zero": c("x") <= lit(0.0),
        "mixed": (c("k") > lit(0)) & (c("x") >= lit(-0.0))
        & (c("s") != lit("s3")),
    }[name]


PREDICATES = ("int", "string", "date", "double", "double_nan", "double_zero",
              "mixed")


@pytest.mark.parametrize("pred", PREDICATES)
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_pushed_filter_against_the_reference(table, fmt, pred):
    spark = TorchSession(device="cpu")
    read = spark.read_parquet if fmt == "parquet" else spark.read_orc
    df = read(table[fmt], pushed_filter=_pred(F, T, pred))
    plan = df.physical_plan()
    got = _rows(plan.execute_collect())
    ref = TpuSession()
    jread = ref.read_parquet if fmt == "parquet" else ref.read_orc
    want = _rows(jread(table[fmt], pushed_filter=_pred(JF, JT, pred))
                 .collect())
    assert _same(got, want)
    # the same rows as a filter above an unfiltered scan
    plain = _rows(read(table[fmt]).filter(_pred(F, T, pred, plain=True))
                  .collect())
    assert _same(got, plain)
    (scan,) = [p for p in _walk(plan) if isinstance(p, FileSourceScanExec)]
    st = scan.stats
    assert st["device_batches"] == 0 and st["arrow_batches"] > 0
    if pred in ("int", "string", "date"):
        assert st["residual_rows_in"] == 0     # all of it in arrow
    else:
        assert st["residual_rows_out"] == len(got)
        assert st["syncs"] == st["arrow_batches"]
    if pred == "mixed":
        # the integer and string conjuncts went to arrow, the double one
        # is the residual, over fewer rows than the table holds
        assert 0 < st["residual_rows_in"] < 600


def test_pushed_filter_keeps_its_columns_through_pruning(table):
    spark = TorchSession(device="cpu")
    df = spark.read_parquet(table["parquet"],
                            pushed_filter=F.col("x") > F.lit(0.5))
    got = _rows(df.select(F.col("k")).collect())
    want = _rows(TpuSession().read_parquet(
        table["parquet"], pushed_filter=JF.col("x") > JF.lit(0.5))
        .select(JF.col("k")).collect())
    assert repr(got) == repr(want) and got


def test_pushed_filter_over_hive_data_columns(table):
    got = _rows(TorchSession(device="cpu").read_parquet(
        table["hive"], pushed_filter=_pred(F, T, "mixed")).collect())
    want = _rows(TpuSession().read_parquet(
        table["hive"], pushed_filter=_pred(JF, JT, "mixed")).collect())
    assert _same(got, want) and got


def test_gap_pushed_filter_over_a_partition_column(table):
    """A pushed conjunct over a hive partition column: the reference hands
    it to arrow's file scan, which has no such column and raises; the port
    evaluates it as the residual and gives Spark's rows."""
    import pyarrow.lib
    with pytest.raises(pyarrow.lib.ArrowInvalid):
        TpuSession().read_parquet(
            table["hive"], pushed_filter=JF.col("p") == JF.lit("a")).collect()
    got = _rows(TorchSession(device="cpu").read_parquet(
        table["hive"], pushed_filter=(F.col("p") == F.lit("a"))
        & (F.col("k") > F.lit(0))).collect())
    src = pq.read_table(table["parquet"]).slice(0, 300).to_pylist()
    want = [(r["k"], r["x"], r["s"], r["dt"], "a") for r in src
            if r["k"] is not None and r["k"] > 0]
    assert _same(got, want) and got


def test_unported_residual_raises_at_planning(table):
    df = TorchSession(device="cpu").read_parquet(
        table["parquet"], pushed_filter=F.col("x") > F.lit(0.5))
    df.physical_plan()
    from spark_rapids_tpu_torch.plan import overrides as O
    original = O.check_expression

    def refuse(e, **kw):
        raise NotImplementedError("refused")
    O.check_expression = refuse
    try:
        with pytest.raises(NotImplementedError):
            df.physical_plan()
    finally:
        O.check_expression = original


# -- the Alluxio path rewrite ------------------------------------------------

def test_alluxio_rewrite_against_the_reference(table):
    fake = "/alluxio-mount/data"
    rule = f"{fake}->{table['dir']}"
    path = f"{fake}/t.parquet"
    got = TorchSession({ALLUXIO: rule}, device="cpu").read_parquet(
        path).collect()
    want = TpuSession({ALLUXIO: rule}).read_parquet(path).collect()
    assert repr(_rows(got)) == repr(_rows(want))
    assert got.num_rows == 600
    # ORC and CSV scans take the rewrite too, and a list of paths
    orc_rows = TorchSession({ALLUXIO: rule}, device="cpu").read_orc(
        f"{fake}/t.orc").collect()
    assert orc_rows.num_rows == 600
    csv_path = os.path.join(table["dir"], "t.csv")
    import pyarrow.csv as pcsv
    pcsv.write_csv(pq.read_table(table["parquet"]).select(["k", "s"]),
                   csv_path)
    schema = T.StructType([T.StructField("k", T.LONG, True),
                           T.StructField("s", T.STRING, True)])
    csv_rows = TorchSession({ALLUXIO: rule}, device="cpu").read_csv(
        [f"{fake}/t.csv"], schema=schema).collect()
    assert _rows(csv_rows) == _rows(pq.read_table(
        table["parquet"]).select(["k", "s"]))


def test_alluxio_bad_rule_raises(table):
    from spark_rapids_tpu.io.filescan import rewrite_scan_path as jrewrite
    from spark_rapids_tpu_torch.io.filescan import rewrite_scan_path
    bad = {ALLUXIO: "/a=/b"}
    with pytest.raises(ValueError):
        TorchSession(bad, device="cpu").read_parquet(table["parquet"])
    with pytest.raises(ValueError):
        TpuSession(bad).read_parquet(table["parquet"])
    spark = TorchSession({ALLUXIO: "/x->/y; /x/z->/w"}, device="cpu")
    ref = TpuSession({ALLUXIO: "/x->/y; /x/z->/w"})
    for p in ("/x/z/f", "/q/f", ["/x/1", "/x/z/2"]):
        assert rewrite_scan_path(p, spark.conf) == jrewrite(p, ref.conf)


# -- Queue 3: date literals in pushed filters, and LEGACY dates ---------------

def test_residual_date_literal_runs_on_the_device(table):
    """A pushed filter whose date conjunct does not translate (an OR with a
    double comparison) runs as the residual on the device with a
    ``datetime.date`` literal: the rows of the same filter above the scan.
    The reference hands the date object to the device and raises."""
    def pred(Fm, Tm):
        return ((Fm.col("dt") < Fm.lit(D94, Tm.DATE))
                | (Fm.col("x") > Fm.lit(0.5)))

    spark = TorchSession(device="cpu")
    got = _rows(spark.read_parquet(table["parquet"],
                                   pushed_filter=pred(F, T)).collect())
    plain = _rows(spark.read_parquet(table["parquet"])
                  .filter(pred(F, T)).collect())
    assert got and _same(got, plain)
    days = (D94 - datetime.date(1970, 1, 1)).days
    want = _rows(spark.read_parquet(table["parquet"]).filter(
        (F.col("dt") < F.lit(days, T.DATE)) | (F.col("x") > F.lit(0.5)))
        .collect())
    assert _same(got, want)
    with pytest.raises(Exception):
        TpuSession().read_parquet(table["parquet"],
                                  pushed_filter=pred(JF, JT)).collect()


@pytest.fixture(scope="module")
def legacy_file(tmp_path_factory):
    """1500-03-01 as the file's raw (hybrid-calendar) day, which LEGACY
    reads as 1500-02-20, and a later date."""
    path = str(tmp_path_factory.mktemp("legacy") / "d.parquet")
    pq.write_table(pa.table({
        "dt": pa.array([datetime.date(1500, 3, 1), datetime.date(1600, 6, 1)],
                       pa.date32()),
        "v": pa.array([1, 2])}), path)
    return path


@pytest.mark.parametrize("mode", ["LEGACY", "CORRECTED"])
def test_pushed_date_filter_under_rebase_modes(legacy_file, mode):
    """Under LEGACY a pushed DATE conjunct stays in the residual, which runs
    after the rebase, so the pushed filter keeps what the same filter above
    the scan keeps (Spark rebases the pushed literal and keeps 1500-02-20 <
    1500-02-25). The reference pushes it to arrow over the raw days and
    drops the row. CORRECTED pushes it, as before."""
    conf = {"spark.rapids.tpu.sql.parquet.datetimeRebaseModeInRead": mode}
    cut = datetime.date(1500, 2, 25)
    spark = TorchSession(conf, device="cpu")
    df = spark.read_parquet(legacy_file,
                            pushed_filter=F.col("dt") < F.lit(cut, T.DATE))
    plan = df.physical_plan()
    got = plan.execute_collect().to_pylist()
    above = (spark.read_parquet(legacy_file)
             .filter(F.col("dt") < F.lit(cut, T.DATE)).collect().to_pylist())
    assert got == above
    (scan,) = [p for p in _walk(plan) if isinstance(p, FileSourceScanExec)]
    ref = TpuSession(conf).read_parquet(
        legacy_file, pushed_filter=JF.col("dt") < JF.lit(cut, JT.DATE))
    if mode == "LEGACY":
        assert got == [{"dt": datetime.date(1500, 2, 20), "v": 1}]
        assert scan.stats["residual_rows_in"] == 2
        assert ref.collect().to_pylist() == []          # the reference gap
    else:
        assert got == []
        assert scan.stats["residual_rows_in"] == 0
        assert ref.collect().to_pylist() == got
