"""The port's arrow reader path (``io/readers.py``, the arrow half of
``io/filescan.py``) and hive partition directories, held against the JAX
package on the same files:

- the PERFILE, MULTITHREADED and COALESCING strategies: ``tables_for`` gives
  the reference's tables, batch for batch; the device batches of the arrow
  path (``parquet.deviceDecode.enabled=false``) equal the reference's
  ``FileSourceScanExec`` batches over the whole padded capacity;
- hive directories: discovery, the layout check, the partition columns'
  types (INT, LONG, STRING, not nullable) and pruning that keeps them;
  scans and TPC-H q1 over ``l_returnflag=A|N|R`` directories through
  ``TorchSession(device="cpu")`` against ``TpuSession`` and the NumPy
  oracle;
- the arrow path where the device decode refuses a partition: row groups
  above the reader caps, and dates before the Gregorian cutover under the
  DATE rebase modes EXCEPTION / CORRECTED / LEGACY.

Tolerance: exact, except TPC-H q1's sums, which the sessions may take in
another order (rel 1e-9, tests/test_tpch.py's bound).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.config import RapidsConf
from spark_rapids_tpu.exec.base import TaskContext
from spark_rapids_tpu.io.filescan import FileScanNode, FileSourceScanExec
from spark_rapids_tpu.plan.pruning import prune_columns as jprune
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shims import rebase_julian_to_gregorian_days as jrebase

import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.config import RapidsConf as TorchConf
from spark_rapids_tpu_torch.io import readers as R
from spark_rapids_tpu_torch.io.filescan import FileScanNode as TFileScanNode
from spark_rapids_tpu_torch.io.filescan import \
    FileSourceScanExec as TFileSourceScanExec
from spark_rapids_tpu_torch.plan.pruning import prune_columns
from spark_rapids_tpu_torch.session import TorchSession

STRATEGIES = ["PERFILE", "MULTITHREADED", "COALESCING"]
OFF = "spark.rapids.tpu.sql.parquet.deviceDecode.enabled"
READER = "spark.rapids.tpu.sql.format.parquet.reader.type"
REBASE = "spark.rapids.tpu.sql.parquet.datetimeRebaseModeInRead"
ROWS = "spark.rapids.tpu.sql.reader.batchSizeRows"


def _table(rng, n: int) -> pa.Table:
    return pa.table({
        "i": pa.array(rng.integers(0, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "l": pa.array(rng.integers(-10**12, 10**12, n)),
        "d": pa.array(np.round(rng.uniform(0, 100, n), 2),
                      mask=rng.random(n) < 0.05),
        "s": pa.array(np.array(["p", "qq", "r", ""])[rng.integers(0, 4, n)],
                      mask=rng.random(n) < 0.2),
        "dt": pa.array(rng.integers(8000, 11000, n).astype(np.int32),
                       mask=rng.random(n) < 0.1).cast(pa.date32()),
    })


@pytest.fixture(scope="module")
def multi_dir(tmp_path_factory):
    """Five files of 400..1,600 rows, row groups of 300."""
    rng = np.random.default_rng(5)
    d = str(tmp_path_factory.mktemp("multi"))
    for i, n in enumerate((400, 1600, 700, 1100, 900)):
        pq.write_table(_table(rng, n), os.path.join(d, f"part-{i}.parquet"),
                       row_group_size=300)
    return d


def _files(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_tables_match_reference(multi_dir, strategy):
    files = _files(multi_dir)
    jnode = FileScanNode(files, "parquet", files_per_partition=5)
    tnode = TFileScanNode(files, "parquet", files_per_partition=5)
    kw = dict(batch_rows=500, strategy=strategy, num_threads=3,
              target_rows=1500)
    want = list(jnode.tables_for(0, **kw))
    got = list(tnode.tables_for(0, **kw))
    assert [t.num_rows for t in got] == [t.num_rows for t in want]
    assert all(g.equals(w) for g, w in zip(got, want))
    assert sum(t.num_rows for t in got) == 4700


def _assert_batches_equal(tb, jb):
    assert len(tb) == len(jb) and tb
    for t, j in zip(tb, jb):
        assert t.num_rows == j.num_rows
        assert t.schema.names == j.schema.names
        for name, tc, jc in zip(t.schema.names, t.columns, j.columns):
            assert tc.dtype.sql_name == jc.dtype.sql_name, name
            np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data),
                                          err_msg=name)
            np.testing.assert_array_equal(tc.validity.numpy(),
                                          np.asarray(jc.validity),
                                          err_msg=name)
            if jc.is_string:
                assert tc.dictionary.equals(jc.dictionary), name


def _scan_both(paths, conf: dict, files_per_partition: int = 1):
    """The device batches of one scan in each package, and the port's exec."""
    jex = FileSourceScanExec(
        FileScanNode(paths, "parquet",
                     files_per_partition=files_per_partition,
                     options={"rebase_mode": conf.get(REBASE, "EXCEPTION")}),
        conf=RapidsConf(conf))
    jb = []
    with TaskContext():
        for split in range(jex.num_partitions):
            jb.extend(jex.execute_partition(split))
    tex = TFileSourceScanExec(
        TFileScanNode(paths, "parquet",
                      files_per_partition=files_per_partition),
        conf=TorchConf(conf), device="cpu")
    tb = [b for split in range(tex.num_partitions)
          for b in tex.execute_partition(split)]
    return tb, jb, tex


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_arrow_path_batches_match_reference(multi_dir, strategy):
    tb, jb, tex = _scan_both(_files(multi_dir),
                             {OFF: "false", READER: strategy},
                             files_per_partition=2)
    _assert_batches_equal(tb, jb)
    assert tex.stats == {"device_batches": 0, "arrow_batches": len(tb),
                         "strategy": strategy, "encoded_vectors": 0,
                         "residual_rows_in": 0, "residual_rows_out": 0,
                         "syncs": 0}


def test_row_groups_above_the_reader_caps_take_the_arrow_path(multi_dir):
    tb, jb, tex = _scan_both(_files(multi_dir),
                             {OFF: "true", ROWS: "250"})
    _assert_batches_equal(tb, jb)
    assert tex.stats["device_batches"] == 0
    assert tex.stats["arrow_batches"] == len(tb) > 5
    assert max(b.num_rows for b in tb) <= 250


def test_device_decode_and_arrow_path_agree(multi_dir):
    files = _files(multi_dir)
    on, _, ex_on = _scan_both(files, {OFF: "true"})
    off, _, ex_off = _scan_both(files, {OFF: "false", READER: "PERFILE"})
    assert ex_on.stats["arrow_batches"] == 0 < ex_on.stats["device_batches"]
    assert ex_off.stats["device_batches"] == 0

    def rows(batches):
        return pa.concat_tables([b.to_arrow() for b in batches])
    assert rows(on).equals(rows(off))


# -- hive partition directories ----------------------------------------------

def _write_hive(root, parts: dict, rng):
    """``{relative dir: rows}`` of _table files under ``root``."""
    for rel, n in parts.items():
        d = os.path.join(root, rel)
        os.makedirs(d, exist_ok=True)
        pq.write_table(_table(rng, n), os.path.join(d, "part-0.parquet"))
    # what Spark's file index skips
    os.makedirs(os.path.join(root, "_temporary"), exist_ok=True)
    pq.write_table(_table(rng, 3), os.path.join(root, "_temporary", "x.parquet"))


@pytest.fixture(scope="module")
def hive_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hive"))
    _write_hive(root, {"k=1/p=a": 300, "k=2/p=b": 500, "k=3000000000/p=a": 200,
                       "k=2/p=c": 100}, np.random.default_rng(9))
    return root


def _fields(node):
    return [(f.name, f.data_type.sql_name, f.nullable) for f in node.output]


def test_hive_discovery_and_partition_types(hive_dir, tmp_path):
    jnode = FileScanNode(hive_dir, "parquet")
    tnode = TFileScanNode(hive_dir, "parquet")
    assert [p.paths for p in tnode.partitions] == \
        [p.paths for p in jnode.partitions]
    assert [p.partition_values for p in tnode.partitions] == \
        [p.partition_values for p in jnode.partitions]
    assert _fields(tnode) == _fields(jnode)
    assert _fields(tnode)[-2:] == [("k", "bigint", False),
                                   ("p", "string", False)]
    assert tnode._data_columns() == jnode._data_columns() == \
        ["i", "l", "d", "s", "dt"]
    small = str(tmp_path / "small")
    _write_hive(small, {"k=7": 10, "k=-3": 10}, np.random.default_rng(1))
    assert _fields(TFileScanNode(small, "parquet"))[-1] == \
        _fields(FileScanNode(small, "parquet"))[-1] == ("k", "int", False)


def test_inconsistent_layout_raises(tmp_path):
    _write_hive(str(tmp_path), {"k=1": 5, "j=2": 5},
                np.random.default_rng(2))
    for node in (FileScanNode, TFileScanNode):
        with pytest.raises(ValueError, match="inconsistent partition"):
            node(str(tmp_path), "parquet")


def _sorted_rows(tbl: pa.Table) -> list:
    return sorted(tbl.to_pylist(), key=lambda r: repr(sorted(r.items())))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_hive_scan_matches_reference(hive_dir, strategy):
    tb, jb, tex = _scan_both(hive_dir, {READER: strategy})
    _assert_batches_equal(tb, jb)
    assert tex.stats["device_batches"] == 0
    got = TorchSession({READER: strategy}, device="cpu") \
        .read_parquet(hive_dir).collect()
    want = TpuSession({READER: strategy}).read_parquet(hive_dir).collect()
    assert got.num_rows == 1100
    assert _sorted_rows(got) == _sorted_rows(want)


def test_pruned_hive_scan_keeps_the_partition_columns(hive_dir):
    def build(s, Fm):
        return (s.read_parquet(hive_dir)
                .filter(Fm.col("i") <= Fm.lit(20))
                .select(Fm.col("l"), Fm.col("k")))
    tplan = prune_columns(build(TorchSession(device="cpu"), F)._plan)
    jplan = jprune(build(TpuSession(), JF)._plan)

    def scan_names(p):
        while p.children:
            p = p.children[0]
        return p.output.names
    assert scan_names(tplan) == scan_names(jplan) == ["i", "l", "k", "p"]
    got = build(TorchSession(device="cpu"), F).collect()
    want = build(TpuSession(), JF).collect()
    assert _sorted_rows(got) == _sorted_rows(want)


@pytest.fixture(scope="module")
def q1_hive(tmp_path_factory):
    """TPC-H lineitem at SF 0.002 rewritten as l_returnflag=A|N|R
    directories without the column."""
    paths = jtpch.generate(0.002, str(tmp_path_factory.mktemp("tpch_hive")))
    li = pq.read_table(paths["lineitem"])
    root = str(tmp_path_factory.mktemp("lineitem_hive"))
    for flag in ("A", "N", "R"):
        part = li.filter(pc.equal(li["l_returnflag"], flag)) \
            .drop_columns(["l_returnflag"])
        d = os.path.join(root, f"l_returnflag={flag}")
        os.makedirs(d)
        pq.write_table(part, os.path.join(d, "part-0000.parquet"))
    return paths, root


def _assert_q1_equal(got, exp):
    assert len(got) == len(exp) == 4
    for g, e in zip(got, exp):
        g, e = list(g), list(e)
        assert g[0] == e[0] and g[1] == e[1] and g[9] == e[9]
        for a, b in zip(g[2:9], e[2:9]):
            assert a == pytest.approx(b, rel=1e-9)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_q1_over_hive_directories(q1_hive, strategy):
    paths, root = q1_hive
    spark = TorchSession({READER: strategy}, device="cpu")
    df = tpch.q1({"lineitem": spark.read_parquet(root)})
    plan = df.physical_plan()
    got = plan.execute_collect().to_pylist()
    want = jtpch.q1({"lineitem": TpuSession().read_parquet(root)}) \
        .collect().to_pylist()
    assert [list(r) for r in got] == [list(r) for r in want]
    _assert_q1_equal([list(r.values()) for r in got],
                     [list(r.values()) for r in want])
    _assert_q1_equal([list(r.values()) for r in got],
                     tpch.np_q1(tpch.load_np({"lineitem":
                                              paths["lineitem"]})))
    scan = plan
    while scan.children:
        scan = scan.children[0]
    assert sorted(scan.output.names) == sorted(
        ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "l_returnflag", "l_linestatus", "l_shipdate"])
    assert scan.output.names[-1] == "l_returnflag"
    assert scan.stats["device_batches"] == 0
    assert scan.stats["arrow_batches"] >= 3
    assert scan.stats["strategy"] == strategy


# -- the DATE rebase ---------------------------------------------------------

def test_rebase_days_equal_the_reference():
    rng = np.random.default_rng(3)
    days = np.concatenate([rng.integers(-800_000, 20_000, 5000),
                           np.arange(R.GREGORIAN_SWITCH_DAY - 40,
                                     R.GREGORIAN_SWITCH_DAY + 40)])
    np.testing.assert_array_equal(R.rebase_julian_to_gregorian_days(days),
                                  jrebase(days))


@pytest.fixture(scope="module")
def old_dates(tmp_path_factory):
    rng = np.random.default_rng(4)
    days = np.concatenate([rng.integers(-400_000, -141_427, 300),
                           rng.integers(-141_427, 20_000, 300)]).astype(
        np.int32)
    path = str(tmp_path_factory.mktemp("old_dates") / "d.parquet")
    pq.write_table(pa.table({
        "dt": pa.array(days, mask=rng.random(600) < 0.1).cast(pa.date32()),
        "v": pa.array(rng.integers(0, 9, 600))}), path, row_group_size=200)
    return path


@pytest.mark.parametrize("mode", ["EXCEPTION", "CORRECTED", "LEGACY"])
def test_date_rebase_modes(old_dates, mode):
    conf = {REBASE: mode}
    if mode == "EXCEPTION":
        for run in (lambda: TorchSession(conf, device="cpu")
                    .read_parquet(old_dates).collect(),
                    lambda: TpuSession(conf).read_parquet(old_dates)
                    .collect()):
            with pytest.raises(ValueError, match="1582-10-15"):
                run()
        return
    tb, jb, tex = _scan_both(old_dates, conf)
    _assert_batches_equal(tb, jb)
    # footer statistics cannot prove the dates post-cutover: the arrow path
    assert tex.stats["device_batches"] == 0 < tex.stats["arrow_batches"]
    got = TorchSession(conf, device="cpu").read_parquet(old_dates).collect()
    want = TpuSession(conf).read_parquet(old_dates).collect()
    assert got.equals(want)
    raw = pq.read_table(old_dates)
    assert got.column("dt").equals(raw.column("dt")) == (mode == "CORRECTED")
