"""Column pruning of the port (``plan/pruning.py``) held against the JAX
package's ``prune_columns`` on the CPU:

- the reference's ``tests/test_pruning.py`` cases rebuilt on the port: the
  columns every scan reads (a spy on the device row-group reader), the
  results against ``TpuSession`` on the same file, the filter's columns that
  survive narrowing, the ordinal remap across a join and a sort, the
  aggregate, and the identity rule (nothing to narrow → the same objects;
  the logical plan is never mutated, so a DataFrame collects twice);
- the same logical plans through both packages' ``prune_columns``: the
  same kept column names per scan, in plan order, for the DataFrame ladder
  (q1, q3, q5, q18), q1 over ``repartition(8, keys)`` (its exchange carries
  the 7 columns q1 reads), and the official q1/q3/q5 SQL text.

Tolerance: exact, except the TPC-H sums, which both sessions compute in
another order (rel 1e-9).
"""

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.plan.pruning import prune_columns as jprune
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.sql.tpch_queries import SQL_QUERIES as JSQL

import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.io import parquet_native as PN
from spark_rapids_tpu_torch.plan.pruning import prune_columns
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.sql.tpch_queries import SQL_QUERIES

SF = 0.01


@pytest.fixture
def scan_spy(monkeypatch):
    """Record the column list every device row-group read receives."""
    seen = []
    orig = PN.read_row_group_device

    def spy(path, row_group, schema, device, columns=None, pf=None):
        seen.append(tuple(columns or ()))
        return orig(path, row_group, schema, device, columns, pf=pf)
    monkeypatch.setattr(PN, "read_row_group_device", spy)
    return seen


@pytest.fixture
def wide_file(tmp_path):
    t = pa.table({
        "a": pa.array(range(100), pa.int64()),
        "b": pa.array([i * 2 for i in range(100)], pa.int64()),
        "c": pa.array([float(i) for i in range(100)]),
        "d": pa.array([str(i % 7) for i in range(100)]),
        "e": pa.array([i % 3 == 0 for i in range(100)]),
    })
    p = str(tmp_path / "wide.parquet")
    pq.write_table(t, p)
    return p, t


def _both(build):
    """``build(spark, functions)`` collected through the port and the
    reference, as row lists."""
    return (build(TorchSession(device="cpu"), F).collect().to_pylist(),
            build(TpuSession(), JF).collect().to_pylist())


def test_scan_reads_only_selected_columns(wide_file, scan_spy):
    p, t = wide_file
    got, want = _both(lambda s, Fm: s.read_parquet(p).select("b", "d"))
    assert set(scan_spy) == {("b", "d")}
    assert got == want
    assert [r["d"] for r in got] == t.column("d").to_pylist()


def test_filter_columns_survive_narrowing(wide_file, scan_spy):
    """A filter on a column that is not projected keeps it readable, and
    the ordinals above the narrowed scan rebind."""
    p, _ = wide_file
    got, want = _both(lambda s, Fm: s.read_parquet(p)
                      .filter(Fm.col("a") > Fm.lit(90))
                      .select(Fm.col("d"), (Fm.col("c") * Fm.lit(2.0))
                              .alias("c2")))
    assert set(scan_spy) == {("a", "c", "d")}
    assert got == want
    assert [r["d"] for r in got] == [str(i % 7) for i in range(91, 100)]
    assert [r["c2"] for r in got] == [i * 2.0 for i in range(91, 100)]


def test_remap_across_join_and_sort(tmp_path, scan_spy):
    """Ordinal rebinding across a join (both sides narrowed by different
    amounts) and a sort on a column that is not first."""
    left = pa.table({
        "k": pa.array([1, 2, 3, 4], pa.int64()),
        "lv": pa.array([10.0, 20.0, 30.0, 40.0]),
        "junk1": pa.array(["x"] * 4),
    })
    right = pa.table({
        "k2": pa.array([2, 3, 4, 5], pa.int64()),
        "rv": pa.array([200, 300, 400, 500], pa.int64()),
        "junk2": pa.array([0.5] * 4),
        "junk3": pa.array([False] * 4),
    })
    lp, rp = str(tmp_path / "l.parquet"), str(tmp_path / "r.parquet")
    pq.write_table(left, lp)
    pq.write_table(right, rp)

    def build(spark, Fm):
        return (spark.read_parquet(lp)
                .join(spark.read_parquet(rp).select(
                    Fm.col("k2").alias("k"), Fm.col("rv")), on="k")
                .select(Fm.col("lv"), Fm.col("rv"))
                .sort(Fm.col("rv"), ascending=False))
    got, want = _both(build)
    assert got == want == [{"lv": 40.0, "rv": 400},
                           {"lv": 30.0, "rv": 300},
                           {"lv": 20.0, "rv": 200}]
    assert set(scan_spy) == {("k", "lv"), ("k2", "rv")}


def test_aggregate_narrow(wide_file, scan_spy):
    p, _ = wide_file
    got, want = _both(lambda s, Fm: s.read_parquet(p).group_by("d")
                      .agg(Fm.sum(Fm.col("b")).alias("sb"))
                      .sort(Fm.col("d")))
    assert set(scan_spy) == {("b", "d")}
    assert got == want
    exp = {}
    for i in range(100):
        exp[str(i % 7)] = exp.get(str(i % 7), 0) + i * 2
    assert {r["d"]: r["sb"] for r in got} == exp


def test_count_star_keeps_one_column(wide_file, scan_spy):
    """A count(*) over a grouping key reads the key only."""
    p, _ = wide_file
    got, want = _both(lambda s, Fm: s.read_parquet(p).group_by("e")
                      .agg(Fm.count().alias("n")).sort(Fm.col("e")))
    assert got == want == [{"e": False, "n": 66}, {"e": True, "n": 34}]
    assert set(scan_spy) == {("e",)}


def test_identity_preserving_when_nothing_narrows(wide_file):
    p, _ = wide_file
    df = TorchSession(device="cpu").read_parquet(p).select(
        "a", "b", "c", "d", "e")
    assert prune_columns(df._plan) is df._plan


def test_logical_plan_is_not_mutated(wide_file, scan_spy):
    p, _ = wide_file
    df = TorchSession(device="cpu").read_parquet(p).select("c")
    scan = df._plan.child
    before = scan.output.names
    first = df.collect().to_pylist()
    assert scan.output.names == before == ["a", "b", "c", "d", "e"]
    assert df.collect().to_pylist() == first
    assert set(scan_spy) == {("c",)}


# -- the same plans through both passes ---------------------------------------

def _scan_columns(plan):
    """Each scan's column names, in plan order (depth first)."""
    if not plan.children and hasattr(plan, "partitions"):
        return [tuple(plan.output.names)]
    out = []
    for c in plan.children:
        out += _scan_columns(c)
    return out


@pytest.fixture(scope="module")
def tpch_paths(tmp_path_factory):
    return jtpch.generate(SF, str(tmp_path_factory.mktemp("tpch_prune")))


def _repartitioned(mod, spark, paths):
    dfs = mod.load(spark, paths)
    dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_returnflag",
                                                  "l_linestatus")
    return mod.q1(dfs)


LADDER = {
    "q1": lambda mod, s, p: mod.q1(mod.load(s, p)),
    "q3": lambda mod, s, p: mod.q3(mod.load(s, p)),
    "q5": lambda mod, s, p: mod.q5(mod.load(s, p)),
    "q18": lambda mod, s, p: mod.q18(mod.load(s, p)),
    "q1-repartition": _repartitioned,
    "sql-q1": lambda mod, s, p: (mod.load(s, p), s.sql(_SQL[mod]["q1"]))[1],
    "sql-q3": lambda mod, s, p: (mod.load(s, p), s.sql(_SQL[mod]["q3"]))[1],
    "sql-q5": lambda mod, s, p: (mod.load(s, p), s.sql(_SQL[mod]["q5"]))[1],
}
_SQL = {tpch: SQL_QUERIES, jtpch: JSQL}

# what each ladder query's lineitem scan reads (bench.py:113-132)
LINEITEM = {
    "q1": 7, "q1-repartition": 7, "sql-q1": 7, "q3": 4, "sql-q3": 4,
    "q5": 4, "sql-q5": 4, "q18": 2}


@pytest.mark.parametrize("q", list(LADDER))
def test_ladder_scans_keep_the_references_columns(tpch_paths, q):
    port = LADDER[q](tpch, TorchSession(device="cpu"), tpch_paths)
    ref = LADDER[q](jtpch, TpuSession(), tpch_paths)
    got = _scan_columns(prune_columns(port._plan))
    want = _scan_columns(jprune(ref._plan))
    assert got == want
    li = [c for c in got if any(n.startswith("l_") for n in c)]
    assert li and all(len(c) == LINEITEM[q] for c in li)


def test_q1_repartition_exchange_moves_seven_columns(tpch_paths):
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    plan = _repartitioned(tpch, TorchSession(device="cpu"),
                          tpch_paths).physical_plan()
    ex = plan
    while not isinstance(ex.child, FileSourceScanExec):
        ex = ex.children[0]
    assert isinstance(ex, ShuffleExchangeExec)
    assert len(ex.output.fields) == 7
    got = plan.execute_collect().to_pylist()
    exp = tpch.np_q1(tpch.load_np({"lineitem": tpch_paths["lineitem"]}))
    assert [(r["l_returnflag"], r["l_linestatus"]) for r in got] == [
        tuple(e[:2]) for e in exp]
    for r, e in zip(got, exp):
        for a, b in zip(list(r.values())[2:], e[2:]):
            assert a == pytest.approx(b, rel=1e-9)
