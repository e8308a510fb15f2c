"""The rest of the TPC-H ladder through the port's session API on the CPU:
q3 and q18 at SF 0.1, the sort-based group-by on an int64 key, ``limit`` and
HAVING, each held against the JAX package's ``TpuSession`` on the same files
and, for the queries, against the NumPy oracles ``np_q3`` and ``np_q18``.

q18 runs at SF 0.1 because below about SF 0.05 no order reaches
``sum(l_quantity) > 300`` and its answer is empty; at SF 0.1 it has 3 rows.

Tolerance: keys, dates, counts, extremes, first and last exact; sums and
averages within ``rel=1e-9`` (tests/test_tpch.py's bound), because the two
packages merge partial sums at batch capacities that may differ.
"""

import datetime
import os

import pytest

from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.session import TpuSession
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.exec.sort import SortExec
from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
from spark_rapids_tpu_torch.session import TorchSession

EPOCH = datetime.date(1970, 1, 1)


def _days(d):
    return (d - EPOCH).days if isinstance(d, datetime.date) else d


def _aggs(plan):
    out = [plan] if isinstance(plan, XA.HashAggregateExec) else []
    for c in plan.children:
        out += _aggs(c)
    return out


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    paths = jtpch.generate(0.1, str(tmp_path_factory.mktemp("tpch_sf0.1")))
    spark = TorchSession(device="cpu")
    ref = TpuSession()
    tb = tpch.load_np(paths)
    out = {"paths": paths}
    for q in ("q3", "q18"):
        plan = tpch.QUERIES[q](tpch.load(spark, paths)).physical_plan()
        out[q] = (plan.execute_collect().to_pylist(), plan,
                  jtpch.QUERIES[q](jtpch.load(ref, paths)).collect()
                  .to_pylist(),
                  getattr(tpch, "np_" + q)(tb))
    return out


def _q3_rows(rows):
    return [(r["l_orderkey"], _days(r["o_orderdate"]), r["o_shippriority"],
             r["revenue"]) for r in rows]


def _q18_rows(rows):
    return [(r["c_custkey"], r["o_orderkey"], _days(r["o_orderdate"]),
             r["o_totalprice"], r["sum_qty"]) for r in rows]


def _assert_rows(got, exp, n_exact: int):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert tuple(g[:n_exact]) == tuple(e[:n_exact]), (g, e)
        for a, b in zip(g[n_exact:], e[n_exact:]):
            assert a == pytest.approx(b, rel=1e-9), (g, e)


@pytest.mark.parametrize("q,rows,n_exact,n_rows", [
    ("q3", _q3_rows, 3, 10), ("q18", _q18_rows, 3, 3)])
def test_query_matches_tpu_session_and_oracle(ladder, q, rows, n_exact,
                                              n_rows):
    port, _plan, ref, exp = ladder[q]
    assert len(port) == n_rows   # q18 is not empty at SF 0.1
    assert [list(r) for r in port] == [list(r) for r in ref]  # column names
    _assert_rows(rows(port), rows(ref), n_exact)
    _assert_rows(rows(port), exp, n_exact)
    _assert_rows(rows(ref), exp, n_exact)


def test_q3_plan_shape(ladder):
    """GlobalLimitExec over SortExec over a COMPLETE segment aggregate on
    three integer keys, whose projection is hoisted into it."""
    _rows, plan, _ref, _exp = ladder["q3"]
    assert isinstance(plan, XB.GlobalLimitExec) and plan.limit == 10
    assert isinstance(plan.child, SortExec)
    (agg,) = _aggs(plan)
    assert agg is plan.child.child
    assert agg.mode == XA.COMPLETE and agg.preproject is not None
    assert len(agg.group_exprs) == 3
    st = agg.stats
    assert st["segment"] == st["updates"] + st["merges"] > 0
    assert st["probes"] == 0   # three keys: no presorted probe


def test_q18_plan_shape_and_presorted_batches(ladder):
    """The HAVING filter folds into the COMPLETE aggregate's finalize (no
    FilterExec is planned), which reads the lineitem scan directly; the
    first batch is probed and arrives sorted by l_orderkey, so it skips
    the sort, and every later batch takes the group-by chain (one status
    readback, no probe), or is redone unchained, probed and presorted,
    when its bucket was mispredicted."""
    _rows, plan, _ref, _exp = ladder["q18"]
    assert isinstance(plan, XB.GlobalLimitExec) and plan.limit == 100
    assert isinstance(plan.child, SortExec)
    (agg,) = _aggs(plan)
    assert agg.mode == XA.COMPLETE
    assert isinstance(agg.child, FileSourceScanExec)
    assert agg.postfilter is not None and "having=" in agg.args_string()
    assert not [f for f in _walk(plan) if isinstance(f, XB.FilterExec)]
    st = agg.stats
    assert st["updates"] > 1 and st["merges"] == st["updates"] - 1
    assert st["chained"] >= 1
    unchained = st["updates"] + st["merges"] - 2 * st["chained"]
    assert st["segment"] == st["updates"] + st["merges"]
    assert st["presorted"] == st["probes"] == unchained
    assert st["groups"][-1] == 150_000   # every order of SF 0.1


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def test_q18_without_the_presorted_skip(ladder):
    """``stageFusion.enabled=false`` turns the presorted skip off: every
    batch sorts, and the answer is the same."""
    spark = TorchSession({"spark.rapids.tpu.sql.stageFusion.enabled":
                          "false"}, device="cpu")
    plan = tpch.q18(tpch.load(spark, ladder["paths"])).physical_plan()
    rows = plan.execute_collect().to_pylist()
    assert rows == ladder["q18"][0]
    (agg,) = _aggs(plan)
    assert agg.stats["presorted"] == agg.stats["probes"] == 0
    assert agg.stats["segment"] > 0


# -- the group-by on l_orderkey and limit at SF 0.002 -------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    paths = jtpch.generate(0.002, str(tmp_path_factory.mktemp("tpch_small")))
    d = paths["lineitem"]
    files = sorted(os.path.join(d, f) for f in os.listdir(d)
                   if f.endswith(".parquet"))
    return paths, files


def _orderkey_aggs(fns, df):
    c = fns.col
    return (df.group_by(c("l_orderkey"))
            .agg(fns.sum(c("l_quantity")).alias("s"),
                 fns.count(c("l_quantity")).alias("n"),
                 fns.avg(c("l_extendedprice")).alias("a"),
                 fns.min(c("l_shipdate")).alias("lo"),
                 fns.max(c("l_extendedprice")).alias("hi"),
                 fns.first(c("l_returnflag")).alias("f"),
                 fns.last(c("l_discount")).alias("l"))
            .sort(c("l_orderkey")))


def test_orderkey_group_by_over_partitions_matches_tpu_session(small):
    """One partition per file: PARTIAL -> hash exchange on the int64 key ->
    FINAL, both through the segment path."""
    _paths, files = small
    df = _orderkey_aggs(F, TorchSession(device="cpu").read_parquet(files))
    plan = df.physical_plan()
    port = plan.execute_collect().to_pylist()
    ref = _orderkey_aggs(JF, TpuSession().read_parquet(files)) \
        .collect().to_pylist()
    aggs = _aggs(plan)
    assert [a.mode for a in aggs] == [XA.FINAL, XA.PARTIAL]
    assert all(a.stats["segment"] > 0 for a in aggs)
    assert len(port) == len(ref) > 1000
    for g, e in zip(port, ref):
        assert [g[k] for k in ("l_orderkey", "n", "lo", "hi", "f", "l")] == \
            [e[k] for k in ("l_orderkey", "n", "lo", "hi", "f", "l")]
        assert g["s"] == pytest.approx(e["s"], rel=1e-9)
        assert g["a"] == pytest.approx(e["a"], rel=1e-9)


@pytest.mark.parametrize("n", [0, 1, 100, 2_999, 3_000, 3_001, 7_777,
                               1 << 20])
@pytest.mark.parametrize("partitions", ["one", "per_file"])
def test_limit_matches_tpu_session(small, n, partitions):
    """0 rows, a cut in the middle of a batch, at a batch's end, across
    batches and partitions, and more rows than there are."""
    paths, files = small
    src = paths["lineitem"] if partitions == "one" else files

    def q(session, fns):
        c = fns.col
        return (session.read_parquet(src)
                .select(c("l_orderkey"), c("l_quantity"), c("l_returnflag"))
                .limit(n))
    df = q(TorchSession(device="cpu"), F)
    plan = df.physical_plan()
    assert isinstance(plan, XB.GlobalLimitExec)
    if partitions == "per_file":
        assert isinstance(plan.child.child, XB.LocalLimitExec)
    port = plan.execute_collect()
    ref = q(TpuSession(), JF).collect()
    assert port.num_rows == min(n, ref.num_rows) == ref.num_rows
    assert port.to_pylist() == ref.to_pylist()


def test_limit_of_an_empty_result(small):
    paths, _files = small
    c = F.col
    df = (TorchSession(device="cpu").read_parquet(paths["lineitem"])
          .filter(c("l_quantity") > F.lit(1000.0))
          .group_by(c("l_orderkey")).agg(F.sum(c("l_tax")).alias("t"))
          .limit(5))
    out = df.collect()
    assert out.num_rows == 0 and out.column_names == ["l_orderkey", "t"]


def test_keyless_aggregate_still_raises_at_planning(small):
    """A keyless aggregate plans since the TPC-DS slice (one COMPLETE
    aggregate, over a gather of the file partitions into one) and equals
    TpuSession; the cross join of two of them plans the nested-loop join,
    and so does their keyless full outer join since the outer joins were
    ported; what still raises at planning is their keyless right outer
    join (the reference refuses it too)."""
    paths, files = small
    ref = TpuSession()
    for src in (paths["lineitem"], files):
        df = TorchSession(device="cpu").read_parquet(src)
        out = df.group_by().agg(F.sum(F.col("l_quantity")).alias("s"),
                                F.count().alias("n"))
        (agg,) = _aggs(out.physical_plan())
        assert agg.mode == XA.COMPLETE and not agg.group_exprs
        want = (ref.read_parquet(src).agg(JF.sum(JF.col("l_quantity"))
                                          .alias("s"),
                                          JF.count().alias("n"))
                .collect().to_pylist())
        got = out.collect().to_pylist()
        assert got[0]["n"] == want[0]["n"] > 0
        assert got[0]["s"] == pytest.approx(want[0]["s"], rel=1e-12)
        other = df.agg(F.count().alias("c"))
        crossed = out.join(other, how="cross").collect().to_pylist()
        assert crossed == [dict(got[0], c=got[0]["n"])]
        assert out.join(other, how="full").collect().to_pylist() == crossed
        with pytest.raises(NotImplementedError):
            out.join(other, how="right").physical_plan()
