"""The SQL front-end of the port (``TorchSession.sql()``, ``sql/``) held
against the JAX package's ``TpuSession.sql()`` on the CPU:

- the official TPC-H q1, q3 and q5 text at SF 0.01, through both sessions
  on the same parquet files, each against the NumPy oracles and against
  each other; the lowered logical plans' node types and schemas equal; q5's
  ``l_suppkey = s_suppkey and c_nationkey = s_nationkey`` plans one join on
  two keys, which runs on the rank path. Tolerance: keys, dates and counts
  exact; sums and averages within rel 1e-9 of each other and 1e-6 of the
  oracle (``tests/test_sql_tpch.py``'s bound);
- the typed-literal grammar (DATE '...', INTERVAL 'n' day/week/month/year)
  and ``DateAddInterval``/``AddMonths`` over month ends and leap days,
  against the reference. Tolerance: exact;
- the SELECT core on small tables: explicit joins, derived tables and CTEs,
  GROUP BY and ORDER BY by name, alias and ordinal, HAVING, DISTINCT,
  LIMIT, the OR-common-conjunct hoist, NOT, IN, BETWEEN and <>, against
  the reference. Tolerance: exact, except sums and averages of doubles,
  within rel 1e-9 (summed in another order);
- each construct outside the slice raises ``NotImplementedError`` while
  the text is lowered, before anything runs; the constructs that have been
  ported since (windows, CASE, IS NULL, division, negation) lower under the
  same test names and equal the reference. Tolerance: exact, except
  doubles within rel 1e-9;
- a window over an aggregate sees only the groups HAVING keeps, and a
  window frame that starts FOLLOWING or ends PRECEDING the current row is
  refused: in both the reference's answer is shown beside the port's,
  since the reference gets them wrong. Tolerance: rel 1e-9 on the sums.
"""

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.sql.tpch_queries import SQL_QUERIES as JSQL

from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.sql.tpch_queries import SQL_QUERIES

SF = 0.01
EPOCH = datetime.date(1970, 1, 1)


def _days(d):
    return (d - EPOCH).days if isinstance(d, datetime.date) else d


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    paths = jtpch.generate(SF, str(tmp_path_factory.mktemp("tpch_sql")))
    spark = TorchSession(device="cpu")
    tpch.load(spark, paths)            # registers the temp views
    ref = TpuSession()
    jtpch.load(ref, paths, files_per_partition=2)
    return spark, ref, tpch.load_np(paths)


def test_sql_text_is_the_references():
    assert SQL_QUERIES == JSQL


def _close(a, b, rel):
    return abs(a - b) <= rel * max(1.0, abs(b))


@pytest.mark.parametrize("q", ["q1", "q3", "q5"])
def test_sql_query_matches_tpu_session_and_oracle(env, q):
    spark, ref, tb = env
    got = spark.sql(SQL_QUERIES[q]).collect()
    want = ref.sql(JSQL[q]).collect()
    assert got.schema.names == want.schema.names
    got, want = got.to_pylist(), want.to_pylist()
    exp = getattr(tpch, "np_" + q)(tb)
    assert len(got) == len(want) == len(exp) > 0
    if q == "q1":
        rows = [list(g.values()) for g in got]
        for g, w, e in zip(rows, [list(w.values()) for w in want], exp):
            assert g[:2] == w[:2] == list(e[:2])
            assert g[-1] == w[-1] == e[-1]         # count(*)
            for a, b, c in zip(g[2:-1], w[2:-1], e[2:-1]):
                assert _close(a, b, 1e-9) and _close(a, c, 1e-6), (g, e)
    elif q == "q3":
        for g, w, (k, d, p, rev) in zip(got, want, exp):
            assert (g["l_orderkey"], _days(g["o_orderdate"]),
                    g["o_shippriority"]) == (w["l_orderkey"],
                                             _days(w["o_orderdate"]),
                                             w["o_shippriority"]) == (k, d, p)
            assert _close(g["revenue"], w["revenue"], 1e-9)
            assert _close(g["revenue"], rev, 1e-6)
    else:
        for g, w, (n, v) in zip(got, want, exp):
            assert g["n_name"] == w["n_name"] == n
            assert _close(g["revenue"], w["revenue"], 1e-9)
            assert _close(g["revenue"], v, 1e-6)


def _plan_shape(node):
    """Node types and output schemas of a logical plan, depth first."""
    out = [(type(node).__name__,
            [(f.name, type(f.data_type).__name__) for f in node.output])]
    for c in node.children:
        out += _plan_shape(c)
    return out


@pytest.mark.parametrize("q", ["q1", "q3", "q5"])
def test_lowered_plans_match_the_reference(env, q):
    spark, ref, _ = env
    assert _plan_shape(spark.sql(SQL_QUERIES[q])._plan) == _plan_shape(
        ref.sql(JSQL[q])._plan)


def _joins(plan):
    out = [plan] if isinstance(plan, XJ.HashJoinExec) else []
    for c in plan.children:
        out += _joins(c)
    return out


def test_q5_two_key_join_takes_the_rank_path(env):
    spark, _, _ = env
    plan = spark.sql(SQL_QUERIES["q5"]).physical_plan()
    plan.execute_collect()
    joins = _joins(plan)
    assert len(joins) == 5
    two = [j for j in joins if len(j.left_keys) == 2]
    assert len(two) == 1
    assert sorted(k.name for k in two[0].left_keys + two[0].right_keys) == [
        "c_custkey", "c_nationkey", "o_custkey", "s_nationkey"]
    assert two[0].stats["probe_mode"] == "rank"
    assert all(j.stats["probe_mode"] != "rank" for j in joins
               if j is not two[0])


# -- typed literals and date arithmetic ----------------------------------------

DATES = [datetime.date(2020, 1, 31), datetime.date(2020, 2, 29),
         datetime.date(2019, 2, 28), datetime.date(2021, 3, 31),
         datetime.date(2000, 2, 29), datetime.date(1900, 3, 1),
         datetime.date(1999, 12, 31), datetime.date(2024, 8, 31), None]


@pytest.fixture(scope="module")
def dates_view(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("dates") / "d.parquet")
    pq.write_table(pa.table({
        "d": pa.array(DATES, pa.date32()),
        "x": pa.array(np.arange(len(DATES), dtype=np.int64))}), p)
    out = []
    for s in (TorchSession(device="cpu"), TpuSession()):
        s.create_or_replace_temp_view("t", s.read_parquet(p))
        out.append(s)
    return out


def _both_sql(sessions, text):
    port, ref = sessions
    return (port.sql(text).collect().to_pylist(),
            ref.sql(text).collect().to_pylist())


def test_typed_literals_grammar(dates_view):
    got, want = _both_sql(dates_view, (
        "select date '2020-03-01' as d, "
        "date '2020-03-01' + interval '2' day as d2, "
        "date '2020-03-01' - interval '1' month as m, "
        "date '2020-01-31' + interval '1' month as clamp, "
        "date '2020-03-01' + interval '1' week as w, "
        "date '2020-02-29' + interval '1' year as leap from t limit 1"))
    assert got == want
    row = got[0]
    assert row["d"] == datetime.date(2020, 3, 1)
    assert row["d2"] == datetime.date(2020, 3, 3)
    assert row["m"] == datetime.date(2020, 2, 1)
    assert row["clamp"] == datetime.date(2020, 2, 29)   # month-end clamp
    assert row["w"] == datetime.date(2020, 3, 8)
    assert row["leap"] == datetime.date(2021, 2, 28)


@pytest.mark.parametrize("n,unit", [(1, "month"), (-1, "month"),
                                    (13, "month"), (1, "year"), (-4, "year"),
                                    (3, "day"), (-2, "week")])
def test_date_intervals_at_month_ends_match_the_reference(dates_view, n,
                                                          unit):
    op = "+" if n >= 0 else "-"
    got, want = _both_sql(dates_view, (
        f"select x, d {op} interval '{abs(n)}' {unit} as r from t "
        "order by x"))
    assert got == want
    assert got[-1]["r"] is None                          # null in, null out
    assert all(r["r"] is not None for r in got[:-1])


# -- the SELECT core ------------------------------------------------------------

@pytest.fixture(scope="module")
def small_views(tmp_path_factory):
    d = tmp_path_factory.mktemp("sql_small")
    rng = np.random.default_rng(20260729)
    n = 200
    emp = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "dept": pa.array(rng.integers(0, 6, n).astype(np.int64)),
        "grade": pa.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)]),
        "pay": pa.array(np.round(rng.uniform(10, 100, n), 2)),
        "start": pa.array(rng.integers(17000, 19000, n).astype(np.int32))
        .cast(pa.date32()),
    })
    dept = pa.table({
        "dept_id": pa.array(np.arange(6, dtype=np.int64)),
        "dname": pa.array(["ops", "eng", "hr", "law", "art", "sea"]),
        "region": pa.array(np.array([0, 1, 1, 0, 2, 1], dtype=np.int64)),
    })
    out = []
    for s in (TorchSession(device="cpu"), TpuSession()):
        for name, t in (("emp", emp), ("dept", dept)):
            p = str(d / f"{name}.parquet")
            pq.write_table(t, p)
            s.create_or_replace_temp_view(name, s.read_parquet(p))
        out.append(s)
    return out


SELECTS = {
    "comma join, alias order": """
        select dname, sum(pay) as total, count(*) as n
        from emp, dept where dept = dept_id and grade <> 'b'
        group by dname order by total desc""",
    "explicit join, ordinal": """
        select e.grade, d.region, max(e.pay) as top, min(e.start) as first
        from emp e join dept d on e.dept = d.dept_id
        group by 1, 2 order by 2, 1""",
    "having, limit": """
        select dept, avg(pay) as a from emp group by dept
        having count(*) > 30 order by a limit 3""",
    "derived table": """
        select region, sum(total) as t from
          (select dept, sum(pay) as total from emp group by dept) s,
          dept where s.dept = dept.dept_id
        group by region order by region""",
    "cte": """
        with big as (select id, dept, pay from emp where pay > 50)
        select dname, count(*) as n from big join dept on dept = dept_id
        group by dname order by dname""",
    "distinct": "select distinct grade from emp order by grade",
    "or hoist": """
        select id from emp, dept
        where (dept = dept_id and region = 1) or (dept = dept_id
               and grade = 'a')
        order by id""",
    "in, between, not": """
        select id, pay from emp
        where grade in ('a', 'c') and pay between 20 and 60
          and not (dept = 3) and start >= date '2017-01-01'
        order by pay desc, id limit 7""",
    "order by expression": """
        select dept, sum(pay) as s from emp group by dept
        order by sum(pay), dept""",
    "left join": """
        select id, dname from emp left join
          (select dept_id, dname from dept where region = 1) r
          on dept = dept_id order by id limit 20""",
}


def _assert_rows(got, want):
    """Equal rows; doubles within rel 1e-9 (the packages sum in another
    order)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-9), (g, w)
            else:
                assert g[k] == w[k], (g, w)


@pytest.mark.parametrize("name", list(SELECTS))
def test_select_core_matches_the_reference(small_views, name):
    _assert_rows(*_both_sql(small_views, SELECTS[name]))


def test_sql_is_lowered_when_called_not_when_collected(small_views):
    port, _ = small_views
    with pytest.raises(Exception):
        port.sql("select nope from emp")
    with pytest.raises(Exception):
        port.sql("select * from missing")


# constructs the lowering refused when these tests were written, ported
# since: under their old names they now lower and equal the reference
LOWERED_SINCE = {
    "window": "select id, rank() over (partition by dept order by pay) "
              "as r from emp order by id",
    "window aggregate": "select id, sum(pay) over (partition by dept) "
                        "as s from emp order by id",
    "case": "select id, case when pay > 50 then 1 else 0 end as c from emp "
            "order by id",
    "is null": "select id from emp where pay is null or start is not null "
               "order by id",
    "division": "select id, pay / 2 as h from emp order by id",
    "negation": "select id, -pay as n from emp order by id",
}

UNPORTED = {
    "rollup": "select dept, sum(pay) from emp group by rollup(dept)",
    "cube": "select dept, grade, sum(pay) from emp group by cube(dept, grade)",
    "grouping sets": "select dept, sum(pay) from emp "
                     "group by grouping sets ((dept), ())",
    "union": "select id from emp union all select dept_id from dept",
    "intersect": "select dept from emp intersect select dept_id from dept",
    "except": "select dept from emp except select dept_id from dept",
    "distinct sum": "select dept, sum(distinct pay) from emp group by dept",
    "distinct count": "select count(distinct grade) from emp",
    "scalar subquery": "select id from emp where pay > "
                       "(select avg(pay) from emp)",
    "in subquery": "select id from emp where dept in "
                   "(select dept_id from dept where region = 1)",
    "exists": "select id from emp where exists "
              "(select 1 from dept where dept_id = dept)",
    "like": "select id from emp where grade like 'a%'",
    "string function": "select upper(grade) from emp",
    "timestamp literal": "select timestamp '2020-03-01 12:30:00' from emp",
    "no from": "select 1",
    "stddev": "select dept, stddev(pay) from emp group by dept",
}


@pytest.mark.parametrize("name", list(UNPORTED) + list(LOWERED_SINCE))
def test_unported_constructs_raise_while_lowering(small_views, name):
    port, _ = small_views
    if name in LOWERED_SINCE:
        _assert_rows(*_both_sql(small_views, LOWERED_SINCE[name]))
        return
    with pytest.raises(NotImplementedError):
        port.sql(UNPORTED[name])


# -- windows over an aggregate with HAVING, and window frames -----------------

def _group_sums(port):
    rows = port.sql("select dept, sum(pay) as s from emp group by dept "
                    "order by dept").collect().to_pylist()
    ss = sorted(r["s"] for r in rows)
    return rows, (ss[1] + ss[2]) / 2      # a threshold that drops two groups


def test_window_over_having_sees_only_the_kept_groups(small_views):
    """HAVING filters the groups before the window ranks and totals them,
    as in Spark. The reference plans the window below HAVING, so its ranks
    and total count the dropped groups too (ROADMAP Queue 3)."""
    port, ref = small_views
    rows, cut = _group_sums(port)
    text = (f"select dept, sum(pay) as s, "
            f"rank() over (order by sum(pay)) as r, "
            f"sum(sum(pay)) over (order by sum(pay) rows between unbounded "
            f"preceding and unbounded following) as tot from emp "
            f"group by dept "
            f"having sum(pay) > {cut!r} order by dept")
    got, want = _both_sql(small_views, text)
    kept = [r for r in rows if r["s"] > cut]
    assert len(kept) == len(rows) - 2
    order = sorted(r["s"] for r in kept)
    tot = sum(r["s"] for r in kept)
    assert [g["dept"] for g in got] == [r["dept"] for r in kept]
    for g, k in zip(got, kept):
        assert g["s"] == pytest.approx(k["s"], rel=1e-9)
        assert g["r"] == order.index(k["s"]) + 1
        assert g["tot"] == pytest.approx(tot, rel=1e-9)
    # the reference: the same groups, ranked and totalled among all six
    every = sorted(r["s"] for r in rows)
    assert [w["dept"] for w in want] == [g["dept"] for g in got]
    assert [w["r"] for w in want] == [every.index(w["s"]) + 1 for w in want]
    assert want[0]["tot"] == pytest.approx(sum(every), rel=1e-9)
    assert [w["r"] for w in want] != [g["r"] for g in got]


def test_window_in_having_raises_while_lowering(small_views):
    port, _ = small_views
    with pytest.raises(NotImplementedError):
        port.sql("select dept from emp group by dept "
                 "having rank() over (order by sum(pay)) < 3")


FRAMES = ["rows between 2 preceding and 1 following",
          "rows between current row and unbounded following",
          "rows between unbounded preceding and current row",
          "range between 10 preceding and 5 following",
          "range between unbounded preceding and unbounded following"]


@pytest.mark.parametrize("frame", FRAMES)
def test_window_frames_match_the_reference(small_views, frame):
    _assert_rows(*_both_sql(small_views, (
        f"select id, sum(pay) over (partition by dept order by start, id "
        f"{frame}) as s from emp order by id")
        if frame.startswith("rows") else (
        f"select id, sum(pay) over (partition by dept order by pay "
        f"{frame}) as s from emp order by id")))


def _frame_sums(rows, lo, hi):
    """sum(pay) over (partition by dept order by id) on the rows frame
    [i + lo, i + hi], in Python."""
    out = {}
    for d in {r["dept"] for r in rows}:
        part = sorted((r for r in rows if r["dept"] == d),
                      key=lambda r: r["id"])
        for i, r in enumerate(part):
            frame = part[max(i + lo, 0):max(i + hi + 1, 0)]
            out[r["id"]] = sum(x["pay"] for x in frame) if frame else None
    return out


def test_a_frame_that_starts_following_raises_while_lowering(small_views):
    """``rows between 1 following and 3 following`` is the frame
    [i+1, i+3]. The exec's frame counts back from its lower bound, so the
    port refuses a lower bound that is FOLLOWING (and an upper bound that
    is PRECEDING). The reference lowers it as [i-1, i+3] (ROADMAP
    Queue 3)."""
    port, ref = small_views
    text = ("select id, dept, pay, sum(pay) over (partition by dept order "
            "by id rows between 1 following and 3 following) as s from emp "
            "order by id")
    with pytest.raises(NotImplementedError):
        port.sql(text)
    with pytest.raises(NotImplementedError):
        port.sql("select id, sum(pay) over (partition by dept order by id "
                 "rows between 3 preceding and 1 preceding) as s from emp")
    want = ref.sql(text).collect().to_pylist()
    wrong = _frame_sums(want, -1, 3)
    right = _frame_sums(want, 1, 3)
    assert all(w["s"] == pytest.approx(wrong[w["id"]], rel=1e-9)
               for w in want)
    assert any(right[w["id"]] is None or w["s"] != pytest.approx(
        right[w["id"]], rel=1e-9) for w in want)


@pytest.mark.parametrize("frame", [
    "rows between unbounded following and current row",
    "rows between current row and unbounded preceding"])
def test_an_unbounded_bound_on_the_wrong_side_raises(small_views, frame):
    port, _ = small_views
    with pytest.raises(ValueError, match="UNBOUNDED"):
        port.sql(f"select id, sum(pay) over (partition by dept order by id "
                 f"{frame}) as s from emp")
