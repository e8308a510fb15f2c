"""Set operations and subqueries through ``TorchSession.sql()`` on the CPU,
held against the reference's ``TpuSession.sql()`` on the same small
numpy-seeded parquet tables, and against hand-computed Spark answers:

- UNION, UNION ALL, INTERSECT, EXCEPT, INTERSECT ALL and EXCEPT ALL over
  NULLs, duplicates and a row whose columns are all NULL given twice;
  arms whose column types widen (int and long, long and double, decimals
  of two scales); ORDER BY and LIMIT over a union; a parenthesized arm
  with a WITH of its own; arms of unlike arity or types refused;
- ``x IN (subquery)`` as a WHERE conjunct (a left semi join in the plan),
  inside an OR and as NOT IN (an eager ``InSet``), with a NULL among the
  subquery's values: NOT IN then keeps no row, as in Spark; IN over a
  decimal or an integer column with values of another type (an int
  subquery or literal against a decimal, a fraction against an integer),
  compared as Spark does in their common type;
- correlated and uncorrelated [NOT] EXISTS, and the shapes the reference
  refuses (``SqlAnalysisError`` in both);
- a scalar subquery of 0, 1 and 2 rows: NULL, the value, an error; one
  subquery read twice in a statement runs once.

Rows of a set operation have no order of their own: where the text has no
ORDER BY, both sides are sorted before they are compared. Tolerance:
exact (no arithmetic but the casts of the widening).
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.sql.lower import SqlAnalysisError


def _nulls(rng, vals, p):
    return [None if m else v for v, m in zip(vals, rng.random(len(vals)) < p)]


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    d = tmp_path_factory.mktemp("setops")
    rng = np.random.default_rng(20261018)
    n = 120

    def side(n, hi):
        return pa.table({
            "k": pa.array(_nulls(rng, rng.integers(0, hi, n).tolist(), 0.1),
                          pa.int64()),
            "s": pa.array(_nulls(rng, [f"s{v}" for v in
                                       rng.integers(0, 4, n)], 0.1),
                          pa.string()),
            "i": pa.array(rng.integers(0, 5, n).astype(np.int32)),
            "x": pa.array(np.round(rng.uniform(0, 4, n)).astype(np.float64)),
            "d": pa.array([Decimal(int(v)).scaleb(-2)
                           for v in rng.integers(0, 300, n)],
                          pa.decimal128(7, 2)),
        })
    # l and r share some rows; each holds the all-NULL row (k, s) twice
    l, r = side(n, 12), side(n // 2, 8)
    both = pa.table({"k": pa.array([None, None], pa.int64()),
                     "s": pa.array([None, None], pa.string()),
                     "i": pa.array([0, 0], pa.int32()),
                     "x": pa.array([0.0, 0.0]),
                     "d": pa.array([Decimal("0.00")] * 2,
                                   pa.decimal128(7, 2))})
    l, r = pa.concat_tables([l, both]), pa.concat_tables([r, both])
    m = pa.table({"v": pa.array([3, 5, None], pa.int64()),
                  "w": pa.array([1, 2, 3], pa.int64())})
    e = pa.table({"v": pa.array([], pa.int64()),
                  "w": pa.array([], pa.int64())})
    d2 = pa.table({"q": pa.array([Decimal(int(v)).scaleb(-3)
                                  for v in rng.integers(0, 3000, 40)],
                                 pa.decimal128(9, 3))})
    # decimals beside the integers of m: 3.00 and 5.00 are in m's values,
    # 0.03 and 0.05 their unscaled look-alikes
    dm = pa.table({"d": pa.array([Decimal(v) if v else None for v in (
        "0.03", "3.00", "0.05", "5.00", "1.50", None)],
        pa.decimal128(7, 2)), "s": pa.array(list("aaaaba"))})
    out = []
    for s in (TorchSession(device="cpu"), TpuSession()):
        for name, t in (("l", l), ("r", r), ("m", m), ("e", e), ("d2", d2),
                        ("dm", dm)):
            p = str(d / f"{name}.parquet")
            pq.write_table(t, p)
            s.create_or_replace_temp_view(name, s.read_parquet(p))
        out.append(s)
    return out


def _rows(df):
    return [tuple(r.values()) for r in df.collect().to_pylist()]


def _key(row):
    return tuple((v is None, str(v)) for v in row)


def _both(views, text, ordered=False):
    port, ref = views
    got, want = _rows(port.sql(text)), _rows(ref.sql(text))
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    return got, want


SETOPS = {
    "union": "select k, s from l union select k, s from r",
    "union all": "select k, s from l union all select k, s from r",
    "intersect": "select k, s from l intersect select k, s from r",
    "except": "select k, s from l except select k, s from r",
    "intersect all": "select k, s from l intersect all select k, s from r",
    "except all": "select k, s from l except all select k, s from r",
    "three arms": "select k from l intersect select k from r "
                  "union all select i as k from r",
    "int and long": "select i from l union select k from r",
    "long and double": "select k from l except select x from r",
    "decimals of two scales": "select d from l union all "
                              "select q as d from d2",
    "intersect of decimals": "select d from l intersect select q from d2",
    "parenthesized with": "select k from l union all "
                          "(with t as (select w from m) select w as k "
                          "from t)",
}


@pytest.mark.parametrize("name", list(SETOPS))
def test_set_operations_match_the_reference(views, name):
    got, want = _both(views, SETOPS[name])
    assert got == want
    assert got or name.startswith("intersect of")


def _counts(rows):
    out = {}
    for r in rows:
        out[r] = out.get(r, 0) + 1
    return out


def test_all_forms_keep_min_and_difference_of_copies(views):
    """Hand-computed Spark answers: INTERSECT ALL keeps min(l, r) copies of
    a row, EXCEPT ALL max(l - r, 0), NULLs equal to NULLs; the all-NULL
    row (given twice in each table besides the random ones) counted as
    any other row."""
    port, _ = views
    lrows = _rows(port.sql("select k, s from l"))
    rrows = _rows(port.sql("select k, s from r"))
    lc, rc = _counts(lrows), _counts(rrows)
    inter = _counts(_rows(port.sql(SETOPS["intersect all"])))
    exc = _counts(_rows(port.sql(SETOPS["except all"])))
    assert inter == {r: min(c, rc[r]) for r, c in lc.items() if r in rc}
    assert exc == {r: c - rc.get(r, 0) for r, c in lc.items()
                   if c > rc.get(r, 0)}
    assert inter[(None, None)] == min(lc[(None, None)], rc[(None, None)]) \
        >= 2
    assert exc.get((None, None), 0) == max(
        lc[(None, None)] - rc[(None, None)], 0)
    dedup = set(_rows(port.sql(SETOPS["intersect"])))
    assert dedup == set(lc) & set(rc) and (None, None) in dedup


def test_order_by_and_limit_over_a_union(views):
    text = ("select k, s from l union all select k, s from r "
            "order by k desc, 2 limit 17")
    got, want = _both(views, text, ordered=True)
    assert got == want and len(got) == 17


def test_set_operations_refuse_unlike_arms(views):
    port, ref = views
    for text in ("select k, s from l union select k from r",
                 "select s from l intersect select k from r"):
        with pytest.raises(SqlAnalysisError):
            port.sql(text)
    with pytest.raises(SqlAnalysisError):
        port.sql("select k from l union select k from r order by k + 1")


SUBQUERIES = {
    "in conjunct": "select k, s from l where k in (select v from m)",
    "in inside an or": "select k, s from l where k in (select v from m) "
                       "or s = 's1'",
    "not in with a null": "select k from l where k not in (select v from m)",
    "not in without a null": "select k from l where k not in "
                             "(select v from m where v is not null)",
    "in widened": "select i from l where i in (select v from m)",
    "exists correlated": "select k, s from l where exists "
                         "(select * from m where v = k)",
    "not exists correlated": "select k, s from l where not exists "
                             "(select * from m where m.v = l.k and w > 1)",
    "exists uncorrelated": "select k from l where exists "
                           "(select * from m where w > 2)",
    "not exists uncorrelated": "select k from l where not exists "
                               "(select * from m where w > 2)",
    "exists of an empty table": "select k from l where exists "
                                "(select * from e)",
    "scalar of one row": "select k, (select v from m where w = 2) sv "
                         "from l where k > (select min(v) from m)",
    "scalar of no row": "select k, (select v from m where w > 9) sv from l",
    "scalar of a null": "select k from l where k > "
                        "(select v from m where w = 3)",
}


@pytest.mark.parametrize("name", list(SUBQUERIES))
def test_subqueries_match_the_reference(views, name):
    got, want = _both(views, SUBQUERIES[name])
    assert got == want


# NOT IN over a subquery of no rows: the reference's answer is not Spark's
NOT_IN_NOTHING = "select k from l where k not in (select v from e)"


def test_subqueries_give_the_spark_answers(views):
    port, _ = views
    ks = [r[0] for r in _rows(port.sql("select k from l"))]
    # NOT IN over values holding a NULL keeps no row; over no values, all
    assert _rows(port.sql(SUBQUERIES["not in with a null"])) == []
    assert sorted(r[0] for r in _rows(port.sql(
        SUBQUERIES["not in without a null"]))) == sorted(
        k for k in ks if k is not None and k not in (3, 5))
    # over no values NOT IN is true, for a NULL k too (Spark's null-aware
    # anti join); the reference drops the NULL k rows (ROADMAP Queue 3)
    assert len(_rows(port.sql(NOT_IN_NOTHING))) == len(ks)
    assert len(_rows(views[1].sql(NOT_IN_NOTHING))) == len(
        [k for k in ks if k is not None]) < len(ks)
    assert sorted(r[0] for r in _rows(port.sql(SUBQUERIES["in conjunct"]))
                  ) == sorted(k for k in ks if k in (3, 5))
    assert _rows(port.sql(SUBQUERIES["not exists uncorrelated"])) == []
    assert _rows(port.sql(SUBQUERIES["exists of an empty table"])) == []
    # a scalar subquery of no row is NULL, of a NULL compares to nothing
    assert {r[1] for r in _rows(port.sql(SUBQUERIES["scalar of no row"]))
            } == {None}
    assert _rows(port.sql(SUBQUERIES["scalar of a null"])) == []
    one = _rows(port.sql(SUBQUERIES["scalar of one row"]))
    assert one and all(r[1] == 5 and r[0] > 3 for r in one)


# IN over a decimal or an integer column with values of another type, each
# with Spark's answer and the reference's: Spark compares both sides in
# their common type; the reference makes each value a literal of the
# column's type, which takes an int as a decimal's unscaled value (3 as
# 0.03) and truncates a float against an integer (2.5 as 2)
IN_ACROSS_TYPES = {
    "subquery in an or": (
        "select d from dm where d in (select v from m) or s = 'b'",
        ["1.50", "3.00", "5.00"], ["0.03", "0.05", "1.50"]),
    "not in a subquery": (
        "select d from dm where d not in "
        "(select v from m where v is not null)",
        ["0.03", "0.05", "1.50"], ["1.50", "3.00", "5.00"]),
    "not in a subquery with a null": (
        "select d from dm where d not in (select v from m)", [], []),
    "literal list": ("select d from dm where d in (3, 5)",
                     ["3.00", "5.00"], ["0.03", "0.05"]),
    "a finer literal": ("select d from dm where d in (1.505)",
                        [], ["1.50"]),
    "a fraction against an integer": (
        "select w from m where w in (2.5, 3.0)", [3], [2, 3]),
}


@pytest.mark.parametrize("name", list(IN_ACROSS_TYPES))
def test_in_compares_values_across_types(views, name):
    text, spark, reference = IN_ACROSS_TYPES[name]

    def values(s):
        return sorted(r[0] for r in _rows(s.sql(text)))
    port, ref = views
    want = [Decimal(v) if isinstance(v, str) else v for v in spark]
    assert values(port) == want
    assert values(ref) == [Decimal(v) if isinstance(v, str) else v
                           for v in reference]


def test_plans_of_the_subqueries(views):
    """IN as a conjunct is a semi join; inside an OR an eager set; a
    correlated EXISTS a semi or anti join; an uncorrelated one is folded.
    The eager subqueries' physical plans ride on the DataFrame."""
    port, _ = views

    def joins(plan):
        out = [plan.join_type] if isinstance(plan, NN.JoinNode) else []
        for c in plan.children:
            out += joins(c)
        return out
    assert joins(port.sql(SUBQUERIES["in conjunct"])._plan) == ["leftsemi"]
    df = port.sql(SUBQUERIES["in inside an or"])
    assert joins(df._plan) == [] and len(df.subquery_plans) == 1
    assert joins(port.sql(SUBQUERIES["not exists correlated"])._plan) == [
        "leftanti"]
    df = port.sql(SUBQUERIES["exists uncorrelated"])
    assert joins(df._plan) == [] and len(df.subquery_plans) == 1


def test_one_subquery_read_twice_runs_once(views):
    port, _ = views
    text = ("select k from l where k > (select min(v) from m) "
            "union all select k from r where k > (select min(v) from m)")
    df = port.sql(text)
    assert len(df.subquery_plans) == 1
    got, want = _both(views, text)
    assert got == want


def test_scalar_subquery_of_two_rows_raises(views):
    port, ref = views
    text = "select k from l where k > (select v from m where w < 3)"
    for s in (port, ref):
        with pytest.raises(ValueError, match="more than one row"):
            s.sql(text)


REFUSED_EXISTS = {
    "aggregate": "select k from l where exists "
                 "(select count(*) from m where v = k)",
    "group by": "select k from l where exists "
                "(select v from m where v = k group by v)",
    "non-equality correlation": "select k from l where exists "
                                "(select * from m where v > k)",
    "inside an or": "select k from l where k = 1 or exists "
                    "(select * from m where v = k)",
}


@pytest.mark.parametrize("name", list(REFUSED_EXISTS))
def test_exists_shapes_the_reference_refuses_are_refused(views, name):
    port, ref = views
    for s in (port, ref):
        with pytest.raises(Exception) as info:
            s.sql(REFUSED_EXISTS[name])
        assert type(info.value).__name__ == "SqlAnalysisError"
