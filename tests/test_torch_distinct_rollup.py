"""DISTINCT aggregates, ROLLUP, CUBE, GROUPING SETS and ``grouping()``
through ``TorchSession.sql()`` on the CPU, held against the reference's
``TpuSession.sql()`` on the same numpy-seeded parquet files (two files, so
that the aggregates above an Expand plan PARTIAL → exchange → FINAL):

- ``count``/``sum``/``avg(DISTINCT x)``, with and without keys, in the
  two-aggregate form (one distinct argument, beside min/max and count/sum/
  avg of the same argument, TPC-DS q28's) and in the general Expand form
  (several distinct arguments, regular aggregates of other columns,
  ``count(*)``), over a key with NULLs, over an empty input (count 0), and
  under ROLLUP; each plan is checked for the form it takes;
- ROLLUP, CUBE and GROUPING SETS over one to three keys with NULL keys (a
  real NULL group stays apart from the subtotal row of the same keys), with
  ``grouping()`` in the select list, in HAVING, in ORDER BY (as a select
  item; outside the select list it is refused) and in a window's
  partition (TPC-DS q36's shape);
- the shapes the reference refuses (``count(DISTINCT a, b)``, a DISTINCT
  ``first``, a ROLLUP over an expression, ``grouping()`` without ROLLUP)
  raise ``SqlAnalysisError`` in both.

Rows without an ORDER BY are sorted before they are compared. Tolerance:
exact on keys, counts, integer sums and decimals; doubles (averages, and
sums of doubles) within rel 1e-9, summed in another order.
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    d = tmp_path_factory.mktemp("distinct_rollup")
    rng = np.random.default_rng(7013)

    def part(n):
        def nulls(vals, p=0.1):
            return [None if m else v for v, m in
                    zip(vals, rng.random(n) < p)]
        return pa.table({
            "g": pa.array(nulls([f"g{v}" for v in rng.integers(0, 3, n)]),
                          pa.string()),
            "h": pa.array(nulls(rng.integers(0, 3, n).tolist()), pa.int64()),
            "j": pa.array(rng.integers(0, 2, n).astype(np.int32)),
            "x": pa.array(nulls(rng.integers(0, 15, n).tolist()), pa.int64()),
            "y": pa.array(np.round(rng.uniform(0, 20, n), 1)),
            "z": pa.array(rng.integers(0, 6, n).astype(np.int32)),
            "p": pa.array([Decimal(int(v)).scaleb(-2)
                           for v in rng.integers(-500, 500, n)],
                          pa.decimal128(7, 2)),
        })
    paths = []
    for i, n in enumerate((150, 90)):
        p = str(d / f"t{i}.parquet")
        pq.write_table(part(n), p)
        paths.append(p)
    out = []
    for s in (TorchSession(device="cpu"), TpuSession()):
        s.create_or_replace_temp_view("t", s.read_parquet(paths))
        out.append(s)
    return out


def _rows(df):
    return [tuple(r.values()) for r in df.collect().to_pylist()]


def _key(row):
    return tuple((v is None, str(v)) for v in row)


def _assert_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def _both(views, text):
    port, ref = views
    got, want = _rows(port.sql(text)), _rows(ref.sql(text))
    if "order by" not in text:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    _assert_rows(got, want)
    return got


def _expands(plan):
    out = [plan] if isinstance(plan, NN.ExpandNode) else []
    for c in plan.children:
        out += _expands(c)
    return out


# name: (text, takes the general Expand form)
DISTINCT = {
    "count distinct, no keys": (
        "select count(distinct x) from t", False),
    "q28 form": (
        "select avg(y) a, count(y) c, count(distinct y) cd from t "
        "where z > 1", False),
    "keyed, sum and min": (
        "select g, sum(distinct x) s, min(y) lo, max(x) hi, "
        "count(distinct x) n from t group by g", False),
    "avg distinct of a decimal": (
        "select h, avg(distinct p) a from t group by h", False),
    "count distinct over nothing": (
        "select count(distinct x) c, avg(x) a from t where z > 99", False),
    "two distinct arguments": (
        "select g, count(distinct x) a, count(distinct z) b from t "
        "group by g", True),
    "distinct beside regular aggregates": (
        "select h, count(distinct x) dx, sum(y) sy, avg(z) az, count(*) n, "
        "max(y) my from t group by h", True),
    "distinct sum of an expression": (
        "select j, sum(distinct x + z) s, count(x) c from t group by j",
        True),
    "distinct under rollup": (
        "select g, h, count(distinct x) c, sum(y) s from t "
        "group by rollup(g, h)", True),
}


@pytest.mark.parametrize("name", list(DISTINCT))
def test_distinct_aggregates_match_the_reference(views, name):
    text, expand_form = DISTINCT[name]
    _both(views, text)
    plan = views[0].sql(text)._plan
    n = len(_expands(plan))
    # the rollup takes an Expand of its own
    assert n == int(expand_form) + int("rollup" in text)


def test_distinct_count_over_nothing_is_zero(views):
    port, _ = views
    assert _rows(port.sql(DISTINCT["count distinct over nothing"][0])) == [
        (0, None)]


ROLLUPS = {
    "rollup one key": "select g, sum(x) s, count(*) n from t "
                      "group by rollup(g)",
    "rollup two keys": "select g, h, sum(x) s, avg(y) a from t "
                       "group by rollup(g, h) order by g, h",
    "rollup three keys": "select g, h, j, count(x) c, sum(p) sp from t "
                         "group by rollup(g, h, j)",
    "cube": "select g, j, sum(z) s, min(y) m from t group by cube(g, j)",
    "grouping sets": "select g, h, count(*) n from t "
                     "group by grouping sets ((g), (h), (g, h), ())",
    "grouping in select": "select g, h, grouping(g) gg, grouping(h) gh, "
                          "sum(x) s from t group by rollup(g, h)",
    "grouping in having": "select g, h, sum(x) s from t "
                          "group by rollup(g, h) having grouping(h) = 1",
    "grouping in order by": "select g, h, grouping(g) + grouping(h) lo, "
                            "sum(z) s from t group by rollup(g, h) "
                            "order by grouping(g) + grouping(h) desc, g, h",
    "grouping in a window": (
        "select g, h, sum(y) s, rank() over (partition by "
        "grouping(g) + grouping(h), case when grouping(h) = 0 then g end "
        "order by sum(y)) r from t group by rollup(g, h)"),
}


@pytest.mark.parametrize("name", list(ROLLUPS))
def test_rollups_match_the_reference(views, name):
    _both(views, ROLLUPS[name])


def test_a_real_null_key_stays_apart_from_the_subtotal(views):
    """g has NULL rows: ROLLUP(g, h) keeps the (NULL, h) groups of those
    rows apart from the (g, NULL) subtotals and the grand total, told apart
    by grouping()."""
    port, _ = views
    rows = _rows(port.sql(ROLLUPS["grouping in select"]))
    real_null_g = [r for r in rows if r[0] is None and r[2] == 0]
    totals = [r for r in rows if r[2] == 1]
    assert real_null_g and len(totals) == 1
    base = _rows(port.sql("select g, h, sum(x) from t group by g, h"))
    assert sorted(((r[0], r[1], r[4]) for r in rows if r[3] == 0),
                  key=_key) == sorted(base, key=_key)


REFUSED = {
    "count distinct of two": "select count(distinct x, z) from t",
    "distinct first": "select first(distinct x) from t",
    "rollup of an expression": "select sum(x) from t group by rollup(x + 1)",
    "grouping without rollup": "select g, grouping(g) from t group by g",
}


def test_order_by_grouping_outside_the_select_list_is_refused(views):
    """Spark sorts by it below the projection. The port did refuse it while
    the text was lowered; since the expression slice it carries the sort
    key as a hidden column and drops it after the sort, Spark's answer: the
    grand total first, then the (g) subtotals, then the (g, h) rows, each
    in g, h order. The reference still fails at run time (its host
    evaluation of ``grouping``)."""
    port, ref = views
    text = ("select g, h, sum(z) s from t group by rollup(g, h) "
            "order by grouping(g) + grouping(h) desc, g, h")
    got = _rows(port.sql(text))
    levels = _rows(port.sql(
        "select g, h, sum(z) s, grouping(g) + grouping(h) lv from t "
        "group by rollup(g, h) order by lv desc, g, h"))
    assert got == [r[:3] for r in levels]
    assert [r[3] for r in levels] == sorted((r[3] for r in levels),
                                            reverse=True)
    with pytest.raises(NotImplementedError):
        ref.sql(text).collect()


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_shapes_raise_in_both(views, name):
    for s in views:
        with pytest.raises(Exception) as info:
            s.sql(REFUSED[name]).collect()
        assert type(info.value).__name__ == "SqlAnalysisError"
