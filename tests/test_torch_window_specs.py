"""Window functions over several partition/order specs in the PyTorch port
on the CPU.

Spark plans one window exec for each distinct (partition keys, order keys),
chained in the order the specs first appear, each over its own
distribution, with a projection on top that restores the select list's
order. The port does the same, in the DataFrame form (``df.window`` with
the ``functions.over`` builders) and the SQL form (``spark.sql``). The
answers are held to a plain-Python oracle of Spark's semantics (ordering
with its NULLS FIRST/LAST rules, row_number, rank, dense_rank, lead/lag
with defaults, and sum/count/min/max over the default frame, RANGE
UNBOUNDED PRECEDING to CURRENT ROW, its peers included), over a numpy-seeded
table in three partitions with NULL partition and order keys.

The reference refuses several specs on the device and runs them on its
host path, which evaluates every expression under the first spec
(``plan/host_window.py:37``): its answers are shown beside, and differ.
A 10-row case makes the reference's fault plain: ``dense_rank() over
(order by k)`` beside ``rank() over (partition by k order by i desc)``.

A node of one spec plans as before: one window exec over its exchange or
gather, and no projection (the plan-shape test).

Tolerance: none (ranks, row numbers, integer sums, counts, min/max and
lead/lag values are exact).
"""

from __future__ import annotations

import functools

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.session import TorchSession


def _table(n=120, seed=7):
    r = np.random.default_rng(seed)

    def nulls(vals, share):
        return [None if r.random() < share else int(v) for v in vals]
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k1": pa.array(nulls(r.integers(0, 6, n), 0.1), pa.int64()),
        "k2": pa.array(nulls(r.integers(0, 4, n), 0.1), pa.int32()),
        "v": pa.array(nulls(r.integers(-20, 20, n), 0.1), pa.int64()),
        "o": pa.array(r.permutation(n).astype(np.int32)),
    })


# -- the oracle: Spark's window semantics, one row at a time ---------------------

def _cmp_key(a, b, asc, nulls_first):
    if a is None and b is None:
        return 0
    if a is None:
        return -1 if nulls_first else 1
    if b is None:
        return 1 if nulls_first else -1
    if a == b:
        return 0
    return (-1 if a < b else 1) * (1 if asc else -1)


def _order(rows, order):
    def cmp(x, y):
        for col, asc, nf in order:
            c = _cmp_key(x[col], y[col], asc, nf)
            if c:
                return c
        return 0
    return sorted(rows, key=functools.cmp_to_key(cmp)), cmp


def oracle(rows, func, part, order, arg=None, offset=1, default=None):
    """Spark's value of ``func`` over (partition by ``part`` order by
    ``order``) with the default frame, per row id."""
    groups = {}
    for r in rows:
        groups.setdefault(tuple(r[c] for c in part), []).append(r)
    out = {}
    for members in groups.values():
        srt, cmp = _order(members, order)
        for i, r in enumerate(srt):
            peers_end = i
            while peers_end + 1 < len(srt) and cmp(srt[peers_end + 1],
                                                   r) == 0:
                peers_end += 1
            first = next(j for j in range(i + 1) if cmp(srt[j], r) == 0)
            if func == "row_number":
                val = i + 1
            elif func == "rank":
                val = first + 1
            elif func == "dense_rank":
                val = 1 + sum(1 for j in range(first)
                              if j == 0 or cmp(srt[j], srt[j - 1]) != 0)
            elif func in ("lag", "lead"):
                j = i - offset if func == "lag" else i + offset
                val = srt[j][arg] if 0 <= j < len(srt) else default
            else:
                frame = [x[arg] for x in (srt[:peers_end + 1] if order
                                          else srt)]
                live = [x for x in frame if x is not None]
                val = {"sum": sum(live) if live else None,
                       "count": len(live),
                       "min": min(live) if live else None,
                       "max": max(live) if live else None}[func]
            out[r["id"]] = val
    return out


# the select list: (name, func, partition keys, order keys, arg, extras);
# four specs, the fourth (k2 by v desc) twice with two frames
SPECS = [
    ("rn", "row_number", ["k1"], [("o", True, True)], None, {}),
    ("lg", "lag", ["k1"], [("o", True, True)], "v", {"default": -99}),
    ("rk", "rank", ["k2"], [("v", False, False)], None, {}),
    ("s1", "sum", ["k1"], [], "v", {}),
    ("dr", "dense_rank", [], [("k2", True, True)], None, {}),
    ("mx", "max", ["k2"], [("v", False, False)], "o", {}),
    ("ct", "count", ["k2"], [("v", False, False)], "v", {}),
]

SQL = ("select id, k1, k2, v, o, "
       "row_number() over (partition by k1 order by o) rn, "
       "lag(v, 1, -99) over (partition by k1 order by o) lg, "
       "rank() over (partition by k2 order by v desc) rk, "
       "sum(v) over (partition by k1) s1, "
       "dense_rank() over (order by k2) dr, "
       "max(o) over (partition by k2 order by v desc) mx, "
       "count(v) over (partition by k2 order by v desc) ct from t")


def _df_exprs(f):
    out = []
    for name, func, part, order, arg, extra in SPECS:
        fn = {"row_number": lambda: f.row_number(), "rank": lambda: f.rank(),
              "dense_rank": lambda: f.dense_rank(),
              "lag": lambda: f.lag(arg, 1, extra.get("default")),
              "sum": lambda: f.sum(arg), "max": lambda: f.max(arg),
              "count": lambda: f.count(arg)}[func]()
        out.append(f.alias(f.over(fn, part, order), name))
    return out


def _expected(t):
    rows = t.to_pylist()
    cols = {name: oracle(rows, func, part, order, arg, **extra)
            for name, func, part, order, arg, extra in SPECS}
    return sorted(tuple([r[c] for c in t.column_names]
                        + [cols[name][r["id"]] for name, *_ in SPECS])
                  for r in rows)


def _sorted_rows(tbl):
    return sorted(tuple(r.values()) for r in tbl.to_pylist())


@pytest.fixture(scope="module")
def table():
    return _table()


def test_several_specs_dataframe_form(table):
    df = TorchSession(device="cpu").create_dataframe(table, 3).window(
        _df_exprs(F))
    plan = df.physical_plan()
    assert type(plan).__name__ == "ProjectExec"
    text = df.explain()
    # four specs, four chained window execs, in first-appearance order:
    # (k1 by o), (k2 by v desc) and (k1) over hash exchanges, (by k2) over
    # a gather
    assert text.count("WindowExec") == 4
    assert text.count("ShuffleExchangeExec") == 3
    assert text.count("_GatherAllExec") == 1
    got = df.collect()
    assert got.column_names == table.column_names + [s[0] for s in SPECS]
    assert _sorted_rows(got) == _expected(table)


def test_several_specs_sql_form(table):
    spark = TorchSession(device="cpu")
    spark.create_or_replace_temp_view(
        "t", spark.create_dataframe(table, 3))
    got = spark.sql(SQL).collect()
    assert _sorted_rows(got) == _expected(table)
    df_form = spark.create_dataframe(table, 3).window(_df_exprs(F)).collect()
    assert _sorted_rows(got) == _sorted_rows(df_form)


def test_reference_evaluates_every_spec_under_the_first(table):
    """The reference's host path gives another answer for the same text:
    every expression runs under the first expression's spec."""
    ref = TpuSession()
    ref.create_or_replace_temp_view("t", ref.create_dataframe(table, 3))
    # (its host path cannot take lag's default from the SQL text)
    rows = ref.sql(SQL.replace("lag(v, 1, -99)", "lag(v, 1)")
                   ).collect().to_pylist()
    # under (partition by k1 order by o) its rank and dense_rank are the
    # row number
    assert all(r["rk"] == r["rn"] == r["dr"] for r in rows)
    spark_rank = oracle(table.to_pylist(), "rank", ["k2"],
                        [("v", False, False)])
    assert any(r["rk"] != spark_rank[r["id"]] for r in rows)


def test_rank_beside_dense_rank_ten_rows():
    """``rank() over (partition by k order by i desc)`` beside
    ``dense_rank() over (order by k)``: Spark's dense_rank is 1, 2, 3, 4 by
    k with the NULL rows first; the reference's repeats the rank column."""
    t = pa.table({"k": pa.array([3, None, 1, 2, 3, 1, None, 4, 2, 3],
                                pa.int64()),
                  "i": pa.array([5, 1, 2, 8, 2, 9, 3, 4, 4, 7], pa.int64())})
    text = ("select k, i, rank() over (partition by k order by i desc) r, "
            "dense_rank() over (order by k) d from t")
    spark, ref = TorchSession(device="cpu"), TpuSession()
    spark.create_or_replace_temp_view("t", spark.create_dataframe(t, 2))
    ref.create_or_replace_temp_view("t", ref.create_dataframe(t, 2))
    key = (lambda r: (r["k"] is not None, r["k"] or 0, -r["i"]))
    got = sorted(spark.sql(text).collect().to_pylist(), key=key)
    assert [(r["k"], r["i"], r["r"], r["d"]) for r in got] == [
        (None, 3, 1, 1), (None, 1, 2, 1), (1, 9, 1, 2), (1, 2, 2, 2),
        (2, 8, 1, 3), (2, 4, 2, 3), (3, 7, 1, 4), (3, 5, 2, 4),
        (3, 2, 3, 4), (4, 4, 1, 5)]
    refd = ref.sql(text).collect().to_pylist()
    assert all(r["d"] == r["r"] for r in refd)


def _shape(plan):
    out, node = [], plan
    while node is not None:
        out.append(type(node).__name__)
        node = node.children[0] if node.children else None
    return out


@pytest.mark.parametrize("parts,partition_by,shape", [
    (3, ["k1"], ["WindowExec", "AdaptiveShuffleReaderExec",
                 "ShuffleExchangeExec", "LocalTableScanExec"]),
    (3, [], ["WindowExec", "_GatherAllExec", "LocalTableScanExec"]),
    (1, ["k1"], ["WindowExec", "LocalTableScanExec"]),
])
def test_one_spec_plans_as_before(table, parts, partition_by, shape):
    """One spec, even with two frames: one window exec over its
    distribution and no projection, as before the several-spec planner;
    the same plan shape the reference gives."""
    def exprs(f):
        order = [("o", True, True)]
        return [f.alias(f.over(f.row_number(), partition_by, order), "rn"),
                f.alias(f.over(f.sum("v"), partition_by, order), "cs"),
                f.alias(f.over(f.count("v"), partition_by, order,
                               _full_frame(f)), "n")]
    df = TorchSession(device="cpu").create_dataframe(table, parts).window(
        exprs(F))
    plan = df.physical_plan()
    assert _shape(plan) == shape
    assert len(plan.window_exprs) == 3
    ref = TpuSession().create_dataframe(table, parts).window(exprs(JF))
    from spark_rapids_tpu.plan.overrides import TpuOverrides
    rplan = TpuOverrides(ref.session.conf).apply(ref._plan)
    assert [n.replace("TpuExec", "Exec") for n in _shape(rplan)][
        :len(shape) - 1] == shape[:-1]
    key = (lambda r: r["id"])
    assert sorted(df.collect().to_pylist(), key=key) == sorted(
        ref.collect().to_pylist(), key=key)


def _full_frame(f):
    if f is F:
        from spark_rapids_tpu_torch.expr.windows import FULL_FRAME
    else:
        from spark_rapids_tpu.expr.windows import FULL_FRAME
    return FULL_FRAME
