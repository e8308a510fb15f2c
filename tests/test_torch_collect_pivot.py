"""collect_list, collect_set, PivotFirst and pivot in the PyTorch port on
the CPU, held against the JAX package (whose host path runs the collects
and PivotFirst; ``plan/nodes.py`` ``AggregateNode._agg_one``).

The same numpy-seeded rows go through ``TorchSession(device="cpu")`` and
``TpuSession`` over one and several partitions, with several batches a
partition (the exchange's coalescing off, so each map block is a batch):
``collect_list`` keeps the input order within a group across batches;
``collect_set``'s order is unspecified (Spark) and the sets are compared
sorted; an all-null group gives ``[]``. Pivot's If-guard lowering gives
the reference's column names and values. Tolerance: none for integers,
strings, dates and lists; the pivot's averages (doubles) within 1e-12
relative.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.expr import aggregates as JAG
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.expr import aggregates as AG
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.session import TorchSession


def rows(seed: int = 41, n: int = 400) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 9, n), pa.int64()),
        "g": pa.array(np.array(["x", "y", "z"])[rng.integers(0, 3, n)]),
        "v": pa.array([None if rng.random() < 0.15 else int(x)
                       for x in rng.integers(0, 20, n)], pa.int64()),
        "s": pa.array([None if rng.random() < 0.15 else f"w{int(x)}"
                       for x in rng.integers(0, 6, n)]),
        "p": pa.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)]),
        "d": pa.array(rng.integers(0, 1000, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        # a group whose values are all null
        "allnull": pa.array([None] * n, pa.int64()),
    })


def _by_key(tbl, key="k"):
    return {r[key]: r for r in tbl.to_pylist()}


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("col", ["v", "s", "d"])
def test_collect_list_order_as_the_reference(parts, col):
    t = rows()
    port = TorchSession({"spark.rapids.tpu.sql.adaptive.coalescePartitions"
                         ".enabled": "false"}, device="cpu")
    got = port.create_dataframe(t, parts).group_by("k").agg(
        F.collect_list(col).alias("l")).collect()
    want = TpuSession().create_dataframe(t, parts).group_by("k").agg(
        JE.Alias(JF.collect_list(col), "l")).collect()
    assert _by_key(got) == _by_key(want)


def test_collect_list_keeps_input_order_across_batches():
    """Several batches in one partition (the update → concat → merge loop):
    each group's values in input order."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec import aggregate as XA
    from spark_rapids_tpu_torch.exec.base import TorchExec
    t = rows(43, 300)

    class Batches(TorchExec):
        def __init__(self):
            super().__init__(device="cpu")

        @property
        def output(self):
            from spark_rapids_tpu_torch import types as T
            return T.StructType.from_arrow(t.schema)

        def execute_partition(self, split):
            for lo in range(0, t.num_rows, 37):
                yield ColumnarBatch.from_arrow(t.slice(lo, 37), "cpu")
    agg = XA.HashAggregateExec([E.col("k")], [E.Alias(AG.CollectList(
        E.col("v")), "l")], Batches())
    got = _by_key(agg.execute_collect())
    for k in range(9):
        want = [r["v"] for r in t.to_pylist()
                if r["k"] == k and r["v"] is not None]
        assert got[k]["l"] == want
    assert agg.stats["merges"] == t.num_rows // 37


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("col", ["v", "s"])
def test_collect_set_as_the_reference_sorted(parts, col):
    t = rows(47)
    got = TorchSession(device="cpu").create_dataframe(t, parts).group_by(
        "k").agg(F.collect_set(col).alias("s")).collect()
    want = TpuSession().create_dataframe(t, parts).group_by("k").agg(
        JE.Alias(JF.collect_set(col), "s")).collect()
    g, w = _by_key(got), _by_key(want)
    assert g.keys() == w.keys()
    for k in g:
        assert sorted(g[k]["s"]) == sorted(w[k]["s"])
        assert len(set(g[k]["s"])) == len(g[k]["s"])


def test_all_null_group_gives_an_empty_array():
    t = rows(53, 60)
    for parts in (1, 2):
        got = TorchSession(device="cpu").create_dataframe(t, parts).group_by(
            "g").agg(F.collect_list("allnull").alias("l"),
                     F.collect_set("allnull").alias("s")).collect()
        want = TpuSession().create_dataframe(t, parts).group_by("g").agg(
            JE.Alias(JF.collect_list("allnull"), "l"),
            JE.Alias(JF.collect_set("allnull"), "s")).collect()
        assert _by_key(got, "g") == _by_key(want, "g")
        assert all(r["l"] == [] and r["s"] == [] for r in got.to_pylist())
    # keyless: one row, an empty list over no row
    df = TorchSession(device="cpu").create_dataframe(t)
    out = df.filter(E.col("k") < 0).agg(F.collect_list("v").alias("l"))
    assert out.collect().to_pylist() == [{"l": []}]


def test_collects_take_the_segment_path():
    """A string key takes the dense path, but not with a collect."""
    t = rows(59, 100)
    plan = TorchSession(device="cpu").create_dataframe(t).group_by("g").agg(
        F.collect_list("v").alias("l"), F.count().alias("n")).physical_plan()
    out = plan.execute_collect()
    assert plan.stats["segment"] == plan.stats["updates"] == 1
    want = TpuSession().create_dataframe(t).group_by("g").agg(
        JE.Alias(JF.collect_list("v"), "l"), JE.Alias(JF.count(), "n")
    ).collect()
    assert _by_key(out, "g") == _by_key(want, "g")


def test_presorted_probe_still_applies():
    """A single 64-bit key arriving sorted skips the sort, collects
    included."""
    n = 1 << 17
    k = np.repeat(np.arange(n // 4, dtype=np.int64), 4)
    v = np.arange(n, dtype=np.int64)[::-1].copy()
    t = pa.table({"k": k, "v": v})
    plan = TorchSession(device="cpu").create_dataframe(t).group_by("k").agg(
        F.collect_list("v").alias("l")).physical_plan()
    out = plan.execute_collect()
    assert plan.stats["presorted"] == 1
    assert out.column("l").to_pylist()[:2] == [list(v[:4]), list(v[4:8])]


@pytest.mark.parametrize("parts", [1, 3])
def test_pivot_first_as_the_reference(parts):
    t = rows(61)
    got = TorchSession(device="cpu").create_dataframe(t, parts).group_by(
        "k").agg(E.Alias(AG.PivotFirst(E.col("v"), E.col("p"),
                                       ["a", "c", "q"]), "pf")).collect()
    want = TpuSession().create_dataframe(t, parts).group_by("k").agg(
        JE.Alias(JAG.PivotFirst(JE.col("v"), JE.col("p"), ["a", "c", "q"]),
                 "pf")).collect()
    assert _by_key(got) == _by_key(want)


@pytest.mark.parametrize("aggs", ["sum", "sum+count", "named", "first",
                                  "count-star", "avg-min"])
def test_pivot_as_the_reference(aggs):
    t = rows(67)
    make = {
        "sum": lambda f, e: [f.sum("v")],
        "sum+count": lambda f, e: [f.sum("v"), f.count()],
        "named": lambda f, e: [e.Alias(f.sum("v"), "tot")],
        "first": lambda f, e: [f.first("v")],
        "count-star": lambda f, e: [f.count()],
        "avg-min": lambda f, e: [f.avg("v"), f.min("s")],
    }[aggs]
    got = TorchSession(device="cpu").create_dataframe(t, 2).group_by(
        "k").pivot("p", ["a", "b", "zz"]).agg(*make(F, E)).collect()
    want = TpuSession().create_dataframe(t, 2).group_by("k").pivot(
        "p", ["a", "b", "zz"]).agg(*make(JF, JE)).collect()
    assert got.column_names == want.column_names
    g, w = _by_key(got), _by_key(want)
    assert g.keys() == w.keys()
    for k in g:
        for c in got.column_names:
            a, b = g[k][c], w[k][c]
            if isinstance(a, float):
                assert b is not None and abs(a - b) <= 1e-12 * max(1, abs(b))
            else:
                assert a == b, (k, c)
