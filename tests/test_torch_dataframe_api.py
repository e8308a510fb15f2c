"""The DataFrame API's remainder in the PyTorch port on the CPU, held
against the JAX package.

The same numpy-seeded table (ints with nulls, doubles, strings) goes through
``TorchSession(device="cpu")`` and the reference ``TpuSession``:

- ``with_column`` (Spark's column order: a replaced column stays where it
  stands; the reference moves it last, shown beside), ``drop``,
  ``with_column_renamed``, the aliases ``where``/``order_by``/
  ``drop_duplicates``, ``schema``/``columns``, ``count()`` (0 over no
  rows), ``GroupedData.count()`` and ``to_pandas()``;
- ``TorchSession.range``: ``RangeExec``'s batches bit for bit the
  reference's (row counts, capacities, live values, validity; the padding
  slots hold 0, where the reference continues the sequence) for one
  argument, a negative step, an empty range and ``num_slices`` above the
  rows;
- ``sort_within_partitions`` over several partitions: the reference's
  ``collect()`` row for row, with no gather in the plan;
- ``explain()``: the exec tree, the refusal ``collect()`` gives, and the
  unported ``metrics``/``stats``/``fused``;
- the ``functions.py`` builders: the window builders against the
  reference's, ``alias`` and ``scalar_subquery`` (NULL for no row, an
  error for two).

Tolerance: none (integers, strings and doubles that are only moved are
compared exactly).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.exec import basic as JXB
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.session import TorchSession


def _table(n=60, seed=16):
    r = np.random.default_rng(seed)
    k = [None if r.random() < 0.15 else int(v) for v in r.integers(0, 5, n)]
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "v": pa.array(r.permutation(n).astype(np.int64)),
        "x": pa.array(np.round(r.normal(0, 10, n), 3)),
        "s": pa.array([["a", "bb", "c"][i % 3] for i in range(n)]),
    })


@pytest.fixture(scope="module")
def frames():
    t = _table()
    return (TorchSession(device="cpu").create_dataframe(t, 3),
            TpuSession().create_dataframe(t, 3))


def _rows(tbl):
    return tbl.to_pylist()


# -- the methods of the frame ---------------------------------------------------

def test_with_column_keeps_sparks_column_order(frames):
    """Spark's withColumn replaces a column of the same name where it
    stands; the reference drops it and appends the new one at the end."""
    port, ref = frames
    got = port.with_column("v", F.col("v") * 2)
    exp = ref.with_column("v", JF.col("v") * 2)
    assert got.columns == ["k", "v", "x", "s"]
    assert exp.columns == ["k", "x", "s", "v"]
    g, e = got.collect(), exp.collect()
    assert g.column("v").to_pylist() == e.column("v").to_pylist()
    assert g.select(["k", "x", "s", "v"]).equals(e)


@pytest.mark.parametrize("case", ["new column", "drop", "drop unknown",
                                  "rename", "rename unknown", "where",
                                  "order_by", "drop_duplicates",
                                  "group count"])
def test_frame_methods_match_reference(frames, case):
    port, ref = frames
    build = {
        "new column": lambda df, f: df.with_column("w", f.col("v") + 1),
        "drop": lambda df, f: df.drop("x", "s"),
        "drop unknown": lambda df, f: df.drop("nope"),
        "rename": lambda df, f: df.with_column_renamed("v", "vv"),
        "rename unknown": lambda df, f: df.with_column_renamed("q", "z"),
        "where": lambda df, f: df.where(f.col("v") < 20),
        "order_by": lambda df, f: df.order_by("k", "v"),
        "drop_duplicates": lambda df, f: df.select("k", "s")
        .drop_duplicates().order_by("k", "s"),
        "group count": lambda df, f: df.group_by("k").count().order_by("k"),
    }[case]
    got, exp = build(port, F), build(ref, JF)
    assert got.columns == exp.columns
    assert [(fl.name, str(fl.data_type), fl.nullable)
            for fl in got.schema] == [(fl.name, str(fl.data_type),
                                       fl.nullable) for fl in exp.schema]
    g, e = got.collect(), exp.collect()
    if case in ("order_by", "drop_duplicates", "group count"):
        assert _rows(g) == _rows(e)
    else:
        key = (lambda r: tuple((v is None, v) for v in r.values()))
        assert sorted(_rows(g), key=key) == sorted(_rows(e), key=key)


@pytest.mark.parametrize("parts", [1, 3])
def test_count_matches_reference(parts):
    t = _table(50)
    port = TorchSession(device="cpu").create_dataframe(t, parts)
    ref = TpuSession().create_dataframe(t, parts)
    assert port.count() == ref.count() == 50
    assert (port.filter(F.col("v") < 10).count()
            == ref.filter(JF.col("v") < 10).count() == 10)
    # no rows: 0, not an empty result
    assert port.filter(F.col("v") < 0).count() == 0
    assert ref.filter(JF.col("v") < 0).count() == 0
    assert isinstance(port.count(), int)


def test_to_pandas(frames):
    port, ref = frames
    pd_port = port.to_pandas()
    assert list(pd_port.columns) == ["k", "v", "x", "s"]
    assert pd_port.equals(ref.collect().to_pandas())


# -- range ------------------------------------------------------------------------

RANGES = {
    "one argument": ((10,), {}),
    "start end step": ((3, 50, 4), {"num_slices": 3}),
    "negative step": ((10, -7, -3), {"num_slices": 2}),
    "empty": ((5, 5), {"num_slices": 2}),
    "backwards empty": ((5, 0), {}),
    "slices above rows": ((0, 3), {"num_slices": 5}),
    "several batches": ((0, 70_000, 1), {"num_slices": 2}),
}


@pytest.mark.parametrize("case", list(RANGES))
def test_range_batches_match_reference(case):
    args, kw = RANGES[case]
    port_df = TorchSession(device="cpu").range(*args, **kw)
    ref_df = TpuSession().range(*args, **kw)
    assert port_df.collect().equals(ref_df.collect())
    assert port_df.count() == ref_df.count()
    # the execs batch for batch (the several-batch case at 2^15 rows a
    # batch, so a slice spans batches)
    start, end = (0, args[0]) if len(args) == 1 else args[:2]
    step = args[2] if len(args) > 2 else 1
    slices = kw.get("num_slices", 1)
    pe = XB.RangeExec(start, end, step, slices, device="cpu",
                      max_rows_per_batch=1 << 15)
    re_ = JXB.RangeExec(start, end, step, slices, max_rows_per_batch=1 << 15)
    assert pe.num_partitions == re_.num_partitions == slices
    for split in range(slices):
        pbs = list(pe.execute_partition(split))
        rbs = list(re_.execute_partition(split))
        assert len(pbs) == len(rbs)
        for pb, rb in zip(pbs, rbs):
            n = int(rb.num_rows)
            assert pb.num_rows == n and pb.capacity == rb.capacity
            pc, rc = pb.columns[0], rb.columns[0]
            assert torch.equal(pc.validity, torch.tensor(
                np.asarray(rc.validity)))
            assert np.array_equal(pc.data.numpy()[:n],
                                  np.asarray(rc.data)[:n])
            assert not pc.data[n:].any()
            assert pc.data.dtype == torch.int64


def test_range_makes_its_rows_on_the_device_and_counts_them():
    spark = TorchSession(device="cpu")
    df = spark.range(0, 100, num_slices=4)
    assert df.schema.fields[0].name == "id"
    assert not df.schema.fields[0].nullable
    plan = df.physical_plan()
    assert type(plan).__name__ == "RangeExec" and plan.num_partitions == 4
    got = df.with_column("k", F.col("id") % 7).group_by("k").count() \
        .order_by("k").collect()
    assert got.column("count").to_pylist() == [15, 15, 14, 14, 14, 14, 14]
    with pytest.raises(ValueError):
        spark.range(0, 10, 0)


# -- sort_within_partitions -------------------------------------------------------

@pytest.mark.parametrize("asc", [True, False])
def test_sort_within_partitions_matches_reference(asc):
    t = _table(90, seed=3)
    port = TorchSession(device="cpu").create_dataframe(t, 3)
    ref = TpuSession().create_dataframe(t, 3)
    got = port.sort_within_partitions("k", "v", ascending=asc)
    exp = ref.sort_within_partitions("k", "v", ascending=asc)
    plan = got.physical_plan()
    assert type(plan).__name__ == "SortExec" and not plan.global_sort
    assert plan.num_partitions == 3
    assert "_GatherAllExec" not in got.explain()
    assert _rows(got.collect()) == _rows(exp.collect())
    # each partition is sorted on its own: a global sort differs
    assert _rows(got.collect()) != _rows(port.sort("k", "v",
                                                   ascending=asc).collect())


# -- explain ----------------------------------------------------------------------

def test_explain_prints_the_exec_tree(frames):
    port, _ = frames
    df = port.filter(F.col("v") > 3).group_by("k").agg(
        F.sum("x").alias("sx"))
    text = df.explain()
    lines = text.splitlines()
    assert lines[0].startswith("HashAggregateExec")
    assert "mode=final" in lines[0]
    names = [ln.strip().split(" ")[0] for ln in lines]
    assert names == ["HashAggregateExec", "AdaptiveShuffleReaderExec",
                     "ShuffleExchangeExec", "HashAggregateExec",
                     "LocalTableScanExec"]
    # one level of indentation a depth
    assert [len(ln) - len(ln.lstrip()) for ln in lines] == [0, 2, 4, 6, 8]
    assert text == df.physical_plan().tree_string()


def test_explain_refuses_what_collect_refuses(frames):
    port, _ = frames
    bad = port.sort(F.spark_partition_id())
    with pytest.raises(NotImplementedError) as e1:
        bad.explain()
    with pytest.raises(NotImplementedError) as e2:
        bad.collect()
    assert str(e1.value) == str(e2.value)
    for flag, module in (("metrics", "runtime/metrics.py"),
                         ("stats", "runtime/stats.py"),
                         ("fused", "plan/stages.py")):
        with pytest.raises(NotImplementedError, match=module):
            port.explain(**{flag: True})


# -- functions.py builders --------------------------------------------------------

def test_window_builders_match_reference(frames):
    port, ref = frames

    def build(df, f):
        spec_p, spec_o = ["k"], [("v", False, False)]
        return df.window([
            f.alias(f.over(f.row_number(), spec_p, spec_o), "rn"),
            f.alias(f.over(f.rank(), spec_p, spec_o), "rk"),
            f.alias(f.over(f.dense_rank(), spec_p, spec_o), "dr"),
            f.alias(f.over(f.lead("x", 1), spec_p, spec_o), "ld"),
            f.alias(f.over(f.sum("v"), spec_p, spec_o), "cs")])
    key = (lambda r: (r["k"] is None, r["k"] or 0, r["v"]))
    got = sorted(_rows(build(port, F).collect()), key=key)
    exp = sorted(_rows(build(ref, JF).collect()), key=key)
    assert got == exp


def test_lag_builder_looks_back(frames):
    """``F.lag`` is Spark's lag (the reference's builder is a lead there:
    ``tests/test_torch_window.py``)."""
    port, _ = frames
    got = port.window([F.alias(F.over(F.lag("v", 1, -1), ["k"], ["v"]),
                               "lg")]).collect().to_pylist()
    by_k = {}
    for r in got:
        by_k.setdefault(r["k"], []).append(r)
    for rows in by_k.values():
        vs = sorted(r["v"] for r in rows)
        want = dict(zip(vs, [-1] + vs[:-1]))
        assert all(r["lg"] == want[r["v"]] for r in rows)


@pytest.mark.parametrize("rows,want", [(1, 7), (0, None), (2, "error")])
def test_scalar_subquery_matches_reference(frames, rows, want):
    port, ref = frames
    t = pa.table({"a": pa.array([7, 8][:rows], pa.int64())})
    sub_p = TorchSession(device="cpu").create_dataframe(t)
    sub_r = TpuSession().create_dataframe(t)
    if want == "error":
        with pytest.raises(ValueError, match="more than one row"):
            F.scalar_subquery(sub_p)
        with pytest.raises(ValueError, match="more than one row"):
            JF.scalar_subquery(sub_r)
        return
    got = port.select("v", F.alias(F.scalar_subquery(sub_p), "q")).collect()
    exp = ref.select("v", JF.alias(JF.scalar_subquery(sub_r), "q")).collect()
    assert got.column("q").to_pylist() == [want] * 60
    assert got.equals(exp)


def test_scalar_subquery_needs_one_column(frames):
    two = TorchSession(device="cpu").create_dataframe(
        pa.table({"a": [1], "b": [2]}))
    with pytest.raises(ValueError, match="one column"):
        F.scalar_subquery(two)
