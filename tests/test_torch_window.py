"""The window exec and ``ops/windowing.py`` of the PyTorch port on the CPU,
held against the JAX package.

- Every case of the reference's ``tests/test_window.py``: the same parquet
  files (one, two or three, so that the multi-file cases plan the hash
  exchange on the partition keys) through ``TorchSession(device="cpu")``
  and the reference ``TpuSession``, each with its own package's window
  expressions; the two cases the reference sends to the host are refused
  by the port at planning. The deterministic cases also check their
  documented rows.
- Each function of ``ops/windowing.py`` against its reference counterpart
  on random boundaries and values, and ``WindowExec._partition_ends``
  against the port's ``seg_ends``.
- The decimal window ``avg``: refused by the port at planning; the
  reference's unscaled 187.5 documented beside it. The decimal window
  ``sum`` is ported and equal. A bounded RANGE frame over a decimal key
  spans the key's units (the reference's spans its scaled units).
- Two more reference gaps the port does not copy, each shown beside the
  reference's answer: its ``lag`` is a lead, and lead/lag with a default
  returns null where the offset lands past the end of a partition that
  the padding joins (no partition keys, or null ones).

Tolerance: every integer, index, rank, count, min/max and lead/lag value
exact. A double sum or average over a frame differences one global cumsum:
the port's (torch's, sequential like ``np.cumsum``) is bit for bit the same
formula over ``np.cumsum``, while XLA's CPU cumsum adds in a tree order, so
against the reference they agree within rel 1e-9 and abs 1e-9 (the
reference's own ``check`` bound).
"""

import math
import os
import types
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.exec.window import WindowExec as RWindowExec
from spark_rapids_tpu.expr import aggregates as RAG
from spark_rapids_tpu.expr import core as RE
from spark_rapids_tpu.expr import windows as RWX
from spark_rapids_tpu.ops import windowing as RW
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.exec.window import WindowExec
from spark_rapids_tpu_torch.expr import aggregates as AG
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import windows as WX
from spark_rapids_tpu_torch.ops import windowing as W
from spark_rapids_tpu_torch.session import TorchSession


def _ns(core, wx, ag):
    return types.SimpleNamespace(
        col=core.col, Alias=core.Alias, WE=wx.WindowExpression,
        Spec=wx.WindowSpec, Frame=wx.WindowFrame, FULL=wx.FULL_FRAME,
        DEFAULT=wx.DEFAULT_FRAME, RowNumber=wx.RowNumber, Rank=wx.Rank,
        DenseRank=wx.DenseRank, Lead=wx.Lead, Lag=wx.Lag, Sum=ag.Sum,
        Count=ag.Count, Min=ag.Min, Max=ag.Max, Average=ag.Average)


PORT = _ns(E, WX, AG)
REF = _ns(RE, RWX, RAG)
# the reference's Lag subclasses Lead and its exec and host path take it for
# a lead (lag(v, n) == lead(v, n) there); its lead with a negative offset is
# Spark's lag, and the port's Lag is held against that
REF.Lag = lambda c, n, default=None: RWX.Lead(c, -n, default)


# -- the reference's tables and specs ------------------------------------------

def win_table(n=400, seed=11):
    r = np.random.default_rng(seed)
    grp = r.integers(0, 8, n)
    ordv = r.permutation(n)
    vals = r.normal(0, 10, n)
    vmask = r.random(n) < 0.1
    return pa.table({
        "g": pa.array([int(v) for v in grp], pa.int64()),
        "o": pa.array([int(v) for v in ordv], pa.int32()),
        "v": pa.array([None if m else float(v) for v, m in zip(vals, vmask)],
                      pa.float64()),
    })


def _spec(m, order=True, frame=None):
    return m.Spec((m.col("g"),),
                  ((m.col("o"), True, True),) if order else (),
                  m.DEFAULT if frame is None else frame)


def _w(m, func, spec, name):
    return m.Alias(m.WE(func, spec), name)


def _rows_frame(m, p, f):
    return m.Frame("rows", p, f)


def _range_table(seed, n, groups, span, nulls):
    r = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array([int(v) for v in r.integers(0, groups, n)], pa.int64()),
        "o": pa.array([int(v) for v in r.integers(0, span, n)], pa.int32()),
        "v": pa.array([None if nulls and m < 0.1 else float(x) for x, m in
                       zip(r.normal(0, 10 if nulls else 3, n), r.random(n))],
                      pa.float64()),
    })


def _exprs_ranking(m):
    return [_w(m, m.RowNumber(), _spec(m), "rn"),
            _w(m, m.Rank(), _spec(m), "rk"),
            _w(m, m.DenseRank(), _spec(m), "dr")]


def _exprs_cumulative(m):
    return [_w(m, m.Sum(m.col("v")), _spec(m), "cum_sum_range"),
            _w(m, m.Count(m.col("v")),
               _spec(m, frame=_rows_frame(m, None, 0)), "cum_cnt_rows"),
            _w(m, m.Min(m.col("v")), _spec(m), "cum_min"),
            _w(m, m.Max(m.col("v")), _spec(m), "cum_max")]


def _exprs_full(m):
    return [_w(m, m.Sum(m.col("v")), _spec(m, frame=m.FULL), "tot"),
            _w(m, m.Average(m.col("v")), _spec(m, frame=m.FULL), "avg"),
            _w(m, m.Count(None), _spec(m, frame=m.FULL), "n")]


def _exprs_sliding(m):
    return [_w(m, m.Sum(m.col("v")), _spec(m, frame=_rows_frame(m, 2, 2)),
               "s5"),
            _w(m, m.Average(m.col("v")),
               _spec(m, frame=_rows_frame(m, 3, 0)), "a4"),
            _w(m, m.Count(m.col("v")), _spec(m, frame=_rows_frame(m, 0, 2)),
               "c3")]


def _exprs_lead_lag(m):
    return [_w(m, m.Lead(m.col("v"), 2), _spec(m), "ld"),
            _w(m, m.Lag(m.col("v"), 1), _spec(m), "lg"),
            _w(m, m.Lag(m.col("o"), 3, default=-1), _spec(m), "lgd")]


def _exprs_full_minmax(m):
    return [_w(m, m.Max(m.col("v")), _spec(m, frame=m.FULL), "mx"),
            _w(m, m.Min(m.col("v")), _spec(m, frame=m.FULL), "mn")]


def _exprs_sliding_minmax(m):
    return [_w(m, m.Min(m.col("v")), _spec(m, frame=_rows_frame(m, 2, 2)),
               "m"),
            _w(m, m.Max(m.col("v")), _spec(m, frame=_rows_frame(m, 3, 1)),
               "x"),
            _w(m, m.Min(m.col("o")), _spec(m, frame=_rows_frame(m, 0, 4)),
               "mi"),
            _w(m, m.Max(m.col("v")),
               _spec(m, frame=_rows_frame(m, 2, None)), "xu")]


def _exprs_sliding_minmax_nan(m):
    return [_w(m, m.Max(m.col("v")), _spec(m, frame=_rows_frame(m, 1, 1)),
               "mx"),
            _w(m, m.Min(m.col("v")), _spec(m, frame=_rows_frame(m, 1, 1)),
               "mn")]


def _exprs_range_int(asc):
    def make(m):
        sp = m.Spec((m.col("g"),), ((m.col("o"), asc, True),),
                    m.Frame("range", 3, 5))
        return [_w(m, m.Sum(m.col("v")), sp, "s"),
                _w(m, m.Count(m.col("v")), sp, "c"),
                _w(m, m.Min(m.col("v")), sp, "mn"),
                _w(m, m.Max(m.col("v")), sp, "mx"),
                _w(m, m.Average(m.col("v")), sp, "av")]
    return make


def _exprs_range_nulls(nf):
    def make(m):
        sp = m.Spec((m.col("g"),), ((m.col("o"), True, nf),),
                    m.Frame("range", 2, 2))
        return [_w(m, m.Sum(m.col("v")), sp, "s"),
                _w(m, m.Count(m.col("v")), sp, "c")]
    return make


def _exprs_range_one_sided(m):
    def sp(p, f):
        return m.Spec((m.col("g"),), ((m.col("o"), True, True),),
                      m.Frame("range", p, f))
    return [_w(m, m.Sum(m.col("v")), sp(None, 4), "s1"),
            _w(m, m.Sum(m.col("v")), sp(2, None), "s2"),
            _w(m, m.Sum(m.col("v")), sp(0, 0), "s3")]


def _exprs_range_float(m):
    sp = m.Spec((m.col("g"),), ((m.col("o"), True, True),),
                m.Frame("range", 2, 2))
    return [_w(m, m.Sum(m.col("v")), sp, "s")]


def _exprs_no_order(m):
    return [_w(m, m.Sum(m.col("v")), _spec(m, order=False, frame=m.FULL),
               "s")]


def _exprs_ties(m):
    return [_w(m, m.Sum(m.col("v")), _spec(m), "s"),
            _w(m, m.Rank(), _spec(m), "rk"),
            _w(m, m.DenseRank(), _spec(m), "dr")]


def _exprs_bool_string(m):
    return [_w(m, m.Min(m.col("b")), _spec(m, frame=m.FULL), "bmin"),
            _w(m, m.Max(m.col("s")), _spec(m, frame=m.FULL), "smax"),
            _w(m, m.Min(m.col("s")), _spec(m, frame=m.FULL), "smin")]


NAN_TABLE = pa.table({
    "g": pa.array([1, 1, 1, 2, 2], pa.int64()),
    "o": pa.array([1, 2, 3, 1, 2], pa.int32()),
    "v": pa.array([1.0, float("nan"), 2.0, float("nan"), float("nan")],
                  pa.float64())})
NAN_EMPTY_TABLE = pa.table({
    "g": pa.array([1, 1, 1, 1, 1], pa.int64()),
    "o": pa.array([1, 2, 3, 4, 5], pa.int32()),
    "v": pa.array([1.0, float("nan"), None, 4.0, 2.0], pa.float64())})
NULL_ORDER_TABLE = pa.table({
    "g": pa.array([1, 1, 1, 1, 1, 2, 2], pa.int64()),
    "o": pa.array([None, None, 1, 3, 9, None, 5], pa.int32()),
    "v": pa.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0], pa.float64())})
FLOAT_KEY_TABLE = pa.table({
    "g": pa.array([1, 1, 1, 1, 1], pa.int64()),
    "o": pa.array([1.0, 2.5, float("nan"), float("nan"), 9.0], pa.float64()),
    "v": pa.array([1.0, 2.0, 4.0, 8.0, 16.0], pa.float64())})
TIES_TABLE = pa.table({
    "g": pa.array([1, 1, 1, 1, 2], pa.int64()),
    "o": pa.array([1, 1, 2, 2, 1], pa.int32()),
    "v": pa.array([10.0, 20.0, 30.0, 40.0, 5.0], pa.float64())})
BOOL_STRING_TABLE = pa.table({
    "g": pa.array([1, 1, 2, 2], pa.int64()),
    "o": pa.array([1, 2, 1, 2], pa.int32()),
    "b": pa.array([True, False, None, True]),
    "s": pa.array(["pear", "apple", "kiwi", None])})

# (reference test, table, files, expressions); the files split the table
# as the reference's split_table does (one partition each)
CASES = [
    ("ranking_functions", lambda: win_table(), 3, _exprs_ranking),
    ("cumulative_and_range_aggregates", lambda: win_table(), 2,
     _exprs_cumulative),
    ("full_partition_frame", lambda: win_table(), 2, _exprs_full),
    ("sliding_rows_frame", lambda: win_table(), 2, _exprs_sliding),
    ("lead_lag", lambda: win_table(), 2, _exprs_lead_lag),
    ("nan_min_max_window", lambda: NAN_TABLE, 1, _exprs_full_minmax),
    ("sliding_min_max_on_device", lambda: win_table(200), 2,
     _exprs_sliding_minmax),
    ("sliding_min_max_nan_and_empty_frames", lambda: NAN_EMPTY_TABLE, 1,
     _exprs_sliding_minmax_nan),
    ("range_frame_bounded_int_key_asc",
     lambda: _range_table(5, 300, 6, 40, True), 2, _exprs_range_int(True)),
    ("range_frame_bounded_int_key_desc",
     lambda: _range_table(5, 300, 6, 40, True), 2, _exprs_range_int(False)),
    ("range_frame_null_order_keys_first", lambda: NULL_ORDER_TABLE, 1,
     _exprs_range_nulls(True)),
    ("range_frame_null_order_keys_last", lambda: NULL_ORDER_TABLE, 1,
     _exprs_range_nulls(False)),
    ("range_frame_one_sided_and_unbounded",
     lambda: _range_table(9, 120, 4, 30, False), 3, _exprs_range_one_sided),
    ("range_frame_float_key_with_nan", lambda: FLOAT_KEY_TABLE, 1,
     _exprs_range_float),
    ("window_no_order_by_full_frame", lambda: win_table(100), 2,
     _exprs_no_order),
    ("range_frame_ties_deterministic", lambda: TIES_TABLE, 1, _exprs_ties),
    ("window_min_max_bool_and_string", lambda: BOOL_STRING_TABLE, 1,
     _exprs_bool_string),
]


def _write(tmp_path, table, n_files):
    """The table as ``n_files`` parquet files, split like the reference's
    ``split_table``."""
    n = table.num_rows
    step = -(-n // n_files)
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"part{i}.parquet")
        pq.write_table(table.slice(i * step, step), p)
        paths.append(p)
    return paths


def _norm(tbl):
    """Rows sorted with a total order over None and NaN."""
    def key(v):
        if v is None:
            return (0, 0)
        if isinstance(v, float) and math.isnan(v):
            return (2, 0)
        return (1, v)
    return sorted((tuple(r.values()) for r in tbl.to_pylist()),
                  key=lambda r: tuple(key(v) for v in r))


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if math.isnan(b):
                    assert math.isnan(a), (g, w)
                else:
                    assert a == pytest.approx(b, rel=1e-9, abs=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def _both(tmp_path, table, n_files, make):
    paths = _write(tmp_path, table, n_files)
    src = paths if n_files > 1 else paths[0]
    port_df = TorchSession(device="cpu").read_parquet(src).window(make(PORT))
    ref_df = TpuSession().read_parquet(src).window(make(REF))
    return port_df, ref_df


def _find(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        out += _find(c, cls)
    return out


@pytest.mark.parametrize("name,table,n_files,make", CASES,
                         ids=[c[0] for c in CASES])
def test_window_case_matches_reference(tmp_path, name, table, n_files, make):
    port_df, ref_df = _both(tmp_path, table(), n_files, make)
    plan = port_df.physical_plan()
    (win,) = _find(plan, WindowExec)
    got = _norm(plan.execute_collect())
    _assert_rows_close(got, _norm(ref_df.collect()))
    assert win.stats["input_rows"] == win.stats["output_rows"] == len(got)


def test_multi_file_window_plans_the_exchange_on_partition_keys(tmp_path):
    """A window over two files: a hash exchange on ``g`` under the exec, so
    every window partition lands in one exec partition; with no partition
    keys, a gather of both files."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.exec.sort import _GatherAllExec
    port_df, ref_df = _both(tmp_path, win_table(), 2, _exprs_full)
    plan = port_df.physical_plan()
    (ex,) = _find(plan, ShuffleExchangeExec)
    assert [repr(k) for k in ex.partitioner.key_exprs] == ["input[0:bigint]"]
    assert not _find(plan, _GatherAllExec)
    _assert_rows_close(_norm(plan.execute_collect()), _norm(ref_df.collect()))
    no_keys = TorchSession(device="cpu").read_parquet(
        _write(tmp_path, win_table(), 2)).window(
            [_w(PORT, PORT.Sum(PORT.col("v")), PORT.Spec((), (), PORT.FULL),
                "s")])
    plan = no_keys.physical_plan()
    assert _find(plan, _GatherAllExec) and not _find(plan,
                                                     ShuffleExchangeExec)
    out = plan.execute_collect()
    total = sum(v for v in win_table().column("v").to_pylist()
                if v is not None)
    assert out.num_rows == 400
    assert all(s == pytest.approx(total, rel=1e-12)
               for s in out.column("s").to_pylist())


def test_documented_rows(tmp_path):
    """The rows the reference's deterministic cases spell out."""
    def run(table, make):
        return TorchSession(device="cpu").read_parquet(
            _write(tmp_path, table, 1)[0]).window(make(PORT)).collect()
    out = run(NAN_TABLE, _exprs_full_minmax)
    rows = {g: (mx, mn) for g, mx, mn in zip(
        out["g"].to_pylist(), out["mx"].to_pylist(), out["mn"].to_pylist())}
    assert math.isnan(rows[1][0]) and rows[1][1] == 1.0
    assert math.isnan(rows[2][0]) and math.isnan(rows[2][1])
    out = run(TIES_TABLE, _exprs_ties)
    assert sorted(zip(*(out[c].to_pylist() for c in
                        ("g", "o", "v", "s", "rk", "dr")))) == [
        (1, 1, 10.0, 30.0, 1, 1), (1, 1, 20.0, 30.0, 1, 1),
        (1, 2, 30.0, 100.0, 3, 2), (1, 2, 40.0, 100.0, 3, 2),
        (2, 1, 5.0, 5.0, 1, 1)]
    out = run(BOOL_STRING_TABLE, _exprs_bool_string)
    assert sorted(zip(*(out[c].to_pylist() for c in
                        ("g", "bmin", "smax", "smin")))) == [
        (1, False, "pear", "apple"), (1, False, "pear", "apple"),
        (2, True, "kiwi", "kiwi"), (2, True, "kiwi", "kiwi")]


def test_range_frame_multi_order_key_refused(tmp_path):
    """The reference sends this to the host ("one order key"); the port
    refuses it at planning."""
    path = _write(tmp_path, win_table(40), 1)[0]
    m = PORT
    sp = m.Spec((m.col("g"),), ((m.col("o"), True, True),
                                (m.col("v"), True, True)),
                m.Frame("range", 1, 1))
    df = TorchSession(device="cpu").read_parquet(path).window(
        [_w(m, m.Sum(m.col("v")), sp, "s")])
    with pytest.raises(NotImplementedError, match="one order key"):
        df.physical_plan()


def test_lead_string_default_refused(tmp_path):
    t = win_table(30)
    st = pa.table({"g": t.column("g"), "o": t.column("o"),
                   "s": pa.array([f"v{i % 5}" for i in range(30)])})
    path = str(tmp_path / "s.parquet")
    pq.write_table(st, path)
    m = PORT
    df = TorchSession(device="cpu").read_parquet(path).window(
        [_w(m, m.Lead(m.col("s"), 1, default="zzz"), _spec(m), "ld")])
    with pytest.raises(NotImplementedError, match="non-null default"):
        df.physical_plan()
    # a null default over strings is ported
    df = TorchSession(device="cpu").read_parquet(path).window(
        [_w(m, m.Lead(m.col("s"), 1), _spec(m), "ld")])
    ref = TpuSession().read_parquet(path).window(
        [_w(REF, REF.Lead(REF.col("s"), 1), _spec(REF), "ld")])
    assert _norm(df.collect()) == _norm(ref.collect())


def test_several_specs_in_one_node_refused(tmp_path):
    """Refused until the window-spec slice; since, two specs in one node
    plan two chained window execs (tests/test_torch_window_specs.py holds
    their answers to a Spark-semantics oracle). The test keeps its name."""
    path = _write(tmp_path, win_table(40), 1)[0]
    m = PORT
    df = TorchSession(device="cpu").read_parquet(path).window(
        [_w(m, m.RowNumber(), _spec(m), "a"),
         _w(m, m.RowNumber(), _spec(m, order=False), "b")])
    plan = df.physical_plan()
    assert type(plan).__name__ == "ProjectExec"
    assert [type(x).__name__ for x in plan.children] == ["WindowExec"]
    assert type(plan.child.child).__name__ == "WindowExec"
    out = df.collect()
    assert out.column_names == ["g", "o", "v", "a", "b"]
    # a: row_number ordered by o within g; b: a row number within g
    rows = sorted(out.to_pylist(), key=lambda r: (r["g"], r["o"]))
    for g in {r["g"] for r in rows}:
        part = [r for r in rows if r["g"] == g]
        assert [r["a"] for r in part] == list(range(1, len(part) + 1))
        assert sorted(r["b"] for r in part) == list(range(1, len(part) + 1))


def test_lead_default_past_the_last_partition(tmp_path):
    """lead with a default over no partition keys: the last row takes the
    default (Spark, and the reference's host path); the reference's device
    path lets the padding join the partition and returns null there."""
    path = str(tmp_path / "l.parquet")
    pq.write_table(pa.table({"o": pa.array([1, 2, 3], pa.int32()),
                             "v": pa.array([10, 20, 30], pa.int64())}), path)

    def lead(m):
        sp = m.Spec((), ((m.col("o"), True, True),))
        return [_w(m, m.Lead(m.col("v"), 1, default=-1), sp, "ld"),
                _w(m, m.Lag(m.col("v"), 2, default=-2), sp, "lg")]
    got = TorchSession(device="cpu").read_parquet(path).window(
        lead(PORT)).collect()
    assert got.column("ld").to_pylist() == [20, 30, -1]
    assert got.column("lg").to_pylist() == [-2, -2, 10]
    ref = TpuSession().read_parquet(path).window(lead(REF))
    assert ref.collect_host().column("ld").to_pylist() == [20, 30, -1]
    assert ref.collect().column("ld").to_pylist() == [20, 30, None]
    # the reference's lag is its lead, on the device and on the host
    rlag = TpuSession().read_parquet(path).window(
        [_w(REF, RWX.Lag(RE.col("v"), 1), REF.Spec((), ((RE.col("o"), True,
                                                          True),)), "lg")])
    assert rlag.collect().column("lg").to_pylist() == [20, 30, None]
    assert rlag.collect_host().column("lg").to_pylist() == [20, 30, None]


# -- the decimal window avg: a reference gap the port refuses -------------------

def _decimal_table(tmp_path):
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({
        "g": pa.array([1, 1], pa.int64()),
        "d": pa.array([Decimal("1.50"), Decimal("2.25")],
                      pa.decimal128(7, 2))}), path)
    return path


def test_decimal_window_avg_refused_where_reference_is_unscaled(tmp_path):
    path = _decimal_table(tmp_path)

    def avg(m):
        return [_w(m, m.Average(m.col("d")),
                   m.Spec((m.col("g"),), (), m.FULL), "a")]
    # the reference's documented gap: the scaled sum (375) over the count,
    # as a double, where Spark gives 1.875
    ref = TpuSession().read_parquet(path).window(avg(REF)).collect()
    assert ref.column("a").to_pylist() == [187.5, 187.5]
    df = TorchSession(device="cpu").read_parquet(path).window(avg(PORT))
    with pytest.raises(NotImplementedError, match="decimal"):
        df.physical_plan()


def test_decimal_window_sum_min_max_match_reference(tmp_path):
    path = _decimal_table(tmp_path)

    def make(m):
        sp = m.Spec((m.col("g"),), (), m.FULL)
        return [_w(m, m.Sum(m.col("d")), sp, "s"),
                _w(m, m.Min(m.col("d")), sp, "mn"),
                _w(m, m.Max(m.col("d")), sp, "mx")]
    got = TorchSession(device="cpu").read_parquet(path).window(
        make(PORT)).collect()
    ref = TpuSession().read_parquet(path).window(make(REF)).collect()
    assert got.schema.field("s").type == pa.decimal128(17, 2)
    assert got.column("s").to_pylist() == [Decimal("3.75")] * 2
    assert _norm(got) == _norm(ref)


@pytest.mark.parametrize("ascending", [True, False])
def test_decimal_range_frame_spans_the_key_units(tmp_path, ascending):
    """RANGE 1 PRECEDING .. 1 FOLLOWING over a decimal(7,2) key spans 1.00
    each side, as over the same values as doubles. The reference compares
    its scaled values with the unscaled offset, so its frame spans 0.01 and
    holds each row alone (its documented gap)."""
    keys = ["1.00", "1.50", "2.00", "2.75", "5.00"]
    path = str(tmp_path / "r.parquet")
    pq.write_table(pa.table({
        "g": pa.array([1] * 5, pa.int64()),
        "d": pa.array([Decimal(k) for k in keys], pa.decimal128(7, 2)),
        "f": pa.array([float(k) for k in keys], pa.float64()),
        "v": pa.array([1, 2, 4, 8, 16], pa.int64())}), path)

    def make(m, key):
        sp = m.Spec((m.col("g"),), ((m.col(key), ascending, True),),
                    m.Frame("range", 1, 1))
        return [_w(m, m.Sum(m.col("v")), sp, "s")]

    def by_v(t):
        return sorted(zip(t.column("v").to_pylist(),
                          t.column("s").to_pylist()))
    got = TorchSession(device="cpu").read_parquet(path).window(
        make(PORT, "d")).collect()
    want = [(1, 7), (2, 7), (4, 15), (8, 12), (16, 16)]
    assert by_v(got) == want
    as_double = TpuSession().read_parquet(path).window(
        make(REF, "f")).collect()
    assert by_v(as_double) == want
    ref = TpuSession().read_parquet(path).window(make(REF, "d")).collect()
    assert by_v(ref) == [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16)]


@pytest.mark.parametrize("ascending,nulls_first,pre,fol",
                         [(True, True, 1, 2), (False, True, 3, 0),
                          (True, False, 0, 5), (False, False, 2, 2)])
def test_decimal_range_frame_matches_whole_cents(tmp_path, ascending,
                                                 nulls_first, pre, fol):
    """Random decimal(7,2) keys with ties and nulls over three files: the
    port's bounded range frames over the decimal key equal the reference's
    over the same keys in whole cents with the offsets times 100 (integer
    sums and counts, exact; a double key would round at the frame edges)."""
    r = np.random.default_rng(pre * 10 + fol)
    n = 300
    cents = r.integers(0, 900, n)
    null = r.random(n) < 0.08
    t = pa.table({
        "g": pa.array(r.integers(0, 5, n), pa.int64()),
        "d": pa.array([None if m else Decimal(int(x)).scaleb(-2)
                       for x, m in zip(cents, null)], pa.decimal128(7, 2)),
        "i": pa.array([None if m else int(x) for x, m in zip(cents, null)],
                      pa.int64()),
        "v": pa.array(r.integers(-50, 50, n), pa.int64())})
    paths = _write(tmp_path, t, 3)

    def make(m, key, unit):
        sp = m.Spec((m.col("g"),), ((m.col(key), ascending, nulls_first),),
                    m.Frame("range", pre * unit, fol * unit))
        return [_w(m, m.Sum(m.col("v")), sp, "s"),
                _w(m, m.Count(m.col("v")), sp, "c")]

    def rows(t):
        return sorted(zip(*(t.column(c).to_pylist()
                            for c in ("g", "i", "v", "s", "c"))), key=str)
    got = TorchSession(device="cpu").read_parquet(paths).window(
        make(PORT, "d", 1)).collect()
    want = TpuSession().read_parquet(paths).window(
        make(REF, "i", 100)).collect()
    assert rows(got) == rows(want)


# -- ops/windowing.py against the reference on random boundaries --------------

CAPS = [8, 64, 1024]


def _boundaries(rng, cap, density, first=True):
    b = rng.random(cap) < density
    if first:
        b[0] = True
    return b


def _pair(rng, cap):
    """Partition boundaries and order boundaries that include them, as the
    exec builds them."""
    part = _boundaries(rng, cap, 0.1)
    order = part | (rng.random(cap) < 0.3)
    return part, order


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("first", [True, False])
def test_segment_scans_match_reference(cap, first):
    rng = np.random.default_rng(cap + first)
    b = _boundaries(rng, cap, 0.15, first)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    _eq(W.seg_starts(tb), RW.seg_starts(jb))
    _eq(W.seg_ends(tb), RW.seg_ends(jb))
    v = rng.integers(-1000, 1000, cap).astype(np.int64)
    _eq(W.seg_cumsum(torch.from_numpy(v), tb),
        RW.seg_cumsum(jnp.asarray(v), jb))
    # ranks and tie ends over any boundaries, the exec's shape or not
    o = _boundaries(rng, cap, 0.4, first)
    to, jo = torch.from_numpy(o), jnp.asarray(o)
    _eq(W.tie_group_ends(to, tb), RW.tie_group_ends(jo, jb))
    _eq(W.rank(to, tb, cap), RW.rank(jo, jb, cap))
    _eq(W.dense_rank(to, tb), RW.dense_rank(jo, jb))
    _eq(W.row_number(tb, cap), RW.row_number(jb, cap))


@pytest.mark.parametrize("cap", CAPS)
def test_ranking_over_exec_boundaries_match_reference(cap):
    rng = np.random.default_rng(7 * cap)
    part, order = _pair(rng, cap)
    tp, to = torch.from_numpy(part), torch.from_numpy(order)
    jp, jo = jnp.asarray(part), jnp.asarray(order)
    _eq(W.tie_group_ends(to, tp), RW.tie_group_ends(jo, jp))
    _eq(W.rank(to, tp, cap), RW.rank(jo, jp, cap))
    _eq(W.dense_rank(to, tp), RW.dense_rank(jo, jp))
    # the exec's partition ends: the reference's reversed seg_cummax
    _eq(W.seg_ends(tp), RWindowExec._partition_ends(jp, cap))


@pytest.mark.parametrize("cap", CAPS)
def test_float_seg_cumsum_is_the_numpy_formula(cap):
    """torch's cumsum adds in np.cumsum's order: the port's segmented sum is
    bit for bit the formula over np.cumsum; XLA's differs within 1e-9."""
    rng = np.random.default_rng(cap)
    b = _boundaries(rng, cap, 0.1)
    v = rng.normal(0, 100, cap)
    got = W.seg_cumsum(torch.from_numpy(v), torch.from_numpy(b)).numpy()
    cs = np.cumsum(v)
    start = W.seg_starts(torch.from_numpy(b)).numpy()
    want = cs - np.where(start > 0, cs[np.maximum(start - 1, 0)], 0.0)
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(RW.seg_cumsum(jnp.asarray(v), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("offset", [-3, -1, 1, 2, 9])
@pytest.mark.parametrize("default", [None, -7])
def test_shift_within_partition_matches_reference(offset, default):
    cap = 64
    rng = np.random.default_rng(offset + 100)
    part = _boundaries(rng, cap, 0.2)
    seg = np.cumsum(part).astype(np.int32) - 1
    v = rng.integers(-50, 50, cap).astype(np.int64)
    valid = rng.random(cap) < 0.8
    fill, fill_valid = (0, False) if default is None else (default, True)
    pv, pm = W.shift_within_partition(
        torch.from_numpy(v), torch.from_numpy(valid), torch.from_numpy(seg),
        offset, cap, fill, fill_valid)
    rv, rm = RW.shift_within_partition(
        jnp.asarray(v), jnp.asarray(valid), jnp.asarray(seg), offset, cap,
        jnp.asarray(fill, jnp.int64), fill_valid)
    _eq(pm, rm)
    _eq(pv, rv)


@pytest.mark.parametrize("cap", [8, 100, 1024])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_sparse_table_range_query_match_reference(cap, kind):
    rng = np.random.default_rng(cap + len(kind))
    if kind == "int":
        v = rng.integers(-1000, 1000, cap).astype(np.int32)
        sent = np.iinfo(np.int32).max
    else:
        v = rng.normal(0, 10, cap)
        sent = np.inf
    lo = rng.integers(0, cap, cap)
    hi = np.minimum(lo + rng.integers(0, cap, cap), cap - 1)
    for comb, jcomb, s in ((torch.minimum, jnp.minimum, sent),
                           (torch.maximum, jnp.maximum, -sent)):
        pt = W.sparse_table(torch.from_numpy(v), comb, s)
        rt = RW.sparse_table(jnp.asarray(v), jcomb, jnp.asarray(s, v.dtype))
        _eq(pt, rt)
        _eq(W.range_query(pt, comb, torch.from_numpy(lo.astype(np.int32)),
                          torch.from_numpy(hi.astype(np.int32))),
            RW.range_query(rt, jcomb, jnp.asarray(lo, jnp.int32),
                           jnp.asarray(hi, jnp.int32)))


def _sorted_triples(rng, cap):
    seg = np.sort(rng.integers(0, 6, cap)).astype(np.int32)
    rank = rng.integers(-2, 4, cap).astype(np.int32)
    val = rng.integers(-20, 20, cap).astype(np.int64)
    order = np.lexsort((val, rank, seg))
    return seg[order], rank[order], val[order]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("cap", [8, 64, 512])
def test_searchsorted_lex_matches_reference(side, cap):
    rng = np.random.default_rng(cap + len(side))
    seg, rank, val = _sorted_triples(rng, cap)
    qs = rng.integers(-1, 7, cap).astype(np.int32)
    qr = rng.integers(-3, 5, cap).astype(np.int32)
    qv = rng.integers(-25, 25, cap).astype(np.int64)
    qv[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    got = W.searchsorted_lex(*(torch.from_numpy(a) for a in
                               (seg, rank, val, qs, qr, qv)), side=side)
    want = RW.searchsorted_lex(*(jnp.asarray(a) for a in
                                 (seg, rank, val, qs, qr, qv)), side=side)
    _eq(got, want)


def _range_case(rng, cap, kind, nulls_first, ascending):
    """Sorted (partition, order) rows as the exec lays them out, with null
    and NaN order keys and padding past the live rows."""
    n = cap - 3
    g = rng.integers(0, 4, n)
    if kind == "int":
        o = rng.integers(-10, 10, n).astype(np.int64)
    else:
        o = rng.normal(0, 5, n).round(1)
        o[rng.random(n) < 0.15] = np.nan
    valid = rng.random(n) < 0.85
    # the exec's sort: partition, then nulls, then NaN largest, then value
    okey = np.where(np.isnan(o), np.inf, o) if kind == "float" else o
    okey = okey if ascending else -okey
    nrank = np.where(valid, 1, 0 if nulls_first else 2)
    order = np.lexsort((okey, nrank, g))
    g, o, valid = g[order], o[order], valid[order]
    pad = cap - n
    g = np.concatenate([g, np.full(pad, g[-1] + 1)])
    o = np.concatenate([np.where(valid, o, 0), np.zeros(pad, o.dtype)])
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    part = np.concatenate([[True], g[1:] != g[:-1]])
    seg = (np.cumsum(part) - 1).astype(np.int32)
    return o, valid, seg, part


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("pre,fol", [(3, 5), (None, 4), (2, None), (0, 0)])
def test_range_frame_bounds_match_reference(kind, ascending, nulls_first,
                                            pre, fol):
    cap = 128
    rng = np.random.default_rng(hash((kind, ascending, nulls_first, pre,
                                      fol)) % 2**32)
    o, valid, seg, part = _range_case(rng, cap, kind, nulls_first, ascending)
    tp = torch.from_numpy(part)
    pstart, pend = W.seg_starts(tp), W.seg_ends(tp)
    got = W.range_frame_bounds(torch.from_numpy(o), torch.from_numpy(valid),
                               torch.from_numpy(seg), ascending, pre, fol,
                               pstart, pend)
    jp = jnp.asarray(part)
    want = RW.range_frame_bounds(jnp.asarray(o), jnp.asarray(valid),
                                 jnp.asarray(seg), ascending, pre, fol,
                                 RW.seg_starts(jp), RW.seg_ends(jp))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
