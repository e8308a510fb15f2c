"""The Expand and Union execs of the port, the bitwise operators and shifts,
and the DataFrame ``rollup``/``union``/``distinct`` methods, held against
the JAX package on the CPU.

The same numpy-seeded parquet files go through both packages:

- ``ExpandExec``: the same ExpandNode (a ROLLUP or GROUPING SETS Expand
  from ``build_rollup_expand``/``build_grouping_sets_expand``, and one of
  hand-written projections with string literals and expressions) planned
  by each package's override rules and run partition by partition: every
  output batch's row count, capacity, validity, string dictionaries and
  valid values equal the reference's, so the interleaved order (r0p0,
  r0p1, ...) is the reference's too, and every invalid slot holds the
  type's default (the reference leaves a projection's literal in the
  padding slots below k x capacity); three projections over 7 rows land
  at capacity 32, past 3 x 8;
- ``UnionExec``: the partitions of two children with different string
  dictionaries, batch for batch the reference's;
- ``BitwiseAnd``/``Or``/``Xor``/``Not`` and the three shifts over int and
  long columns with nulls, shift counts past the width and negative ones,
  against the reference's projections;
- column pruning through an Expand and a Union: the scans read only the
  columns the query uses;
- ``DataFrame.rollup``, ``union`` and ``distinct`` against the reference's
  DataFrame methods.

Tolerance: exact everywhere (values move without arithmetic; the rollup's
sums are of integers and decimals).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.expr import arithmetic as RA
from spark_rapids_tpu.expr import core as RE
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.basic import UnionExec
from spark_rapids_tpu_torch.exec.expand import ExpandExec
from spark_rapids_tpu_torch.expr import arithmetic as PA
from spark_rapids_tpu_torch.expr import core as PE
from spark_rapids_tpu_torch.plan import nodes as PN
from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
from spark_rapids_tpu_torch.session import TorchSession


def _table(seed, n, null_p=0.2):
    rng = np.random.default_rng(seed)

    def nulls(vals):
        return [None if m else v for v, m in
                zip(vals, rng.random(n) < null_p)]
    return pa.table({
        "a": pa.array(nulls(rng.integers(0, 4, n).tolist()), pa.int64()),
        "s": pa.array(nulls([f"w{v}" for v in rng.integers(0, 5, n)]),
                      pa.string()),
        "b": pa.array(nulls(rng.integers(-2**31, 2**31, n).tolist()),
                      pa.int32()),
        "c": pa.array(nulls(rng.integers(-70, 70, n).tolist()), pa.int32()),
        "x": pa.array(nulls(rng.integers(-2**62, 2**62, n).tolist()),
                      pa.int64()),
        "v": pa.array(rng.integers(0, 100, n), pa.int64()),
    })


def _write(tmp_path, name, tables):
    paths = []
    for i, t in enumerate(tables):
        p = str(tmp_path / f"{name}{i}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    return paths if len(paths) > 1 else paths[0]


def _sessions():
    return TorchSession(device="cpu"), TpuSession()


def _batches(exec_, split):
    return list(exec_.execute_partition(split))


def _assert_batches_equal(got, want):
    """Row counts, capacities, validity and dictionaries equal; values
    equal in the valid slots. Every invalid slot of the port holds the
    type's default: the reference leaves a projection's literal in the
    padding slots below k x capacity."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_rows == int(w.num_rows)
        assert g.capacity == w.capacity
        for gc, wc in zip(g.columns, w.columns):
            valid = gc.validity.tolist()
            assert valid == np.asarray(wc.validity).tolist()
            gv, wv = gc.data.tolist(), np.asarray(wc.data).tolist()
            default = gc.dtype.default_value()
            assert [v if ok else None for v, ok in zip(gv, valid)] == \
                [v if ok else None for v, ok in zip(wv, valid)]
            assert all(v == default for v, ok in zip(gv, valid) if not ok)
            if wc.dictionary is None:
                assert gc.dictionary is None
            else:
                assert gc.dictionary.to_pylist() == wc.dictionary.to_pylist()


def _both_execs(path, build):
    """``build(nodes, exprs, types, plan)`` → ExpandNode, in each package
    (its modules) over its read of ``path``; returns (port exec,
    reference exec)."""
    port, ref = _sessions()
    pplan = build(PN, PE, T, port.read_parquet(path)._plan)
    rplan = build(RN, RE, RT, ref.read_parquet(path)._plan)
    return (TorchOverrides(port.conf, port.device).apply(pplan),
            TpuOverrides(ref.conf).apply(rplan))


def _refs(E, plan, names):
    out = plan.output
    return [E.BoundReference(out.index_of(n), out[out.index_of(n)].data_type,
                             True, n) for n in names]


EXPANDS = {
    "rollup a, s": lambda N, E, Ty, p: N.build_rollup_expand(
        p, _refs(E, p, ["a", "s"]))[0],
    "rollup s": lambda N, E, Ty, p: N.build_rollup_expand(
        p, _refs(E, p, ["s"]))[0],
    "rollup s, a, c": lambda N, E, Ty, p: N.build_rollup_expand(
        p, _refs(E, p, ["s", "a", "c"]))[0],
    "grouping sets": lambda N, E, Ty, p: N.build_grouping_sets_expand(
        p, _refs(E, p, ["a", "s"]), [[0], [1], [0, 1], []])[0],
    # string literals with one-entry dictionaries, a null string, and an
    # expression per projection
    "projections": lambda N, E, Ty, p: N.ExpandNode(
        [[E.Literal("left"), _refs(E, p, ["s"])[0],
          _refs(E, p, ["a"])[0] * E.Literal(2)],
         [E.Literal("right"), E.Literal(None, Ty.STRING),
          _refs(E, p, ["v"])[0]],
         [E.Literal("mid"), E.Literal("zz"), E.Literal(None, Ty.LONG)]],
        [Ty.StructField("side", Ty.STRING, False),
         Ty.StructField("s", Ty.STRING, True),
         Ty.StructField("n", Ty.LONG, True)], p),
}


@pytest.mark.parametrize("n_rows", [7, 200, 0])
@pytest.mark.parametrize("case", list(EXPANDS))
def test_expand_exec_matches_the_reference(tmp_path, case, n_rows):
    path = _write(tmp_path, "t", [_table(11 + n_rows, n_rows)])
    port, ref = _both_execs(path, EXPANDS[case])
    assert isinstance(port, ExpandExec)
    got, want = _batches(port, 0), _batches(ref, 0)
    # the port's scan hands an empty file on as one batch of no rows, the
    # reference's as none: both expand to no rows
    if n_rows == 0:
        assert sum(b.num_rows for b in got) == 0
    got = [b for b in got if b.num_rows]
    _assert_batches_equal(got, want)
    if n_rows == 7 and case == "projections":
        # three projections of 7 rows: capacity 32, past 3 x 8
        assert got[0].num_rows == 21 and got[0].capacity == 32
    for b in got:
        for c in b.columns:
            if isinstance(c.dtype, T.StringType):
                d = c.dictionary.to_pylist()
                assert d == sorted(set(d))        # one sorted dictionary


def test_expand_exec_interleaves_the_projections(tmp_path):
    """Row r of the input yields rows k*r .. k*r+k-1, projection by
    projection (Spark's order)."""
    t = pa.table({"a": pa.array([10, 20, 30], pa.int64())})
    path = _write(tmp_path, "i", [t])
    port = TorchSession(device="cpu")
    plan = port.read_parquet(path)._plan
    a = PE.BoundReference(0, T.LONG, True, "a")
    node = PN.ExpandNode([[a], [a + PE.Literal(1)]],
                         [T.StructField("a", T.LONG, True)], plan)
    got = TorchOverrides(port.conf, port.device).apply(node).execute_collect()
    assert got.column("a").to_pylist() == [10, 11, 20, 21, 30, 31]


def test_union_exec_matches_the_reference(tmp_path):
    """Two children of two and one partitions, whose string columns have
    different dictionaries: the union's three partitions are the
    children's batches under the union's schema."""
    left = _write(tmp_path, "l", [_table(1, 40), _table(2, 9)])
    right = _write(tmp_path, "r", [pa.table({
        "a": pa.array([7, None, 8], pa.int64()),
        "s": pa.array(["q", "w0", None]),
        "b": pa.array([1, 2, 3], pa.int32()),
        "c": pa.array([None, 4, 5], pa.int32()),
        "x": pa.array([1, 2, None], pa.int64()),
        "v": pa.array([1, 2, 3], pa.int64())})])
    port, ref = _sessions()
    pu = port.read_parquet(left).union(port.read_parquet(right))
    ru = ref.read_parquet(left).union(ref.read_parquet(right))
    pe = pu.physical_plan()
    re_ = TpuOverrides(ref.conf).apply(ru._plan)
    assert isinstance(pe, UnionExec)
    assert pe.num_partitions == re_.num_partitions == 3
    for split in range(3):
        got, want = _batches(pe, split), _batches(re_, split)
        _assert_batches_equal(got, want)
        assert all(b.schema.names == pe.output.names for b in got)
    assert pu.collect().equals(ru.collect())


def test_union_of_unlike_types_is_refused(tmp_path):
    path = _write(tmp_path, "t", [_table(3, 10)])
    port = TorchSession(device="cpu")
    df = port.read_parquet(path)
    with pytest.raises(ValueError):
        df.select(F.col("a")).union(df.select(F.col("s")))


BITWISE = {
    "and": lambda M, a, b: M.BitwiseAnd(a, b),
    "or": lambda M, a, b: M.BitwiseOr(a, b),
    "xor": lambda M, a, b: M.BitwiseXor(a, b),
    "not": lambda M, a, b: M.BitwiseNot(a),
    "shl": lambda M, a, b: M.ShiftLeft(a, b),
    "shr": lambda M, a, b: M.ShiftRight(a, b),
    "ushr": lambda M, a, b: M.ShiftRightUnsigned(a, b),
}


@pytest.mark.parametrize("base", ["b", "x"])
@pytest.mark.parametrize("op", list(BITWISE))
def test_bitwise_and_shifts_match_the_reference(tmp_path, op, base):
    """Over an int (b) or a long (x) base with nulls; the second operand
    (c, an int in [-70, 70)) is a shift count past the width or negative,
    masked to 31 or 63 as in Java."""
    path = _write(tmp_path, "t", [_table(5, 300)])
    port, ref = _sessions()
    other = "c" if "sh" in op else {"b": "c", "x": "v"}[base]
    out = []
    for M, s, fns in ((PA, port, F), (RA, ref, RF)):
        df = s.read_parquet(path)
        e = BITWISE[op](M, fns.col(base), fns.col(other))
        out.append(df.select(e.alias("r")).collect().column("r").to_pylist())
    assert out[0] == out[1]
    assert any(v is None for v in out[0]) and any(v for v in out[0])


def test_grouping_bits_are_the_references(tmp_path):
    """``grouping()`` of each key reads its bit of the grouping id: the
    first key is the most significant."""
    path = _write(tmp_path, "t", [_table(9, 120)])
    port, ref = _sessions()
    text = ("select a, s, c, grouping(a) ga, grouping(s) gs, grouping(c) gc, "
            "sum(v) t from t group by rollup(a, s, c) "
            "order by ga, gs, gc, a, s, c")
    got = []
    for s in (port, ref):
        s.create_or_replace_temp_view("t", s.read_parquet(path))
        got.append(s.sql(text).collect().to_pylist())
    assert got[0] == got[1]
    bits = {(r["ga"], r["gs"], r["gc"]) for r in got[0]}
    assert bits == {(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)}


def test_union_names_come_from_the_first_arm(tmp_path):
    """Arms that name a column differently: the union's rows carry the
    first arm's names, as in Spark. The reference's UnionExec passes each
    arm's batches on under the arm's own names, and its collect fails to
    concatenate them (ROADMAP Queue 3)."""
    import pyarrow.lib
    path = _write(tmp_path, "t", [_table(4, 50)])
    port, ref = _sessions()
    for s in (port, ref):
        s.create_or_replace_temp_view("t", s.read_parquet(path))
    text = "select a, v from t union all select c, v from t"
    got = port.sql(text).collect()
    assert got.schema.names == ["a", "v"] and got.num_rows == 100
    with pytest.raises(pyarrow.lib.ArrowInvalid):
        ref.sql(text).collect()


def _scanned(plan):
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    out = [plan] if isinstance(plan, FileSourceScanExec) else []
    for c in plan.children:
        out += _scanned(c)
    return out


def test_pruning_reads_only_used_columns_through_expand_and_union(tmp_path):
    path = _write(tmp_path, "t", [_table(4, 50)])
    port, ref = _sessions()
    for s in (port, ref):
        s.create_or_replace_temp_view("t", s.read_parquet(path))
    texts = [
        "select a, sum(v) from t group by rollup(a) order by a",
        "select a, v from t union all select c as a, v from t",
        "select count(*) from (select * from t union all select * from t) u",
    ]
    for text in texts:
        plan = port.sql(text).physical_plan()
        read = sorted({f.name for sc in _scanned(plan) for f in sc.output})
        assert set(read) < {"a", "s", "b", "c", "x", "v"}, (text, read)
        got = sorted(map(str, plan.execute_collect().to_pylist()))
        want = sorted(map(str, ref.sql(text).collect().to_pylist()))
        assert got == want
    plan = port.sql(texts[0]).physical_plan()
    assert sorted(f.name for sc in _scanned(plan)
                  for f in sc.output) == ["a", "v"]


def test_dataframe_rollup_union_distinct_match_the_reference(tmp_path):
    paths = _write(tmp_path, "t", [_table(21, 80), _table(22, 50)])
    port, ref = _sessions()
    out = []
    for s, fns in ((port, F), (ref, RF)):
        df = s.read_parquet(paths)
        rolled = df.rollup("a", "s").agg(fns.sum(fns.col("v")).alias("t"),
                                         fns.count().alias("n"))
        unioned = df.select(fns.col("a"), fns.col("s")).union(
            df.select(fns.col("a"), fns.col("s")))
        distinct = unioned.distinct()
        out.append([sorted(map(str, d.collect().to_pylist()))
                    for d in (rolled, unioned, distinct)])
    assert out[0] == out[1]
    rolled, unioned, distinct = out[0]
    assert len(unioned) == 2 * 130
    assert len(distinct) < len(unioned)
    # the grand total row: both keys null
    assert any("'a': None, 's': None" in r for r in rolled)


def test_dataframe_rollup_refuses_an_expression_key(tmp_path):
    path = _write(tmp_path, "t", [_table(3, 10)])
    df = TorchSession(device="cpu").read_parquet(path)
    with pytest.raises(ValueError):
        df.rollup(F.col("a") + F.lit(1))
