"""Conditional expressions and keyless aggregates of the PyTorch port on the
CPU, held against the JAX package.

``If``, ``CaseWhen`` (with and without ELSE, several branches, null and
false predicates) and ``Least``/``Greatest`` (nulls skipped, NaN greatest)
over the same numpy columns with nulls through both packages' expressions;
string branches from two dictionaries decoded to the same strings; the
refusals at planning. Keyless aggregates (``df.agg``) through
``TorchSession`` and ``TpuSession`` over one partition, several partitions
and empty input (one row: count 0, the sums null), and the plan they take.

Tolerance: none. Every branch is a selection, so values and validity are
compared exactly, and the keyless sums are held exactly (one partition's
rows in one order) or within rel 1e-12 where the partitions' partial sums
merge.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.expr import conditional as RCd
from spark_rapids_tpu.expr import core as RE
from spark_rapids_tpu.expr import predicates as RP
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.exec.sort import _GatherAllExec
from spark_rapids_tpu_torch.expr import conditional as Cd
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.session import TorchSession

CAP = 64
N = 60
_REF = {T.INT: RT.INT, T.LONG: RT.LONG, T.DOUBLE: RT.DOUBLE,
        T.BOOLEAN: RT.BOOLEAN, T.STRING: RT.STRING}


def _ref_type(t):
    if isinstance(t, T.DecimalType):
        return RT.DecimalType(t.precision, t.scale)
    return _REF[t]


def _col(values, valid, t, dictionary=None):
    vals = np.zeros(CAP, values.dtype)
    vals[:len(values)] = values
    m = np.zeros(CAP, bool)
    m[:len(valid)] = valid
    vals[~m] = 0
    return (E.Col(torch.from_numpy(vals), torch.from_numpy(m), t, dictionary),
            RE.Col(jnp.asarray(vals), jnp.asarray(m), _ref_type(t),
                   dictionary))


@pytest.fixture
def cols():
    """0: bool predicate, 1: bool predicate, 2: int, 3: long, 4: double
    (with NaN), 5: decimal(7,2), 6: string (dict A), 7: string (dict B);
    every column with nulls."""
    rng = np.random.default_rng(17)

    def valid():
        return rng.random(N) < 0.8
    dbl = rng.normal(0, 100, N)
    dbl[::9] = np.nan
    dict_a = pa.array(["apple", "kiwi", "pear"])
    dict_b = pa.array(["fig", "kiwi", "plum", "zucchini"])
    return [_col(rng.random(N) < 0.5, valid(), T.BOOLEAN),
            _col(rng.random(N) < 0.5, valid(), T.BOOLEAN),
            _col(rng.integers(-50, 50, N).astype(np.int32), valid(), T.INT),
            _col(rng.integers(-10**12, 10**12, N), valid(), T.LONG),
            _col(dbl, valid(), T.DOUBLE),
            _col(rng.integers(-10**6, 10**6, N), valid(),
                 T.DecimalType(7, 2)),
            _col(rng.integers(0, 3, N).astype(np.int32), valid(), T.STRING,
                 dict_a),
            _col(rng.integers(0, 4, N).astype(np.int32), valid(), T.STRING,
                 dict_b)]


def _refs(idx, cols):
    return (E.BoundReference(idx, cols[idx][0].dtype),
            RE.BoundReference(idx, cols[idx][1].dtype))


def _eval(pe, re_, cols):
    pc = pe.eval(E.EvalContext([c[0] for c in cols], N, CAP, "cpu"))
    rc = re_.eval(RE.EvalContext([c[1] for c in cols], N, CAP))
    return pc, rc


def _values(c, is_port: bool):
    vals = c.values.numpy() if is_port else np.asarray(c.values)
    valid = c.validity.numpy() if is_port else np.asarray(c.validity)
    if c.dictionary is not None and isinstance(
            c.dtype, (T.StringType, RT.StringType)):
        d = c.dictionary.to_pylist()
        return [d[int(v)] if ok else None for v, ok in zip(vals, valid)]
    return [(v.item() if not (isinstance(v, float) and np.isnan(v))
             else "nan") if ok else None
            for v, ok in zip(vals[:CAP], valid[:CAP])]


def _assert_same(pc, rc):
    assert _ref_type(pc.dtype) == rc.dtype
    assert _values(pc, True) == _values(rc, False)


# (then, else) column pairs: equal types, int/long and int/double promotion,
# decimals, and strings from two dictionaries
BRANCHES = [(2, 2), (2, 3), (2, 4), (3, 4), (5, 5), (5, 2), (6, 7), (6, 6)]


@pytest.mark.parametrize("a,b", BRANCHES)
def test_if_matches_reference(cols, a, b):
    (pp, rp), (pa_, ra), (pb, rb) = _refs(0, cols), _refs(a, cols), \
        _refs(b, cols)
    pc, rc = _eval(Cd.If(pp, pa_, pb), RCd.If(rp, ra, rb), cols)
    _assert_same(pc, rc)


@pytest.mark.parametrize("with_else", [True, False])
@pytest.mark.parametrize("a,b", BRANCHES)
def test_case_when_matches_reference(cols, a, b, with_else):
    """Two WHEN branches (a null or false predicate falls through), with an
    ELSE or without one (null)."""
    (p0, r0), (p1, r1) = _refs(0, cols), _refs(1, cols)
    (pa_, ra), (pb, rb) = _refs(a, cols), _refs(b, cols)
    pe = Cd.CaseWhen([(p0, pa_), (p1, pb)], pa_ if with_else else None)
    re_ = RCd.CaseWhen([(r0, ra), (r1, rb)], ra if with_else else None)
    pc, rc = _eval(pe, re_, cols)
    _assert_same(pc, rc)


def test_when_chain_and_literals(cols):
    """F.when(...).when(...).otherwise(...) with literal values, as the
    reference's functions chain it."""
    (pi, ri) = _refs(2, cols)
    pe = (F.when(P.LessThan(pi, E.Literal(-10)), -1)
          .when(P.GreaterThan(pi, E.Literal(10)), 1).otherwise(0))
    re_ = (JF.when(RP.LessThan(ri, RE.Literal(-10)), -1)
           .when(RP.GreaterThan(ri, RE.Literal(10)), 1).otherwise(0))
    pc, rc = _eval(pe, re_, cols)
    _assert_same(pc, rc)
    pc, rc = _eval(F.if_(P.EqualTo(pi, E.Literal(0)), "zero", "other"),
                   JF.if_(RP.EqualTo(ri, RE.Literal(0)), "zero", "other"),
                   cols)
    _assert_same(pc, rc)


@pytest.mark.parametrize("fn", ["Least", "Greatest"])
@pytest.mark.parametrize("idx", [(2, 3), (2, 4, 3), (4, 4), (5, 2)])
def test_least_greatest_match_reference(cols, fn, idx):
    refs = [_refs(i, cols) for i in idx]
    pe = getattr(Cd, fn)(*[p for p, _ in refs])
    re_ = getattr(RCd, fn)(*[r for _, r in refs])
    pc, rc = _eval(pe, re_, cols)
    _assert_same(pc, rc)


@pytest.fixture
def table_path(tmp_path):
    rng = np.random.default_rng(23)
    n = 500
    x = rng.normal(0, 10, n)
    x[::17] = np.nan
    t = pa.table({
        "k": pa.array(rng.choice(["a", "b", "c"], n)),
        "s": pa.array([None if i % 11 == 0 else v for i, v in
                       enumerate(rng.choice(["x", "yy", "zzz"], n))]),
        "n": pa.array(rng.integers(0, 7, n), pa.int32()),
        "x": pa.array([None if i % 13 == 0 else v for i, v in enumerate(x)],
                      pa.float64())})
    paths = []
    for i in range(3):
        p = str(tmp_path / f"part-{i}.parquet")
        pq.write_table(t.slice(i * 200, 200), p)
        paths.append(p)
    return paths


def _rows(tbl):
    return [tuple("nan" if isinstance(v, float) and v != v else v
                  for v in r.values()) for r in tbl.to_pylist()]


def test_conditionals_through_the_session(table_path):
    """q43's shape: seven-way conditional sums in one dense aggregate, and
    CASE WHEN over two string columns in a projection, against TpuSession."""
    spark, ref = TorchSession(device="cpu"), TpuSession()
    df = spark.read_parquet(table_path[0])
    rdf = ref.read_parquet(table_path[0])
    got = (df.group_by("k").agg(*[
        F.sum(F.when(F.col("n") == F.lit(i), F.col("x"))).alias(f"d{i}")
        for i in range(7)]).sort("k").collect())
    want = (rdf.group_by("k").agg(*[
        JF.sum(JF.when(JF.col("n") == JF.lit(i), JF.col("x"))).alias(f"d{i}")
        for i in range(7)]).sort("k").collect())
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w) == 3
    for a, b in zip(g, w):
        assert a[0] == b[0]
        assert a[1:] == pytest.approx(b[1:], rel=1e-12, nan_ok=True)
    got = df.select(F.when(F.col("n") > F.lit(3), F.col("k"))
                    .otherwise(F.col("s")).alias("v"),
                    Cd.Greatest(F.col("n"), F.lit(2)).alias("g")).collect()
    want = rdf.select(JF.when(JF.col("n") > JF.lit(3), JF.col("k"))
                      .otherwise(JF.col("s")).alias("v"),
                      JF.greatest(JF.col("n"), JF.lit(2)).alias("g")
                      ).collect()
    assert _rows(got) == _rows(want)


def test_refused_conditionals_raise_at_planning(table_path):
    df = TorchSession(device="cpu").read_parquet(table_path[0])
    for bad in (Cd.Least(F.col("k"), F.col("s")),                # strings
                F.when(F.col("n") > F.lit(1), F.col("k")).otherwise(
                    F.col("n")),                                 # str / int
                F.if_(F.col("n"), F.col("x"), F.col("x"))):      # int pred
        with pytest.raises(NotImplementedError):
            df.select(bad.alias("v")).physical_plan()


def _keyless(F_, df):
    return df.agg(F_.count().alias("rows"), F_.count(F_.col("x")).alias("c"),
                  F_.sum(F_.col("x")).alias("sx"),
                  F_.sum(F_.col("n")).alias("sn"),
                  F_.avg(F_.col("n")).alias("an"),
                  F_.min(F_.col("n")).alias("mn"),
                  F_.max(F_.col("k")).alias("mk"))


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("empty", [False, True])
def test_keyless_aggregate_matches_reference(table_path, parts, empty):
    """df.agg over one partition and over three (gathered into one), and
    over input that a filter empties: one row (count 0, the rest null)."""
    spark, ref = TorchSession(device="cpu"), TpuSession()
    df = spark.read_parquet(table_path[:parts])
    rdf = ref.read_parquet(table_path[:parts])
    if empty:
        df = df.filter(F.col("n") > F.lit(100))
        rdf = rdf.filter(JF.col("n") > JF.lit(100))
    out = _keyless(F, df)
    plan = out.physical_plan()
    agg = plan if isinstance(plan, XA.HashAggregateExec) else \
        plan.children[0]
    assert isinstance(agg, XA.HashAggregateExec) and agg.mode == XA.COMPLETE
    assert isinstance(agg.children[0], _GatherAllExec) == (parts > 1)
    got = _rows(plan.execute_collect())
    want = _rows(_keyless(JF, rdf).collect())
    assert len(got) == len(want) == 1
    if empty:
        assert got == [(0, 0, None, None, None, None, None)]
    assert got[0][:2] == want[0][:2] and got[0][3:] == want[0][3:]
    assert got[0][2] == pytest.approx(want[0][2], rel=1e-12, nan_ok=True)


def test_keyless_aggregate_over_an_empty_file(tmp_path):
    path = str(tmp_path / "empty.parquet")
    pq.write_table(pa.table({"x": pa.array([], pa.float64()),
                             "k": pa.array([], pa.string())}), path)
    got = (TorchSession(device="cpu").read_parquet(path)
           .agg(F.count().alias("c"), F.sum(F.col("x")).alias("s"),
                F.max(F.col("k")).alias("m")).collect().to_pylist())
    want = (TpuSession().read_parquet(path)
            .agg(JF.count().alias("c"), JF.sum(JF.col("x")).alias("s"),
                 JF.max(JF.col("k")).alias("m")).collect().to_pylist())
    assert got == want == [{"c": 0, "s": None, "m": None}]
