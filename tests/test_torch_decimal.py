"""Decimals in the PyTorch port on the CPU, held against the JAX package.

The same numpy inputs go through the port and the reference: the arrow
round trip (arrow → device → arrow) at precisions 7..18 with nulls and
negatives, the decimal casts, ``promote`` and the multiply typing, Add,
Subtract and Multiply, comparisons of a decimal column with int and double
literals (TPC-DS q48's ``profit >= lit(0)``), and the decimal ``Sum`` and
``Average`` (``decimal(18, s + 4)``, HALF_UP on the magnitude) evaluated from
the same states, negative means at the HALF_UP midpoint included; ``Divide``
(double, integer and decimal operands, zero divisors) and ``Abs``.

Tolerance: none. Decimals are scaled int64 on both sides, so every value and
validity bit is compared exactly; a decimal cast to double is the same
float64 division on both sides.
"""

from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar import arrow as RA
from spark_rapids_tpu.expr import aggregates as RAG
from spark_rapids_tpu.expr import arithmetic as RAR
from spark_rapids_tpu.expr import cast as RC
from spark_rapids_tpu.expr import core as RE
from spark_rapids_tpu.expr import predicates as RP
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import arrow as PA
from spark_rapids_tpu_torch.expr import aggregates as AG
from spark_rapids_tpu_torch.expr import arithmetic as AR
from spark_rapids_tpu_torch.expr import cast as C
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.session import TorchSession

CAP = 64


def _ref_type(t):
    if isinstance(t, T.DecimalType):
        return RT.DecimalType(t.precision, t.scale)
    return {T.INT: RT.INT, T.LONG: RT.LONG, T.DOUBLE: RT.DOUBLE,
            T.BOOLEAN: RT.BOOLEAN}[t]


def _unscaled(rng, p: int, n: int) -> np.ndarray:
    """n unscaled values of precision p, both signs, the bounds included."""
    top = 10 ** p - 1
    v = rng.integers(-top, top + 1, n, dtype=np.int64)
    v[:4] = [top, -top, 0, -1]
    return v


def _cols(values: np.ndarray, valid: np.ndarray, t):
    """The same column as a port Col and a reference Col, padded to CAP."""
    n = len(values)
    vals = np.zeros(CAP, values.dtype)
    vals[:n] = values
    m = np.zeros(CAP, bool)
    m[:n] = valid
    vals[~m] = 0
    return (E.Col(torch.from_numpy(vals), torch.from_numpy(m), t),
            RE.Col(jnp.asarray(vals), jnp.asarray(m), _ref_type(t)))


def _eval_both(port_expr, ref_expr, cols):
    pc = port_expr.eval(E.EvalContext([c[0] for c in cols], CAP, CAP, "cpu"))
    rc = ref_expr.eval(RE.EvalContext([c[1] for c in cols], CAP, CAP))
    return pc, rc


def _assert_same(pc, rc):
    pv, pm = pc.values.numpy(), pc.validity.numpy()
    rv, rm = np.asarray(rc.values), np.asarray(rc.validity)
    assert _ref_type(pc.dtype) == rc.dtype
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_array_equal(np.where(pm, pv, 0), np.where(rm, rv, 0))


@pytest.mark.parametrize("p,s", [(7, 2), (9, 0), (12, 4), (15, 7), (18, 2),
                                 (18, 18)])
def test_arrow_round_trip(p, s):
    """arrow → device → arrow with nulls and negatives: the same decimals
    back, and the same scaled int64 on the device as the reference's."""
    rng = np.random.default_rng(p * 100 + s)
    v = _unscaled(rng, p, 200)
    valid = rng.random(200) < 0.8
    arr = pa.array([Decimal(int(x)).scaleb(-s) if ok else None
                    for x, ok in zip(v, valid)], pa.decimal128(p, s))
    arr = arr.slice(3)   # an offset into the buffers
    cv = PA.array_to_device(arr, None, 256, "cpu")
    assert cv.dtype == T.DecimalType(p, s)
    ref = RA.array_to_device(arr, None, 256)
    np.testing.assert_array_equal(cv.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(cv.validity.numpy(),
                                  np.asarray(ref.validity))
    back = cv.to_arrow(len(arr))
    assert back.type == pa.decimal128(p, s)
    assert back.to_pylist() == arr.to_pylist()
    assert back.equals(ref.to_arrow(len(arr)))


def test_empty_and_all_null_round_trip():
    for arr in (pa.array([], pa.decimal128(7, 2)),
                pa.array([None, None], pa.decimal128(7, 2))):
        cv = PA.array_to_device(arr, None, 8, "cpu")
        assert cv.to_arrow(len(arr)).to_pylist() == arr.to_pylist()


def test_precision_above_18_refused():
    with pytest.raises(NotImplementedError):
        T.from_arrow_type(pa.decimal128(19, 2))


def test_parquet_scan_round_trip(tmp_path):
    """A decimal column read by the scan (FIXED_LEN_BYTE_ARRAY chunks: the
    arrow route) and collected back."""
    rng = np.random.default_rng(3)
    v = _unscaled(rng, 7, 1000)
    arr = pa.array([None if i % 7 == 0 else Decimal(int(x)).scaleb(-2)
                    for i, x in enumerate(v)], pa.decimal128(7, 2))
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"m": arr}), path)
    from spark_rapids_tpu_torch.io import parquet_native as PN
    PN.reset_routes()
    got = TorchSession(device="cpu").read_parquet(path).collect()
    assert got.column("m").to_pylist() == arr.to_pylist()
    assert PN.routes["arrow"] == 1 and PN.routes["python"] == 0


CASTS = [
    (T.DecimalType(7, 2), T.DecimalType(9, 4)),     # scale up
    (T.DecimalType(9, 4), T.DecimalType(7, 2)),     # HALF_UP down
    (T.DecimalType(9, 4), T.DecimalType(5, 1)),     # overflow -> null
    (T.DecimalType(12, 3), T.DecimalType(12, 0)),
    (T.DecimalType(7, 2), T.INT),
    (T.DecimalType(18, 2), T.INT),                  # out of int range
    (T.DecimalType(15, 3), T.LONG),
    (T.DecimalType(7, 2), T.DOUBLE),
    (T.DecimalType(18, 9), T.DOUBLE),
    (T.INT, T.DecimalType(7, 2)),                   # overflow -> null
    (T.INT, T.DecimalType(12, 2)),
    (T.LONG, T.DecimalType(18, 0)),
    (T.DOUBLE, T.DecimalType(7, 2)),                # HALF_UP, NaN null
    (T.DOUBLE, T.DecimalType(18, 6)),
]


def _inputs(t, rng, n=CAP - 4):
    if isinstance(t, T.DecimalType):
        return _unscaled(rng, t.precision, n)
    if t == T.INT:
        v = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        v[:6] = [0, -1, 99_999, -100_000, 2**31 - 1, -2**31]
        return v
    if t == T.LONG:
        v = rng.integers(-10**17, 10**17, n, dtype=np.int64)
        v[:3] = [0, -1, 10**17]
        return v
    v = rng.normal(0, 1e5, n)
    v[:8] = [0.125, -0.125, 0.005, -0.005, 2.675, np.nan, -0.0, 1e30]
    return v


@pytest.mark.parametrize("frm,to", CASTS, ids=[f"{a}->{b}" for a, b in CASTS])
def test_decimal_casts_match_reference(frm, to):
    rng = np.random.default_rng(len(repr(frm)) * 31 + len(repr(to)))
    v = _inputs(frm, rng)
    valid = rng.random(len(v)) < 0.9
    cols = [_cols(v, valid, frm)]
    assert C.supported_cast(frm, to)
    pc, rc = _eval_both(C.Cast(E.BoundReference(0, frm), to),
                        RC.Cast(RE.BoundReference(0, _ref_type(frm)),
                                _ref_type(to)), cols)
    assert pc.dtype == to
    _assert_same(pc, rc)


def test_supported_cast_admits_exactly_the_decimal_casts():
    """The decimal casts: with the numbers, and (since the expression
    slice ported the cast matrix) with strings and booleans; never with a
    date, as in Spark."""
    d = T.DecimalType(7, 2)
    for other in (T.INT, T.LONG, T.DOUBLE, T.DecimalType(9, 4), T.BYTE,
                  T.SHORT, T.FLOAT, T.STRING, T.BOOLEAN):
        assert C.supported_cast(d, other) and C.supported_cast(other, d)
    for other in (T.DATE, T.TIMESTAMP):
        assert not C.supported_cast(d, other)
        assert not C.supported_cast(other, d)


PAIRS = [(T.DecimalType(7, 2), T.DecimalType(7, 2)),
         (T.DecimalType(7, 2), T.DecimalType(9, 4)),
         (T.DecimalType(12, 1), T.DecimalType(5, 3)),
         (T.DecimalType(18, 2), T.DecimalType(18, 10)),
         (T.DecimalType(7, 2), T.INT), (T.LONG, T.DecimalType(9, 3)),
         (T.DecimalType(7, 2), T.DOUBLE)]


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a},{b}" for a, b in PAIRS])
def test_promote_and_multiply_typing_match_reference(a, b):
    got = AR.promote(a, b)
    assert _ref_type(got) == RAR.promote(_ref_type(a), _ref_type(b))
    mt = AR.decimal_mul_type(a, b)
    rmt = RAR.decimal_mul_type(_ref_type(a), _ref_type(b))
    assert (mt is None and rmt is None) or _ref_type(mt) == rmt


ARITH = [(T.DecimalType(7, 2), T.DecimalType(7, 2)),      # exact multiply
         (T.DecimalType(7, 2), T.DecimalType(9, 4)),
         (T.DecimalType(9, 3), T.INT),
         (T.DecimalType(12, 6), T.DecimalType(12, 6)),    # float multiply
         (T.DecimalType(18, 2), T.DecimalType(7, 2))]


@pytest.mark.parametrize("op", ["Add", "Subtract", "Multiply"])
@pytest.mark.parametrize("a,b", ARITH, ids=[f"{a},{b}" for a, b in ARITH])
def test_decimal_arithmetic_matches_reference(op, a, b):
    rng = np.random.default_rng(7)
    va, vb = _inputs(a, rng), _inputs(b, rng)
    if b == T.INT:
        vb = rng.integers(-10**4, 10**4, len(vb)).astype(np.int32)
    cols = [_cols(va, rng.random(len(va)) < 0.9, a),
            _cols(vb, rng.random(len(vb)) < 0.9, b)]
    pe = getattr(AR, op)(E.BoundReference(0, a), E.BoundReference(1, b))
    re_ = getattr(RAR, op)(RE.BoundReference(0, _ref_type(a)),
                           RE.BoundReference(1, _ref_type(b)))
    pc, rc = _eval_both(pe, re_, cols)
    assert _ref_type(pc.dtype) == rc.dtype
    _assert_same(pc, rc)


DIVIDE = [(T.DOUBLE, T.DOUBLE), (T.INT, T.INT), (T.LONG, T.DOUBLE),
          (T.INT, T.LONG), (T.DecimalType(7, 2), T.DecimalType(7, 2)),
          (T.DecimalType(7, 2), T.INT), (T.LONG, T.DecimalType(9, 3)),
          (T.DecimalType(12, 1), T.DecimalType(5, 3)),
          (T.DecimalType(18, 2), T.DecimalType(18, 10)),
          (T.DecimalType(7, 2), T.DOUBLE)]


def _with_zeros(v, rng):
    """Values with zero divisors (and, for doubles, -0.0 and NaN)."""
    v = v.copy()
    v[rng.random(len(v)) < 0.15] = 0
    if v.dtype == np.float64:
        v[1:3] = [-0.0, np.nan]
    return v


@pytest.mark.parametrize("a,b", DIVIDE, ids=[f"{a},{b}" for a, b in DIVIDE])
def test_divide_matches_reference(a, b):
    """Divide: a double for non-decimal operands, the decimal quotient
    HALF_UP at ``decimal_div_type``'s scale, and null on a zero divisor
    (doubles included); the typing, every value and every validity bit as
    the reference's."""
    rng = np.random.default_rng(len(repr(a)) * 13 + len(repr(b)))
    va, vb = _inputs(a, rng), _with_zeros(_inputs(b, rng), rng)
    if b == T.INT:
        vb = _with_zeros(rng.integers(-10**4, 10**4, len(vb))
                         .astype(np.int32), rng)
    cols = [_cols(va, rng.random(len(va)) < 0.9, a),
            _cols(vb, rng.random(len(vb)) < 0.9, b)]
    dt = AR.decimal_div_type(a, b)
    rdt = RAR.decimal_div_type(_ref_type(a), _ref_type(b))
    assert (dt is None and rdt is None) or _ref_type(dt) == rdt
    pe = AR.Divide(E.BoundReference(0, a), E.BoundReference(1, b))
    re_ = RAR.Divide(RE.BoundReference(0, _ref_type(a)),
                     RE.BoundReference(1, _ref_type(b)))
    pc, rc = _eval_both(pe, re_, cols)
    assert pc.dtype == (dt if dt is not None else T.DOUBLE)
    _assert_same(pc, rc)
    zero = cols[1][0].values.numpy() == 0
    assert not pc.validity.numpy()[zero].any()


@pytest.mark.parametrize("t", [T.INT, T.LONG, T.DOUBLE, T.DecimalType(7, 2),
                               T.DecimalType(18, 4)], ids=str)
def test_abs_matches_reference(t):
    """abs keeps its type; int minimum wraps to itself on both sides."""
    rng = np.random.default_rng(len(repr(t)))
    v = _inputs(t, rng)
    cols = [_cols(v, rng.random(len(v)) < 0.9, t)]
    pc, rc = _eval_both(AR.Abs(E.BoundReference(0, t)),
                        RAR.Abs(RE.BoundReference(0, _ref_type(t))), cols)
    assert pc.dtype == t
    _assert_same(pc, rc)


def test_divide_and_abs_operator_sugar():
    """``/`` and ``F.abs`` build the ported expressions, a number on the left
    of ``/`` included; unary minus builds ``UnaryMinus`` (ported since)."""
    x = F.col("x")
    assert isinstance(x / 2.0, AR.Divide)
    r = 2.0 / x
    assert isinstance(r, AR.Divide) and isinstance(r.left, E.Literal)
    assert isinstance(F.abs("x"), AR.Abs)
    neg = -(x / 2.0)
    assert isinstance(neg, AR.UnaryMinus)
    assert isinstance(neg.children[0], AR.Divide)
    assert isinstance(-x, AR.UnaryMinus)


LITS = [0, 2000, 25000, 150, -7, 1.5, 2.675, 12345.675]


@pytest.mark.parametrize("cmp", ["GreaterThanOrEqual", "LessThanOrEqual",
                                 "EqualTo", "LessThan"])
@pytest.mark.parametrize("lit", LITS)
def test_comparison_with_literal_matches_reference(cmp, lit):
    """q48's profit bands: a decimal(7,2) column against an int literal
    (promoted to the decimal) or a double one (both to double)."""
    t = T.DecimalType(7, 2)
    rng = np.random.default_rng(11)
    v = _unscaled(rng, 7, CAP - 4)
    v[4:12] = [0, 200_000, 2_500_000, 15_000, -700, 150, 268, 1_234_568]
    cols = [_cols(v, rng.random(len(v)) < 0.9, t)]
    pe = getattr(P, cmp)(E.BoundReference(0, t), E.Literal(lit))
    re_ = getattr(RP, cmp)(RE.BoundReference(0, _ref_type(t)),
                           RE.Literal(lit))
    pc, rc = _eval_both(pe, re_, cols)
    np.testing.assert_array_equal(pc.validity.numpy(), np.asarray(rc.validity))
    np.testing.assert_array_equal(pc.values.numpy(), np.asarray(rc.values))


def test_decimal_literal_scales_like_reference():
    t = T.DecimalType(9, 3)
    for v in (1.5, "2.675", 7):
        pc = E.Literal(v, t).eval(E.EvalContext([], 8, 8, "cpu"))
        rc = RE.Literal(v, _ref_type(t)).eval(RE.EvalContext([], 8, 8))
        np.testing.assert_array_equal(pc.values.numpy(), np.asarray(rc.values))


def _segctx_of(cap: int, n: int):
    from spark_rapids_tpu.ops import grouping as RG
    from spark_rapids_tpu_torch.ops import grouping as G
    idx = np.arange(cap)
    seg = np.where(idx < n, idx * 4 // max(n, 1), cap - 1).astype(np.int32)
    return (G.segment_structure(torch.from_numpy(seg), cap),
            RG.segment_structure(jnp.asarray(seg), cap))


@pytest.mark.parametrize("p,s", [(7, 2), (12, 4), (18, 0), (5, 5)])
def test_decimal_sum_and_average_bit_for_bit(p, s):
    """update over four segments, then evaluate: Sum is
    decimal(min(p + 10, 18), s) and Average decimal(18, s + 4) on both
    sides, every value and null equal."""
    t = T.DecimalType(p, s)
    rng = np.random.default_rng(p + s)
    n = CAP - 5
    v = _unscaled(rng, p, n)
    valid = rng.random(n) < 0.85
    valid[n // 4: n // 4 + 20] = False      # one segment all null
    pcol, rcol = _cols(v, valid, t)
    pseg, rseg = _segctx_of(CAP, n)
    for pf, rf in ((AG.Sum(E.BoundReference(0, t)),
                    RAG.Sum(RE.BoundReference(0, _ref_type(t)))),
                   (AG.Average(E.BoundReference(0, t)),
                    RAG.Average(RE.BoundReference(0, _ref_type(t))))):
        assert _ref_type(pf.dtype) == rf.dtype
        pst = pf.update(pcol, pseg)
        rst = rf.update(rcol, rseg)
        for a, b in zip(pst, rst):
            _assert_same(a, b)
        _assert_same(pf.evaluate(pst), rf.evaluate(rst))


@pytest.mark.parametrize("scale", [0, 2, 6])
def test_average_half_up_at_midpoints(scale):
    """Average.evaluate from given (sum, count) states: negative and positive
    means exactly at the HALF_UP midpoint, one below and above it, zero
    counts (null), and sums near the int64 range after the rescale."""
    t = T.DecimalType(18 if scale == 6 else 9, scale)
    sums = np.array([-1, 1, -3, 3, -5, 5, -10**9 - 1, 10**9 + 1, 0, -7,
                     -9_223_372_036_854, 9_223_372_036_854, 12_345, -12_345],
                    np.int64)
    counts = np.array([20_000, 20_000, 20_000, 20_000, 2, 2, 2_000, 2_000, 0,
                       4, 7, 7, 40_000, 40_000], np.int64)
    sum_t = T.DecimalType(min(t.precision + 10, 18), scale)
    ps, rs = _cols(sums, counts > 0, sum_t)
    pc, rc = _cols(counts, np.ones(len(counts), bool), T.LONG)
    got = AG.Average(E.BoundReference(0, t)).evaluate([ps, pc])
    want = RAG.Average(RE.BoundReference(0, _ref_type(t))).evaluate([rs, rc])
    _assert_same(got, want)
    # -1e-scale / 20000 * 1e4 = -0.5 units: HALF_UP away from zero
    assert int(got.values[0]) == -1 and int(got.values[1]) == 1
    assert not bool(got.validity[8])


def test_sum_and_avg_of_decimal_through_the_session(tmp_path):
    """A grouped and a keyless sum and avg of a decimal column through
    TorchSession: exact decimals of the reference's result types."""
    from spark_rapids_tpu.session import TpuSession
    import spark_rapids_tpu.functions as JF
    rng = np.random.default_rng(5)
    n = 3000
    v = _unscaled(rng, 7, n)
    t = pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                  "m": pa.array([None if i % 11 == 0 else
                                 Decimal(int(x)).scaleb(-2)
                                 for i, x in enumerate(v)],
                                pa.decimal128(7, 2))})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path)
    spark, ref = TorchSession(device="cpu"), TpuSession()
    got = (spark.read_parquet(path).group_by("k")
           .agg(F.sum(F.col("m")).alias("s"), F.avg(F.col("m")).alias("a"))
           .sort("k").collect())
    want = (ref.read_parquet(path).group_by("k")
            .agg(JF.sum(JF.col("m")).alias("s"),
                 JF.avg(JF.col("m")).alias("a")).sort("k").collect())
    assert got.schema.field("s").type == pa.decimal128(17, 2)
    assert got.schema.field("a").type == pa.decimal128(18, 6)
    assert got.to_pylist() == want.to_pylist()
    got = spark.read_parquet(path).agg(F.sum(F.col("m")).alias("s"),
                                       F.avg(F.col("m")).alias("a"))
    want = ref.read_parquet(path).agg(JF.sum(JF.col("m")).alias("s"),
                                      JF.avg(JF.col("m")).alias("a"))
    assert got.collect().to_pylist() == want.collect().to_pylist()


def test_decimal_sort_key(tmp_path):
    """A decimal sort key orders by value (q79 sorts by its profit sum)."""
    rng = np.random.default_rng(9)
    v = _unscaled(rng, 7, 500)
    arr = pa.array([None if i % 13 == 0 else Decimal(int(x)).scaleb(-2)
                    for i, x in enumerate(v)], pa.decimal128(7, 2))
    path = str(tmp_path / "s.parquet")
    pq.write_table(pa.table({"m": arr}), path)
    df = TorchSession(device="cpu").read_parquet(path)
    up = df.sort("m").collect().column("m").to_pylist()
    down = df.sort("m", ascending=False).collect().column("m").to_pylist()
    vals = sorted(x for x in arr.to_pylist() if x is not None)
    nulls = [None] * arr.null_count
    assert up == nulls + vals          # nulls first when ascending
    assert down == vals[::-1] + nulls  # last when descending
