"""The math, arithmetic, cast, datetime, decimal and hash expressions of the
PyTorch port on the CPU, held against the JAX package.

The small ``qa`` table of ``tests/test_torch_sweep.py`` (every scalar type,
10 % nulls, numpy-seeded) goes through ``TorchSession(device="cpu")`` and
``TpuSession``; each case builds the same expression in both packages
(``functions.py`` where the reference has the function, else the class of
the same name) and the collected columns must be equal: integers, strings,
booleans, dates and timestamps exactly, doubles and floats within 1e-12
relative (the two packages' math libraries may differ by an ulp; NaN equals
NaN).

Then the places where the reference differs from Spark, each with the
reference's answer beside the port's (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import arithmetic as JA
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.expr import datetime as JDT
from spark_rapids_tpu.expr import decimalexprs as JDX
from spark_rapids_tpu.expr import mathexprs as JM
from spark_rapids_tpu.expr import predicates as JP
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import datetime as DT
from spark_rapids_tpu_torch.expr import decimalexprs as DX
from spark_rapids_tpu_torch.expr import mathexprs as M
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr.cast import supported_cast
from spark_rapids_tpu_torch.session import TorchSession

from test_torch_sweep import qa_table  # noqa: E402  (tests/ is on sys.path)

REL = 1e-12


class _Pkg:
    """One package's modules under common names."""

    def __init__(self, f, e, a, m, dt, dx, p, t):
        self.f, self.e, self.a, self.m = f, e, a, m
        self.dt, self.dx, self.p, self.t = dt, dx, p, t

    def c(self, name):
        return self.e.col(name)

    def lit(self, v, dt=None):
        return self.e.Literal(v, dt)


PORT = _Pkg(F, E, A, M, DT, DX, P, T)
REF = _Pkg(JF, JE, JA, JM, JDT, JDX, JP, JT)


@pytest.fixture(scope="module")
def frames():
    """The port over two partitions; the reference over one: its fused
    projection races when two partitions' threads trace an untraceable
    expression (a cast to string) at once — one latches the key's
    "eager" sentinel, the other calls it (``runtime/fuse.call_fused``:
    ``'str' object is not callable``). One partition gives the same rows
    in the same order."""
    t = qa_table(3000, seed=21)
    return (TorchSession(device="cpu").create_dataframe(t, 2),
            TpuSession().create_dataframe(t, 1))


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == pytest.approx(b, rel=REL, abs=1e-300)
    return a == b


# round/bround of a decimal: the port takes Spark's type (decimal(12,2) at
# one digit is decimal(12,1), SPARK-39226), the reference keeps the input's;
# the values are equal as numbers (test_gap_round_of_a_decimal_has_sparks_type)
SPARK_TYPED = {"round decimal 1": (pa.decimal128(12, 1),
                                   pa.decimal128(12, 2)),
               "bround decimal 1": (pa.decimal128(12, 1),
                                    pa.decimal128(12, 2))}


def _check(frames, build, types=None):
    port_df, ref_df = frames
    got = port_df.select(build(PORT).alias("v")).collect()
    exp = ref_df.select(build(REF).alias("v")).collect()
    if types is not None:
        assert (got.schema.field("v").type,
                exp.schema.field("v").type) == types
    else:
        assert got.schema.field("v").type == exp.schema.field("v").type
    g, e = got.column("v").to_pylist(), exp.column("v").to_pylist()
    assert len(g) == len(e)
    bad = [(i, x, y) for i, (x, y) in enumerate(zip(g, e))
           if not _close(x, y)]
    assert not bad, bad[:5]


MATH = {
    "sqrt": lambda k: k.f.sqrt("doubleF"),
    "sqrt float": lambda k: k.f.sqrt("floatF"),
    "exp": lambda k: k.m.Exp(k.f.col("floatF")),
    "log10": lambda k: k.m.Log10(k.c("doubleF")),
    "log of short": lambda k: k.m.Log(k.c("shortF")),
    "log1p": lambda k: k.m.Log1p(k.c("shortF")),
    "log2": lambda k: k.m.Log2(k.c("intF")),
    "logarithm": lambda k: k.m.Logarithm(k.lit(3.0), k.c("doubleF")),
    "pow": lambda k: k.f.pow("floatF", k.lit(2.0)),
    "pow columns": lambda k: k.m.Pow(k.c("byteF"), k.c("floatF")),
    "atan2": lambda k: k.m.Atan2(k.c("shortF"), k.c("intF")),
    "sin": lambda k: k.m.Sin(k.c("doubleF")),
    "cos": lambda k: k.m.Cos(k.c("floatF")),
    "tan": lambda k: k.m.Tan(k.c("floatF")),
    "asin": lambda k: k.m.Asin(k.c("floatF")),
    "acos": lambda k: k.m.Acos(k.c("floatF")),
    "atan": lambda k: k.m.Atan(k.c("doubleF")),
    "sinh": lambda k: k.m.Sinh(k.c("floatF")),
    "cosh": lambda k: k.m.Cosh(k.c("floatF")),
    "tanh": lambda k: k.m.Tanh(k.c("doubleF")),
    "asinh": lambda k: k.m.Asinh(k.c("doubleF")),
    "acosh": lambda k: k.m.Acosh(k.c("doubleF")),
    "atanh": lambda k: k.m.Atanh(k.c("floatF")),
    "expm1": lambda k: k.m.Expm1(k.c("floatF")),
    "cbrt": lambda k: k.m.Cbrt(k.c("shortF")),
    "signum": lambda k: k.m.Signum(k.c("shortF")),
    "degrees": lambda k: k.m.ToDegrees(k.c("floatF")),
    "radians": lambda k: k.m.ToRadians(k.c("doubleF")),
    "rint": lambda k: k.m.Rint(k.c("doubleF")),
    "cot": lambda k: k.m.Cot(k.c("doubleF")),
    "floor double": lambda k: k.f.floor("doubleF"),
    "ceil float": lambda k: k.f.ceil("floatF"),
    "floor int": lambda k: k.f.floor("intF"),
    "round int -2": lambda k: k.f.round("intF", -2),
    "round short -3": lambda k: k.f.round("shortF", -3),
    "round decimal 1": lambda k: k.f.round("decimalF", 1),
    "round double 0": lambda k: k.f.round("doubleF", 0),
    "bround decimal 1": lambda k: k.m.BRound(k.c("decimalF"), 1),
    "bround int -1": lambda k: k.m.BRound(k.c("intF"), -1),
    "bround double 0": lambda k: k.m.BRound(k.c("doubleF"), 0),
    "abs short": lambda k: k.f.abs("shortF"),
}

ARITH = {
    "byte + byte": lambda k: k.c("byteF") + k.c("byteF"),
    "byte * byte wraps": lambda k: k.c("byteF") * k.c("byteF"),
    "short - int": lambda k: k.c("shortF") - k.c("intF"),
    "short * short wraps": lambda k: k.c("shortF") * k.c("shortF"),
    "float + double": lambda k: k.c("floatF") + k.c("doubleF"),
    "float * byte": lambda k: k.c("floatF") * k.c("byteF"),
    "byte / short": lambda k: k.c("byteF") / k.c("shortF"),
    "int % 7": lambda k: k.a.Remainder(k.c("intF"), k.lit(7)),
    "short % byte": lambda k: k.a.Remainder(k.c("shortF"), k.c("byteF")),
    "double % float": lambda k: k.a.Remainder(k.c("doubleF"),
                                             k.c("floatF")),
    "pmod short 7": lambda k: k.f.pmod("shortF", k.lit(7)),
    "pmod int -3": lambda k: k.f.pmod("intF", k.lit(-3)),
    "pmod double": lambda k: k.f.pmod("doubleF", k.lit(7.5)),
    "div": lambda k: k.a.IntegralDivide(k.c("shortF"), k.c("byteF")),
    "div long": lambda k: k.a.IntegralDivide(k.c("longF"), k.lit(-7)),
    "unary minus byte": lambda k: -k.c("byteF"),
    "eqnullsafe": lambda k: k.p.EqualNullSafe(k.c("byteF"), k.lit(5)),
    "eqnullsafe columns": lambda k: k.p.EqualNullSafe(k.c("floatF"),
                                                      k.c("floatF")),
    "bitwise and short": lambda k: k.a.BitwiseAnd(k.c("shortF"),
                                                  k.lit(0xFF, k.t.SHORT)),
}

DATES = {
    "year": lambda k: k.f.year("dateF"),
    "year ts": lambda k: k.f.year("timestampF"),
    "month ts": lambda k: k.f.month("timestampF"),
    "dayofmonth": lambda k: k.f.dayofmonth("dateF"),
    "quarter": lambda k: k.dt.Quarter(k.c("timestampF")),
    "dayofweek": lambda k: k.dt.DayOfWeek(k.c("dateF")),
    "weekday": lambda k: k.dt.WeekDay(k.c("timestampF")),
    "dayofyear": lambda k: k.dt.DayOfYear(k.c("dateF")),
    "hour": lambda k: k.dt.Hour(k.c("timestampF")),
    "minute": lambda k: k.dt.Minute(k.c("timestampF")),
    "second": lambda k: k.dt.Second(k.c("timestampF")),
    "last_day": lambda k: k.dt.LastDay(k.c("dateF")),
    "date_add": lambda k: k.dt.DateAdd(k.c("dateF"), k.c("byteF")),
    "date_sub": lambda k: k.f.date_sub("timestampF", 30),
    "datediff": lambda k: k.dt.DateDiff(k.c("dateF"), k.lit(9000,
                                                            k.t.DATE)),
    "datediff ts": lambda k: k.dt.DateDiff(k.c("timestampF"), k.c("dateF")),
    "add_months": lambda k: k.f.add_months("dateF", 13),
    "months_between dates": lambda k: k.f.months_between("dateF",
                                                         k.lit(9000,
                                                               k.t.DATE)),
    "trunc month": lambda k: k.f.trunc("dateF", "month"),
    "trunc quarter": lambda k: k.f.trunc("timestampF", "quarter"),
    "trunc week": lambda k: k.f.trunc("dateF", "week"),
    "trunc year": lambda k: k.f.trunc("dateF", "year"),
    "unix_timestamp": lambda k: k.f.unix_timestamp("timestampF"),
    "unix_timestamp date": lambda k: k.f.unix_timestamp("dateF"),
    "from_unixtime": lambda k: k.f.from_unixtime("longF", "yyyy-MM-dd HH:mm"),
    "date_format ts": lambda k: k.f.date_format("timestampF",
                                                "yyyy-MM-dd HH:mm:ss"),
    "date_format date": lambda k: k.f.date_format("dateF", "dd/MM/yy EEE"),
    "time_add": lambda k: k.dt.TimeAdd(k.c("timestampF"),
                                       k.lit(3_600_000_000)),
    "unix_timestamp string": lambda k: k.f.unix_timestamp(
        k.f.date_format("timestampF", "yyyy-MM-dd HH:mm:ss")),
}

DECIMALS = {
    "unscaled": lambda k: k.dx.UnscaledValue(k.c("decimalF")),
    "make_decimal": lambda k: k.dx.MakeDecimal(k.c("longF"), 9, 3),
    "check_overflow": lambda k: k.dx.CheckOverflow(k.c("decimalF"),
                                                   k.t.DecimalType(6, 1)),
    "promote_precision": lambda k: k.dx.PromotePrecision(
        k.c("decimalF"), k.t.DecimalType(14, 4)),
}

HASHES = {
    "hash string": lambda k: k.f.hash("nameF"),
    "hash string int": lambda k: k.f.hash("nameF", "intF"),
    "hash byte short long": lambda k: k.f.hash("byteF", "shortF", "longF"),
    "hash float double": lambda k: k.f.hash("floatF", "doubleF"),
    "hash decimal date ts bool": lambda k: k.f.hash(
        "decimalF", "dateF", "timestampF", "booleanF"),
    "pmod hash": lambda k: k.f.pmod(k.f.hash("nameF", "intF"), k.lit(8)),
}


# cases the reference cannot run (it plans them on its host path, which
# lacks them or overflows on a timestamp's microseconds): the port is held
# to Python's math and datetime over the same columns instead
ORACLES = {
    "atan2": (("shortF", "intF"), math.atan2),
    "cbrt": (("shortF",), lambda x: math.copysign(abs(x) ** (1 / 3), x)),
    "signum": (("shortF",), lambda x: float((x > 0) - (x < 0))),
    "year ts": (("timestampF",), lambda v: v.year),
    "month ts": (("timestampF",), lambda v: v.month),
    "quarter": (("timestampF",), lambda v: (v.month - 1) // 3 + 1),
    "weekday": (("timestampF",), lambda v: v.weekday()),
    "trunc quarter": (("timestampF",), lambda v: __import__(
        "datetime").date(v.year, (v.month - 1) // 3 * 3 + 1, 1)),
    "datediff ts": (("timestampF", "dateF"), lambda a, b: (a.date() - b).days),
}


def _check_or_oracle(frames, name, build):
    if name not in ORACLES:
        _check(frames, build, SPARK_TYPED.get(name))
        return
    port_df, ref_df = frames
    cols, fn = ORACLES[name]
    with pytest.raises(Exception):
        ref_df.select(build(REF).alias("v")).collect()
    got = port_df.select(build(PORT).alias("v"),
                         *[E.col(c) for c in cols]).collect().to_pylist()
    for r in got:
        args = [r[c] for c in cols]
        want = None if any(a is None for a in args) else fn(*args)
        assert _close(r["v"], want), (r, want)


@pytest.mark.parametrize("name", list(MATH))
def test_math_matches_reference(frames, name):
    _check_or_oracle(frames, name, MATH[name])


@pytest.mark.parametrize("name", list(ARITH))
def test_arithmetic_matches_reference(frames, name):
    _check(frames, ARITH[name])


@pytest.mark.parametrize("name", list(DATES))
def test_datetime_matches_reference(frames, name):
    _check_or_oracle(frames, name, DATES[name])


@pytest.mark.parametrize("name", list(DECIMALS))
def test_decimal_expressions_match_reference(frames, name):
    _check(frames, DECIMALS[name])


@pytest.mark.parametrize("name", list(HASHES))
def test_hash_matches_reference(frames, name):
    _check(frames, HASHES[name])


COLS = ["strF", "byteF", "shortF", "intF", "longF", "floatF", "doubleF",
        "decimalF", "booleanF", "dateF", "timestampF"]
TO = {"string": (T.STRING, JT.STRING), "tinyint": (T.BYTE, JT.BYTE),
      "smallint": (T.SHORT, JT.SHORT), "int": (T.INT, JT.INT),
      "bigint": (T.LONG, JT.LONG), "float": (T.FLOAT, JT.FLOAT),
      "double": (T.DOUBLE, JT.DOUBLE),
      "decimal(9,1)": (T.DecimalType(9, 1), JT.DecimalType(9, 1)),
      "boolean": (T.BOOLEAN, JT.BOOLEAN), "date": (T.DATE, JT.DATE),
      "timestamp": (T.TIMESTAMP, JT.TIMESTAMP)}
_SCHEMA = {f.name: f.type for f in qa_table(4).schema}


def _cast_pairs():
    out = []
    for c in COLS:
        frm = T.from_arrow_type(_SCHEMA[c])
        for to, (pt, _) in TO.items():
            if frm == pt or not supported_cast(frm, pt):
                continue
            # a float or double narrowed to tinyint/smallint: a reference
            # gap (test_gap_float_to_tinyint_wraps_through_int)
            if isinstance(frm, T.FractionalType) and isinstance(
                    pt, (T.ByteType, T.ShortType)):
                continue
            out.append((c, to))
    return out


@pytest.mark.parametrize("col,to", _cast_pairs())
def test_cast_matches_reference(frames, col, to):
    pt, rt = TO[to]
    _check(frames, lambda k: k.e.col(col).cast(pt if k is PORT else rt))


def test_cast_from_strings_parses_like_spark(frames):
    """String → every type through the dictionary: valid and invalid
    strings, null where Spark's non-ANSI cast is null."""
    vals = [" 12 ", "-7.9", "1e3", "abc", "", "2020-02-29", "true",
            "2020-02-29 10:11:12.5", "3.5f", "NaN", None, "99999"]
    t = pa.table({"s": pa.array(vals, pa.string())})
    df = TorchSession(device="cpu").create_dataframe(t)
    got = df.select(*[E.col("s").cast(pt).alias(n) for n, (pt, _) in
                      TO.items() if n != "string"]).collect().to_pylist()
    cols = {k: [r[k] for r in got] for k in got[0]}
    assert cols["int"] == [12, -7, None, None, None, None, None, None, None,
                           None, None, 99999]
    assert cols["tinyint"][-1] is None            # out of range
    assert cols["smallint"][-1] is None
    assert cols["double"][:3] == [12.0, -7.9, 1000.0]
    assert cols["double"][8] == 3.5 and math.isnan(cols["double"][9])
    assert cols["boolean"][6] is True and cols["boolean"][0] is None
    assert str(cols["date"][5]) == "2020-02-29"
    assert cols["timestamp"][7].isoformat() == \
        "2020-02-29T10:11:12.500000+00:00"
    assert str(cols["decimal(9,1)"][1]) == "-7.9"


# -- where the reference differs from Spark -----------------------------------

def _both(t, port_e, ref_e):
    return (TorchSession(device="cpu").create_dataframe(t).select(
                port_e.alias("v")).collect().column("v").to_pylist(),
            TpuSession().create_dataframe(t).select(
                ref_e.alias("v")).collect().column("v").to_pylist())


def test_gap_round_of_a_double_reads_its_printed_digits():
    """Spark rounds BigDecimal(Double.toString(x)): round(1.005, 2) is
    1.01. The reference scales the double (100.49999999999999) and gets
    1.0; bround's HALF_EVEN likewise (0.125 → 0.12, 0.135 → 0.14)."""
    t = pa.table({"d": pa.array([2.675, -2.675, 1.005, 0.125, 0.135])})
    got, ref = _both(t, F.round("d", 2), JF.round("d", 2))
    assert got == [2.68, -2.68, 1.01, 0.13, 0.14]
    assert ref[2] == 1.0
    got, _ = _both(t, M.BRound(E.col("d"), 2), JM.BRound(JE.col("d"), 0))
    assert got == [2.68, -2.68, 1.0, 0.12, 0.14]


def test_gap_float_to_tinyint_wraps_through_int():
    """Spark casts a double to tinyint as ``toInt.toByte``: 300.7 → 300 →
    44. The reference saturates at the byte's range (127)."""
    t = pa.table({"d": pa.array([300.7, -300.7, 1e10, float("nan"), 5.9])})
    got, ref = _both(t, E.col("d").cast(T.BYTE), JE.col("d").cast(JT.BYTE))
    assert got == [44, -44, -1, 0, 5]
    assert ref == [127, -128, 127, 0, 5]
    got, _ = _both(t, E.col("d").cast(T.SHORT), JE.col("d").cast(JT.SHORT))
    assert got == [300, -300, -1, 0, 5]


def test_gap_months_between_counts_the_time_of_day():
    """Spark's months_between of two timestamps adds their seconds apart
    within the day over 31 days, and rounds HALF_UP; the reference reads
    only the dates."""
    us = 86_400_000_000
    t = pa.table({"a": pa.array([(31 + 10) * us + 12 * 3600 * 1_000_000],
                                pa.timestamp("us", tz="UTC")),
                  "b": pa.array([5 * us], pa.timestamp("us", tz="UTC"))})
    got, ref = _both(t, F.months_between("a", "b"),
                     JF.months_between("a", "b"))
    # 1970-02-11 12:00 vs 1970-01-06: 1 month + (5 days + 12 h) / 31 days
    assert got == [round(1 + 5.5 / 31, 8)]
    assert ref == [round(1 + 5 / 31, 8)]


def test_gap_floor_of_a_decimal_has_sparks_precision():
    """Spark types floor(decimal(12,2)) as decimal(11,0); the reference
    keeps decimal(12,0). The values are equal."""
    pe = M.Floor(E.BoundReference(0, T.DecimalType(12, 2)))
    re_ = JM.Floor(JE.BoundReference(0, JT.DecimalType(12, 2)))
    assert pe.dtype == T.DecimalType(11, 0)
    assert re_.dtype == JT.DecimalType(12, 0)


def test_gap_stddev_of_a_decimal_reads_its_value():
    """The reference's central moments read a decimal's unscaled long, so
    stddev of 1.00 and 3.00 (decimal(5,2)) is 141.42...; Spark and the
    port give 1.4142..."""
    from decimal import Decimal
    t = pa.table({"x": pa.array([Decimal("1.00"), Decimal("3.00")],
                                pa.decimal128(5, 2))})
    port = TorchSession(device="cpu").create_dataframe(t).agg(
        F.stddev("x").alias("s")).collect().to_pylist()[0]["s"]
    ref = TpuSession().create_dataframe(t).agg(
        JF.stddev("x").alias("s")).collect().to_pylist()[0]["s"]
    assert port == pytest.approx(math.sqrt(2), rel=1e-12)
    assert ref == pytest.approx(100 * math.sqrt(2), rel=1e-12)


def test_gap_double_to_decimal_rounds_the_printed_digits():
    """Spark's cast of a double to a decimal reads the double's printed
    digits (``Decimal(double)``): cast(1.005 as decimal(6,2)) is 1.01.
    The reference scales the double (100.49999999999999) and gets 1.00."""
    t = pa.table({"d": pa.array([1.005, -1.005, 0.25, 7.0])})
    to, jto = T.DecimalType(6, 2), JT.DecimalType(6, 2)
    got, ref = _both(t, E.col("d").cast(to), JE.col("d").cast(jto))
    assert [str(x) for x in got] == ["1.01", "-1.01", "0.25", "7.00"]
    assert [str(x) for x in ref[:2]] == ["1.00", "-1.00"]


# -- round/bround of large doubles and of decimals (ROADMAP Queue 3) -----------

@pytest.mark.parametrize("fn,digits,ref_gives", [
    ("round", 1, "spark"), ("round", 0, "spark"), ("round", -2, "scaled"),
    ("bround", 1, "raises"), ("bround", -2, "raises")])
def test_gap_round_of_a_large_double_keeps_it(fn, digits, ref_gives):
    """A double of 1e16 and above is integral: Spark's round returns it as
    it is (1e300 stays 1e300). The port sent every row with |x| * 10^d >=
    5e8 to the host as a near tie, where a 28-digit ``Decimal.quantize``
    raised ``InvalidOperation``; now the integral rows stay on the device
    and the host call runs wide enough for any double. The reference gives
    Spark's answer for round at d >= 0, scales the double at d < 0
    (1e27 comes back as 1.0000000000000002e27), and raises the same
    ``InvalidOperation`` for bround."""
    vals = [1e300, -1e300, 1e27, 123456789012.5, 2.5, None,
            float("inf"), 1.7976931348623157e308]
    t = pa.table({"d": pa.array(vals)})
    pe = (M.Round if fn == "round" else M.BRound)(E.col("d"), digits)
    re_ = (JM.Round if fn == "round" else JM.BRound)(JE.col("d"), digits)
    got = TorchSession(device="cpu").create_dataframe(t).select(
        pe.alias("v")).collect().column("v").to_pylist()
    assert got[:3] == [1e300, -1e300, 1e27]
    ref_df = TpuSession().create_dataframe(t).select(re_.alias("v"))
    if ref_gives == "raises":
        with pytest.raises(Exception):
            ref_df.collect()
    else:
        ref = ref_df.collect().column("v").to_pylist()
        assert ref[:2] == got[:2]
        assert (ref[2] == got[2]) == (ref_gives == "spark")
    assert got[5] is None and got[6] == float("inf")
    assert got[7] == 1.7976931348623157e308
    if digits == 1:
        assert got[3] == 123456789012.5
    if digits == 0:
        assert got[4] == 3.0 and got[3] == 123456789013.0   # HALF_UP
    # a double at the near-tie edge still rounds its printed digits
    from decimal import ROUND_HALF_UP
    assert M._spark_round_host(1e300, -290, ROUND_HALF_UP) == 1e300


def test_round_of_large_doubles_makes_no_host_call(monkeypatch):
    """Rows whose scaled magnitude is 2^52 or more never reach the host."""
    calls = []
    real = M._spark_round_host

    def counting(*a):
        calls.append(a)
        return real(*a)
    monkeypatch.setattr(M, "_spark_round_host", counting)
    vals = [float(10 ** k) + 0.5 for k in range(16, 300, 7)]
    t = pa.table({"d": pa.array(vals)})
    got = TorchSession(device="cpu").create_dataframe(t).select(
        F.round("d", 1).alias("v")).collect().column("v").to_pylist()
    assert got == vals and not calls


def test_gap_round_of_a_decimal_has_sparks_type():
    """Spark types round(decimal(p,s), d) as decimal(p-s+1+min(s,d),
    min(s,d)), and decimal(max(p-s+1, 1-d), 0) for d < 0 (SPARK-39226):
    round(1.25, 1) over decimal(7,2) is 1.3 and round(99999.99, 1) is
    100000.0, both decimal(7,1). The reference keeps decimal(7,2): it
    gives 1.30, and its collect of 100000.00 fails (precision 8 > 7)."""
    from decimal import Decimal as D
    t = pa.table({"m": pa.array([D("1.25"), D("99999.99"), D("-2.35"),
                                 None, D("0.05")], pa.decimal128(7, 2))})
    cases = [(1, pa.decimal128(7, 1),
              [D("1.3"), D("100000.0"), D("-2.4"), None, D("0.1")]),
             (-2, pa.decimal128(6, 0),
              [D("0"), D("100000"), D("0"), None, D("0")]),
             (3, pa.decimal128(8, 2),
              [D("1.25"), D("99999.99"), D("-2.35"), None, D("0.05")])]
    port = TorchSession(device="cpu").create_dataframe(t)
    for digits, at, want in cases:
        out = port.select(F.round("m", digits).alias("v")).collect()
        assert out.schema.field("v").type == at
        assert out.column("v").to_pylist() == want
        assert [str(x) for x in want if x is not None] == [
            str(x) for x in out.column("v").to_pylist() if x is not None]
    b = port.select(F.bround("m", 1).alias("v")).collect()
    assert b.schema.field("v").type == pa.decimal128(7, 1)
    assert b.column("v").to_pylist() == [D("1.2"), D("100000.0"),
                                         D("-2.4"), None, D("0.0")]
    small = pa.table({"m": pa.array([D("1.25")], pa.decimal128(7, 2))})
    ref = TpuSession().create_dataframe(small).select(
        JF.round("m", 1).alias("v")).collect()
    assert ref.schema.field("v").type == pa.decimal128(7, 2)
    assert str(ref.column("v")[0].as_py()) == "1.30"
    with pytest.raises(Exception):
        TpuSession().create_dataframe(t).select(
            JF.round("m", 1).alias("v")).collect()
    assert M.Round(E.BoundReference(0, T.DecimalType(18, 0)),
                   0).dtype == T.DecimalType(18, 0)        # capped at 18


# -- date and timestamp literals from Python objects (ROADMAP Queue 3) --------

def test_gap_date_and_timestamp_literals_are_values():
    """``F.lit(datetime.date(...))`` is a DATE literal and
    ``F.lit(datetime.datetime(...))`` a TIMESTAMP one (naive taken as UTC),
    in a projection and in a filter, as Spark takes them. The reference
    plans them and then hands the object to the device, which raises."""
    import datetime
    d0 = datetime.date(1600, 1, 2)
    ts = datetime.datetime(2001, 2, 3, 4, 5, 6, 789012)
    aware = datetime.datetime(2001, 2, 3, 6, 5, 6, 789012,
                              tzinfo=datetime.timezone(
                                  datetime.timedelta(hours=2)))
    t = pa.table({"dt": pa.array([datetime.date(1599, 12, 31), d0,
                                  datetime.date(2020, 5, 5), None],
                                 pa.date32())})
    spark = TorchSession(device="cpu")
    df = spark.create_dataframe(t)
    out = df.select(F.lit(d0).alias("d"), F.lit(ts).alias("t"),
                    F.lit(aware, T.TIMESTAMP).alias("a"),
                    F.date_add(F.lit(d0, T.DATE), F.lit(1)).alias("n")
                    ).collect()
    utc = datetime.timezone.utc
    assert out.column("d").to_pylist() == [d0] * 4
    assert out.column("t").to_pylist() == [ts.replace(tzinfo=utc)] * 4
    assert out.column("a").to_pylist() == [ts.replace(tzinfo=utc)] * 4
    assert out.column("n").to_pylist() == [datetime.date(1600, 1, 3)] * 4
    assert out.schema.field("d").type == pa.date32()
    got = df.filter(F.col("dt") >= F.lit(d0)).collect()
    assert got.column("dt").to_pylist() == [d0, datetime.date(2020, 5, 5)]
    assert E.lit(d0).value == (d0 - datetime.date(1970, 1, 1)).days
    assert E.lit(ts).dtype == T.TIMESTAMP
    with pytest.raises(Exception):
        TpuSession().create_dataframe(t).filter(
            JF.col("dt") >= JF.lit(d0, JT.DATE)).collect()
