"""Cast — Spark (non-ANSI) cast semantics on the device.

Counterpart of ``spark_rapids_tpu/expr/cast.py`` (reference GpuCast.scala),
the whole matrix over the port's scalar types:

- integral narrowing wraps like Java (long → int keeps the low 32 bits);
- float/double → int/long truncates toward zero and saturates, NaN is 0
  (Java's ``(int)``/``(long)``); → byte/short goes through int and then
  wraps, as Spark's ``toInt.toByte`` (the reference saturates at the byte's
  range: ``cast(300.7 as tinyint)`` is 44 in Spark, 127 there);
- numeric → boolean is ``!= 0``; boolean → numeric is 1/0;
- date ↔ timestamp through days × 86,400,000,000 µs (floor for
  timestamp → date); timestamp ↔ long through seconds (floor);
- decimal rescale with HALF_UP, overflow to null; decimal → integral
  truncates toward zero, a value outside the target null; float/double →
  decimal rounds HALF_UP at the digits the double prints as (Spark's
  ``Decimal(double)``: ``cast(1234.45 as decimal(6,1))`` is 1234.5; the
  reference scales the double and gets 1234.4);
- string → number/boolean/date/timestamp parses each *dictionary entry*
  once on the host with Spark's rules (an invalid string is null), then
  gathers on the device;
- number/date/timestamp → string formats the distinct values present once
  on the host (Java's ``Double.toString``/``Float.toString``) into a new
  sorted dictionary.

``supported_cast`` names the pairs; any other raises
``NotImplementedError``, so the planner refuses it before anything runs.
"""

from __future__ import annotations

import datetime
import math
import re

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression

_INT_BOUNDS = {
    T.ByteType: (-(2**7), 2**7 - 1),
    T.ShortType: (-(2**15), 2**15 - 1),
    T.IntegerType: (-(2**31), 2**31 - 1),
    T.LongType: (-(2**63), 2**63 - 1),
}

_MICROS_PER_DAY = 86_400_000_000

_SCALAR = (T.BooleanType, T.NumericType, T.StringType, T.DateType,
           T.TimestampType)


def supported_cast(frm: T.DataType, to: T.DataType) -> bool:
    """Whether the port casts ``frm`` to ``to``: NULL to any scalar type,
    and every pair of scalar types except a date with a number or a
    boolean, and a timestamp with anything numeric but a long (its
    seconds)."""
    if frm == to:
        return True
    if isinstance(frm, T.NullType):
        return isinstance(to, _SCALAR)
    if not (isinstance(frm, _SCALAR) and isinstance(to, _SCALAR)):
        return False
    date_like = (T.DateType,)
    for a, b in ((frm, to), (to, frm)):
        if isinstance(a, date_like) and isinstance(b, (T.NumericType,
                                                       T.BooleanType)):
            return False
        if isinstance(a, T.TimestampType) and isinstance(
                b, (T.DecimalType, T.FractionalType, T.BooleanType)):
            return False
    if isinstance(frm, T.TimestampType) and isinstance(to, T.IntegralType):
        return isinstance(to, T.LongType)
    if isinstance(to, T.TimestampType) and isinstance(frm, T.IntegralType):
        return isinstance(frm, T.LongType)
    return True


def _float_to_integral(vals: torch.Tensor, to: T.DataType) -> torch.Tensor:
    """Java's float → integral: truncate toward zero, NaN 0, saturate at
    int (for byte, short and int) or long, then narrow by wrapping."""
    wide = T.LONG if isinstance(to, T.LongType) else T.INT
    lo, hi = _INT_BOUNDS[type(wide)]
    v = vals.to(torch.float64)
    t = torch.trunc(torch.where(torch.isnan(v), torch.zeros_like(v), v))
    if isinstance(wide, T.LongType):
        # 2**63 is not an int64: saturate in the float domain first
        big = t >= float(2**63)
        small = t <= float(-(2**63))
        mid = torch.where(big | small, torch.zeros_like(t), t)
        out = mid.to(torch.int64)
        out = torch.where(big, torch.full_like(out, hi), out)
        out = torch.where(small, torch.full_like(out, lo), out)
    else:
        out = t.clamp(float(lo), float(hi)).to(torch.int64)
    return out.to(to.torch_dtype)


def _null_col(capacity: int, to: T.DataType, device) -> Col:
    d = pa.array([], type=pa.string()) if isinstance(to, T.StringType) \
        else None
    return Col(torch.full((capacity,), to.default_value(),
                          dtype=to.torch_dtype, device=device),
               torch.zeros((capacity,), dtype=torch.bool, device=device),
               to, d)


def cast_col(c: Col, to: T.DataType) -> Col:
    frm = c.dtype
    if frm == to:
        return c
    if not supported_cast(frm, to):
        raise NotImplementedError(f"cast {frm} -> {to} is not ported yet")
    if isinstance(frm, T.NullType):
        return _null_col(int(c.values.shape[0]), to, c.values.device)
    if isinstance(frm, T.StringType):
        return _cast_from_string(c, to)
    if isinstance(to, T.StringType):
        return _cast_to_string(c)
    vals, validity = c.values, c.validity
    if isinstance(frm, T.BooleanType):
        return Col(vals.to(to.torch_dtype), validity, to).canonicalized()
    if isinstance(to, T.BooleanType):
        return Col(vals != 0, validity, to).canonicalized()
    if isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
        return Col(vals.to(torch.int64) * _MICROS_PER_DAY, validity,
                   to).canonicalized()
    if isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
        return Col(torch.div(vals, _MICROS_PER_DAY,
                             rounding_mode="floor").to(torch.int32),
                   validity, to).canonicalized()
    if isinstance(frm, T.TimestampType):          # → long: seconds
        return Col(torch.div(vals, 1_000_000, rounding_mode="floor"),
                   validity, to).canonicalized()
    if isinstance(to, T.TimestampType):           # long seconds →
        return Col(vals * 1_000_000, validity, to).canonicalized()
    if isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType):
        return _cast_decimal(c, to)
    if isinstance(frm, T.FractionalType) and isinstance(to, T.IntegralType):
        return Col(_float_to_integral(vals, to), validity,
                   to).canonicalized()
    # integral → integral (wraps), integral → float, float ↔ double
    return Col(vals.to(to.torch_dtype), validity, to).canonicalized()


def _in_range(out, precision: int):
    bound = 10 ** precision
    return (out < bound) & (out > -bound)


def _cast_decimal(c: Col, to: T.DataType) -> Col:
    frm = c.dtype
    vals, validity = c.values, c.validity
    if isinstance(frm, T.DecimalType) and isinstance(to, T.DecimalType):
        ds = to.scale - frm.scale
        if ds >= 0:
            out = vals * (10 ** ds)
        else:
            # HALF_UP on the magnitude, the sign put back
            div = 10 ** (-ds)
            mag = vals.abs()
            qm = torch.div(mag, div, rounding_mode="floor")
            rm = mag - qm * div
            qm = qm + (2 * rm >= div).to(qm.dtype)
            out = torch.where(vals < 0, -qm, qm)
        return Col(out, validity & _in_range(out, to.precision),
                   to).canonicalized()
    if isinstance(frm, T.IntegralType):
        out = vals.to(torch.int64) * (10 ** to.scale)
        return Col(out, validity & _in_range(out, to.precision),
                   to).canonicalized()
    if isinstance(to, T.IntegralType):
        div = 10 ** frm.scale
        q = torch.div(vals, div, rounding_mode="floor")
        rem = vals - q * div
        q = torch.where((rem != 0) & (vals < 0), q + 1, q)  # toward zero
        lo, hi = _INT_BOUNDS[type(to)]
        ok = (q >= lo) & (q <= hi)
        return Col(q.to(to.torch_dtype), validity & ok, to).canonicalized()
    if isinstance(to, T.FractionalType):
        return Col((vals.to(torch.float64) / float(10 ** frm.scale)).to(
            to.torch_dtype), validity, to).canonicalized()
    # float/double → decimal: HALF_UP on the magnitude; NaN and overflow null
    scaled = vals.to(torch.float64) * float(10 ** to.scale)
    nan = torch.isnan(scaled)
    r = torch.floor(scaled.abs() + 0.5)
    out64 = _printed_half_up(vals.to(torch.float64), scaled,
                             torch.where(scaled < 0, -r, r), to.scale,
                             validity)
    ok = ~nan & (out64.abs() < float(10 ** to.precision))
    out = torch.where(ok, out64, torch.zeros_like(out64)).to(torch.int64)
    return Col(out, validity & ok, to).canonicalized()


def _printed_half_up(x, scaled, rounded, scale: int, validity):
    """Spark rounds the decimal a double prints as (``Decimal(double)`` is
    ``BigDecimal(Double.toString(x))``), so 1234.45 at scale 1 is 1234.5;
    the scaled product 12344.499999999998 rounds down. Where the scaled
    magnitude lies within 1e-9 of a half the value is rounded on the host
    at its printed digits (once each, few); elsewhere both agree."""
    frac = scaled.abs() - torch.floor(scaled.abs())
    near = ((frac - 0.5).abs() <= 1e-9 * torch.clamp(scaled.abs(), min=1.0)) \
        & validity & torch.isfinite(scaled)
    if not bool(near.any()):
        return rounded
    from decimal import ROUND_HALF_UP, Context, Decimal
    ctx = Context(prec=800)        # the whole double, never inexact
    idx = torch.nonzero(near).flatten()
    fixed = [float(Decimal(repr(v)).scaleb(scale, ctx).quantize(
        Decimal(1), rounding=ROUND_HALF_UP, context=ctx))
        for v in x[idx].cpu().tolist()]
    return rounded.index_put((idx,), torch.tensor(
        fixed, dtype=rounded.dtype, device=rounded.device))


# -- string → value: one parse per dictionary entry ---------------------------

_INT_RE = re.compile(r"^[+-]?(\d+)(\.\d*)?$|^[+-]?\.\d+$")


def _parse_integral(s: str, lo: int, hi: int):
    """Spark ``UTF8String.toLong`` (non-ANSI): trimmed, an optional sign,
    digits and an optional fraction that is truncated; anything else, and a
    value outside the type, is null."""
    t = s.strip()
    if not _INT_RE.match(t):
        return None
    whole = t.split(".", 1)[0]
    if whole in ("", "+", "-"):
        v = 0
    else:
        v = int(whole)
    if v < lo or v > hi:
        return None
    return v


def _parse_double(s: str):
    t = s.strip()
    if not t:
        return None
    low = t.lower()
    if low == "nan":
        return float("nan")
    if low in ("inf", "+inf", "infinity", "+infinity"):
        return float("inf")
    if low in ("-inf", "-infinity"):
        return float("-inf")
    if low.endswith(("d", "f")):
        t = t[:-1]          # Java's parseDouble takes a trailing D or F
    if not re.match(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$", t):
        return None
    return float(t)


def _parse_float(s: str):
    """``Float.parseFloat``: the decimal string rounded once to float32."""
    v = _parse_double(s)
    if v is None or not math.isfinite(v):
        return v
    t = s.strip()
    if t.lower().endswith(("d", "f")):
        t = t[:-1]
    return float(np.float32(t))


def _parse_bool(s: str):
    t = s.strip().lower()
    if t in ("t", "true", "y", "yes", "1"):
        return True
    if t in ("f", "false", "n", "no", "0"):
        return False
    return None


def _parse_date(s: str):
    """Spark ``DateTimeUtils.stringToDate`` subset: ``yyyy[-m[m][-d[d]]]``
    with an optional trailing time part after 'T' or ' '."""
    t = s.strip()
    for sep in ("T", " "):
        if sep in t:
            t = t.split(sep, 1)[0]
    parts = t.split("-")
    try:
        if len(parts) == 1:
            d = datetime.date(int(parts[0]), 1, 1)
        elif len(parts) == 2:
            d = datetime.date(int(parts[0]), int(parts[1]), 1)
        elif len(parts) == 3:
            d = datetime.date(int(parts[0]), int(parts[1]), int(parts[2]))
        else:
            return None
    except ValueError:
        return None
    return (d - datetime.date(1970, 1, 1)).days


_TS_RE = re.compile(
    r"^([+-]?\d{4,6})(?:-(\d{1,2})(?:-(\d{1,2})"
    r"(?:[ T](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,9}))?)?"
    r"\s*(Z|UTC|[+-]\d{1,2}(?::\d{1,2})?)?)?)?)?$")


def _parse_timestamp(s: str):
    """Spark ``DateTimeUtils.stringToTimestamp`` (3.2+): ``[+-]y+[-m[m]
    [-d[d]]]`` with an optional ``[T or space]h[h]:m[m][:s[s][.f+]]`` time
    and an optional ``Z``/``UTC``/``±hh[:mm]`` zone, shifted into UTC (the
    session zone). Epoch micros, or None for an unparsable string."""
    m = _TS_RE.match(s.strip())
    if not m:
        return None
    try:
        frac = (m[7] or "")[:6].ljust(6, "0")
        dt = datetime.datetime(int(m[1]), int(m[2] or 1), int(m[3] or 1),
                               int(m[4] or 0), int(m[5] or 0),
                               int(m[6] or 0), int(frac),
                               tzinfo=datetime.timezone.utc)
    except ValueError:
        return None
    off = 0
    if m[8] and m[8] not in ("Z", "UTC"):
        zm = re.match(r"([+-])(\d{1,2})(?::(\d{1,2}))?$", m[8])
        zh, zmin = int(zm[2]), int(zm[3] or 0)
        if zh > 18 or zmin > 59 or zh * 3600 + zmin * 60 > 18 * 3600:
            return None
        off = (zh * 3600 + zmin * 60) * (1 if zm[1] == "+" else -1)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    return ((dt - epoch) // datetime.timedelta(microseconds=1)
            - off * 1_000_000)


def _parse_decimal(s: str, to: T.DecimalType):
    from decimal import ROUND_HALF_UP, Decimal, InvalidOperation
    try:
        v = Decimal(s.strip()).scaleb(to.scale).to_integral_value(
            ROUND_HALF_UP)
    except (InvalidOperation, ValueError, ArithmeticError):
        return None
    if not v.is_finite():
        return None
    v = int(v)
    return v if -(10 ** to.precision) < v < 10 ** to.precision else None


def _cast_from_string(c: Col, to: T.DataType) -> Col:
    from spark_rapids_tpu_torch.ops.strings import dict_transform_to_values
    if isinstance(to, T.IntegralType):
        lo, hi = _INT_BOUNDS[type(to)]
        return dict_transform_to_values(
            c, lambda s: _parse_integral(s, lo, hi), to)
    if isinstance(to, T.DoubleType):
        return dict_transform_to_values(c, _parse_double, to)
    if isinstance(to, T.FloatType):
        return dict_transform_to_values(c, _parse_float, to)
    if isinstance(to, T.BooleanType):
        return dict_transform_to_values(c, _parse_bool, to)
    if isinstance(to, T.DateType):
        return dict_transform_to_values(c, _parse_date, to)
    if isinstance(to, T.TimestampType):
        return dict_transform_to_values(c, _parse_timestamp, to)
    return dict_transform_to_values(c, lambda s: _parse_decimal(s, to), to)


# -- value → string: Java's formatting -----------------------------------------

def java_double_str(v: float) -> str:
    """Java ``Double.toString`` (what Spark's CAST(double AS STRING) gives):
    the shortest round-trip digits, plain in [1e-3, 1e7), else
    ``d.dddE±n``."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == 0:
        return "-0.0" if math.copysign(1, v) < 0 else "0.0"
    return _sci_or_plain(abs(v), repr(abs(v)), v < 0)


def java_float_str(v) -> str:
    """Java ``Float.toString``: the shortest digits that round-trip the
    float32 value (the widened double would print 0.10000000149011612)."""
    f = np.float32(v)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    if f == 0:
        return "-0.0" if np.signbit(f) else "0.0"
    short = np.format_float_scientific(abs(f), unique=True, trim="-")
    return _sci_or_plain(abs(float(f)), short, bool(f < 0))


def _sci_or_plain(a: float, digits_repr: str, neg: bool) -> str:
    """Java layout of a positive value from a shortest-digits repr
    (``1.5``, ``1e-05`` or ``1.5e+20``)."""
    mant, _, exp = digits_repr.lower().partition("e")
    digits = mant.replace(".", "")
    point = mant.index(".") if "." in mant else len(mant)
    e10 = (int(exp) if exp else 0) + point - 1     # exponent of digit 0
    lead = len(digits) - len(digits.lstrip("0"))
    digits = digits.strip("0") or "0"
    e10 -= lead
    if 1e-3 <= a < 1e7:
        if e10 >= 0:
            whole = digits[:e10 + 1].ljust(e10 + 1, "0")
            frac = digits[e10 + 1:] or "0"
        else:
            whole = "0"
            frac = "0" * (-e10 - 1) + digits
        s = f"{whole}.{frac}"
    else:
        s = f"{digits[0]}.{digits[1:] or '0'}E{e10}"
    return "-" + s if neg else s


def _fmt_decimal(v, scale: int) -> str:
    from decimal import Decimal
    d = Decimal(int(v)).scaleb(-scale)
    return str(d.quantize(Decimal(1).scaleb(-scale)) if scale > 0 else d)


def format_timestamp(us: int) -> str:
    """Spark's CAST(timestamp AS STRING) in UTC: ``yyyy-MM-dd HH:mm:ss``
    and the fraction's significant digits."""
    dt = (datetime.datetime(1970, 1, 1)
          + datetime.timedelta(microseconds=int(us)))
    s = dt.strftime("%Y-%m-%d %H:%M:%S")
    if dt.microsecond:
        s += ("%.6f" % (dt.microsecond / 1e6))[1:].rstrip("0")
    return s


def _cast_to_string(c: Col) -> Col:
    from spark_rapids_tpu_torch.ops.strings import value_transform_to_string
    frm = c.dtype
    if isinstance(frm, T.BooleanType):
        fmt = lambda v: "true" if v else "false"          # noqa: E731
    elif isinstance(frm, T.IntegralType):
        fmt = lambda v: str(int(v))                        # noqa: E731
    elif isinstance(frm, T.DecimalType):
        fmt = lambda v: _fmt_decimal(v, frm.scale)         # noqa: E731
    elif isinstance(frm, T.DateType):
        fmt = lambda v: (datetime.date(1970, 1, 1)         # noqa: E731
                         + datetime.timedelta(days=int(v))).isoformat()
    elif isinstance(frm, T.TimestampType):
        fmt = format_timestamp
    elif isinstance(frm, T.FloatType):
        fmt = java_float_str
    else:
        fmt = lambda v: java_double_str(float(v))          # noqa: E731
    return value_transform_to_string(c, fmt)


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DataType):
        self.children = [child]
        self.to = to

    @property
    def dtype(self):
        if not supported_cast(self.children[0].dtype, self.to):
            raise NotImplementedError(
                f"cast {self.children[0].dtype} -> {self.to} is not ported")
        return self.to

    def with_children(self, children):
        return Cast(children[0], self.to)

    def eval(self, ctx):
        return cast_col(self.children[0].eval(ctx), self.to)

    def __repr__(self):
        return f"cast({self.children[0]!r} AS {self.to})"
