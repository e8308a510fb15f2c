"""Cast — Spark (non-ANSI) cast semantics on the device.

Counterpart of ``spark_rapids_tpu/expr/cast.py``, limited to what the
ported TPC-H and TPC-DS paths and the numeric promotion of their arithmetic
use:

- string → date parses each *dictionary entry* once on the host with Spark's
  ``stringToDate`` rules (``yyyy[-m[m][-d[d]]]``, optional time part), then
  gathers on the device; an unparsable entry is null;
- int → long, int → double and long → double widen exactly as the JAX
  package's ``astype`` does;
- the decimal casts (reference ``_cast_decimal``): decimal ↔ decimal
  rescale (HALF_UP on the magnitude when the scale drops), integral ↔
  decimal (toward zero into the integer), decimal ↔ double (HALF_UP on the
  magnitude into the decimal); a value outside the target's range, or a
  NaN, is null.

Any other pair raises ``NotImplementedError`` (``supported_cast`` lets the
planner refuse it before anything runs).
"""

from __future__ import annotations

import datetime

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression

_WIDENING = {(T.IntegerType, T.LongType), (T.IntegerType, T.DoubleType),
             (T.LongType, T.DoubleType)}


_INT_BOUNDS = {T.IntegerType: (-(2**31), 2**31 - 1),
               T.LongType: (-(2**63), 2**63 - 1)}


def _decimal_cast(frm: T.DataType, to: T.DataType) -> bool:
    """A cast with a decimal side whose other side is a decimal, an int, a
    long or a double."""
    if not (isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType)):
        return False
    return all(isinstance(t, (T.DecimalType, T.IntegerType, T.LongType,
                              T.DoubleType)) for t in (frm, to))


def supported_cast(frm: T.DataType, to: T.DataType) -> bool:
    return (frm == to or (type(frm), type(to)) in _WIDENING
            or _decimal_cast(frm, to)
            or (isinstance(frm, T.StringType) and isinstance(to, T.DateType)))


def _parse_date(s: str):
    """Spark DateTimeUtils.stringToDate subset: yyyy[-m[m][-d[d]]] with an
    optional trailing time part after 'T' or ' '."""
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


def cast_col(c: Col, to: T.DataType) -> Col:
    frm = c.dtype
    if frm == to:
        return c
    if not supported_cast(frm, to):
        raise NotImplementedError(f"cast {frm} -> {to} is not ported yet")
    if isinstance(frm, T.StringType):
        from spark_rapids_tpu_torch.ops.strings import dict_transform_to_values
        return dict_transform_to_values(c, _parse_date, to)
    if isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType):
        return _cast_decimal(c, to)
    return Col(c.values.to(to.torch_dtype), c.validity, to).canonicalized()


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
    if isinstance(frm, (T.IntegerType, T.LongType)):
        out = vals.to(torch.int64) * (10 ** to.scale)
        return Col(out, validity & _in_range(out, to.precision),
                   to).canonicalized()
    if isinstance(to, (T.IntegerType, T.LongType)):
        div = 10 ** frm.scale
        q = torch.div(vals, div, rounding_mode="floor")
        rem = vals - q * div
        q = torch.where((rem != 0) & (vals < 0), q + 1, q)  # toward zero
        lo, hi = _INT_BOUNDS[type(to)]
        ok = (q >= lo) & (q <= hi)
        return Col(q.to(to.torch_dtype), validity & ok, to).canonicalized()
    if isinstance(to, T.DoubleType):
        return Col(vals.to(torch.float64) / float(10 ** frm.scale), validity,
                   to).canonicalized()
    # double -> decimal: HALF_UP on the magnitude; NaN and overflow null
    scaled = vals.to(torch.float64) * float(10 ** to.scale)
    nan = torch.isnan(scaled)
    r = torch.floor(scaled.abs() + 0.5)
    out64 = torch.where(scaled < 0, -r, r)
    ok = ~nan & (out64.abs() < float(10 ** to.precision))
    out = torch.where(ok, out64, torch.zeros_like(out64)).to(torch.int64)
    return Col(out, validity & ok, to).canonicalized()


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DataType):
        self.children = [child]
        self.to = to

    @property
    def dtype(self):
        return self.to

    def with_children(self, children):
        return Cast(children[0], self.to)

    def eval(self, ctx):
        return cast_col(self.children[0].eval(ctx), self.to)

    def __repr__(self):
        return f"cast({self.children[0]!r} AS {self.to})"
