"""Math expressions — counterpart of ``spark_rapids_tpu/expr/mathexprs.py``
(reference mathExpressions.scala: GpuSqrt, GpuFloor, GpuCeil, GpuRound,
GpuBRound, GpuExp, GpuLog, GpuPow, the trigonometric and hyperbolic
functions).

Spark's rules: a unary function takes its operand as a double and returns a
double; floor/ceil of a float or double return a long (of a decimal, a
decimal of scale 0; of an integer, the integer); log of a non-positive
value is null (Java would give NaN); round is HALF_UP and bround HALF_EVEN.

Rounding a double follows Spark, not the reference: Spark rounds the
decimal the double prints as (``BigDecimal(Double.toString(x))``), so
``round(1.005, 2)`` is 1.01, where the reference's float product
``1.005 * 100 = 100.49999999999999`` gives 1.0. The device rounds every
value whose scaled magnitude is not within 1e-9 of a half (there both
rules agree); the few near ties go to the host once each, through
``decimal`` at the printed digits.
"""

from __future__ import annotations

import math
from decimal import ROUND_HALF_EVEN, ROUND_HALF_UP, Context, Decimal

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
from spark_rapids_tpu_torch.expr.core import Col, Expression, valid_and


def _numeric(e: Expression, what: str) -> T.DataType:
    t = e.dtype
    if not isinstance(t, T.NumericType):
        raise NotImplementedError(f"{what} of a {t} is not ported yet")
    return t


class _UnaryMath(Expression):
    """double → double elementwise."""

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        _numeric(self.children[0], type(self).__name__.lower())
        return T.DOUBLE

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = _cast_col(self.children[0].eval(ctx), T.DOUBLE)
        return Col(self.op(c.values), c.validity, T.DOUBLE).canonicalized()

    def op(self, v):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


def _unary(name: str, fn, doc: str = ""):
    cls = type(name, (_UnaryMath,), {"op": lambda self, v: fn(v),
                                      "__doc__": doc or None})
    return cls


Sqrt = _unary("Sqrt", torch.sqrt)
Exp = _unary("Exp", torch.exp)
Expm1 = _unary("Expm1", torch.expm1)
Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", torch.sinh)
Cosh = _unary("Cosh", torch.cosh)
Tanh = _unary("Tanh", torch.tanh)
Asinh = _unary("Asinh", torch.asinh)
Acosh = _unary("Acosh", torch.acosh)
Atanh = _unary("Atanh", torch.atanh)
Cbrt = _unary("Cbrt", lambda v: torch.sign(v) * v.abs().pow(1.0 / 3.0),
              "cbrt(x): the real cube root.")
Signum = _unary("Signum", torch.sign)
ToDegrees = _unary("ToDegrees", torch.rad2deg)
ToRadians = _unary("ToRadians", torch.deg2rad)
Rint = _unary("Rint", torch.round,
              "rint(x): Java's Math.rint, half-even to a double.")
Cot = _unary("Cot", lambda v: torch.cos(v) / torch.sin(v),
             "cot(x) = cos(x) / sin(x).")


class Log(Expression):
    """ln(x); null for x <= 0 (Spark)."""

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        _numeric(self.children[0], "log")
        return T.DOUBLE

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = _cast_col(self.children[0].eval(ctx), T.DOUBLE)
        ok = c.values > 0
        vals = torch.log(torch.where(ok, c.values, torch.ones_like(c.values)))
        return Col(self.post(vals), c.validity & ok, T.DOUBLE).canonicalized()

    def post(self, v):
        return v

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class Log2(Log):
    def post(self, v):
        return v / math.log(2.0)


class Log10(Log):
    def post(self, v):
        return v / math.log(10.0)


class Log1p(Log):
    """ln(1 + x); null for x <= -1."""

    def eval(self, ctx):
        c = _cast_col(self.children[0].eval(ctx), T.DOUBLE)
        ok = c.values > -1
        vals = torch.log1p(torch.where(ok, c.values,
                                       torch.zeros_like(c.values)))
        return Col(vals, c.validity & ok, T.DOUBLE).canonicalized()


class _BinaryMath(Expression):
    def __init__(self, left, right):
        self.children = [left, right]

    @property
    def dtype(self):
        for c in self.children:
            _numeric(c, type(self).__name__.lower())
        return T.DOUBLE

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        l = _cast_col(self.children[0].eval(ctx), T.DOUBLE)
        r = _cast_col(self.children[1].eval(ctx), T.DOUBLE)
        vals, ok = self.op(l.values, r.values)
        return Col(vals, valid_and(l.validity, r.validity) & ok,
                   T.DOUBLE).canonicalized()

    def __repr__(self):
        return (f"{type(self).__name__.lower()}({self.children[0]!r}, "
                f"{self.children[1]!r})")


class Pow(_BinaryMath):
    def op(self, l, r):
        return torch.pow(l, r), torch.ones_like(l, dtype=torch.bool)


class Atan2(_BinaryMath):
    def op(self, l, r):
        return torch.atan2(l, r), torch.ones_like(l, dtype=torch.bool)


class Logarithm(_BinaryMath):
    """log(base, x): null for x <= 0 or base <= 0."""

    def op(self, b, x):
        ok = (x > 0) & (b > 0)
        one = torch.ones_like(x)
        vals = torch.log(torch.where(x > 0, x, one)) / torch.log(
            torch.where(b > 0, b, one * 2.0))
        return vals, ok


class Floor(Expression):
    """floor(x): a long for a float or double (Java's saturating cast), a
    decimal of scale 0 for a decimal, the integer itself for an integer."""

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        ct = _numeric(self.children[0], type(self).__name__.lower())
        if isinstance(ct, T.DecimalType):
            return T.DecimalType(min(ct.precision - ct.scale + 1,
                                     T.DecimalType.MAX_PRECISION), 0)
        if isinstance(ct, T.IntegralType):
            return ct
        return T.LONG

    def with_children(self, children):
        return type(self)(children[0])

    def _dec_round(self, v, div):
        return torch.div(v, div, rounding_mode="floor")

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.cast import _float_to_integral
        ct = self.children[0].dtype
        c = self.children[0].eval(ctx)
        if isinstance(ct, T.IntegralType):
            return c
        if isinstance(ct, T.DecimalType):
            q = self._dec_round(c.values, 10 ** ct.scale)
            return Col(q, c.validity, self.dtype).canonicalized()
        v = self.round_op(c.values.to(torch.float64))
        return Col(_float_to_integral(v, T.LONG), c.validity,
                   T.LONG).canonicalized()

    def round_op(self, v):
        return torch.floor(v)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class Ceil(Floor):
    def _dec_round(self, v, div):
        return -torch.div(-v, div, rounding_mode="floor")

    def round_op(self, v):
        return torch.ceil(v)


# wide enough for a double's 309 integral digits and any scale Spark takes
_WIDE = Context(prec=1200, Emax=999_999, Emin=-999_999)


def _spark_round_host(x: float, digits: int, mode) -> float:
    """Spark's ``BigDecimal(x).setScale(digits, mode).toDouble``: Scala's
    ``BigDecimal(double)`` reads the double's printed digits (a float is
    widened to a double first). The quantize runs in a context wide
    enough for every double (the default 28 digits overflow from ~1e28)."""
    if not math.isfinite(x):
        return x
    return float(Decimal(repr(float(x))).quantize(Decimal(1).scaleb(-digits),
                                                  rounding=mode,
                                                  context=_WIDE))


class Round(Expression):
    """round(x, d): HALF_UP. An integer rounds to a multiple of 10**-d
    (wrapping in its type, as Java's ``intValue``), a float or double keeps
    its type (Spark's printed-digit rule, module docstring). A decimal
    takes Spark's type (``RoundBase.dataType``, SPARK-39226): for d >= 0
    ``decimal(p - s + 1 + min(s, d), min(s, d))``, for d < 0
    ``decimal(max(p - s + 1, 1 - d), 0)``, the precision capped at the
    port's 18 as floor/ceil cap theirs; a rounded value that overflows it
    is NULL, as in Spark. The reference keeps the input's type."""

    mode = ROUND_HALF_UP

    def __init__(self, child, digits: int = 0):
        self.children = [child]
        self.digits = int(digits)

    @property
    def dtype(self):
        ct = _numeric(self.children[0], type(self).__name__.lower())
        if isinstance(ct, T.DecimalType):
            p, s, d = ct.precision, ct.scale, self.digits
            if d < 0:
                prec, scale = max(p - s + 1, 1 - d), 0
            else:
                scale = min(s, d)
                prec = p - s + 1 + scale
            return T.DecimalType(min(prec, T.DecimalType.MAX_PRECISION),
                                 scale)
        return ct

    def with_children(self, children):
        return type(self)(children[0], self.digits)

    def _int_round(self, v, div):
        """v rounded to a multiple of div (int64)."""
        mag = v.abs()
        qm = torch.div(mag + div // 2, div, rounding_mode="floor") * div
        return torch.where(v < 0, -qm, qm)

    def eval(self, ctx):
        ct = self.dtype
        c = self.children[0].eval(ctx)
        d = self.digits
        if isinstance(ct, T.IntegralType):
            if d >= 0:
                return c
            out = self._int_round(c.values.to(torch.int64), 10 ** (-d))
            return Col(out.to(c.values.dtype), c.validity, ct).canonicalized()
        if isinstance(ct, T.DecimalType):
            # round the unscaled value to a multiple of 10**(s - d), then
            # drop the digits below the result's scale
            s = self.children[0].dtype.scale
            out = c.values
            if s - d > 18:       # |value| < 10**18: every value rounds to 0
                out = torch.zeros_like(out)
            elif s - d > 0:
                out = self._int_round(out, 10 ** (s - d))
                out = torch.div(out, 10 ** (s - ct.scale),
                                rounding_mode="trunc")
            ok = out.abs() < 10 ** ct.precision
            return Col(out, c.validity & ok, ct).canonicalized()
        return self._round_fractional(c, ct, d)

    def _round_fractional(self, c: Col, ct, d: int) -> Col:
        x = c.values.to(torch.float64)
        scale = 10.0 ** d
        y = x.abs() * scale
        f = torch.floor(y)
        frac = y - f
        # y >= 2^52 is integral already (and so is an infinite y): x stays
        big = ~torch.isfinite(y) | (y >= 2.0 ** 52)
        near_tie = ((frac - 0.5).abs() <= 1e-9 * torch.clamp(y, min=1.0)) \
            & c.validity & torch.isfinite(x) & ~big
        out = self._device_round(x, y, f, frac, scale)
        n_near = int(near_tie.sum())
        if n_near:
            idx = torch.nonzero(near_tie).flatten()
            host = x[idx].cpu().tolist()
            fixed = torch.tensor(
                [_spark_round_host(v, d, self.mode) for v in host],
                dtype=torch.float64, device=x.device)
            out = out.index_put((idx,), fixed)
        out = torch.where(big, x, out)
        return Col(out.to(c.values.dtype), c.validity, ct).canonicalized()

    def _device_round(self, x, y, f, frac, scale):
        mag = torch.where(frac >= 0.5, f + 1.0, f)
        return torch.where(x < 0, -mag, mag) / scale

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r}, {self.digits})"


class BRound(Round):
    """bround(x, d): HALF_EVEN (banker's) rounding, by the same routes."""

    mode = ROUND_HALF_EVEN

    def _int_round(self, v, div):
        q = torch.div(v, div, rounding_mode="floor")
        rem = v - q * div
        twice = rem * 2
        up = (twice > div) | ((twice == div) & (q % 2 != 0))
        return (q + up.to(q.dtype)) * div

    def _device_round(self, x, y, f, frac, scale):
        odd = torch.remainder(f, 2.0) == 1.0
        up = (frac > 0.5) | ((frac == 0.5) & odd)
        mag = torch.where(up, f + 1.0, f)
        return torch.where(x < 0, -mag, mag) / scale
