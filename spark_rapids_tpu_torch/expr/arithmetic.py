"""Arithmetic expressions with Spark semantics (non-ANSI mode).

Counterpart of ``spark_rapids_tpu/expr/arithmetic.py``: Add, Subtract,
Multiply, Divide, IntegralDivide (``div``), Remainder (``%``) and Pmod over
every numeric type and decimals, UnaryMinus, UnaryPositive, Abs, and the
bitwise operators and shifts over the integral types (``BitwiseAnd``,
``BitwiseOr``, ``BitwiseXor``, ``BitwiseNot``, ``ShiftLeft``,
``ShiftRight``, ``ShiftRightUnsigned``; Java semantics, the shift count
masked to 31 or 63). Integers wrap like Java (two's complement, which torch
shares), a tinyint or smallint result too; the result type follows Spark's
numeric precedence byte < short < int < long < float < double. Decimals
follow the reference's simplified promotion (``promote``: the wider
integral digits and the larger scale; an integral operand takes the
decimal's type, a float or double makes the result a double) and its
multiply and divide typing (``decimal_mul_type``, ``decimal_div_type``:
Spark's ``DecimalPrecision`` capped at precision 18), HALF_UP when the
result's scale drops and null on overflow. Divide is Spark's: a double for
non-decimal operands, and null on a zero divisor, doubles included; ``div``
is a long truncated toward zero, ``%`` takes the dividend's sign and pmod
the divisor's, each null on a zero divisor.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression, valid_and

_NUMERIC_ORDER = [T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.FloatType, T.DoubleType]


_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)
_INT_DIGITS = {T.ByteType: 3, T.ShortType: 5, T.IntegerType: 10,
               T.LongType: 18}


def promote(a: T.DataType, b: T.DataType) -> T.DataType:
    if a == b:
        return a
    if isinstance(a, T.NullType):   # the untyped NULL takes any type
        return b
    if isinstance(b, T.NullType):
        return a
    if {type(a), type(b)} == {T.DateType, T.TimestampType}:
        return T.TIMESTAMP      # a date meets a timestamp at its midnight
    if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
        da = a if isinstance(a, T.DecimalType) else None
        db = b if isinstance(b, T.DecimalType) else None
        if da and db:
            scale = max(da.scale, db.scale)
            prec = min(T.DecimalType.MAX_PRECISION,
                       max(da.precision - da.scale,
                           db.precision - db.scale) + scale)
            return T.DecimalType(prec, scale)
        other = b if da else a
        if isinstance(other, _INTEGRAL):
            return da or db
        if isinstance(other, T.FractionalType):
            return T.DOUBLE
        raise NotImplementedError(
            f"arithmetic on {a} and {b} is not ported yet")
    if type(a) not in _NUMERIC_ORDER or type(b) not in _NUMERIC_ORDER:
        raise NotImplementedError(f"arithmetic on {a} and {b} is not ported yet")
    ia = _NUMERIC_ORDER.index(type(a))
    ib = _NUMERIC_ORDER.index(type(b))
    return a if ia >= ib else b


def _as_dec(t: T.DataType) -> T.DecimalType | None:
    if isinstance(t, T.DecimalType):
        return t
    d = _INT_DIGITS.get(type(t))
    return T.DecimalType(d, 0) if d is not None else None


def _dec_adjust(p: int, s: int) -> T.DecimalType:
    """Spark adjustPrecisionScale with a maximum precision of 18: when the
    ideal precision overflows, keep the integral digits and at least
    min(scale, 6) fractional digits."""
    if p > 18:
        s = max(18 - (p - s), min(s, 6))
        p = 18
    return T.DecimalType(p, max(s, 0))


def decimal_mul_type(lt, rt):
    """Result type of a decimal multiply, or None when it is not one."""
    if not (isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType)):
        return None
    d1, d2 = _as_dec(lt), _as_dec(rt)
    if d1 is None or d2 is None:        # decimal x double -> double
        return None
    return _dec_adjust(d1.precision + d2.precision + 1, d1.scale + d2.scale)


def decimal_div_type(lt, rt):
    """Result type of a decimal divide, or None when it is not one."""
    if not (isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType)):
        return None
    d1, d2 = _as_dec(lt), _as_dec(rt)
    if d1 is None or d2 is None:        # decimal / double -> double
        return None
    s = max(6, d1.scale + d2.precision + 1)
    p = d1.precision - d1.scale + d2.scale + s
    return _dec_adjust(p, s)


def _cast_col(c: Col, to: T.DataType) -> Col:
    if c.dtype == to:
        return c
    if isinstance(c.dtype, T.NullType) and T.is_nested(to):
        # the untyped NULL as a nested value: every row null and empty
        from spark_rapids_tpu_torch.columnar.batch import empty_vector
        return Col.from_vector(empty_vector(to, c.values.shape[0],
                                            c.values.device))
    from spark_rapids_tpu_torch.expr.cast import cast_col
    return cast_col(c, to)


class BinaryArithmetic(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def dtype(self):
        return promote(self.left.dtype, self.right.dtype)

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        out_t = self.dtype
        l = _cast_col(self.left.eval(ctx), out_t)
        r = _cast_col(self.right.eval(ctx), out_t)
        validity = valid_and(l.validity, r.validity)
        vals = self.op(l.values, r.values)
        return Col(vals, validity, out_t).canonicalized()

    def op(self, lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    def op(self, lv, rv):
        return lv + rv


class Subtract(BinaryArithmetic):
    symbol = "-"

    def op(self, lv, rv):
        return lv - rv


def _round_half_up_i64(q):
    """HALF_UP (away from zero) float64 -> int64."""
    return torch.where(q >= 0, torch.floor(q + 0.5),
                       torch.ceil(q - 0.5)).to(torch.int64)


class Multiply(BinaryArithmetic):
    symbol = "*"

    @property
    def dtype(self):
        dt = decimal_mul_type(self.left.dtype, self.right.dtype)
        return dt if dt is not None else promote(self.left.dtype,
                                                 self.right.dtype)

    def eval(self, ctx):
        out_t = self.dtype
        if not isinstance(out_t, T.DecimalType):
            return super().eval(ctx)
        # the unscaled product is at scale s1 + s2, rounded HALF_UP to the
        # result's scale: exact in int64 when the ideal precision fits 18
        # digits, else through float64 (as the reference)
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        d1, d2 = _as_dec(self.left.dtype), _as_dec(self.right.dtype)
        lv = l.values.to(torch.int64)
        rv = r.values.to(torch.int64)
        drop = d1.scale + d2.scale - out_t.scale
        if d1.precision + d2.precision + 1 <= 18:
            prod = lv * rv
            if drop:
                div = 10 ** drop
                q = torch.div(prod.abs() + div // 2, div,
                              rounding_mode="floor")
                prod = torch.where(prod < 0, -q, q)
            vals = prod
            ok = vals.abs() < 10 ** out_t.precision
        else:
            qf = (lv.to(torch.float64) * rv.to(torch.float64)
                  / (10.0 ** drop))
            # the overflow check in the float domain: an out-of-range cast
            # would saturate to int64 min, whose abs is negative
            ok = qf.abs() < float(10 ** out_t.precision)
            vals = _round_half_up_i64(torch.where(ok, qf,
                                                  torch.zeros_like(qf)))
        validity = valid_and(l.validity, r.validity) & ok
        return Col(vals, validity, out_t).canonicalized()

    def op(self, lv, rv):
        return lv * rv


class Divide(BinaryArithmetic):
    """Spark Divide: a double result for non-decimal operands, null on a
    zero divisor, doubles included (reference ``Divide``, GpuDivide)."""
    symbol = "/"

    @property
    def dtype(self):
        dt = decimal_div_type(self.left.dtype, self.right.dtype)
        return dt if dt is not None else T.DOUBLE

    def eval(self, ctx):
        out_t = self.dtype
        if isinstance(out_t, T.DecimalType):
            # the float64 quotient at the result's scale, HALF_UP; null on a
            # zero divisor and on overflow (checked in the float domain, as
            # Multiply)
            l, r = self.left.eval(ctx), self.right.eval(ctx)
            d1, d2 = _as_dec(self.left.dtype), _as_dec(self.right.dtype)
            lv = l.values.to(torch.int64)
            rv = r.values.to(torch.int64)
            zero = rv == 0
            k = out_t.scale + d2.scale - d1.scale
            q = (lv.to(torch.float64)
                 / torch.where(zero, torch.ones_like(rv), rv).to(torch.float64)
                 * (10.0 ** k))
            ok = q.abs() < float(10 ** out_t.precision)
            vals = _round_half_up_i64(torch.where(ok, q, torch.zeros_like(q)))
            validity = valid_and(l.validity, r.validity) & ~zero & ok
            return Col(vals, validity, out_t).canonicalized()
        l = _cast_col(self.left.eval(ctx), out_t)
        r = _cast_col(self.right.eval(ctx), out_t)
        zero = r.values == 0
        validity = valid_and(l.validity, r.validity) & ~zero
        safe_r = torch.where(zero, torch.ones_like(r.values), r.values)
        return Col(l.values / safe_r, validity, out_t).canonicalized()


def _java_rem(a, n):
    """Java's ``%`` (the sign of the dividend): torch.fmod, with a divisor
    of -1 answered as 0 for integers (the minimum divided by -1 traps in
    C)."""
    if a.is_floating_point():
        return torch.fmod(a, n)
    m1 = n == -1
    return torch.where(m1, torch.zeros_like(a),
                       torch.fmod(a, torch.where(m1, torch.ones_like(n), n)))


class _ZeroNullArithmetic(BinaryArithmetic):
    """An integer-style operator: null where the divisor is zero."""

    @property
    def dtype(self):
        out = promote(self.left.dtype, self.right.dtype)
        if isinstance(out, T.DecimalType):
            raise NotImplementedError(
                f"{self.symbol} over decimals is not ported yet")
        if not isinstance(out, T.NumericType):
            raise NotImplementedError(
                f"{self.symbol} over {out} is not ported yet")
        return out

    def eval(self, ctx):
        out_t = promote(self.left.dtype, self.right.dtype)
        l = _cast_col(self.left.eval(ctx), out_t)
        r = _cast_col(self.right.eval(ctx), out_t)
        zero = r.values == 0
        validity = valid_and(l.validity, r.validity) & ~zero
        safe_r = torch.where(zero, torch.ones_like(r.values), r.values)
        vals = self.op(l.values, safe_r)
        return Col(vals, validity, self.dtype).canonicalized()


class IntegralDivide(_ZeroNullArithmetic):
    """``a div b``: a long, truncated toward zero (Java), null on a zero
    divisor."""
    symbol = "div"

    @property
    def dtype(self):
        super().dtype
        return T.LONG

    def op(self, lv, rv):
        if lv.is_floating_point():
            q = torch.trunc(lv / rv)
            from spark_rapids_tpu_torch.expr.cast import _float_to_integral
            return _float_to_integral(q, T.LONG)
        lv, rv = lv.to(torch.int64), rv.to(torch.int64)
        m1 = rv == -1        # the minimum over -1 wraps in Java, traps in C
        q = torch.div(lv, torch.where(m1, torch.ones_like(rv), rv),
                      rounding_mode="trunc")
        return torch.where(m1, -lv, q)


class Remainder(_ZeroNullArithmetic):
    """``a % b``: Java's remainder (the dividend's sign), null on a zero
    divisor."""
    symbol = "%"

    def op(self, lv, rv):
        return _java_rem(lv, rv)


class Pmod(_ZeroNullArithmetic):
    """pmod(a, n): ``r = a % n``; ``(r + n) % n`` when r < 0 (so a
    negative divisor gives a non-positive result, as in Spark)."""
    symbol = "pmod"

    def op(self, lv, rv):
        m = _java_rem(lv, rv)
        return torch.where(m < 0, _java_rem(m + rv, rv), m)

    def __repr__(self):
        return f"pmod({self.left!r}, {self.right!r})"


class UnaryPositive(Expression):
    """+x: the value itself."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def dtype(self):
        t = self.children[0].dtype
        if not isinstance(t, T.NumericType):
            raise NotImplementedError(f"+ of a {t} is not ported")
        return t

    def with_children(self, children):
        return UnaryPositive(children[0])

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def __repr__(self):
        return f"(+ {self.children[0]!r})"


class UnaryMinus(Expression):
    """-x of the child's type, a number (int, long, double, decimal);
    integers wrap at their minimum, as Java."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def dtype(self):
        t = self.children[0].dtype
        if not isinstance(t, T.NumericType):
            raise NotImplementedError(f"negation of a {t} is not ported")
        return t

    def with_children(self, children):
        return UnaryMinus(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(-c.values, c.validity, c.dtype).canonicalized()

    def __repr__(self):
        return f"(- {self.children[0]!r})"


class Abs(Expression):
    """abs(x) of the child's type; integers wrap at their minimum, as
    Java's Math.abs."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def dtype(self):
        return self.children[0].dtype

    def with_children(self, children):
        return Abs(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(c.values.abs(), c.validity, c.dtype,
                   c.dictionary).canonicalized()

    def __repr__(self):
        return f"abs({self.children[0]!r})"


# -- bitwise operators and shifts (reference bitwise.scala's GpuBitwiseAnd/
# Or/Xor/Not and GpuShiftLeft/Right/RightUnsigned, Java semantics) ---------

def _integral(t: T.DataType, what: str) -> T.DataType:
    if not isinstance(t, _INTEGRAL):
        raise NotImplementedError(f"{what} over a {t} is not ported")
    return t


class BitwiseBinary(BinaryArithmetic):
    @property
    def dtype(self):
        return promote(_integral(self.left.dtype, self.symbol),
                       _integral(self.right.dtype, self.symbol))


class BitwiseAnd(BitwiseBinary):
    symbol = "&"

    def op(self, lv, rv):
        return lv & rv


class BitwiseOr(BitwiseBinary):
    symbol = "|"

    def op(self, lv, rv):
        return lv | rv


class BitwiseXor(BitwiseBinary):
    symbol = "^"

    def op(self, lv, rv):
        return lv ^ rv


class BitwiseNot(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def dtype(self):
        return _integral(self.children[0].dtype, "~")

    def with_children(self, children):
        return BitwiseNot(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(~c.values, c.validity, c.dtype).canonicalized()

    def __repr__(self):
        return f"(~ {self.children[0]!r})"


class Shift(Expression):
    """base SHIFT amount: the result is a long for a long base, else an int
    (a tinyint or smallint base widens, as Spark's implicit cast), and the
    count is masked to that width as in Java (``x << 33`` is ``x << 1`` for
    an int)."""
    symbol = "?"

    def __init__(self, base: Expression, amount: Expression):
        self.children = [base, amount]

    @property
    def dtype(self):
        _integral(self.children[1].dtype, self.symbol)
        base = _integral(self.children[0].dtype, self.symbol)
        return base if isinstance(base, T.LongType) else T.INT

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        out_t = self.dtype
        b = _cast_col(self.children[0].eval(ctx), out_t)
        a = self.children[1].eval(ctx)
        width = 64 if isinstance(out_t, T.LongType) else 32
        amt = (a.values.to(torch.int64) & (width - 1)).to(b.values.dtype)
        vals = self.op(b.values, amt, width)
        return Col(vals, valid_and(b.validity, a.validity),
                   out_t).canonicalized()

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class ShiftLeft(Shift):
    symbol = "<<"

    def op(self, bv, amt, width):
        return bv << amt


class ShiftRight(Shift):
    symbol = ">>"

    def op(self, bv, amt, width):
        return bv >> amt          # arithmetic: signed integers


class ShiftRightUnsigned(Shift):
    """``>>>``: the arithmetic shift with the sign-extended high bits
    cleared (torch has no unsigned shift of every width)."""
    symbol = ">>>"

    def op(self, bv, amt, width):
        keep = torch.clamp(width - amt, max=width - 1)
        mask = (torch.ones_like(bv) << keep) - 1
        return torch.where(amt == 0, bv, (bv >> amt) & mask)
