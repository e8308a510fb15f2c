"""Comparison and boolean predicates with Spark three-valued logic.

Counterpart of ``spark_rapids_tpu/expr/predicates.py``: EqualTo, NotEqual,
LessThan, LessThanOrEqual, GreaterThan, GreaterThanOrEqual, the Kleene And,
Or and Not, and In over a literal list (with InSet, its sorted form). Spark float
comparison: NaN is greater than every other value and equal to itself;
-0.0 == 0.0. Integers of different widths compare in the wider type.

String comparisons run over dictionary codes after both sides are remapped
onto one sorted union dictionary (order-preserving), so a comparison of
codes is the comparison of the strings; a string literal is a one-entry
dictionary. EqualNullSafe (``<=>``) is true where both sides are null and
never null. The untyped NULL compares as the other side's type.

Arrays and structs of one type compare for equality (``=``, ``!=``,
``<=>``) as Spark's ``ordering.equiv`` does (``ops/nested.equiv``): a null
row gives null (``<=>``: false, or true beside another null), and inside
the value two nulls, two NaNs, or -0.0 and 0.0 are equal. Spark orders no
map, and the port orders no nested value: a map comparison, and ``<``,
``<=``, ``>``, ``>=`` over a nested value, are refused when typed.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.arithmetic import _cast_col, promote
from spark_rapids_tpu_torch.expr.core import Col, Expression, valid_and
from spark_rapids_tpu_torch.ops.strings import align_many


def _operand_type(ldt: T.DataType, rdt: T.DataType) -> T.DataType:
    """The type both operands compare in; raises on a pair the port cannot
    compare (so planning refuses it)."""
    if isinstance(ldt, T.NullType):
        return rdt
    if isinstance(rdt, T.NullType):
        return ldt
    if T.is_nested(ldt) or T.is_nested(rdt):
        if ldt != rdt:
            raise NotImplementedError(
                f"comparison of {ldt!r} with {rdt!r} is not ported (nested "
                "values compare within one type)")
        return ldt
    l_str, r_str = isinstance(ldt, T.StringType), isinstance(rdt, T.StringType)
    if l_str or r_str:
        if not (l_str and r_str):
            raise NotImplementedError(
                f"comparison of {ldt} with {rdt} is not ported yet")
        return ldt
    return ldt if ldt == rdt else promote(ldt, rdt)


def _comparable(l: Col, r: Col, ldt: T.DataType, rdt: T.DataType):
    if isinstance(ldt, T.NullType) or isinstance(rdt, T.NullType):
        ct = _operand_type(ldt, rdt)
        l, r = _cast_col(l, ct), _cast_col(r, ct)
        ldt = rdt = ct
    if isinstance(ldt, T.StringType):
        # the reference's align_strings: one sorted union dictionary
        return align_many([l, r])
    if ldt == rdt:
        return l, r
    ct = _operand_type(ldt, rdt)
    return _cast_col(l, ct), _cast_col(r, ct)


def _float_total(lv, rv, op):
    """Comparison with Spark NaN semantics: NaN equals NaN and sorts above
    +inf."""
    l_nan = torch.isnan(lv)
    r_nan = torch.isnan(rv)
    if op == "eq":
        return torch.where(l_nan & r_nan, True, lv == rv)
    if op == "lt":
        return torch.where(l_nan, False, torch.where(r_nan, True, lv < rv))
    if op == "le":
        return torch.where(l_nan, r_nan, torch.where(r_nan, True, lv <= rv))
    raise AssertionError(op)


def _has_map(dt: T.DataType) -> bool:
    if isinstance(dt, T.MapType):
        return True
    if isinstance(dt, T.ArrayType):
        return _has_map(dt.element_type)
    if isinstance(dt, T.StructDataType):
        return any(_has_map(t) for t in dt.types)
    return False


class BinaryComparison(Expression):
    symbol = "?"
    #: whether the comparison takes arrays and structs (equality only)
    nested_ok = False

    def __init__(self, left, right):
        self.children = [left, right]

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def dtype(self):
        ct = _operand_type(self.left.dtype, self.right.dtype)
        if T.is_nested(ct) and (not self.nested_ok or _has_map(ct)):
            raise NotImplementedError(
                f"{self.symbol} over a {ct!r} value is not ported (arrays "
                "and structs compare for equality only; Spark orders no "
                "map)")
        return T.BOOLEAN

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        l, r = _comparable(l, r, self.left.dtype, self.right.dtype)
        validity = valid_and(l.validity, r.validity)
        if l.nested is not None:
            from spark_rapids_tpu_torch.ops.nested import equiv
            eq = equiv(l, r)
            vals = ~eq if isinstance(self, NotEqual) else eq
            return Col(vals & validity, validity, T.BOOLEAN)
        vals = self.compare(l.values, r.values,
                            isinstance(l.dtype, T.FractionalType))
        return Col(vals & validity, validity, T.BOOLEAN)

    def compare(self, lv, rv, is_float):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(BinaryComparison):
    symbol = "="
    nested_ok = True

    def compare(self, lv, rv, is_float):
        return _float_total(lv, rv, "eq") if is_float else lv == rv


class LessThan(BinaryComparison):
    symbol = "<"

    def compare(self, lv, rv, is_float):
        return _float_total(lv, rv, "lt") if is_float else lv < rv


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def compare(self, lv, rv, is_float):
        return _float_total(lv, rv, "le") if is_float else lv <= rv


class GreaterThan(BinaryComparison):
    symbol = ">"

    def compare(self, lv, rv, is_float):
        return _float_total(rv, lv, "lt") if is_float else lv > rv


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def compare(self, lv, rv, is_float):
        return _float_total(rv, lv, "le") if is_float else lv >= rv


class EqualNullSafe(BinaryComparison):
    """``<=>``: null <=> null is true, a null and a value false; never
    null."""
    symbol = "<=>"
    nested_ok = True

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        l, r = _comparable(l, r, self.left.dtype, self.right.dtype)
        if l.nested is not None:
            from spark_rapids_tpu_torch.ops.nested import equiv
            vals = equiv(l, r)
            return Col(vals, torch.ones_like(vals), T.BOOLEAN)
        both = valid_and(l.validity, r.validity)
        eq = (_float_total(l.values, r.values, "eq")
              if isinstance(l.dtype, T.FractionalType)
              else l.values == r.values)
        vals = (both & eq) | (~l.validity & ~r.validity)
        return Col(vals, torch.ones_like(vals), T.BOOLEAN)


class NotEqual(BinaryComparison):
    symbol = "!="
    nested_ok = True

    def compare(self, lv, rv, is_float):
        eq = _float_total(lv, rv, "eq") if is_float else lv == rv
        return ~eq


class And(Expression):
    """Kleene AND: F & x = F; T & null = null."""

    def __init__(self, left, right):
        self.children = [left, right]

    @property
    def dtype(self):
        return T.BOOLEAN

    def with_children(self, children):
        return And(children[0], children[1])

    def eval(self, ctx):
        l = self.children[0].eval(ctx)
        r = self.children[1].eval(ctx)
        lv = l.values & l.validity
        rv = r.values & r.validity
        false_l = l.validity & ~l.values
        false_r = r.validity & ~r.values
        vals = lv & rv
        validity = (l.validity & r.validity) | false_l | false_r
        return Col(vals & validity, validity, T.BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} AND {self.children[1]!r})"


class Or(Expression):
    """Kleene OR: T | x = T; F | null = null."""

    def __init__(self, left, right):
        self.children = [left, right]

    @property
    def dtype(self):
        return T.BOOLEAN

    def with_children(self, children):
        return Or(children[0], children[1])

    def eval(self, ctx):
        l = self.children[0].eval(ctx)
        r = self.children[1].eval(ctx)
        true_l = l.validity & l.values
        true_r = r.validity & r.values
        vals = true_l | true_r
        validity = (l.validity & r.validity) | true_l | true_r
        return Col(vals & validity, validity, T.BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} OR {self.children[1]!r})"


class Not(Expression):
    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        return T.BOOLEAN

    def with_children(self, children):
        return Not(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(~c.values & c.validity, c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"(NOT {self.children[0]!r})"


def _value_at(v, dtype: T.DataType):
    """An IN value as a literal of the column's type, or None where that
    type cannot hold it: Spark compares both in their common type, so such
    a value matches no row. An int against a decimal is that number (a
    decimal ``Literal`` takes an int as the unscaled value); ``1.505``
    against a decimal of scale 2, or ``3.5`` against an integer, is no
    value of the column."""
    if isinstance(v, (str, bool)):
        return v
    if isinstance(dtype, T.DecimalType):
        from decimal import Decimal
        d = Decimal(v) if isinstance(v, int) else Decimal(str(v))
        return d if d == d.quantize(Decimal(1).scaleb(-dtype.scale)) \
            else None
    if isinstance(dtype, T.IntegralType) and \
            not isinstance(v, int):
        return int(v) if float(v).is_integer() else None
    if isinstance(dtype, T.DoubleType):
        return float(v)
    return v


class In(Expression):
    """IN over a literal list (reference GpuInSet). Null semantics: x IN
    (...) is null if x is null, or if nothing matches and the list holds a
    null. Each value compares at the column's type (``_value_at``)."""

    def __init__(self, child, values: list):
        self.children = [child]
        self.values = values

    @property
    def dtype(self):
        # each value becomes a literal of the child's type
        is_str = isinstance(self.children[0].dtype, T.StringType)
        if any(isinstance(v, str) != is_str
               for v in self.values if v is not None):
            raise NotImplementedError(
                f"IN over {self.children[0].dtype} with values "
                f"{self.values!r} is not ported yet")
        return T.BOOLEAN

    def with_children(self, children):
        return In(children[0], self.values)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.core import Literal
        c = self.children[0].eval(ctx)
        has_null = any(v is None for v in self.values)
        match = torch.zeros_like(c.validity)
        for v in self.values:
            if v is None:
                continue
            v = _value_at(v, c.dtype)
            if v is None:
                continue
            lc = Literal(v, c.dtype).eval(ctx)
            if c.is_string:
                l2, r2 = _comparable(c, lc, c.dtype, lc.dtype)
                match = match | (l2.values == r2.values)
            else:
                match = match | (c.values == lc.values)
        validity = c.validity & (match | (not has_null))
        return Col(match & validity, validity, T.BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} IN {self.values!r})"


class InSet(In):
    """Literal-set membership (reference GpuInSet): In over the values in
    a canonical order, as Spark plans a long IN list."""

    def __init__(self, child, values):
        super().__init__(child, sorted(values, key=lambda v: (v is None,
                                                              repr(v))))
