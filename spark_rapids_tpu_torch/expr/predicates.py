"""Comparison and boolean predicates with Spark three-valued logic.

Counterpart of ``spark_rapids_tpu/expr/predicates.py``: LessThanOrEqual and
And. Spark float comparison: NaN is greater than every other value and equal
to itself; -0.0 == 0.0.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.arithmetic import _cast_col, promote
from spark_rapids_tpu_torch.expr.core import Col, Expression, valid_and


def _comparable(l: Col, r: Col, ldt: T.DataType, rdt: T.DataType):
    if isinstance(ldt, T.StringType) or isinstance(rdt, T.StringType):
        raise NotImplementedError("string comparisons are not ported yet")
    if ldt == rdt:
        return l, r
    ct = promote(ldt, rdt)
    return _cast_col(l, ct), _cast_col(r, ct)


def _float_le(lv, rv):
    """<= with Spark NaN semantics: NaN equals NaN and sorts above +inf."""
    l_nan = torch.isnan(lv)
    r_nan = torch.isnan(rv)
    return torch.where(l_nan, r_nan, torch.where(r_nan, True, lv <= rv))


class BinaryComparison(Expression):
    symbol = "?"

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
        return T.BOOLEAN

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        l, r = _comparable(l, r, self.left.dtype, self.right.dtype)
        validity = valid_and(l.validity, r.validity)
        vals = self.compare(l.values, r.values,
                            isinstance(l.dtype, T.FractionalType))
        return Col(vals & validity, validity, T.BOOLEAN)

    def compare(self, lv, rv, is_float):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def compare(self, lv, rv, is_float):
        return _float_le(lv, rv) if is_float else lv <= rv


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
