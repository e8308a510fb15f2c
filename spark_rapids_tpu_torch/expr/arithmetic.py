"""Arithmetic expressions with Spark semantics (non-ANSI mode).

Counterpart of ``spark_rapids_tpu/expr/arithmetic.py``: Add, Subtract and
Multiply over int/long/double. Integers wrap like Java (two's complement,
which torch shares); the result type follows Spark's numeric precedence
int < long < double.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression, valid_and

_NUMERIC_ORDER = [T.IntegerType, T.LongType, T.DoubleType]


def promote(a: T.DataType, b: T.DataType) -> T.DataType:
    if a == b:
        return a
    if type(a) not in _NUMERIC_ORDER or type(b) not in _NUMERIC_ORDER:
        raise NotImplementedError(f"arithmetic on {a} and {b} is not ported yet")
    ia = _NUMERIC_ORDER.index(type(a))
    ib = _NUMERIC_ORDER.index(type(b))
    return a if ia >= ib else b


def _cast_col(c: Col, to: T.DataType) -> Col:
    if c.dtype == to:
        return c
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


class Multiply(BinaryArithmetic):
    symbol = "*"

    def op(self, lv, rv):
        return lv * rv
