"""Decimal plan expressions — counterpart of
``spark_rapids_tpu/expr/decimalexprs.py`` (reference decimalExpressions.scala:
GpuPromotePrecision, GpuCheckOverflow, GpuUnscaledValue, GpuMakeDecimal).

A decimal is its unscaled int64 (precision <= 18).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.cast import cast_col
from spark_rapids_tpu_torch.expr.core import Col, Expression


def _fits(v: torch.Tensor, precision: int) -> torch.Tensor:
    limit = 10 ** precision
    return (v > -limit) & (v < limit)


class PromotePrecision(Expression):
    """A marker around a child already cast to its operation's type; with
    ``to`` it casts there."""

    def __init__(self, child, to: T.DecimalType | None = None):
        self.children = [child]
        self._to = to

    @property
    def dtype(self):
        return self._to if self._to is not None else self.children[0].dtype

    def with_children(self, children):
        return PromotePrecision(children[0], self._to)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return cast_col(c, self.dtype) if c.dtype != self.dtype else c

    def __repr__(self):
        return f"promote_precision({self.children[0]!r})"


class CheckOverflow(Expression):
    """The child at ``to``, null where its unscaled value needs more digits
    than ``to``'s precision (non-ANSI)."""

    def __init__(self, child, to: T.DecimalType,
                 null_on_overflow: bool = True):
        self.children = [child]
        self.to = to
        self.null_on_overflow = null_on_overflow

    @property
    def dtype(self):
        if not self.null_on_overflow:
            raise NotImplementedError(
                "CheckOverflow raising on overflow (ANSI) is not ported yet")
        return self.to

    def with_children(self, children):
        return CheckOverflow(children[0], self.to, self.null_on_overflow)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if c.dtype != self.to:
            c = cast_col(c, self.to)
        ok = _fits(c.values, self.to.precision)
        return Col(torch.where(ok, c.values, torch.zeros_like(c.values)),
                   c.validity & ok, self.to)

    def __repr__(self):
        return f"check_overflow({self.children[0]!r}, {self.to})"


class UnscaledValue(Expression):
    """decimal → its unscaled long."""

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        if not isinstance(self.children[0].dtype, T.DecimalType):
            raise NotImplementedError(
                f"unscaled value of a {self.children[0].dtype}")
        return T.LONG

    def with_children(self, children):
        return UnscaledValue(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(c.values.to(torch.int64), c.validity, T.LONG)

    def __repr__(self):
        return f"unscaled_value({self.children[0]!r})"


class MakeDecimal(Expression):
    """An unscaled long → decimal(precision, scale), null where it does
    not fit the precision."""

    def __init__(self, child, precision: int, scale: int,
                 null_on_overflow: bool = True):
        self.children = [child]
        self.to = T.DecimalType(precision, scale)
        self.null_on_overflow = null_on_overflow

    @property
    def dtype(self):
        if not isinstance(self.children[0].dtype, T.IntegralType):
            raise NotImplementedError(
                f"make_decimal of a {self.children[0].dtype}")
        if not self.null_on_overflow:
            raise NotImplementedError(
                "MakeDecimal raising on overflow (ANSI) is not ported yet")
        return self.to

    def with_children(self, children):
        return MakeDecimal(children[0], self.to.precision, self.to.scale,
                           self.null_on_overflow)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = c.values.to(torch.int64)
        ok = _fits(v, self.to.precision)
        return Col(torch.where(ok, v, torch.zeros_like(v)), c.validity & ok,
                   self.to)

    def __repr__(self):
        return f"make_decimal({self.children[0]!r}, {self.to})"
