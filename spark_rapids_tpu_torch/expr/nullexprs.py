"""Null-handling expressions — counterpart of
``spark_rapids_tpu/expr/nullexprs.py`` (reference nullExpressions.scala:
GpuIsNull, GpuIsNotNull, GpuCoalesce, GpuIsNan, GpuNaNvl, GpuNvl and
AtLeastNNonNulls).

``Coalesce`` takes the common type of its children (``promote``); string
children meet on one sorted union dictionary first, so the codes it
returns index one dictionary. The untyped null literal (Spark's NullType)
is not ported, so every child has a type.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression


def _live(ctx):
    return torch.arange(ctx.capacity, device=ctx.device) < ctx.num_rows


class IsNull(Expression):
    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return IsNull(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(~c.validity & _live(ctx), torch.ones_like(c.validity),
                   T.BOOLEAN)

    def __repr__(self):
        return f"isnull({self.children[0]!r})"


class IsNotNull(Expression):
    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return IsNotNull(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(c.validity.clone(), torch.ones_like(c.validity), T.BOOLEAN)

    def __repr__(self):
        return f"isnotnull({self.children[0]!r})"


class IsNaN(Expression):
    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return IsNaN(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return Col(torch.isnan(c.values) & c.validity,
                   torch.ones_like(c.validity), T.BOOLEAN)

    def __repr__(self):
        return f"isnan({self.children[0]!r})"


class Coalesce(Expression):
    """The first non-null child value of each row."""

    def __init__(self, *children):
        self.children = list(children)

    @property
    def dtype(self):
        from spark_rapids_tpu_torch.expr.arithmetic import promote
        t = self.children[0].dtype
        for c in self.children[1:]:
            t = promote(t, c.dtype)
        return t

    def with_children(self, children):
        return Coalesce(*children)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        out_t = self.dtype
        if isinstance(out_t, T.StringType):
            from spark_rapids_tpu_torch.ops.strings import coalesce_strings
            return coalesce_strings([c.eval(ctx) for c in self.children])
        cols = [_cast_col(c.eval(ctx), out_t) for c in self.children]
        vals = cols[-1].values
        validity = cols[-1].validity
        for c in reversed(cols[:-1]):
            vals = torch.where(c.validity, c.values, vals)
            validity = c.validity | validity
        return Col(vals, validity, out_t).canonicalized()

    def __repr__(self):
        return f"coalesce({', '.join(map(repr, self.children))})"


class NaNvl(Expression):
    """nanvl(a, b): a unless a is NaN, then b."""

    def __init__(self, left, right):
        self.children = [left, right]

    @property
    def dtype(self):
        from spark_rapids_tpu_torch.expr.arithmetic import promote
        return promote(self.children[0].dtype, self.children[1].dtype)

    def with_children(self, children):
        return NaNvl(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        out_t = self.dtype
        l = _cast_col(self.children[0].eval(ctx), out_t)
        r = _cast_col(self.children[1].eval(ctx), out_t)
        use_r = torch.isnan(l.values) & l.validity
        vals = torch.where(use_r, r.values, l.values)
        validity = torch.where(use_r, r.validity, l.validity)
        return Col(vals, validity, out_t).canonicalized()

    def __repr__(self):
        return f"nanvl({self.children[0]!r}, {self.children[1]!r})"


class AtLeastNNonNulls(Expression):
    """True when at least n children are non-null, and non-NaN for doubles
    (Spark's DropNaN semantics, the reference's AtLeastNNonNulls)."""

    def __init__(self, n: int, *children):
        self.n = int(n)
        self.children = list(children)

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, *children)

    def eval(self, ctx):
        count = torch.zeros((ctx.capacity,), dtype=torch.int32,
                            device=ctx.device)
        for ch in self.children:
            c = ch.eval(ctx)
            ok = c.validity
            if isinstance(c.dtype, T.FractionalType):
                ok = ok & ~torch.isnan(c.values)
            count = count + ok.to(torch.int32)
        return Col(count >= self.n,
                   torch.ones((ctx.capacity,), dtype=torch.bool,
                              device=ctx.device), T.BOOLEAN)

    def __repr__(self):
        return (f"atleastnnonnulls({self.n}, "
                + ", ".join(map(repr, self.children)) + ")")
