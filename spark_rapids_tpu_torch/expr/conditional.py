"""Conditional expressions — counterpart of ``spark_rapids_tpu/expr/conditional.py``.

``If``, ``CaseWhen`` (folded right to left into nested ``If``; no ELSE
gives null) and ``Least``/``Greatest`` (nulls skipped, null only when every
input is null; NaN greater than every number). The result type is the
common type of the branches (``_common_type``, through ``promote``). A null
or false predicate takes the else branch, as in Spark.

String branches meet on one sorted union dictionary (``ops/strings.
align_many``, the reference's ``union_dictionaries``), so codes from two
dictionaries never mix. Branches that are arrays, structs or maps must
share one type; each row is then gathered from its branch's column
(``ops/nested.select_rows``, one gather over the branches'
concatenation). ``Least``/``Greatest`` over strings are refused when the
expression is typed, so at planning: the reference would order codes of
two unaligned dictionaries.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression, Literal


def _common_type(types):
    from spark_rapids_tpu_torch.expr.arithmetic import promote
    out = None
    for t in types:
        out = t if out is None else (promote(out, t) if out != t else out)
    return out


def _branch_type(types):
    """The common type of the branches (an untyped NULL takes the others');
    a string with anything but a string is refused (``promote`` knows no
    such pair)."""
    types = [t for t in types if not isinstance(t, T.NullType)] or [T.NULL]
    if any(T.is_nested(t) for t in types):
        if any(t != types[0] for t in types):
            raise NotImplementedError(
                f"conditional over {types} is not ported (nested branches "
                "share one type)")
        return types[0]
    strs = [isinstance(t, T.StringType) for t in types]
    if any(strs):
        if not all(strs):
            raise NotImplementedError(
                f"conditional over {types} is not ported yet")
        return T.STRING
    return _common_type(types)


class If(Expression):
    def __init__(self, pred, then, other):
        self.children = [pred, then, other]

    @property
    def dtype(self):
        if not isinstance(self.children[0].dtype, T.BooleanType):
            raise NotImplementedError(
                f"if over a {self.children[0].dtype} predicate is not "
                "ported yet")
        return _branch_type([self.children[1].dtype,
                             self.children[2].dtype])

    def with_children(self, children):
        return If(children[0], children[1], children[2])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        out_t = self.dtype
        p = self.children[0].eval(ctx)
        take_a = p.values & p.validity   # a null predicate takes the else
        a = self.children[1].eval(ctx)
        b = self.children[2].eval(ctx)
        if T.is_nested(out_t):
            from spark_rapids_tpu_torch.ops import nested as N
            a, b = _cast_col(a, out_t), _cast_col(b, out_t)
            choice = torch.where(take_a, 0, 1)
            return Col.from_vector(N.select_rows(
                [a.nested, b.nested], choice, ctx.num_rows, ctx.capacity))
        if isinstance(out_t, T.StringType):
            from spark_rapids_tpu_torch.ops.strings import align_many
            a, b = align_many([_cast_col(a, out_t), _cast_col(b, out_t)])
            validity = torch.where(take_a, a.validity, b.validity)
            vals = torch.where(take_a, a.values, b.values)
            return Col(torch.where(validity, vals, torch.zeros_like(vals)),
                       validity, T.STRING, a.dictionary)
        a, b = _cast_col(a, out_t), _cast_col(b, out_t)
        vals = torch.where(take_a, a.values, b.values)
        validity = torch.where(take_a, a.validity, b.validity)
        return Col(vals, validity, out_t).canonicalized()

    def __repr__(self):
        return (f"if({self.children[0]!r}, {self.children[1]!r}, "
                f"{self.children[2]!r})")


def as_value(v) -> Expression:
    """A branch value: an expression, or a literal of anything else."""
    return v if isinstance(v, Expression) else Literal(v)


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... [ELSE e] END; branches: [(pred, value)]."""

    def __init__(self, branches, else_value=None):
        self.branches = [(p, v) for p, v in branches]
        self.else_value = else_value
        self.children = [x for pv in self.branches for x in pv] + (
            [else_value] if else_value is not None else [])

    @property
    def dtype(self):
        ts = [v.dtype for _, v in self.branches]
        if self.else_value is not None:
            ts.append(self.else_value.dtype)
        for p, _ in self.branches:
            if not isinstance(p.dtype, T.BooleanType):
                raise NotImplementedError(
                    f"case when over a {p.dtype} predicate is not ported yet")
        return _branch_type(ts)

    def with_children(self, children):
        n = len(self.branches)
        branches = [(children[2 * i], children[2 * i + 1]) for i in range(n)]
        ev = children[2 * n] if self.else_value is not None else None
        return CaseWhen(branches, ev)

    # pyspark Column chaining: F.when(p, v).when(p2, v2).otherwise(e)
    def when(self, cond, value) -> "CaseWhen":
        return CaseWhen(self.branches + [(as_value(cond), as_value(value))],
                        self.else_value)

    def otherwise(self, value) -> "CaseWhen":
        return CaseWhen(self.branches, as_value(value))

    def _as_ifs(self) -> Expression:
        out = (self.else_value if self.else_value is not None
               else Literal(None, self.dtype))
        for p, v in reversed(self.branches):
            out = If(p, v, out)
        return out

    def eval(self, ctx):
        return self._as_ifs().eval(ctx)

    def __repr__(self):
        bs = " ".join(f"WHEN {p!r} THEN {v!r}" for p, v in self.branches)
        return f"CASE {bs} ELSE {self.else_value!r} END"


class _LeastGreatest(Expression):
    def __init__(self, *children):
        self.children = list(children)

    @property
    def dtype(self):
        ts = [c.dtype for c in self.children]
        if any(isinstance(t, T.StringType) for t in ts):
            raise NotImplementedError(
                f"{type(self).__name__.lower()} over strings is not ported "
                "yet")
        return _common_type(ts)

    def with_children(self, children):
        return type(self)(*children)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        out_t = self.dtype
        cols = [_cast_col(c.eval(ctx), out_t) for c in self.children]
        out = cols[0]
        for c in cols[1:]:
            better = self.prefer(c.values, out.values)
            take_c = c.validity & (~out.validity | better)
            vals = torch.where(take_c, c.values, out.values)
            out = Col(vals, out.validity | c.validity, out_t)
        return out.canonicalized()

    @staticmethod
    def _lt(a, b):
        """a < b in Spark's total order for floats: NaN greatest."""
        if a.is_floating_point():
            return (a < b) | (torch.isnan(b) & ~torch.isnan(a))
        return a < b

    def __repr__(self):
        name = type(self).__name__.lower()
        return f"{name}({', '.join(map(repr, self.children))})"


class Least(_LeastGreatest):
    def prefer(self, cand, cur):
        return self._lt(cand, cur)


class Greatest(_LeastGreatest):
    def prefer(self, cand, cur):
        return self._lt(cur, cand)
