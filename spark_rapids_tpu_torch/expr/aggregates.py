"""Aggregate functions with Spark two-phase (update/merge) semantics.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py``: Sum, Count and
Average. Each names its partial-state columns (``state_types``) and how the
final value is computed from merged states (``evaluate``). The update and
merge reductions themselves are the aggregate exec's dense group sums
(``exec/aggregate.py``), which is the only group-by path ported so far.

Null semantics: COUNT(x) counts non-nulls and is never null; SUM and AVG
ignore nulls and are null iff no input was non-null; SUM of integrals is
long, of doubles double; AVG is double.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression


class AggregateFunction(Expression):
    """Declarative aggregate. ``state_types`` names the partial-state columns."""

    def __init__(self, child: Expression | None):
        if child is None:
            raise NotImplementedError(
                f"{type(self).__name__.lower()}(*) is not ported yet")
        self.children = [child]

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def state_types(self) -> list:
        raise NotImplementedError

    def evaluate(self, state_cols: list) -> Col:
        """Merged states → final value column."""
        raise NotImplementedError

    def eval(self, ctx):
        raise RuntimeError(
            "aggregate functions are evaluated by the aggregate exec")

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child!r})"


def _sum_result_type(t: T.DataType) -> T.DataType:
    if isinstance(t, T.IntegralType):
        return T.LONG
    if isinstance(t, T.DoubleType):
        return T.DOUBLE
    raise NotImplementedError(f"sum/avg over {t} is not ported yet")


class Sum(AggregateFunction):
    @property
    def dtype(self):
        return _sum_result_type(self.child.dtype)

    @property
    def state_types(self):
        return [self.dtype]

    def evaluate(self, state_cols):
        return state_cols[0].canonicalized()


class Count(AggregateFunction):
    """COUNT(expr) counts non-null rows."""

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    @property
    def state_types(self):
        return [T.LONG]

    def evaluate(self, state_cols):
        return state_cols[0]


class Average(AggregateFunction):
    """AVG: (sum, count) state; double result."""

    @property
    def dtype(self):
        _sum_result_type(self.child.dtype)
        return T.DOUBLE

    @property
    def state_types(self):
        return [_sum_result_type(self.child.dtype), T.LONG]

    def evaluate(self, state_cols):
        s_st, c_st = state_cols
        cnt = c_st.values
        ok = cnt > 0
        safe = torch.where(ok, cnt, torch.ones_like(cnt))
        vals = s_st.values.to(torch.float64) / safe
        return Col(vals, ok, self.dtype).canonicalized()

    def __repr__(self):
        return f"avg({self.child!r})"
