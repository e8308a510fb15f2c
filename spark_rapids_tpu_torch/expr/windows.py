"""Window expressions: specs, frames, ranking and offset functions.

Counterpart of ``spark_rapids_tpu/expr/windows.py`` (reference
GpuWindowExpression.scala, GpuWindowExec.scala:92). A WindowExpression pairs
a function (ranking, offset or aggregate) with a WindowSpec (partition keys,
order keys, frame). Frames follow Spark: ROWS or RANGE, with UNBOUNDED,
CURRENT or numeric offsets; Spark's default frame with an ORDER BY is RANGE
UNBOUNDED PRECEDING..CURRENT ROW. The window exec evaluates them
(``exec/window.py``).
"""

from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expr.core import Expression

UNBOUNDED = None  # sentinel for unbounded preceding/following
CURRENT = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """A rows or range frame with offsets relative to the current row:
    ``preceding`` and ``following`` are UNBOUNDED (None) or non-negative
    ints (reference GpuSpecifiedWindowFrame)."""
    frame_type: str = "range"          # "rows" | "range"
    preceding: int | None = UNBOUNDED
    following: int | None = CURRENT

    @property
    def is_unbounded_to_current(self):
        return self.preceding is UNBOUNDED and self.following == CURRENT

    @property
    def is_unbounded_both(self):
        return self.preceding is UNBOUNDED and self.following is UNBOUNDED


DEFAULT_FRAME = WindowFrame("range", UNBOUNDED, CURRENT)
FULL_FRAME = WindowFrame("rows", UNBOUNDED, UNBOUNDED)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    partition_by: tuple = ()
    order_by: tuple = ()               # ((expr, ascending, nulls_first), ...)
    frame: WindowFrame = DEFAULT_FRAME

    def with_frame(self, frame: WindowFrame) -> "WindowSpec":
        return WindowSpec(self.partition_by, self.order_by, frame)


class WindowFunction(Expression):
    """Base of the ranking and offset functions, which exist only over a
    window."""
    children: list = []

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        raise RuntimeError("window functions are evaluated by the window exec")


class RowNumber(WindowFunction):
    def __init__(self):
        self.children = []

    @property
    def dtype(self):
        return T.INT

    def with_children(self, children):
        return self

    def __repr__(self):
        return "row_number()"


class Rank(WindowFunction):
    def __init__(self):
        self.children = []

    @property
    def dtype(self):
        return T.INT

    def with_children(self, children):
        return self

    def __repr__(self):
        return "rank()"


class DenseRank(WindowFunction):
    def __init__(self):
        self.children = []

    @property
    def dtype(self):
        return T.INT

    def with_children(self, children):
        return self

    def __repr__(self):
        return "dense_rank()"


class Lead(WindowFunction):
    """lead(col, n, default): the value n rows after the current row within
    its partition (reference GpuLead)."""

    def __init__(self, child, offset: int = 1, default=None):
        self.children = [child]
        self.offset = offset
        self.default = default

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return True

    def with_children(self, children):
        return type(self)(children[0], self.offset, self.default)

    def __repr__(self):
        return (f"{type(self).__name__.lower()}({self.children[0]!r}, "
                f"{self.offset})")


class Lag(Lead):
    pass


class WindowExpression(Expression):
    """func OVER spec (reference GpuWindowExpression)."""

    def __init__(self, func: Expression, spec: WindowSpec):
        assert isinstance(func, (WindowFunction, AggregateFunction)), func
        self.func = func
        self.spec = spec
        # the children are the function's inputs AND the spec's partition
        # and order expressions, so bind_references rewrites all of them
        self._n_func = len(getattr(func, "children", []))
        self.children = (list(getattr(func, "children", []))
                         + [e for e in spec.partition_by]
                         + [e for (e, _, _) in spec.order_by])

    @property
    def dtype(self):
        return self.func.dtype

    @property
    def nullable(self):
        return not isinstance(self.func, (RowNumber, Rank, DenseRank))

    def with_children(self, children):
        nf = self._n_func
        f = self.func.with_children(children[:nf]) if nf else self.func
        np_ = len(self.spec.partition_by)
        parts = tuple(children[nf:nf + np_])
        orders = tuple(
            (c, asc, nfirst) for c, (_, asc, nfirst)
            in zip(children[nf + np_:], self.spec.order_by))
        return WindowExpression(f, WindowSpec(parts, orders, self.spec.frame))

    def eval(self, ctx):
        raise RuntimeError(
            "window expressions are evaluated by the window exec")

    def __repr__(self):
        return f"{self.func!r} OVER {self.spec}"
