"""Miscellaneous expressions — counterpart of ``spark_rapids_tpu/expr/misc.py``.

Only ``ScalarSubquery`` is ported: the SQL lowering runs an uncorrelated
scalar subquery once, while the text is lowered (Spark runs subquery stages
before the query that reads them; the reference's GpuScalarSubquery
likewise carries the computed value), and the expression then behaves as a
literal of the subquery's type. The rest of the module (the input-file and
partition-id expressions, ``MonotonicallyIncreasingID``, the assertions
and UUIDs) is not ported.
"""

from __future__ import annotations

import datetime as _dt

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Expression, Literal


def device_value(v):
    """A value collected from a subquery as a literal takes it: a DATE as
    its int days."""
    if isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    return v


class ScalarSubquery(Expression):
    """The value of a subquery of one column and at most one row: NULL when
    it returns no row, an error when it returns more than one (Spark's)."""

    def __init__(self, value, dtype: T.DataType):
        self.children = []
        self.value = device_value(value)
        self._dtype = dtype

    @classmethod
    def from_table(cls, tbl, dtype: T.DataType) -> "ScalarSubquery":
        """From a subquery's collected arrow table and its column type."""
        if tbl.num_columns != 1:
            raise ValueError("a scalar subquery must return one column")
        if tbl.num_rows > 1:
            raise ValueError(
                "more than one row returned by a subquery used as an "
                "expression")     # Spark's error
        value = tbl.column(0)[0].as_py() if tbl.num_rows else None
        return cls(value, dtype)

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def eval(self, ctx):
        return Literal(self.value, self._dtype).eval(ctx)

    def __repr__(self):
        return f"scalar_subquery(={self.value!r})"
