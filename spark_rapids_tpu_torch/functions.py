"""Column-function builders — the pyspark.sql.functions facade.

Counterpart of ``spark_rapids_tpu/functions.py``, limited to what the
ported TPC-H and TPC-DS queries use: ``col``, ``lit``, ``cast``, ``sum``,
``avg`` and ``count``, ``min``, ``max``, ``first`` and ``last``, ``abs``,
and the conditionals ``when`` and ``if_``.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as _AG
from spark_rapids_tpu_torch.expr import arithmetic as _A
from spark_rapids_tpu_torch.expr import conditional as _C
from spark_rapids_tpu_torch.expr.cast import Cast
from spark_rapids_tpu_torch.expr.core import col, lit  # noqa: F401


def _e(c):
    from spark_rapids_tpu_torch.session import _to_expr
    return _to_expr(c)


def sum(c):  # noqa: A001
    return _AG.Sum(_e(c))


def count(c=None):
    return _AG.Count(None if c is None else _e(c))


def min(c):  # noqa: A001
    return _AG.Min(_e(c))


def max(c):  # noqa: A001
    return _AG.Max(_e(c))


def avg(c):
    return _AG.Average(_e(c))


def first(c, ignore_nulls: bool = False):
    return _AG.First(_e(c), ignore_nulls)


def last(c, ignore_nulls: bool = False):
    return _AG.Last(_e(c), ignore_nulls)


def abs(c):  # noqa: A001
    return _A.Abs(_e(c))


# a value position takes a non-expression as a literal (the pyspark
# convention: only the first argument reads a string as a column name)
def when(cond, value):
    return _C.CaseWhen([(_e(cond), _C.as_value(value))])


def if_(cond, a, b):
    return _C.If(_e(cond), _C.as_value(a), _C.as_value(b))


def cast(c, to: T.DataType):
    return Cast(_e(c), to)
