"""Column-function builders — the pyspark.sql.functions facade.

Counterpart of ``spark_rapids_tpu/functions.py``, limited to what TPC-H q1
uses: ``col``, ``lit``, ``cast``, ``sum``, ``avg`` and ``count``.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as _AG
from spark_rapids_tpu_torch.expr.cast import Cast
from spark_rapids_tpu_torch.expr.core import col, lit  # noqa: F401


def _e(c):
    from spark_rapids_tpu_torch.session import _to_expr
    return _to_expr(c)


def sum(c):  # noqa: A001
    return _AG.Sum(_e(c))


def count(c=None):
    return _AG.Count(None if c is None else _e(c))


def avg(c):
    return _AG.Average(_e(c))


def cast(c, to: T.DataType):
    return Cast(_e(c), to)
