"""Miscellaneous expressions — counterpart of ``spark_rapids_tpu/expr/misc.py``.

Ported: ``Murmur3Hash`` (Spark's ``hash()``) and ``ScalarSubquery``. The
SQL lowering runs an uncorrelated scalar subquery once, while the text is
lowered (Spark runs subquery stages before the query that reads them; the
reference's GpuScalarSubquery likewise carries the computed value), and the
expression then behaves as a literal of the subquery's type. ``Rand``,
``SparkPartitionID``, ``MonotonicallyIncreasingID`` and the input-file
expressions are not ported.
"""

from __future__ import annotations

import datetime as _dt

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression, Literal


def device_value(v):
    """A value collected from a subquery as a literal takes it: a DATE as
    its int days, a TIMESTAMP as its epoch microseconds."""
    if isinstance(v, _dt.datetime):
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        if v.tzinfo is None:
            v = v.replace(tzinfo=_dt.timezone.utc)
        return (v - epoch) // _dt.timedelta(microseconds=1)
    if isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    return v


_HASHABLE = (T.BooleanType, T.NumericType, T.StringType, T.DateType,
             T.TimestampType)


def _spark_float_bits(c: Col) -> Col:
    """A float or double column as the int or long whose hash Spark takes:
    ``floatToIntBits``/``doubleToLongBits``, with -0.0 as 0.0 (Spark 3.2+,
    SPARK-35207) and NaN canonical. Subnormals keep their bits (the
    exchange's partitioner flushes them to 0, as the JAX package's XLA
    does)."""
    from spark_rapids_tpu_torch.ops.hashing import double_to_long_bits
    v = c.values
    v = torch.where(v == 0, torch.zeros_like(v), v)     # -0.0 → 0.0
    if v.dtype == torch.float32:
        bits = v.view(torch.int32)
        bits = torch.where(torch.isnan(v), torch.full_like(bits, 0x7fc00000),
                           bits)
        return Col(bits, c.validity, T.INT)
    return Col(double_to_long_bits(v), c.validity, T.LONG)


class Murmur3Hash(Expression):
    """hash(c1, c2, ...): Spark's Murmur3Hash with seed 42, an int never
    null. Each column's hash seeds the next; a null leaves the running hash
    as it is. Strings hash their UTF-8 bytes through the ``murmur3_words``
    kernel (``ops/hashing.py``), the row hash the exchange's partitioner
    uses (``shuffle/partitioning.murmur3_row_hash``); a byte, short, int,
    date or boolean hashes as an int, a long, timestamp or decimal
    (p <= 18: its unscaled long) as a long."""

    def __init__(self, *children, seed: int = 42):
        self.children = list(children)
        self.seed = seed

    @property
    def dtype(self):
        for c in self.children:
            if not isinstance(c.dtype, _HASHABLE):
                raise NotImplementedError(
                    f"hash of a {c.dtype} is not ported yet")
        return T.INT

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return Murmur3Hash(*children, seed=self.seed)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
        from spark_rapids_tpu_torch.shuffle.partitioning import \
            murmur3_row_hash
        cols, words = [], {}
        for i, e in enumerate(self.children):
            c = e.eval(ctx)
            if isinstance(c.dtype, T.FractionalType):
                c = _spark_float_bits(c)
            elif c.is_string:
                words[i] = TorchColumnVector(
                    T.STRING, c.values, c.validity,
                    c.dictionary).dictionary_words()
            cols.append(c)
        h = murmur3_row_hash(cols, ctx.capacity, seed=self.seed,
                             dict_words=words)
        return Col(h, torch.ones((ctx.capacity,), dtype=torch.bool,
                                 device=ctx.device), T.INT)

    def __repr__(self):
        return f"hash({', '.join(map(repr, self.children))})"


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
