"""Miscellaneous expressions — counterpart of ``spark_rapids_tpu/expr/misc.py``.

Ported: ``Murmur3Hash`` (Spark's ``hash()``), ``ScalarSubquery`` and the
context expressions. The SQL lowering runs an uncorrelated scalar subquery
once, while the text is lowered (Spark runs subquery stages before the
query that reads them; the reference's GpuScalarSubquery likewise carries
the computed value), and ``functions.scalar_subquery`` runs a DataFrame's
plan once; the expression then behaves as a literal of the subquery's
type.

The context expressions read the task's ``EvalContext``:
``SparkPartitionID`` its partition, ``MonotonicallyIncreasingID`` the
partition and the row's position in it (Spark's layout), and
``InputFileName``/``InputFileBlockStart``/``InputFileBlockLength`` the
batch's scan provenance (``ColumnarBatch.metadata``). Spark, and the
planner here, allow them in a projection, a filter and an aggregate only
(``CONTEXT_SENSITIVE``). ``Rand`` draws the reference's stream bit for
bit (``ops/random.py``, threefry2x32 in torch), keyed by the seed, the
partition and the row offset.
"""

from __future__ import annotations

import datetime as _dt
import os

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

    @classmethod
    def from_dataframe(cls, df) -> "ScalarSubquery":
        """Run ``df``'s plan once, on its session's device, and take its
        one value (``functions.scalar_subquery``)."""
        return cls.from_table(df.collect(), df.schema.fields[0].data_type)

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


def _const(ctx, value, dtype: T.DataType) -> Col:
    return Col(torch.full((ctx.capacity,), value, dtype=dtype.torch_dtype,
                          device=ctx.device),
               torch.ones((ctx.capacity,), dtype=torch.bool,
                          device=ctx.device), dtype)


class _ContextExpr(Expression):
    """A leaf that reads the task's context; never null."""

    def __init__(self):
        self.children = []

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return type(self)()

    def __repr__(self):
        return self.sql_name + "()"


class SparkPartitionID(_ContextExpr):
    """spark_partition_id(): the task's partition index, an int."""

    sql_name = "spark_partition_id"

    @property
    def dtype(self):
        return T.INT

    def eval(self, ctx):
        return _const(ctx, ctx.split, T.INT)


class MonotonicallyIncreasingID(_ContextExpr):
    """monotonically_increasing_id(): ``(partition << 33) + row``, the row
    counted from the partition's first (Spark's exact layout: 31 bits of
    partition, 33 of row). The padding slots hold the default 0."""

    sql_name = "monotonically_increasing_id"

    @property
    def dtype(self):
        return T.LONG

    def eval(self, ctx):
        base = (int(ctx.split) << 33) + int(ctx.row_offset)
        idx = torch.arange(ctx.capacity, dtype=torch.int64,
                           device=ctx.device)
        live = idx < ctx.num_rows
        return Col(torch.where(live, idx + base, torch.zeros_like(idx)),
                   torch.ones((ctx.capacity,), dtype=torch.bool,
                              device=ctx.device), T.LONG)


class Rand(_ContextExpr):
    """rand(seed): uniform doubles in [0, 1), the reference's stream
    (``uniform(fold_in(PRNGKey(seed ^ (split * 0x9E3779B9)),
    row_offset), (capacity,), float64)``) bit for bit. Like the
    reference's GpuRand, not Spark's XORShiftRandom values."""

    sql_name = "rand"

    def __init__(self, seed: int = 0):
        self.children = []
        self.seed = int(seed)

    @property
    def dtype(self):
        return T.DOUBLE

    def with_children(self, children):
        return Rand(self.seed)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops import random as R
        key = R.fold_in(R.prng_key(self.seed ^ (int(ctx.split) * 0x9E3779B9)),
                        int(ctx.row_offset))
        return Col(R.uniform(key, ctx.capacity, ctx.device),
                   torch.ones((ctx.capacity,), dtype=torch.bool,
                              device=ctx.device), T.DOUBLE)

    def __repr__(self):
        return f"rand({self.seed})"


class _ScanMetaExpr(_ContextExpr):
    """The input-file family (reference GpuInputFileName,
    GpuInputFileBlockStart/Length): the value comes from the batch's scan
    provenance; a batch without it (after an exchange, a concatenation or
    a coalescing read) gives Spark's contract, ``""`` and -1."""

    meta_key = None

    def _meta_value(self, ctx):
        return (ctx.scan_meta or {}).get(self.meta_key)


class InputFileName(_ScanMetaExpr):
    sql_name = "input_file_name"
    meta_key = "input_file"

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx):
        import pyarrow as pa
        c = _const(ctx, 0, T.INT)
        return Col(c.values, c.validity, T.STRING,
                   pa.array([self._meta_value(ctx) or ""], type=pa.string()))


class InputFileBlockStart(_ScanMetaExpr):
    sql_name = "input_file_block_start"
    meta_key = "block_start"

    @property
    def dtype(self):
        return T.LONG

    def eval(self, ctx):
        v = self._meta_value(ctx)
        return _const(ctx, -1 if v is None else int(v), T.LONG)


class InputFileBlockLength(InputFileBlockStart):
    sql_name = "input_file_block_length"
    meta_key = "block_length"


#: the expressions that read the task's context; the planner admits them
#: in a projection, a filter and an aggregate only, as Spark's analyzer does
CONTEXT_SENSITIVE = (Rand, SparkPartitionID, MonotonicallyIncreasingID,
                     _ScanMetaExpr)


def is_positional(*exprs) -> bool:
    """Whether an expression reads the row's position in its partition
    (the execs then keep ``row_offset``)."""
    return any(e.collect(lambda x: isinstance(
        x, (MonotonicallyIncreasingID, Rand))) for e in exprs if e is not None)


def is_context_sensitive(*exprs) -> bool:
    """Whether an expression reads the task's context."""
    return any(e.collect(lambda x: isinstance(x, CONTEXT_SENSITIVE))
               for e in exprs if e is not None)


def is_context_free(*exprs) -> bool:
    """True when no expression reads the task's context (reference
    ``is_context_free``): the planner's test for a term it may move into
    another exec, such as a join's hoisted stream filter or projection,
    where the batch's partition, row offset and provenance are not the
    ones the term was written against."""
    return not is_context_sensitive(*exprs)


def scan_meta(path: str) -> dict:
    """The provenance of a batch read from one whole file (the reference's
    ``io/filescan._scan_meta``): the path as the scan was given it, block
    start 0, and the file's size as the block's length."""
    return {"input_file": path, "block_start": 0,
            "block_length": os.path.getsize(path)}
