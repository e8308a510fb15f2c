"""Expression trees evaluated over torch tensors.

Counterpart of ``spark_rapids_tpu/expr/core.py``. ``Expression.eval`` runs
eager torch ops over a ``Col`` (values + validity). Null semantics are
Spark's: null in, null out for arithmetic and comparisons, Kleene AND.

Only the expressions of the ported slices (the TPC-H ladder and its SQL
text, the TPC-DS DataFrame queries) exist; the operators that would build any other expression raise
``NotImplementedError`` where the expression is built.
"""

from __future__ import annotations

import typing

import torch

from spark_rapids_tpu_torch import types as T


class Col:
    """A column value during evaluation: padded values + validity, the dtype,
    and (for strings) the host dictionary."""

    __slots__ = ("values", "validity", "dtype", "dictionary")

    def __init__(self, values: torch.Tensor, validity: torch.Tensor,
                 dtype: T.DataType, dictionary=None):
        self.values = values
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary

    @staticmethod
    def from_vector(cv):
        return Col(cv.data, cv.validity, cv.dtype, cv.dictionary)

    def to_vector(self):
        from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
        return TorchColumnVector(self.dtype, self.values, self.validity,
                                 self.dictionary)

    @property
    def is_string(self):
        return isinstance(self.dtype, T.StringType)

    def canonicalized(self):
        """Force invalid slots to the dtype default."""
        default = torch.tensor(self.dtype.default_value(),
                               dtype=self.values.dtype,
                               device=self.values.device)
        return Col(torch.where(self.validity, self.values, default),
                   self.validity, self.dtype, self.dictionary)


def valid_and(*validities):
    out = validities[0]
    for v in validities[1:]:
        out = out & v
    return out


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class Expression:
    """Base expression. Subclasses define ``dtype``, ``children`` and ``eval``."""

    children: typing.Sequence["Expression"] = ()

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx: "EvalContext") -> Col:
        raise NotImplementedError

    def transform(self, fn):
        """Bottom-up transform returning a new tree."""
        new_children = [c.transform(fn) for c in self.children]
        node = self.with_children(new_children) if new_children else self
        return fn(node)

    def with_children(self, children):
        return self

    def collect(self, pred):
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    @property
    def name(self):
        return str(self)

    # -- pyspark-Column-style operator sugar ---------------------------------
    def _bin(self, other, cls, swap=False):
        o = other if isinstance(other, Expression) else Literal(other)
        return cls(o, self) if swap else cls(self, o)

    def __add__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Add
        return self._bin(other, Add)

    def __radd__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Add
        return self._bin(other, Add, swap=True)

    def __sub__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Subtract
        return self._bin(other, Subtract)

    def __rsub__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Subtract
        return self._bin(other, Subtract, swap=True)

    def __mul__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Multiply
        return self._bin(other, Multiply)

    def __rmul__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Multiply
        return self._bin(other, Multiply, swap=True)

    def __eq__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import EqualTo
        return self._bin(other, EqualTo)

    def __lt__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import LessThan
        return self._bin(other, LessThan)

    def __le__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import LessThanOrEqual
        return self._bin(other, LessThanOrEqual)

    def __gt__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import GreaterThan
        return self._bin(other, GreaterThan)

    def __ge__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import GreaterThanOrEqual
        return self._bin(other, GreaterThanOrEqual)

    def __and__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import And
        return self._bin(other, And)

    def __ne__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import NotEqual
        return self._bin(other, NotEqual)

    def __or__(self, other):
        from spark_rapids_tpu_torch.expr.predicates import Or
        return self._bin(other, Or)

    def __invert__(self):
        from spark_rapids_tpu_torch.expr.predicates import Not
        return Not(self)

    def __truediv__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        return self._bin(other, Divide)

    def __rtruediv__(self, other):
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        return self._bin(other, Divide, swap=True)

    def __neg__(self):
        from spark_rapids_tpu_torch.expr.arithmetic import UnaryMinus
        return UnaryMinus(self)

    __hash__ = object.__hash__

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def isin(self, *values):
        """col.isin(a, b, ...) or col.isin([a, b]) (pyspark Column.isin)."""
        from spark_rapids_tpu_torch.expr.predicates import InSet
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return InSet(self, list(values))


class EvalContext:
    """Input columns for bound-reference lookup, the live row count, the
    batch capacity and the device that literals materialize on."""

    def __init__(self, cols, num_rows: int, capacity: int, device):
        self.cols = list(cols)
        self.num_rows = num_rows
        self.capacity = capacity
        self.device = torch.device(device)

    @staticmethod
    def from_batch(batch, device):
        return EvalContext([Col.from_vector(c) for c in batch.columns],
                           batch.num_rows, batch.capacity, device)


class AttributeReference(Expression):
    """Named column reference, resolved to a BoundReference before execution."""

    def __init__(self, name: str, dtype: T.DataType = None,
                 nullable: bool = True):
        self._name = name
        self._dtype = dtype
        self._nullable = nullable

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    @property
    def name(self):
        return self._name

    def eval(self, ctx):
        raise RuntimeError(
            f"unresolved attribute {self._name}; bind_references first")

    def __repr__(self):
        return f"'{self._name}"


class BoundReference(Expression):
    def __init__(self, ordinal: int, dtype: T.DataType, nullable: bool = True,
                 name: str = None):
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable
        self._name = name or f"input[{ordinal}]"

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    @property
    def name(self):
        return self._name

    def eval(self, ctx):
        return ctx.cols[self.ordinal]

    def __repr__(self):
        return f"input[{self.ordinal}:{self._dtype}]"


def _infer_literal_type(v):
    if isinstance(v, bool):
        return T.BOOLEAN
    if isinstance(v, int):
        return T.INT if -(2**31) <= v < 2**31 else T.LONG
    if isinstance(v, float):
        return T.DOUBLE
    if isinstance(v, str):
        return T.STRING
    raise NotImplementedError(f"literal {v!r} is not ported yet")


class Literal(Expression):
    """A constant. A null takes the type it is given (CASE WHEN without ELSE
    builds one); the untyped null literal (NullType) is not ported. A
    decimal literal given as a non-integer holds its value at the type's
    scale; an int is taken as the unscaled value, as in the reference."""

    def __init__(self, value, dtype: T.DataType | None = None):
        if value is None and dtype is None:
            _not_ported("an untyped null literal")
        self.value = value
        self._dtype = dtype if dtype is not None else _infer_literal_type(value)

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def eval(self, ctx):
        cap = ctx.capacity
        dev = ctx.device
        if self.value is None:
            import pyarrow as pa
            d = (pa.array([], type=pa.string())
                 if isinstance(self._dtype, T.StringType) else None)
            return Col(torch.full((cap,), self._dtype.default_value(),
                                  dtype=self._dtype.torch_dtype, device=dev),
                       torch.zeros((cap,), dtype=torch.bool, device=dev),
                       self._dtype, d)
        ones = torch.ones((cap,), dtype=torch.bool, device=dev)
        if isinstance(self._dtype, T.StringType):
            import pyarrow as pa
            d = pa.array([self.value], type=pa.string())
            return Col(torch.zeros((cap,), dtype=torch.int32, device=dev),
                       ones, self._dtype, d)
        v = self.value
        if isinstance(self._dtype, T.DecimalType) and not isinstance(v, int):
            from decimal import Decimal
            v = int(Decimal(str(v)).scaleb(self._dtype.scale))
        vals = torch.full((cap,), v, dtype=self._dtype.torch_dtype,
                          device=dev)
        return Col(vals, ones, self._dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        self.children = [child]
        self.alias = alias

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable

    @property
    def name(self):
        return self.alias

    def eval(self, ctx):
        return self.child.eval(ctx)

    def with_children(self, children):
        return Alias(children[0], self.alias)

    def __repr__(self):
        return f"{self.child!r} AS {self.alias}"


def bind_references(expr: Expression, schema: T.StructType) -> Expression:
    """Replace AttributeReferences with BoundReferences against ``schema``."""
    def fn(node):
        if isinstance(node, AttributeReference):
            i = schema.index_of(node.name)
            f = schema[i]
            return BoundReference(i, f.data_type, f.nullable, node.name)
        return node
    return expr.transform(fn)


def col(name: str, dtype: T.DataType = None, nullable: bool = True):
    return AttributeReference(name, dtype, nullable)


def lit(value, dtype: T.DataType | None = None):
    return Literal(value, dtype)
