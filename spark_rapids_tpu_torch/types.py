"""Spark SQL data types with their torch device representations.

Counterpart of ``spark_rapids_tpu/types.py``: every scalar type and the
nested ArrayType, StructDataType and MapType, nested to any depth
(``array<struct<..>>``, ``array<array<..>>``, a struct of arrays, a map of
any value type); a map key stays scalar, and a nested one is refused when
the type is built, so at planning. The device layout is the JAX package's,
so buffers compare 1:1:

- fixed-width types: one padded 1-D tensor plus a bool validity tensor;
- ByteType int8, ShortType int16, IntegerType int32, LongType int64,
  FloatType float32, DoubleType float64 (all native on the card);
- DateType: int32 days since 1970-01-01; TimestampType: int64 microseconds
  since the epoch, UTC (Spark's internal representation);
- DecimalType: precision <= 18, the unscaled value as int64;
- StringType: int32 codes into a host-side sorted pyarrow dictionary;
- NullType: an int8 carrier whose every slot is invalid (the untyped NULL);
- ArrayType: ``columnar/vector.ListVector`` (int32 row lengths as ``data``,
  a flat padded element column, host row offsets); MapType: ``MapVector``
  (keys and values as two flat columns over one set of offsets);
  StructDataType: ``StructVector`` (one column a field, row validity); a
  nested element, value or field is itself such a vector.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pyarrow as pa
import torch


class DataType:
    """Base of the Spark SQL type hierarchy."""

    #: torch dtype of the device value tensor
    torch_dtype = None
    sql_name = "unknown"

    def __repr__(self):
        return self.sql_name

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def default_value(self):
        """Canonical value stored in invalid (null) and padding slots."""
        return 0


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    torch_dtype = torch.bool
    sql_name = "boolean"

    def default_value(self):
        return False


class ByteType(IntegralType):
    torch_dtype = torch.int8
    sql_name = "tinyint"


class ShortType(IntegralType):
    torch_dtype = torch.int16
    sql_name = "smallint"


class IntegerType(IntegralType):
    torch_dtype = torch.int32
    sql_name = "int"


class LongType(IntegralType):
    torch_dtype = torch.int64
    sql_name = "bigint"


class FloatType(FractionalType):
    torch_dtype = torch.float32
    sql_name = "float"

    def default_value(self):
        return 0.0


class DoubleType(FractionalType):
    torch_dtype = torch.float64
    sql_name = "double"

    def default_value(self):
        return 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class DecimalType(NumericType):
    """Decimal of precision <= 18 carried as its scaled int64 (the
    reference's DECIMAL64 bound)."""
    precision: int = 10
    scale: int = 0
    torch_dtype = torch.int64

    MAX_PRECISION = 18

    def __post_init__(self):
        if self.precision > self.MAX_PRECISION:
            raise ValueError(
                f"DecimalType precision {self.precision} > "
                f"{self.MAX_PRECISION} is not supported on the device")

    @property
    def sql_name(self):  # type: ignore[override]
        return f"decimal({self.precision},{self.scale})"

    def __repr__(self):
        return self.sql_name

    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))


class StringType(DataType):
    # int32 codes into a host-side sorted dictionary
    torch_dtype = torch.int32
    sql_name = "string"


class DateType(DataType):
    """Days since 1970-01-01, Spark's internal int32 representation."""
    torch_dtype = torch.int32
    sql_name = "date"


class TimestampType(DataType):
    """Microseconds since 1970-01-01 00:00 UTC, Spark's internal int64."""
    torch_dtype = torch.int64
    sql_name = "timestamp"


class NullType(DataType):
    """The type of the untyped NULL: an int8 carrier, every slot invalid."""
    torch_dtype = torch.int8
    sql_name = "void"


def is_nested(dt: DataType) -> bool:
    return isinstance(dt, (ArrayType, StructDataType, MapType))


def ordered_array(dt: DataType) -> bool:
    """An array of scalars or of such arrays, to any depth: the nested
    types whose order the port computes for ``min``/``max`` and a sort key
    (the reference's host comparator raises on a struct, and Spark orders
    no map)."""
    while isinstance(dt, ArrayType):
        dt = dt.element_type
        if not is_nested(dt):
            return True
    return False


def holds_map(dt: DataType) -> bool:
    """A map anywhere in the type (Spark's ``collect_set`` refuses one)."""
    if isinstance(dt, MapType):
        return True
    if isinstance(dt, ArrayType):
        return holds_map(dt.element_type)
    if isinstance(dt, StructDataType):
        return any(holds_map(t) for t in dt.types)
    return False


def _scalar_key(dt: DataType) -> DataType:
    if is_nested(dt):
        raise NotImplementedError(
            f"a map key of type {dt!r} is not ported: map keys are scalar "
            "(the reference cannot read a map column at all)")
    return dt


class ArrayType(DataType):
    """Spark ArrayType over any element type."""

    sql_name = "array"

    def __init__(self, element_type: DataType, contains_null: bool = True):
        self.element_type = element_type
        self.contains_null = contains_null

    def default_value(self):
        return None

    def __eq__(self, other):
        return (isinstance(other, ArrayType)
                and other.element_type == self.element_type)

    def __hash__(self):
        return hash(("array", self.element_type))

    def __repr__(self):
        return f"ArrayType({self.element_type!r})"


class StructDataType(DataType):
    """Spark's StructType used as a column type (``struct<...>`` values),
    fields of any type."""

    sql_name = "struct"

    def __init__(self, names: list, types: list):
        self.names = list(names)
        self.types = list(types)

    def default_value(self):
        return None

    def __eq__(self, other):
        return (isinstance(other, StructDataType)
                and other.names == self.names and other.types == self.types)

    def __hash__(self):
        return hash(("struct", tuple(self.names)))

    def __repr__(self):
        inner = ", ".join(f"{n}: {t!r}" for n, t in
                          zip(self.names, self.types))
        return f"StructDataType({inner})"


class MapType(DataType):
    """Spark MapType with scalar keys and values of any type."""

    sql_name = "map"

    def __init__(self, key_type: DataType, value_type: DataType,
                 value_contains_null: bool = True):
        self.key_type = _scalar_key(key_type)
        self.value_type = value_type
        self.value_contains_null = value_contains_null

    def default_value(self):
        return None

    def __eq__(self, other):
        return (isinstance(other, MapType)
                and other.key_type == self.key_type
                and other.value_type == self.value_type)

    def __hash__(self):
        return hash(("map", self.key_type, self.value_type))

    def __repr__(self):
        return f"map<{self.key_type!r},{self.value_type!r}>"


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

_ARROW_TO_SPARK = {
    pa.bool_(): BOOLEAN,
    pa.int8(): BYTE,
    pa.int16(): SHORT,
    pa.int32(): INT,
    pa.int64(): LONG,
    pa.float32(): FLOAT,
    pa.float64(): DOUBLE,
    pa.string(): STRING,
    pa.large_string(): STRING,
    pa.string_view(): STRING,
    pa.date32(): DATE,
    pa.null(): NULL,
}

_NUMPY = {torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
          torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32, torch.float64: np.float64}


def from_arrow_type(at: pa.DataType) -> DataType:
    """Map an Arrow type to the Spark SQL type the engine executes with."""
    if at in _ARROW_TO_SPARK:
        return _ARROW_TO_SPARK[at]
    if pa.types.is_timestamp(at):
        return TIMESTAMP
    if pa.types.is_decimal(at):
        if at.precision > DecimalType.MAX_PRECISION:
            raise NotImplementedError(
                f"arrow type {at}: decimals above precision "
                f"{DecimalType.MAX_PRECISION} are not supported on the device")
        return DecimalType(at.precision, at.scale)
    if pa.types.is_dictionary(at):
        return from_arrow_type(at.value_type)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow_type(at.value_type))
    if pa.types.is_map(at):
        return MapType(from_arrow_type(at.key_type),
                       from_arrow_type(at.item_type))
    if pa.types.is_struct(at):
        return StructDataType([at.field(i).name for i in range(at.num_fields)],
                              [from_arrow_type(at.field(i).type)
                               for i in range(at.num_fields)])
    raise NotImplementedError(
        f"arrow type {at} is not ported yet (the port reads the scalar "
        "types, and lists, maps and structs of them at any depth)")


def to_arrow_type(dt: DataType) -> pa.DataType:
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow_type(dt.element_type))
    if isinstance(dt, MapType):
        return pa.map_(to_arrow_type(dt.key_type),
                       to_arrow_type(dt.value_type))
    if isinstance(dt, StructDataType):
        return pa.struct([pa.field(n, to_arrow_type(t))
                          for n, t in zip(dt.names, dt.types)])
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, TimestampType):
        return pa.timestamp("us", tz="UTC")
    for a, s in _ARROW_TO_SPARK.items():
        if s == dt and a not in (pa.large_string(), pa.string_view()):
            return a
    raise NotImplementedError(f"spark type {dt!r} has no arrow type")


def to_numpy_dtype(dt: DataType):
    return np.dtype(_NUMPY[dt.torch_dtype])


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


class StructType:
    """Schema of a batch or plan output."""

    def __init__(self, fields):
        self.fields = tuple(fields)

    @property
    def names(self):
        return [f.name for f in self.fields]

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.fields[self.index_of(i)]
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self):
        return "StructType(" + ", ".join(
            f"{f.name}: {f.data_type!r}" for f in self.fields) + ")"

    def to_arrow(self) -> pa.Schema:
        return pa.schema([pa.field(f.name, to_arrow_type(f.data_type),
                                   f.nullable) for f in self.fields])

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "StructType":
        return StructType([StructField(f.name, from_arrow_type(f.type),
                                       f.nullable) for f in schema])
