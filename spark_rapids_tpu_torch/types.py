"""Spark SQL data types with their torch device representations.

Counterpart of ``spark_rapids_tpu/types.py``, limited to the types the
ported TPC-H and TPC-DS paths touch. The device layout is the JAX package's,
so buffers compare 1:1:

- fixed-width types: one padded 1-D tensor plus a bool validity tensor;
- DateType: int32 days since 1970-01-01; DoubleType: float64 (native on the card);
- DecimalType: precision <= 18, the unscaled value as int64;
- StringType: int32 codes into a host-side sorted pyarrow dictionary.
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


class IntegerType(IntegralType):
    torch_dtype = torch.int32
    sql_name = "int"


class LongType(IntegralType):
    torch_dtype = torch.int64
    sql_name = "bigint"


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


BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()

_ARROW_TO_SPARK = {
    pa.bool_(): BOOLEAN,
    pa.int32(): INT,
    pa.int64(): LONG,
    pa.float64(): DOUBLE,
    pa.string(): STRING,
    pa.large_string(): STRING,
    pa.date32(): DATE,
}

_NUMPY = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
          torch.float64: np.float64}


def from_arrow_type(at: pa.DataType) -> DataType:
    """Map an Arrow type to the Spark SQL type the engine executes with."""
    if at in _ARROW_TO_SPARK:
        return _ARROW_TO_SPARK[at]
    if pa.types.is_decimal(at):
        if at.precision > DecimalType.MAX_PRECISION:
            raise NotImplementedError(
                f"arrow type {at}: decimals above precision "
                f"{DecimalType.MAX_PRECISION} are not supported on the device")
        return DecimalType(at.precision, at.scale)
    if pa.types.is_dictionary(at):
        return from_arrow_type(at.value_type)
    raise NotImplementedError(f"arrow type {at} is not ported yet")


def to_arrow_type(dt: DataType) -> pa.DataType:
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    for a, s in _ARROW_TO_SPARK.items():
        if s == dt and a != pa.large_string():
            return a
    raise NotImplementedError(f"spark type {dt} is not ported yet")


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
