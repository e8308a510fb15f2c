"""ColumnarBatch — a set of device columns plus a row count.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``. PyTorch runs eagerly,
so the row count is always a host int here.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                    bucket_capacity)


def empty_vector(dtype: T.DataType, capacity: int, device):
    """A column of ``capacity`` padding slots and no row: every slot null and
    at its default; a string column has an empty dictionary, a nested one
    no element."""
    from spark_rapids_tpu_torch.columnar import arrow as ai
    return ai.array_to_device(pa.nulls(0, T.to_arrow_type(dtype)), dtype,
                              capacity, device)


class ColumnarBatch:
    """``metadata`` is the scan provenance of a batch read from one file
    (``{"input_file", "block_start", "block_length"}``, which the
    input-file expressions read), or None; every scan route sets it, the
    execs that pass a batch through keep it, and every other batch (after
    an exchange, a concatenation or a coalescing read) has none."""

    __slots__ = ("columns", "num_rows", "schema", "metadata")

    def __init__(self, columns, num_rows: int,
                 schema: T.StructType | None = None,
                 metadata: dict | None = None):
        self.columns = list(columns)
        self.num_rows = int(num_rows)
        self.schema = schema
        self.metadata = metadata
        if self.columns:
            cap = self.columns[0].capacity
            if any(c.capacity != cap for c in self.columns):
                raise ValueError(
                    "all columns in a batch must share one padded capacity")

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    @property
    def capacity(self) -> int:
        return (self.columns[0].capacity if self.columns
                else bucket_capacity(self.num_rows))

    def column(self, i: int) -> TorchColumnVector:
        return self.columns[i]

    def device_memory_size(self) -> int:
        return sum(c.device_memory_size() for c in self.columns)

    def to_arrow(self) -> pa.Table:
        n = self.num_rows
        names = (self.schema.names if self.schema is not None
                 else [f"c{i}" for i in range(self.num_cols)])
        return pa.Table.from_arrays(
            [col.to_arrow(n) for col in self.columns], names=list(names))

    @staticmethod
    def empty(schema: T.StructType, device) -> "ColumnarBatch":
        """A batch of no rows (the smallest capacity) with ``schema``'s
        columns; a string column has an empty dictionary."""
        return ColumnarBatch([empty_vector(f.data_type, bucket_capacity(0),
                                           device) for f in schema], 0, schema)

    @staticmethod
    def from_arrow(table, device, schema: T.StructType | None = None):
        from spark_rapids_tpu_torch.columnar import arrow as ai
        return ai.table_to_device(table, device, schema=schema)

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows}, cols={self.num_cols}, "
                f"cap={self.capacity})")
