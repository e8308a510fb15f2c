"""ColumnarBatch — a set of device columns plus a row count.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``. PyTorch runs eagerly,
so the row count is always a host int here.
"""

from __future__ import annotations

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                    bucket_capacity)


class ColumnarBatch:
    __slots__ = ("columns", "num_rows", "schema")

    def __init__(self, columns, num_rows: int,
                 schema: T.StructType | None = None):
        self.columns = list(columns)
        self.num_rows = int(num_rows)
        self.schema = schema
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

    def to_arrow(self) -> pa.Table:
        n = self.num_rows
        names = (self.schema.names if self.schema is not None
                 else [f"c{i}" for i in range(self.num_cols)])
        return pa.Table.from_arrays(
            [col.to_arrow(n) for col in self.columns], names=list(names))

    @staticmethod
    def from_arrow(table, device, schema: T.StructType | None = None):
        from spark_rapids_tpu_torch.columnar import arrow as ai
        return ai.table_to_device(table, device, schema=schema)

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows}, cols={self.num_cols}, "
                f"cap={self.capacity})")
