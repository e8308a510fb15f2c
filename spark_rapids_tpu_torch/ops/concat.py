"""Batch concatenation on the device — counterpart of
``spark_rapids_tpu/ops/concat.py``. String columns are first remapped onto
one sorted union dictionary; the output lands in the capacity bucket of the
total row count with canonical defaults in the padding."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.expr.core import Col


def concat_batches(batches) -> ColumnarBatch:
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    from spark_rapids_tpu_torch.ops.strings import align_many
    schema = batches[0].schema
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    cap = bucket_capacity(total)
    out = []
    for ci in range(batches[0].num_cols):
        cols = [Col.from_vector(b.column(ci)) for b in batches]
        if cols[0].is_string:
            cols = align_many(cols)
        first = cols[0]
        v = torch.full((cap,), first.dtype.default_value(),
                       dtype=first.values.dtype, device=first.values.device)
        m = torch.zeros((cap,), dtype=torch.bool, device=first.values.device)
        off = 0
        for c, n in zip(cols, counts):
            v[off:off + n] = c.values[:n]
            m[off:off + n] = c.validity[:n]
            off += n
        out.append(Col(v, m, first.dtype, first.dictionary).to_vector())
    return ColumnarBatch(out, total, schema)
