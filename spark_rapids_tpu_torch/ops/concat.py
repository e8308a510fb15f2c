"""Batch concatenation on the device — counterpart of
``spark_rapids_tpu/ops/concat.py``. String columns are first remapped onto
one sorted union dictionary; the output lands in the capacity bucket of the
total row count with canonical defaults in the padding. Nested columns go
to ``ops/nested.concat``, which concatenates their flat element columns
here."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.expr.core import Col


def concat_cols(cols, counts, cap) -> Col:
    """The first ``counts[i]`` rows of each Col, one after another, in a Col
    of ``cap`` slots."""
    from spark_rapids_tpu_torch.ops.strings import align_many
    if cols[0].nested is not None:
        from spark_rapids_tpu_torch.ops import nested as N
        return Col.from_vector(N.concat([c.nested for c in cols], counts,
                                        cap))
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
    return Col(v, m, first.dtype, first.dictionary)


def concat_at(a: Col, b: Col, n_a: int, n_b: torch.Tensor, cap: int) -> Col:
    """The first ``n_a`` rows of ``a`` (a host count) and then the first
    ``n_b`` rows of ``b`` (a 0-d device count) in a Col of ``cap`` slots,
    with no host sync: ``concat_cols`` of two flat columns where the second
    count is still on the device (the group-by chain's concat at its
    predicted bucket). Rows past ``cap`` are dropped."""
    from spark_rapids_tpu_torch.ops.strings import align_many
    if a.is_string:
        a, b = align_many([a, b])
    dev = a.values.device
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    from_a = j < n_a
    jb = j - n_a
    from_b = (jb >= 0) & (jb < n_b)
    ia = j.clamp(max=a.values.shape[0] - 1)
    ib = jb.clamp(0, b.values.shape[0] - 1)
    default = torch.full((), a.dtype.default_value(), dtype=a.values.dtype,
                         device=dev)
    v = torch.where(from_a, a.values[ia],
                    torch.where(from_b, b.values[ib], default))
    m = torch.where(from_a, a.validity[ia], from_b & b.validity[ib])
    return Col(v, m, a.dtype, a.dictionary)


def concat_batches(batches) -> ColumnarBatch:
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    cap = bucket_capacity(total)
    out = [concat_cols([Col.from_vector(b.column(ci)) for b in batches],
                       counts, cap).to_vector()
           for ci in range(batches[0].num_cols)]
    return ColumnarBatch(out, total, schema)


def concat_all(batches, schema, device) -> ColumnarBatch:
    """Drain ``batches`` into exactly one batch (the reference's
    ``concat_all``, ConcatAndConsumeAll): empty batches are dropped, and
    no batch at all gives an empty batch of ``schema`` at the smallest
    capacity."""
    batches = [b for b in batches if b.num_rows > 0]
    if batches:
        return concat_batches(batches)
    return ColumnarBatch.empty(schema, device)
