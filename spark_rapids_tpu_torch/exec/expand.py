"""Expand exec: each input row becomes one row per projection, the building
block of ROLLUP, CUBE, GROUPING SETS and the general DISTINCT-aggregate
rewrite.

Counterpart of ``spark_rapids_tpu/exec/expand.py`` (reference
GpuExpandExec). Plain torch ops, as in the reference, which has no Pallas
kernel here: the k projections are evaluated at the batch's capacity, each
output column's k results are stacked to ``(cap, k)`` and flattened row
major, so the rows come out interleaved (r0p0, r0p1, ..., r1p0, ...), in
Spark's order. A string column's k results first move onto one shared
dictionary (``ops/strings.align_many``): a projection that nulls the column
carries an empty one. The output is re-landed at the power-of-two capacity
of its row count, with canonical defaults in the invalid and padding slots.
A nested column (an array, a struct, a map, such as a payload that a
ROLLUP carries into ``collect_list``) takes the same order through
``ops/nested.interleave``: its k results concatenated, then one gather;
a projection that nulls it gives null lists.
"""

from __future__ import annotations

import threading

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import Col, EvalContext, bind_references
from spark_rapids_tpu_torch.ops.strings import align_many


def _to_capacity(t: torch.Tensor, target: int) -> torch.Tensor:
    """``t`` cut or zero-padded to ``target`` slots (k·cap need not be a
    power of two)."""
    n = t.shape[0]
    if n >= target:
        return t[:target]
    return torch.cat([t, t.new_zeros(target - n)])


class ExpandExec(TorchExec):
    def __init__(self, projections: list, out_schema: T.StructType,
                 child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        self.projections = [[bind_references(e, child.output) for e in proj]
                            for proj in projections]
        self._out = out_schema
        #: rows in and rows out; partitions may run on an exchange's map
        #: threads, hence the lock
        self.stats = {"input_rows": 0, "output_rows": 0}
        self._lock = threading.Lock()

    @property
    def output(self):
        return self._out

    def execute_partition(self, split):
        for batch in self.child.execute_partition(split):
            out = self._expand(batch)
            with self._lock:
                self.stats["input_rows"] += batch.num_rows
                self.stats["output_rows"] += out.num_rows
            yield out

    def _expand(self, batch: ColumnarBatch) -> ColumnarBatch:
        k = len(self.projections)
        ctx = EvalContext.from_batch(batch, self.device)
        cap = ctx.capacity
        out_rows = ctx.num_rows * k
        target = bucket_capacity(out_rows)
        per_proj = [[e.eval(ctx) for e in proj] for proj in self.projections]
        live = torch.arange(cap * k, device=self.device) < out_rows
        out_cols = []
        for ci, field in enumerate(self._out):
            cols = [per_proj[p][ci] for p in range(k)]
            if T.is_nested(field.data_type):
                from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
                from spark_rapids_tpu_torch.ops.nested import interleave
                cols = [_cast_col(c, field.data_type) for c in cols]
                out_cols.append(interleave(cols, ctx.num_rows)[0].to_vector())
                continue
            if isinstance(field.data_type, T.StringType):
                cols = align_many(cols)
            vals = torch.stack([c.values for c in cols], dim=1).reshape(-1)
            valid = torch.stack([c.validity for c in cols],
                                dim=1).reshape(-1) & live
            col = Col(_to_capacity(vals, target), _to_capacity(valid, target),
                      field.data_type, cols[0].dictionary)
            out_cols.append(col.canonicalized().to_vector())
        return ColumnarBatch(out_cols, out_rows, self._out)

    def args_string(self):
        return f"{len(self.projections)} projections"
