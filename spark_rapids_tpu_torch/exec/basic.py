"""Filter, project, range, limit and union execs — counterpart of
``spark_rapids_tpu/exec/basic.py``.

Under an aggregate the planner hoists a filter or project into the
aggregate (the JAX package's whole-stage hoist), so these run only where a
filter or project stands elsewhere in a plan, a HAVING filter above an
aggregate among them. The project and the filter hand their expressions the
task's partition (``EvalContext.split``), and, where an expression reads the
row's position (``monotonically_increasing_id``), the rows earlier batches
of the partition held (the port's row counts are host ints, so this costs
no device sync). They, the limits and the union pass each batch's scan
provenance (``ColumnarBatch.metadata``) on.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import (EvalContext, Expression,
                                              bind_references)
from spark_rapids_tpu_torch.expr.misc import is_positional
from spark_rapids_tpu_torch.ops.filtering import compact_cols, selection_mask


class LocalTableScanExec(TorchExec):
    """Leaf exec of an in-memory ``ScanNode``: each partition's arrow table
    crosses to the device as one batch."""

    def __init__(self, node, conf=None, device=None):
        super().__init__(conf=conf, device=device)
        self.node = node

    @property
    def output(self):
        return self.node.output

    @property
    def num_partitions(self):
        return self.node.num_partitions

    def execute_partition(self, split):
        from spark_rapids_tpu_torch.columnar.arrow import table_to_device
        tbl = self.node.partitions[split]
        yield table_to_device(tbl, self.device, schema=self.output)


class ProjectExec(TorchExec):
    def __init__(self, project_list: list, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        self.project_list = [bind_references(e, child.output)
                             for e in project_list]

    @property
    def output(self):
        return T.StructType([T.StructField(e.name, e.dtype, e.nullable)
                             for e in self.project_list])

    def execute_partition(self, split):
        positional = is_positional(*self.project_list)
        offset = 0
        for batch in self.child.execute_partition(split):
            ctx = EvalContext.from_batch(batch, self.device, split, offset)
            cols = [e.eval(ctx) for e in self.project_list]
            yield ColumnarBatch([c.to_vector() for c in cols], batch.num_rows,
                                self.output, batch.metadata)
            if positional:
                offset += batch.num_rows

    def args_string(self):
        return str(self.project_list)


class FilterExec(TorchExec):
    def __init__(self, condition: Expression, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        self.condition = bind_references(condition, child.output)

    @property
    def output(self):
        return self.child.output

    def execute_partition(self, split):
        positional = is_positional(self.condition)
        offset = 0
        for batch in self.child.execute_partition(split):
            ctx = EvalContext.from_batch(batch, self.device, split, offset)
            keep = selection_mask(self.condition.eval(ctx), ctx.num_rows,
                                  ctx.capacity)
            cols, count = compact_cols(ctx.cols, keep)
            yield ColumnarBatch([c.to_vector() for c in cols], count,
                                self.output, batch.metadata)
            if positional:
                offset += batch.num_rows

    def args_string(self):
        return repr(self.condition)


class RangeExec(TorchExec):
    """``range(start, end, step)`` in ``num_slices`` partitions (reference
    ``RangeExec``, GpuRangeExec): non-null LONG ``id`` made on the
    session's device, at most ``max_rows_per_batch`` rows a batch at a
    power-of-two capacity, each slice ``ceil(total / num_slices)`` rows
    (the last ones fewer or none), as the reference cuts them. The padding
    slots hold 0 (the reference's continue the sequence)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_slices: int = 1, conf=None, device=None,
                 max_rows_per_batch: int = 1 << 20):
        super().__init__(conf=conf, device=device)
        if step == 0:
            raise ValueError("range: step must not be 0")
        self.start, self.end, self.step = start, end, step
        self.num_slices = num_slices
        self.max_rows_per_batch = max_rows_per_batch

    @property
    def output(self):
        return T.StructType([T.StructField("id", T.LONG, False)])

    @property
    def num_partitions(self):
        return self.num_slices

    def execute_partition(self, split):
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self.num_slices)
        i, hi = split * per, min(total, (split + 1) * per)
        while i < hi:
            n = min(self.max_rows_per_batch, hi - i)
            cap = bucket_capacity(n)
            idx = torch.arange(cap, dtype=torch.int64, device=self.device)
            live = idx < n
            vals = torch.where(live, self.start + (idx + i) * self.step,
                               torch.zeros_like(idx))
            yield ColumnarBatch([TorchColumnVector(T.LONG, vals, live)], n,
                                self.output)
            i += n

    def args_string(self):
        return (f"({self.start}, {self.end}, {self.step}, "
                f"{self.num_slices} slices)")


class UnionExec(TorchExec):
    """UNION ALL: the children's partitions, concatenated (reference
    ``UnionExec``, GpuUnionExec). A child's batches pass through as they
    are, under the union's schema: each keeps its own string dictionaries,
    which the operators above align where batches meet (``concat_batches``,
    the exchange's string hash). ``out_schema`` is the union node's
    (``plan/nodes.union_output``)."""

    def __init__(self, children: list, out_schema, conf=None):
        super().__init__(*children, conf=conf)
        self._out = out_schema

    @property
    def output(self):
        return self._out

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def execute_partition(self, split):
        out = self.output
        for c in self.children:
            if split < c.num_partitions:
                for batch in c.execute_partition(split):
                    yield ColumnarBatch(batch.columns, batch.num_rows, out,
                                        batch.metadata)
                return
            split -= c.num_partitions
        raise IndexError(split)

    def args_string(self):
        return f"{len(self.children)} children"


class LocalLimitExec(TorchExec):
    """The first ``limit`` rows of each partition (reference limit.scala
    GpuLocalLimitExec). The port's row counts are host ints, so the limit
    reads no count back from the device. A batch cut in the middle keeps
    the canonical defaults in the slots that are no longer live."""

    def __init__(self, limit: int, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        self.limit = limit

    @property
    def output(self):
        return self.child.output

    def execute_partition(self, split):
        remaining = self.limit
        for batch in self.child.execute_partition(split):
            if remaining <= 0:
                break
            n = batch.num_rows
            if n <= remaining:
                remaining -= n
                yield batch
                continue
            live = torch.arange(batch.capacity, device=self.device) < remaining
            cols = []
            for c in batch.columns:
                if T.is_nested(c.dtype):
                    from spark_rapids_tpu_torch.ops import nested as N
                    cols.append(N.take_rows(c, 0, remaining, batch.capacity))
                    continue
                default = torch.tensor(c.dtype.default_value(),
                                       dtype=c.data.dtype, device=self.device)
                cols.append(TorchColumnVector(
                    c.dtype, torch.where(live, c.data, default),
                    c.validity & live, c.dictionary))
            yield ColumnarBatch(cols, remaining, batch.schema,
                                batch.metadata)
            remaining = 0

    def args_string(self):
        return str(self.limit)


class GlobalLimitExec(LocalLimitExec):
    """The first ``limit`` rows of the whole plan, over a single-partition
    child (Spark plans GlobalLimit over a single-partition exchange)."""

    def __init__(self, limit: int, child: TorchExec, conf=None):
        if child.num_partitions != 1:
            raise ValueError("GlobalLimitExec needs a single-partition child")
        super().__init__(limit, child, conf=conf)
