"""Sort exec — counterpart of ``spark_rapids_tpu/exec/sort.py`` (``SortExec``).
The batches of a partition are concatenated, then sorted with one
permutation and one gather per column (``ops/sorting.py``)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import EvalContext, bind_references
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.filtering import gather_cols
from spark_rapids_tpu_torch.ops.sorting import sort_permutation


class SortExec(TorchExec):
    def __init__(self, sort_exprs: list, orders: list, child: TorchExec,
                 conf=None):
        """A global sort. sort_exprs: expressions producing sort keys;
        orders: SortOrders. Sorting several partitions needs the gather
        exchange, which is not ported yet."""
        if child.num_partitions > 1:
            raise NotImplementedError(
                "a global sort over several partitions is not ported yet")
        super().__init__(child, conf=conf)
        self.sort_exprs = [bind_references(e, child.output)
                           for e in sort_exprs]
        self.orders = list(orders)

    @property
    def output(self):
        return self.child.output

    def execute_partition(self, split):
        batches = list(self.child.execute_partition(split))
        if not batches:
            return
        batch = concat_batches(batches)
        if batch.num_rows == 0:
            return
        ctx = EvalContext.from_batch(batch, self.device)
        key_cols = [e.eval(ctx) for e in self.sort_exprs]
        perm = sort_permutation(key_cols, self.orders, ctx.num_rows,
                                ctx.capacity)
        live = torch.arange(ctx.capacity, device=self.device) < ctx.num_rows
        cols = gather_cols(ctx.cols, perm, live)
        yield ColumnarBatch([c.to_vector() for c in cols], batch.num_rows,
                            self.output)

    def args_string(self):
        return str(list(zip(self.sort_exprs, self.orders)))
