"""Sort exec — counterpart of ``spark_rapids_tpu/exec/sort.py`` (``SortExec``
and ``_GatherAllExec``). A global sort over several partitions first gathers
them into one; a local sort (``sort_within_partitions``) keeps its child's
partitions. The batches of a partition are concatenated, then sorted with
one permutation and one gather per column (``ops/sorting.py``). The input
batches wait in the spill catalog while they accumulate
(``exec/coalesce.concat_all_spillable``), under
``spark.rapids.tpu.pipeline.enabled`` the child produces them on a
pipelined stage ("sort.input"), and the whole-batch sort runs under
spill-only OOM retry (``R.call_with_retry(scope="sort.sort")``)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import EvalContext, bind_references
from spark_rapids_tpu_torch.exec.coalesce import concat_all_spillable
from spark_rapids_tpu_torch.ops.filtering import gather_cols
from spark_rapids_tpu_torch.ops.sorting import sort_permutation
from spark_rapids_tpu_torch.runtime import pipeline as P
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.semaphore import DeviceSemaphore


class SortExec(TorchExec):
    def __init__(self, sort_exprs: list, orders: list, child: TorchExec,
                 global_sort: bool = True, conf=None):
        """sort_exprs: expressions producing sort keys; orders: SortOrders.
        A global sort gathers several input partitions into one first (a
        total order); a local one sorts each partition on its own."""
        if global_sort and child.num_partitions > 1:
            child = _GatherAllExec(child, conf=conf)
        super().__init__(child, conf=conf)
        self.sort_exprs = [bind_references(e, child.output)
                           for e in sort_exprs]
        self.orders = list(orders)
        self.global_sort = global_sort

    @property
    def output(self):
        return self.child.output

    def execute_partition(self, split):
        src = self.child.execute_partition(split)
        src = P.maybe_stage(src, "sort.input", self.conf)
        batch = concat_all_spillable(src, conf=self.conf)
        if batch is None:
            return
        DeviceSemaphore.get().acquire_if_necessary()

        def run_sort():
            ctx = EvalContext.from_batch(batch, self.device, split)
            key_cols = [e.eval(ctx) for e in self.sort_exprs]
            perm = sort_permutation(key_cols, self.orders, ctx.num_rows,
                                    ctx.capacity)
            live = (torch.arange(ctx.capacity, device=self.device)
                    < ctx.num_rows)
            return gather_cols(ctx.cols, perm, live)

        # the total sort needs the whole batch: spill-only retry
        cols = R.call_with_retry(run_sort, scope="sort.sort")
        yield ColumnarBatch([c.to_vector() for c in cols], batch.num_rows,
                            self.output)

    def args_string(self):
        return (f"{list(zip(self.sort_exprs, self.orders))} "
                f"global={self.global_sort}")


class _GatherAllExec(TorchExec):
    """Pulls every child partition, in order, into one partition."""

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return 1

    def execute_partition(self, split):
        for p in range(self.child.num_partitions):
            yield from self.child.execute_partition(p)
