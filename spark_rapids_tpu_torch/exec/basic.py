"""Filter and project execs — counterpart of ``spark_rapids_tpu/exec/basic.py``.

Under an aggregate the planner hoists both into the aggregate (the JAX
package's whole-stage hoist), so these run only where a filter or project
stands elsewhere in a plan.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import (EvalContext, Expression,
                                              bind_references)
from spark_rapids_tpu_torch.ops.filtering import compact_cols, selection_mask


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
        for batch in self.child.execute_partition(split):
            ctx = EvalContext.from_batch(batch, self.device)
            cols = [e.eval(ctx) for e in self.project_list]
            yield ColumnarBatch([c.to_vector() for c in cols], batch.num_rows,
                                self.output)

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
        for batch in self.child.execute_partition(split):
            ctx = EvalContext.from_batch(batch, self.device)
            keep = selection_mask(self.condition.eval(ctx), ctx.num_rows,
                                  ctx.capacity)
            cols, count = compact_cols(ctx.cols, keep)
            yield ColumnarBatch([c.to_vector() for c in cols], count,
                                self.output)

    def args_string(self):
        return repr(self.condition)
