"""Logical plan nodes the DataFrame API builds and the override rules turn
into execs — counterpart of ``spark_rapids_tpu/plan/nodes.py``.

The JAX package's nodes also carry a host interpreter (the CPU-Spark oracle
path); the port's nodes only carry their schema, because every node of the
ported slice runs on the device. The scan node lives in ``io/filescan.py``.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction


class PlanNode:
    def __init__(self, *children: "PlanNode"):
        self.children = list(children)

    @property
    def child(self) -> "PlanNode":
        return self.children[0]

    @property
    def output(self) -> T.StructType:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1


def _expr_name(e: E.Expression, i: int) -> str:
    if isinstance(e, (E.Alias, E.AttributeReference, E.BoundReference)):
        return e.name
    return f"col{i}"


class ProjectNode(PlanNode):
    def __init__(self, project_list: list, child: PlanNode):
        super().__init__(child)
        self.project_list = [E.bind_references(e, child.output)
                             for e in project_list]

    @property
    def output(self):
        return T.StructType([
            T.StructField(_expr_name(e, i), e.dtype, e.nullable)
            for i, e in enumerate(self.project_list)])


class FilterNode(PlanNode):
    def __init__(self, condition: E.Expression, child: PlanNode):
        super().__init__(child)
        self.condition = E.bind_references(condition, child.output)

    @property
    def output(self):
        return self.child.output


class AggregateNode(PlanNode):
    def __init__(self, group_exprs: list, agg_exprs: list, child: PlanNode):
        super().__init__(child)
        self.group_exprs = [E.bind_references(e, child.output)
                            for e in group_exprs]
        self.agg_exprs = [E.bind_references(e, child.output)
                          for e in agg_exprs]

    @property
    def output(self):
        fields = [T.StructField(_expr_name(e, i), e.dtype, True)
                  for i, e in enumerate(self.group_exprs)]
        for e in self.agg_exprs:
            fields.append(T.StructField(
                _expr_name(e, len(fields)), e.dtype, e.nullable))
        return T.StructType(fields)

    @property
    def num_partitions(self):
        return 1


class SortNode(PlanNode):
    """A global sort (the per-partition sortWithinPartitions is not ported)."""

    def __init__(self, sort_exprs: list, child: PlanNode):
        """sort_exprs: list of (expr, ascending, nulls_first)."""
        super().__init__(child)
        self.sort_exprs = [(E.bind_references(e, child.output), asc, nf)
                           for (e, asc, nf) in sort_exprs]

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return 1


def agg_fn(e) -> AggregateFunction:
    f = e.child if isinstance(e, E.Alias) else e
    if not isinstance(f, AggregateFunction):
        raise ValueError(f"agg() requires aggregate expressions, got {e!r}")
    return f
