"""Override rules: logical plan → device execs.

Counterpart of the rules of ``spark_rapids_tpu/plan/overrides.py`` that the
ported slice needs: scan, filter, project, aggregate (``:710-770``, with the
legacy depth-2 hoist of a child Filter/Project into the aggregation) and sort
(``:881-899``). Every node, expression or shape outside the slice raises
``NotImplementedError`` here, while the plan is built, so nothing runs
wrongly. There is no partial CPU fallback: the whole plan runs on the device.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.exec.sort import SortExec
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expr.arithmetic import BinaryArithmetic
from spark_rapids_tpu_torch.expr.cast import Cast, supported_cast
from spark_rapids_tpu_torch.expr.predicates import And, LessThanOrEqual
from spark_rapids_tpu_torch.io.filescan import FileScanNode, FileSourceScanExec
from spark_rapids_tpu_torch.ops.sorting import SortOrder
from spark_rapids_tpu_torch.plan import nodes as NN

_PORTED_EXPRS = (E.BoundReference, E.Literal, E.Alias, BinaryArithmetic,
                 LessThanOrEqual, And, Cast, AggregateFunction)


def check_expression(e: E.Expression) -> None:
    """Refuse, before anything runs, an expression the port cannot evaluate."""
    for node in e.collect(lambda x: True):
        if not isinstance(node, _PORTED_EXPRS):
            raise NotImplementedError(
                f"expression {type(node).__name__} is not ported yet")
        if isinstance(node, Cast) and not supported_cast(
                node.children[0].dtype, node.to):
            raise NotImplementedError(
                f"cast {node.children[0].dtype} -> {node.to} is not ported yet")
        # resolves the result type, which raises on unported operand types
        _ = node.dtype


class TorchOverrides:
    def __init__(self, conf: CFG.RapidsConf, device):
        self.conf = conf
        self.device = device

    def apply(self, plan: NN.PlanNode):
        kids = [self.apply(c) for c in plan.children]
        conv = {FileScanNode: self._scan, NN.FilterNode: self._filter,
                NN.ProjectNode: self._project,
                NN.AggregateNode: self._aggregate,
                NN.SortNode: self._sort}.get(type(plan))
        if conv is None:
            raise NotImplementedError(
                f"plan node {type(plan).__name__} is not ported yet")
        return conv(plan, kids)

    def _scan(self, n, kids):
        if n.fmt != "parquet":
            raise NotImplementedError(f"{n.fmt} scans are not ported yet")
        if not self.conf.get(CFG.PARQUET_DEVICE_DECODE):
            raise NotImplementedError(
                "the arrow parquet reader is not ported yet: "
                f"{CFG.PARQUET_DEVICE_DECODE.key} must stay true")
        return FileSourceScanExec(n, conf=self.conf, device=self.device)

    def _filter(self, n, kids):
        check_expression(n.condition)
        return XB.FilterExec(n.condition, kids[0], conf=self.conf)

    def _project(self, n, kids):
        for e in n.project_list:
            check_expression(e)
        return XB.ProjectExec(n.project_list, kids[0], conf=self.conf)

    def _aggregate(self, n, kids):
        for e in (*n.group_exprs, *n.agg_exprs):
            check_expression(e)
        if not n.group_exprs or not all(
                isinstance(e.dtype, (T.StringType, T.BooleanType))
                for e in n.group_exprs):
            raise NotImplementedError(
                "only group-bys on string/boolean keys (the dense path) are "
                "ported so far")
        child = kids[0]
        # whole-stage hoist of the child Filter/Project into the
        # aggregation: the predicate masks rows there and the projection
        # re-derives the inputs there (legacy depth-2 patterns)
        prefilter = preproject = None
        pre_on_proj = False
        if isinstance(child, XB.FilterExec):
            prefilter = child.condition           # Agg(Filter(...))
            child = child.children[0]
            if isinstance(child, XB.ProjectExec):
                preproject = child.project_list   # Agg(Filter(Project(x)))
                child = child.children[0]
                pre_on_proj = True                # condition binds to proj
        elif isinstance(child, XB.ProjectExec):
            preproject = child.project_list       # Agg(Project(...))
            child = child.children[0]
            if isinstance(child, XB.FilterExec):
                prefilter = child.condition       # Agg(Project(Filter(x)))
                child = child.children[0]
        if child.num_partitions != 1:
            raise NotImplementedError(
                "aggregating several partitions needs the exchange, which "
                "is not ported yet")
        return XA.HashAggregateExec(
            n.group_exprs, n.agg_exprs, child, mode=XA.COMPLETE,
            conf=self.conf, prefilter=prefilter, preproject=preproject,
            prefilter_on_projected=pre_on_proj)

    def _sort(self, n, kids):
        for e, _, _ in n.sort_exprs:
            check_expression(e)
        exprs = [e for (e, _, _) in n.sort_exprs]
        orders = [SortOrder(ascending=asc, nulls_first=nf)
                  for (_, asc, nf) in n.sort_exprs]
        return SortExec(exprs, orders, kids[0], conf=self.conf)
