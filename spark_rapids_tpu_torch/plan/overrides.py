"""Override rules: logical plan → device execs.

Counterpart of the rules of ``spark_rapids_tpu/plan/overrides.py`` that the
ported slices need: scan, filter, project, aggregate (``:710-770``, with the
legacy depth-2 hoist of a child Filter/Project into the aggregation; several
input partitions plan PARTIAL → hash exchange → FINAL; keys of every ported
type, on the dense or the sort-based path; a keyless aggregate is COMPLETE,
over a gather of its partitions into one when it has several,
``:752-758``), the hash exchange
(``_hash_exchange``, ``:635-659``), the exchange node (``:901-917``), sort
(``:881-899``), limit (``conv_limit``, ``:697-705``), and the equi-join
(``:770-875``): a broadcast hash join, inner joins building the side with
the smaller row estimate (``plan/cbo.py``), and a keyless or cross join as
the nested-loop join (``conv_join``, ``:787-790``, with ``tag_join``'s
refusals, ``:771-782``). One fixed-point key takes the
single-key probe modes; several keys, or one string or double key, take the
rank path (``ops/joining.join_ranks``). A HAVING filter above an aggregate
plans as a FilterExec: the reference folds it into the aggregate
(``fuse_having``), which keeps the same rows. The window node (``tag_window``/``conv_window``, ``:939-977``) plans a
``WindowExec`` over a hash exchange on its partition keys, or a gather of
every partition when it has none. The rules receive the plan
after column pruning (``plan/pruning.py``, which ``DataFrame.physical_plan``
runs once at the root, as the reference runs it first in
``TpuOverrides.apply``).

Every node, expression or shape outside the slices raises
``NotImplementedError`` here, while the plan is built, so nothing runs
wrongly: range partitioning, right and full outer joins (matched-build
tracking; keyless ones too), residual conditions on an equi-join, join
keys of two unlike types, several window specs in one node, and a window
``avg`` over a decimal column (the reference returns the unscaled mean
there) among them. The SQL front-end refuses window functions while it
lowers the text, and the mesh is refused earlier, by the conf, which does
not know its keys. There is no partial CPU fallback: the whole
plan runs on the device.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.exec import exchange as XE
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.exec.sort import SortExec, _GatherAllExec
from spark_rapids_tpu_torch.exec.window import (WindowExec,
                                                supported_window_expr)
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expr.arithmetic import Abs, BinaryArithmetic
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.cast import Cast, supported_cast
from spark_rapids_tpu_torch.expr.conditional import (CaseWhen, Greatest, If,
                                                     Least)
from spark_rapids_tpu_torch.expr.datetime import AddMonths, DateAddInterval
from spark_rapids_tpu_torch.expr.predicates import (
    And, EqualTo, GreaterThan, GreaterThanOrEqual, In, LessThan,
    LessThanOrEqual, Not, NotEqual, Or)
from spark_rapids_tpu_torch.expr.windows import WindowExpression
from spark_rapids_tpu_torch.io.filescan import FileScanNode, FileSourceScanExec
from spark_rapids_tpu_torch.ops import joining as J
from spark_rapids_tpu_torch.ops.sorting import SortOrder
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.plan.cbo import estimate_rows
from spark_rapids_tpu_torch.shuffle import partitioning as SP

_PORTED_EXPRS = (E.BoundReference, E.Literal, E.Alias, BinaryArithmetic,
                 EqualTo, NotEqual, LessThan, LessThanOrEqual, GreaterThan,
                 GreaterThanOrEqual, And, Or, Not, In, Cast, DateAddInterval,
                 AddMonths, AggregateFunction, If, CaseWhen, Least, Greatest,
                 Abs)


def _joinable(ldt: T.DataType, rdt: T.DataType) -> bool:
    """Key types the join compares: equal types, or integers of two
    widths (compared in the wider one)."""
    return ldt == rdt or (isinstance(ldt, T.IntegralType)
                          and isinstance(rdt, T.IntegralType))


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
                NN.ExchangeNode: self._exchange,
                NN.JoinNode: self._join,
                NN.SortNode: self._sort,
                NN.LimitNode: self._limit,
                NN.WindowNode: self._window}.get(type(plan))
        if conv is None:
            raise NotImplementedError(
                f"plan node {type(plan).__name__} is not ported yet")
        return conv(plan, kids)

    def _scan(self, n, kids):
        if n.fmt != "parquet":
            raise NotImplementedError(f"{n.fmt} scans are not ported yet")
        if self.conf.get(CFG.ALLUXIO_PATHS_REPLACE):
            raise NotImplementedError(
                f"{CFG.ALLUXIO_PATHS_REPLACE.key} (the Alluxio path rewrite) "
                "is not ported yet")
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
        fused = dict(prefilter=prefilter, preproject=preproject,
                     prefilter_on_projected=pre_on_proj)
        if child.num_partitions == 1 or not n.group_exprs:
            if child.num_partitions > 1:
                # a keyless aggregation gathers every partition first
                child = _GatherAllExec(child, conf=self.conf)
            return XA.HashAggregateExec(n.group_exprs, n.agg_exprs, child,
                                        mode=XA.COMPLETE, conf=self.conf,
                                        **fused)
        # Spark's two-phase aggregation: partial states per input
        # partition, a hash exchange on the keys, then merge and finalize
        partial = XA.HashAggregateExec(n.group_exprs, n.agg_exprs, child,
                                       mode=XA.PARTIAL, conf=self.conf,
                                       **fused)
        key_names = [f.name for f in partial.output][:len(n.group_exprs)]
        keys = [E.col(k) for k in key_names]
        exchange = self._hash_exchange(keys, partial, adaptive=True)
        return XA.HashAggregateExec(keys, n.agg_exprs, exchange,
                                    mode=XA.FINAL, conf=self.conf)

    def _hash_exchange(self, keys, child, adaptive: bool = False):
        """A hash exchange into as many partitions as ``child`` has;
        ``adaptive`` adds the AQE coalescing reader, valid only above an
        exchange with one consumer (an aggregate)."""
        ex = XE.ShuffleExchangeExec(
            SP.HashPartitioner(keys, child.num_partitions), child,
            conf=self.conf)
        if adaptive and self.conf.get(CFG.ADAPTIVE_COALESCE_ENABLED):
            return XE.AdaptiveShuffleReaderExec(ex, conf=self.conf)
        return ex

    def _exchange(self, n, kids):
        for e in n.keys:
            check_expression(e)
        if n.partitioning == "hash":
            p = SP.HashPartitioner(n.keys, n.num_out)
        elif n.partitioning == "single":
            p = SP.SinglePartitioner()
        elif n.partitioning == "roundrobin":
            p = SP.RoundRobinPartitioner(n.num_out)
        else:
            p = SP.RangePartitioner(n.keys, [SortOrder() for _ in n.keys],
                                    n.num_out)
        return XE.ShuffleExchangeExec(p, kids[0], conf=self.conf)

    def _join(self, n, kids):
        if not n.left_keys or n.join_type == "cross":
            return self._nested_loop_join(n, kids)
        if n.join_type in ("right", "full"):
            raise NotImplementedError(
                f"{n.join_type} outer joins are not ported yet")
        if n.condition is not None:
            raise NotImplementedError(
                "residual conditions on an equi-join are not ported yet")
        for lk, rk in zip(n.left_keys, n.right_keys):
            check_expression(lk)
            check_expression(rk)
            if not _joinable(lk.dtype, rk.dtype):
                raise NotImplementedError(
                    f"a join of a {lk.dtype} key with a {rk.dtype} key is "
                    "not ported yet")
        jt = {"left": J.LEFT_OUTER}.get(n.join_type, n.join_type)
        # an inner join builds the smaller estimated side (reference
        # GpuJoinUtils.getGpuBuildSide); the others stream the preserved side
        build_side = "right"
        if jt == J.INNER and estimate_rows(n.left) < estimate_rows(n.right):
            build_side = "left"
        return XJ.BroadcastHashJoinExec(jt, n.left_keys, n.right_keys,
                                        kids[0], kids[1],
                                        build_side=build_side, conf=self.conf)

    def _nested_loop_join(self, n, kids):
        """A keyless or cross join: the nested-loop join over a broadcast
        right side (the reference's conv_join; a cross join's keys, if any,
        are ignored there too)."""
        if n.join_type in ("right", "full"):
            # right: the reference refuses it too (tag_join); full: the
            # unmatched build rows need the matched flags merged across the
            # stream partitions
            raise NotImplementedError(
                f"a keyless {n.join_type} outer join (the nested-loop join "
                "with a left build side or matched-build tracking) is not "
                "ported yet")
        jt = {"left": J.LEFT_OUTER, "cross": J.INNER}.get(n.join_type,
                                                          n.join_type)
        exec_ = XJ.NestedLoopJoinExec(jt, kids[0], kids[1],
                                      condition=n.condition, conf=self.conf)
        if exec_.condition is not None:
            check_expression(exec_.condition)
        return exec_

    def _window(self, n, kids):
        wes = [e.child if isinstance(e, E.Alias) else e
               for e in n.window_exprs]
        for we in wes:
            if not isinstance(we, WindowExpression):
                raise NotImplementedError(
                    f"not a window expression: {we!r}")
            for c in we.children:
                check_expression(c)
            reason = supported_window_expr(we)
            if reason:
                raise NotImplementedError(reason)
            _ = we.dtype    # raises on unported input types
        if len({repr((we.spec.partition_by, we.spec.order_by))
                for we in wes}) > 1:
            raise NotImplementedError(
                "several window partition/order specs in one node are not "
                "ported yet")
        child = kids[0]
        spec = wes[0].spec
        if child.num_partitions > 1:
            if spec.partition_by:
                child = self._hash_exchange(list(spec.partition_by), child,
                                            adaptive=True)
            else:
                child = _GatherAllExec(child, conf=self.conf)
        return WindowExec(n.window_exprs, child, conf=self.conf)

    def _sort(self, n, kids):
        for e, _, _ in n.sort_exprs:
            check_expression(e)
        exprs = [e for (e, _, _) in n.sort_exprs]
        orders = [SortOrder(ascending=asc, nulls_first=nf)
                  for (_, asc, nf) in n.sort_exprs]
        return SortExec(exprs, orders, kids[0], conf=self.conf)

    def _limit(self, n, kids):
        child = kids[0]
        if not n.global_limit:
            return XB.LocalLimitExec(n.n, child, conf=self.conf)
        if child.num_partitions > 1:
            # Spark plans LocalLimit -> single-partition exchange ->
            # GlobalLimit
            child = _GatherAllExec(
                XB.LocalLimitExec(n.n, child, conf=self.conf), conf=self.conf)
        return XB.GlobalLimitExec(n.n, child, conf=self.conf)
