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
(``:770-875``): a broadcast hash join of every type (inner, left, right
and full outer, semi, anti; an inner join with a residual condition),
inner joins building the side with the smaller row estimate
(``plan/cbo.py``), and a keyless or cross join as the nested-loop join
(``conv_join``, ``:787-790``), with ``tag_join``'s refusals (``:771-782``:
a residual condition on an outer, semi or anti equi-join, and a keyless
right outer join). One fixed-point key takes the single-key probe modes;
several keys, or one string or double key, take the rank path
(``ops/joining.join_ranks``). Key pairs of two types: integers of two
widths meet in the wider one, and decimals of one scale in their raw
unscaled values, as the reference compares them; every other pair is
refused (``_joinable``). A context-free filter directly above a COMPLETE
or FINAL aggregate (a HAVING) folds into the aggregate's finalize under
``stageFusion.enabled`` (``conv_filter``, ``:682-695``;
``HashAggregateExec.fuse_having``): no ``FilterExec`` is planned, and the
rows are the same. The window node
(``tag_window``/``conv_window``, ``:939-977``) plans, as Spark plans it, one
``WindowExec`` for each distinct (partition keys, order keys), chained in
the order the specs first appear, each over a hash exchange on its
partition keys or a gather of every partition when it has none, and a
projection on top that restores the node's column order; a node of one
spec plans one exec and no projection. The reference refuses several
specs on the device (``:951-954``) and runs them on its host path, which
evaluates every expression under the first spec. The range node plans a
``RangeExec`` (``conv_range``, ``:665``), and a sort node a global sort or,
for ``sort_within_partitions``, a sort of each partition
(``conv_sort``, ``:881-899``). The union node plans a ``UnionExec`` of
its children's partitions (``conv_union``, ``:707-708``), so an aggregate
above it with keys plans PARTIAL → hash exchange → FINAL; the expand node
an ``ExpandExec`` (``conv_expand``, ``:970-978``). The rules receive the plan
after column pruning (``plan/pruning.py``, which ``DataFrame.physical_plan``
runs once at the root, as the reference runs it first in
``TpuOverrides.apply``).

A generate node (explode, posexplode, ``outer`` or not) plans a
``GenerateExec`` over an array column of any element type, an
``array<struct>`` or an ``array<array>`` too (``conv_generate``,
``:990-1027``; the reference's device rule refuses a nested element,
``:1005-1008``, and its host path answers); a map generator is refused.
Nested columns (arrays, maps and structs, nested to any depth) are
admitted as payload everywhere, ``ExpandExec`` included (so ROLLUP, CUBE
and GROUPING SETS carry them), and as input only to the extractions
(``expr/complexexprs.py``), ``struct(..)`` and ``array(..)``, the null
tests, ``count``, ``collect_list``, ``collect_set`` (of a type without a
map), ``first`` and ``last``, ``min`` and ``max`` of an array of scalars or
of such arrays, ``If``, ``CaseWhen`` and ``Coalesce`` over one nested type,
and equality (``=``, ``!=``, ``<=>``) over arrays and structs of one type
(``_NESTED_INPUT_OK``); a sort key may be an array of scalars or of such
arrays, in every direction and null order (``_sort``; the order over whole
values is ``ops/nested.order_ranks``). Refused, each raising
``NotImplementedError`` here: any other nested key (grouping, join, a sort
key that holds a struct or a map, window partition or order, hash
partitioning, ``IN``; the message names the exec, ``refuse_nested_keys``;
the reference crashes on such keys on its host path), ``min`` and ``max``
of a type that holds a struct or a map (the reference's host comparator
raises on a struct, Spark orders no map), ``collect_set`` of a map (Spark
refuses it), ``<``, ``<=``, ``>``, ``>=`` over a nested value, a map in a
comparison, a map generator, the packed row format of a nested column
(``columnar/rows.py``) and a CSV write of one (``io/writer.py``).

The context expressions (``spark_partition_id``,
``monotonically_increasing_id``, the input-file family) are admitted in a
projection, a filter and an aggregate, where Spark's analyzer admits a
nondeterministic expression. As Spark's ``PullOutNondeterministic``
does, an aggregate's context expressions are computed by a projection
below it, on the child's partitions and rows (before a gather or a
compaction could move them), and a projection or filter that holds one is
never hoisted into an aggregate.

Every node, expression or shape outside the slices raises
``NotImplementedError`` here, while the plan is built, so nothing runs
wrongly: range partitioning, the join shapes above, join keys of two
unlike types, a context expression anywhere else, and a window ``avg``
over a decimal column (the reference returns the unscaled mean there)
among them. The mesh is refused earlier, by the conf, which does not know its
keys. There is no partial CPU fallback: the whole
plan runs on the device.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.exec import exchange as XE
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.exec.expand import ExpandExec
from spark_rapids_tpu_torch.exec.generate import GenerateExec
from spark_rapids_tpu_torch.exec.sort import SortExec, _GatherAllExec
from spark_rapids_tpu_torch.exec.window import (WindowExec,
                                                supported_window_expr)
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import complexexprs as _CX
from spark_rapids_tpu_torch.expr.aggregates import (AggregateFunction,
                                                     CollectList, Count,
                                                     First, Last, Max, Min,
                                                     PivotFirst)
from spark_rapids_tpu_torch.expr import datetime as _DT
from spark_rapids_tpu_torch.expr import decimalexprs as _DX
from spark_rapids_tpu_torch.expr import mathexprs as _MX
from spark_rapids_tpu_torch.expr import strings as _SX
from spark_rapids_tpu_torch.expr.arithmetic import (
    Abs, BinaryArithmetic, BitwiseNot, UnaryMinus, UnaryPositive, Shift)
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.cast import Cast, supported_cast
from spark_rapids_tpu_torch.expr.conditional import (CaseWhen, Greatest, If,
                                                     Least)
from spark_rapids_tpu_torch.expr.misc import (CONTEXT_SENSITIVE,
                                              is_context_free,
                                              Murmur3Hash, ScalarSubquery,
                                              is_context_sensitive)
from spark_rapids_tpu_torch.expr.nullexprs import (AtLeastNNonNulls, Coalesce,
                                                   IsNaN, IsNotNull, IsNull,
                                                   NaNvl)
from spark_rapids_tpu_torch.expr.predicates import (
    And, EqualNullSafe, EqualTo, GreaterThan, GreaterThanOrEqual, In, InSet,
    LessThan, LessThanOrEqual, Not, NotEqual, Or)
from spark_rapids_tpu_torch.expr.windows import WindowExpression
from spark_rapids_tpu_torch.io.filescan import FileScanNode, FileSourceScanExec
from spark_rapids_tpu_torch.ops import joining as J
from spark_rapids_tpu_torch.ops.sorting import SortOrder
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.plan.cbo import estimate_rows
from spark_rapids_tpu_torch.shuffle import partitioning as SP

def _module_exprs(*mods) -> tuple:
    """Every expression class a module defines."""
    return tuple(v for m in mods for v in vars(m).values()
                 if isinstance(v, type) and issubclass(v, E.Expression)
                 and v.__module__ == m.__name__)


_PORTED_EXPRS = (E.BoundReference, E.Literal, E.Alias, BinaryArithmetic,
                 EqualTo, EqualNullSafe, NotEqual, LessThan, LessThanOrEqual,
                 GreaterThan, GreaterThanOrEqual, And, Or, Not, In, Cast,
                 AggregateFunction, If, CaseWhen, Least, Greatest, Abs,
                 UnaryMinus, UnaryPositive, IsNull, IsNotNull, IsNaN,
                 Coalesce, NaNvl, AtLeastNNonNulls, BitwiseNot, Shift,
                 Murmur3Hash, ScalarSubquery, *CONTEXT_SENSITIVE
                 ) + _module_exprs(_CX, _DT, _DX, _MX, _SX)

# the expressions that take a nested (array, map, struct) input: the
# extractions, the builders, the null tests, count, the collects
# (collect_set is a CollectList), first and last, min and max, the
# conditionals, equality, and the column itself (min and max refuse a
# struct or a map when typed, collect_set a map, and so do a map
# comparison and the order comparisons)
_NESTED_INPUT_OK = (E.BoundReference, E.Alias, IsNull, IsNotNull, Count,
                    CollectList, PivotFirst, First, Last, Min, Max, If,
                    CaseWhen, Coalesce, EqualTo, EqualNullSafe, NotEqual,
                    _CX.GetStructField, _CX.GetArrayItem, _CX.Size,
                    _CX.ElementAt, _CX.ArrayContains, _CX.GetMapValue,
                    _CX.CreateNamedStruct, _CX.CreateArray)


def refuse_nested_keys(exprs, operator: str, role: str = "key") -> None:
    """A nested value cannot be a key: ``operator`` names the exec that
    refuses it (grouping, join, sort, window, hash partitioning, IN)."""
    for e in exprs:
        if T.is_nested(e.dtype):
            raise NotImplementedError(
                f"{operator}: a {role} of type {e.dtype!r} is not ported "
                "(a nested value can be a payload column, not a key)")


def _joinable(ldt: T.DataType, rdt: T.DataType) -> bool:
    """Key types the join compares: equal types, integers of two widths
    (compared in the wider one), or decimals of one scale (their unscaled
    values compare as the decimals do). The reference compares the raw
    values of other pairs too, where they mean different numbers (decimals
    of two scales, a decimal and an integer, a date and an integer), or
    reads an integer's bounds off a double key in a full outer join."""
    if ldt == rdt:
        return True
    if isinstance(ldt, T.IntegralType) and isinstance(rdt, T.IntegralType):
        return True
    return (isinstance(ldt, T.DecimalType) and isinstance(rdt, T.DecimalType)
            and ldt.scale == rdt.scale)


def check_expression(e: E.Expression, context_ok: bool = False) -> None:
    """Refuse, before anything runs, an expression the port cannot evaluate;
    a context expression only where ``context_ok`` (a projection, a filter
    or an aggregate)."""
    for node in e.collect(lambda x: True):
        if not isinstance(node, _PORTED_EXPRS):
            raise NotImplementedError(
                f"expression {type(node).__name__} is not ported yet")
        if isinstance(node, CONTEXT_SENSITIVE) and not context_ok:
            raise NotImplementedError(
                f"{node!r} outside a projection, a filter or an aggregate "
                "is not ported (select it into a column first)")
        if isinstance(node, Cast) and not supported_cast(
                node.children[0].dtype, node.to):
            raise NotImplementedError(
                f"cast {node.children[0].dtype} -> {node.to} is not ported yet")
        # resolves the result type, which raises on unported operand types
        _ = node.dtype
        if isinstance(node, (In, InSet)):
            refuse_nested_keys(node.children, "IN")
        if not isinstance(node, _NESTED_INPUT_OK):
            for c in node.children:
                if T.is_nested(c.dtype):
                    raise NotImplementedError(
                        f"{type(node).__name__} over a {c.dtype!r} value is "
                        "not ported yet")


class TorchOverrides:
    def __init__(self, conf: CFG.RapidsConf, device):
        self.conf = conf
        self.device = device

    def apply(self, plan: NN.PlanNode):
        kids = [self.apply(c) for c in plan.children]
        conv = {FileScanNode: self._scan, NN.ScanNode: self._local_scan,
                NN.RangeNode: self._range,
                NN.FilterNode: self._filter,
                NN.ProjectNode: self._project,
                NN.AggregateNode: self._aggregate,
                NN.ExchangeNode: self._exchange,
                NN.JoinNode: self._join,
                NN.SortNode: self._sort,
                NN.LimitNode: self._limit,
                NN.WindowNode: self._window,
                NN.UnionNode: self._union,
                NN.ExpandNode: self._expand,
                NN.GenerateNode: self._generate}.get(type(plan))
        if conv is None:
            raise NotImplementedError(
                f"plan node {type(plan).__name__} is not ported yet")
        return conv(plan, kids)

    def _scan(self, n, kids):
        # the reference hands a scan its conf disables to the CPU plan; the
        # port has none, so it refuses the plan
        for fmt, entry in (("csv", CFG.CSV_ENABLED), ("orc", CFG.ORC_ENABLED)):
            if n.fmt == fmt and not self.conf.get(entry):
                raise NotImplementedError(
                    f"{entry.key}=false: the port has no host {fmt} scan")
        # a pushed filter's residual runs on the device: refuse it here if
        # an expression of it is not ported
        residual = n.split_filter(self.conf.get(CFG.PARQUET_REBASE_MODE))[1]
        if residual is not None:
            check_expression(residual)
        return FileSourceScanExec(n, conf=self.conf, device=self.device)

    def _local_scan(self, n, kids):
        return XB.LocalTableScanExec(n, conf=self.conf, device=self.device)

    def _range(self, n, kids):
        return XB.RangeExec(n.start, n.end, n.step, n.num_slices,
                            conf=self.conf, device=self.device)

    def _filter(self, n, kids):
        check_expression(n.condition, context_ok=True)
        child = kids[0]
        # HAVING fusion (reference conv_filter): a context-free filter
        # directly above a finalizing aggregate folds into its finalize
        if (self.conf.get(CFG.STAGE_FUSION_ENABLED)
                and isinstance(child, XA.HashAggregateExec)
                and child.mode != XA.PARTIAL
                and not is_context_sensitive(n.condition)):
            child.fuse_having(n.condition)
            return child
        return XB.FilterExec(n.condition, child, conf=self.conf)

    def _project(self, n, kids):
        for e in n.project_list:
            check_expression(e, context_ok=True)
        return XB.ProjectExec(n.project_list, kids[0], conf=self.conf)

    def _aggregate(self, n, kids):
        for e in (*n.group_exprs, *n.agg_exprs):
            check_expression(e, context_ok=True)
        refuse_nested_keys(n.group_exprs, "HashAggregateExec",
                           "grouping key")
        child = kids[0]
        group_exprs, agg_exprs = n.group_exprs, n.agg_exprs
        if is_context_sensitive(*group_exprs, *agg_exprs):
            child, group_exprs, agg_exprs = self._pull_out_context(
                child, group_exprs, agg_exprs)
        # whole-stage hoist of the child Filter/Project into the
        # aggregation: the predicate masks rows there and the projection
        # re-derives the inputs there (legacy depth-2 patterns); one that
        # reads the task's context stays its own exec
        prefilter = preproject = None
        pre_on_proj = False

        def hoistable(x, cls):
            return isinstance(x, cls) and not is_context_sensitive(
                *(x.project_list if cls is XB.ProjectExec
                  else [x.condition]))
        if hoistable(child, XB.FilterExec):
            prefilter = child.condition           # Agg(Filter(...))
            child = child.children[0]
            if hoistable(child, XB.ProjectExec):
                preproject = child.project_list   # Agg(Filter(Project(x)))
                child = child.children[0]
                pre_on_proj = True                # condition binds to proj
        elif hoistable(child, XB.ProjectExec):
            preproject = child.project_list       # Agg(Project(...))
            child = child.children[0]
            if hoistable(child, XB.FilterExec):
                prefilter = child.condition       # Agg(Project(Filter(x)))
                child = child.children[0]
        fused = dict(prefilter=prefilter, preproject=preproject,
                     prefilter_on_projected=pre_on_proj)
        if child.num_partitions == 1 or not group_exprs:
            if child.num_partitions > 1:
                # a keyless aggregation gathers every partition first
                child = _GatherAllExec(child, conf=self.conf)
            return XA.HashAggregateExec(group_exprs, agg_exprs, child,
                                        mode=XA.COMPLETE, conf=self.conf,
                                        **fused)
        # Spark's two-phase aggregation: partial states per input
        # partition, a hash exchange on the keys, then merge and finalize
        partial = XA.HashAggregateExec(group_exprs, agg_exprs, child,
                                       mode=XA.PARTIAL, conf=self.conf,
                                       **fused)
        key_names = [f.name for f in partial.output][:len(group_exprs)]
        keys = [E.col(k) for k in key_names]
        exchange = self._hash_exchange(keys, partial, adaptive=True)
        return XA.HashAggregateExec(keys, agg_exprs, exchange,
                                    mode=XA.FINAL, conf=self.conf)

    def _pull_out_context(self, child, group_exprs, agg_exprs):
        """A projection below the aggregate that appends one column a
        context expression, and the aggregate's expressions over those
        columns (Spark's PullOutNondeterministic); each expression keeps
        its output name."""
        n_in = len(child.output.fields)
        cols: dict = {}

        def sub(x):
            if isinstance(x, CONTEXT_SENSITIVE):
                i = cols.setdefault(repr(x), (n_in + len(cols), x))[0]
                return E.BoundReference(i, x.dtype, False, repr(x))
            return x

        def rewrite(e):
            out = e.transform(sub)
            if isinstance(e, (E.Alias, E.BoundReference)):
                return out
            return E.Alias(out, e.name)
        group_exprs = [rewrite(e) for e in group_exprs]
        agg_exprs = [rewrite(e) for e in agg_exprs]
        fields = child.output.fields
        proj = [E.Alias(E.BoundReference(i, f.data_type, f.nullable, f.name),
                        f.name) for i, f in enumerate(fields)]
        proj += [E.Alias(x, f"_ctx{j}")
                 for j, (_i, x) in enumerate(cols.values())]
        return (XB.ProjectExec(proj, child, conf=self.conf), group_exprs,
                agg_exprs)

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
        refuse_nested_keys(n.keys, "ShuffleExchangeExec",
                           "hash partitioning key")
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
        if n.condition is not None and n.join_type != "inner":
            # the reference's tag_join refuses them too (GpuHashJoin.tagJoin)
            raise NotImplementedError(
                f"a residual condition on a {n.join_type} equi-join is not "
                "ported (the reference runs it on the host)")
        refuse_nested_keys(n.left_keys + n.right_keys,
                           "BroadcastHashJoinExec", "join key")
        for lk, rk in zip(n.left_keys, n.right_keys):
            check_expression(lk)
            check_expression(rk)
            if not _joinable(lk.dtype, rk.dtype):
                raise NotImplementedError(
                    f"a join of a {lk.dtype} key with a {rk.dtype} key is "
                    "not ported yet")
        jt = {"left": J.LEFT_OUTER, "right": J.RIGHT_OUTER,
              "full": J.FULL_OUTER}.get(n.join_type, n.join_type)
        # an inner join builds the smaller estimated side (reference
        # GpuJoinUtils.getGpuBuildSide); the others stream the preserved side
        build_side = "right"
        if jt == J.INNER and estimate_rows(n.left) < estimate_rows(n.right):
            build_side = "left"
        kids = list(kids)
        keys = [list(n.left_keys), list(n.right_keys)]
        hoist = self._stream_hoist(jt, build_side, kids, keys)
        exec_ = XJ.BroadcastHashJoinExec(
            jt, keys[0], keys[1], kids[0], kids[1],
            condition=n.condition, build_side=build_side, conf=self.conf,
            **hoist)
        if exec_.condition is not None:
            check_expression(exec_.condition)
        if self.conf.get(CFG.STAGE_FUSION_ENABLED):
            # the probe chain: a join whose stream child is another join
            # (or a chain formed below it) becomes one chain
            return XJ.maybe_chain(exec_, conf=self.conf)
        return exec_

    def _stream_hoist(self, jt, build_side, kids, keys) -> dict:
        """The stream side's ``FilterExec``, a ``ProjectExec`` over one, or
        (under ``stageFusion.enabled``) a bare ``ProjectExec``, hoisted into
        an inner join on one fixed-point key with context-free terms
        (reference ``conv_join``, ``:813-868``). Filtered rows emit no pairs
        and the projection is re-derived on the emitted rows, so no result
        changes. With a project, the stream key is rewritten to read the
        raw child: each ``BoundReference`` becomes the project expression it
        names, its ``Alias`` unwrapped. Outer, semi and anti joins keep their
        ``FilterExec``; a timestamp or decimal key, which the reference
        hoists, stays unhoisted here (the port's ``_int_backed``). Updates
        ``kids`` and ``keys`` in place; returns the join's hoist kwargs."""
        if jt != J.INNER or len(keys[0]) != 1:
            return {}
        si = 0 if build_side == "right" else 1
        skid = kids[si]
        proj = fkid = None
        if (isinstance(skid, XB.ProjectExec)
                and isinstance(skid.child, XB.FilterExec)
                and is_context_free(*skid.project_list)):
            proj, fkid = skid, skid.child
        elif isinstance(skid, XB.FilterExec):
            fkid = skid
        elif (self.conf.get(CFG.STAGE_FUSION_ENABLED)
              and isinstance(skid, XB.ProjectExec)
              and is_context_free(*skid.project_list)):
            proj = skid
        if ((proj is None and fkid is None)
                or not XJ._int_backed(keys[0][0].dtype)
                or not XJ._int_backed(keys[1][0].dtype)
                or not is_context_free(keys[0][0], keys[1][0])
                or (fkid is not None
                    and not is_context_free(fkid.condition))):
            return {}
        hoist = {"stream_prefilter": (fkid.condition if fkid is not None
                                      else None)}
        if proj is not None:
            plist = [e.child if isinstance(e, E.Alias) else e
                     for e in proj.project_list]
            keys[si] = [k.transform(
                lambda x: plist[x.ordinal]
                if isinstance(x, E.BoundReference) else x)
                for k in keys[si]]
            hoist.update(stream_preproject=proj.project_list,
                         stream_schema=proj.output)
        kids[si] = (fkid if fkid is not None else proj).child
        return hoist

    def _nested_loop_join(self, n, kids):
        """A keyless or cross join: the nested-loop join over a broadcast
        right side (the reference's conv_join; a cross join's keys, if any,
        are ignored there too)."""
        if n.join_type == "right":
            # the nested-loop join builds its right side; the reference
            # refuses this shape too (tag_join)
            raise NotImplementedError(
                "a keyless right outer join (the nested-loop join with a "
                "left build side) is not ported")
        jt = {"left": J.LEFT_OUTER, "full": J.FULL_OUTER,
              "cross": J.INNER}.get(n.join_type, n.join_type)
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
            refuse_nested_keys([*we.spec.partition_by,
                                *[o[0] for o in we.spec.order_by]],
                               "WindowExec", "partition or order key")
            reason = supported_window_expr(we)
            if reason:
                raise NotImplementedError(reason)
            _ = we.dtype    # raises on unported input types
        # one exec a distinct (partition keys, order keys), in the order the
        # specs first appear; the expressions of one spec share an exec,
        # whatever their frames (Spark's ExtractWindowExpressions)
        groups: dict = {}
        for i, we in enumerate(wes):
            key = repr((we.spec.partition_by, we.spec.order_by))
            groups.setdefault(key, []).append(i)
        child = kids[0]
        n_in = len(child.output.fields)
        for idx in groups.values():
            spec = wes[idx[0]].spec
            if child.num_partitions > 1:
                if spec.partition_by:
                    child = self._hash_exchange(list(spec.partition_by),
                                                child, adaptive=True)
                else:
                    child = _GatherAllExec(child, conf=self.conf)
            # the expressions bind to the node's child's columns, which
            # every exec of the chain keeps in front
            child = WindowExec([n.window_exprs[i] for i in idx], child,
                               conf=self.conf)
        if len(groups) == 1:
            return child
        # the node's column order: the child's, then each expression's (the
        # chain appended them spec by spec)
        chain = [i for idx in groups.values() for i in idx]
        out = child.output.fields
        order = list(range(n_in)) + [n_in + chain.index(i)
                                     for i in range(len(wes))]
        return XB.ProjectExec(
            [E.Alias(E.BoundReference(j, out[j].data_type, out[j].nullable,
                                      out[j].name), out[j].name)
             for j in order], child, conf=self.conf)

    def _union(self, n, kids):
        return XB.UnionExec(kids, n.output, conf=self.conf)

    def _expand(self, n, kids):
        for proj in n.projections:
            for e in proj:
                check_expression(e)
        return ExpandExec(n.projections, n.output, kids[0], conf=self.conf)

    def _generate(self, n, kids):
        f = n.child.output[n.generator_col]
        if not isinstance(f.data_type, T.ArrayType):
            raise NotImplementedError(
                f"GenerateExec: explode of {n.generator_col} "
                f"({f.data_type!r}) is not ported (arrays only; maps are "
                "not)")
        if f.data_type.element_type != n.element_type:
            raise ValueError(
                f"explode: declared element type {n.element_type!r} is not "
                f"the column's {f.data_type.element_type!r}")
        return GenerateExec(n.generator_col, kids[0], outer=n.outer,
                            element_type=n.element_type, pos=n.pos,
                            conf=self.conf)

    def _sort(self, n, kids):
        for e, _, _ in n.sort_exprs:
            check_expression(e)
        # an array key sorts by its rank under Spark's ordering; a key that
        # holds a struct or a map stays refused (the reference's comparator
        # raises on a struct; Spark orders no map)
        refuse_nested_keys([e for e, _, _ in n.sort_exprs
                            if not T.ordered_array(e.dtype)], "SortExec",
                           "sort key")
        exprs = [e for (e, _, _) in n.sort_exprs]
        orders = [SortOrder(ascending=asc, nulls_first=nf)
                  for (_, asc, nf) in n.sort_exprs]
        return SortExec(exprs, orders, kids[0], global_sort=n.global_sort,
                        conf=self.conf)

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
