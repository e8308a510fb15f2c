"""Logical plan nodes the DataFrame API builds and the override rules turn
into execs — counterpart of ``spark_rapids_tpu/plan/nodes.py``.

The JAX package's nodes also carry a host interpreter (the CPU-Spark oracle
path); the port's nodes only carry their schema, because every node of the
ported slice runs on the device. The file scan node lives in
``io/filescan.py``.
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


class ScanNode(PlanNode):
    """An in-memory scan over arrow tables, one a partition (Spark's
    LocalTableScan): ``TorchSession.create_dataframe`` and the one-row
    relation of a SELECT without FROM build it."""

    def __init__(self, partitions: list, schema: T.StructType | None = None):
        super().__init__()
        self.partitions = list(partitions)
        if not self.partitions:
            raise ValueError("ScanNode needs at least one partition")
        self._schema = schema or T.StructType.from_arrow(
            self.partitions[0].schema)

    @property
    def output(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self.partitions)


class RangeNode(PlanNode):
    """``TorchSession.range``: one non-null LONG column ``id`` from
    ``start`` to ``end`` (exclusive) by ``step``, in ``num_slices``
    partitions (Spark's Range; ``exec/basic.RangeExec`` makes it)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_slices: int = 1):
        super().__init__()
        if step == 0:
            raise ValueError("range: step must not be 0")
        if num_slices < 1:
            raise ValueError("range: num_slices must be at least 1")
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.num_slices = int(num_slices)

    @property
    def output(self):
        return T.StructType([T.StructField("id", T.LONG, False)])

    @property
    def num_partitions(self):
        return self.num_slices


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


class ExchangeNode(PlanNode):
    """Repartition rows across ``num_out`` partitions: "hash" on ``keys``,
    "roundrobin", "single" or "range" (the ShuffleExchangeExec analog)."""

    def __init__(self, child: PlanNode, partitioning: str, num_out: int,
                 keys: list | None = None):
        super().__init__(child)
        if partitioning not in ("hash", "single", "roundrobin", "range"):
            raise ValueError(f"unknown partitioning {partitioning}")
        self.partitioning = partitioning
        self.num_out = num_out
        self.keys = [E.bind_references(e, child.output) for e in (keys or [])]

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return self.num_out


class SortNode(PlanNode):
    """A global sort (one partition, a total order), or with
    ``global_sort=False`` Spark's sortWithinPartitions: each partition
    sorted on its own, the partitions kept."""

    def __init__(self, sort_exprs: list, child: PlanNode,
                 global_sort: bool = True):
        """sort_exprs: list of (expr, ascending, nulls_first)."""
        super().__init__(child)
        self.sort_exprs = [(E.bind_references(e, child.output), asc, nf)
                           for (e, asc, nf) in sort_exprs]
        self.global_sort = global_sort

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return 1 if self.global_sort else self.child.num_partitions


class LimitNode(PlanNode):
    """The first ``n`` rows: of each partition (a local limit), or of the
    whole plan (a global limit, one partition)."""

    def __init__(self, n: int, child: PlanNode, global_limit: bool = False):
        super().__init__(child)
        self.n = n
        self.global_limit = global_limit

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return 1 if self.global_limit else self.child.num_partitions


class JoinNode(PlanNode):
    """Equi-join (a cross join when it has no keys) with Spark null
    semantics: null keys never match. The override rules plan the ported
    shapes and refuse the others."""

    TYPES = ("inner", "left", "right", "full", "leftsemi", "leftanti", "cross")

    def __init__(self, left: PlanNode, right: PlanNode, left_keys: list,
                 right_keys: list, join_type: str = "inner",
                 condition: E.Expression | None = None):
        super().__init__(left, right)
        if join_type not in self.TYPES:
            raise ValueError(f"unknown join type {join_type}")
        self.left_keys = [E.bind_references(e, left.output)
                          for e in left_keys]
        self.right_keys = [E.bind_references(e, right.output)
                           for e in right_keys]
        self.join_type = join_type
        self.condition = condition

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def output(self):
        if self.join_type in ("leftsemi", "leftanti"):
            return self.left.output
        lnull = self.join_type in ("right", "full")
        rnull = self.join_type in ("left", "full")
        return T.StructType(
            [T.StructField(f.name, f.data_type, f.nullable or lnull)
             for f in self.left.output]
            + [T.StructField(f.name, f.data_type, f.nullable or rnull)
               for f in self.right.output])

    @property
    def num_partitions(self):
        return 1


class WindowNode(PlanNode):
    """Window functions over one or more partition/order specs (the
    GpuWindowExec analog): the planner runs one ``exec/window.py`` exec a
    spec, chained, as Spark plans them. The output is the child's columns,
    then one column per window expression, in the given order."""

    def __init__(self, window_exprs: list, child: PlanNode):
        """window_exprs: a list of Alias(WindowExpression)."""
        super().__init__(child)
        self.window_exprs = [E.bind_references(e, child.output)
                             for e in window_exprs]

    @property
    def output(self):
        fields = list(self.child.output.fields)
        for e in self.window_exprs:
            fields.append(T.StructField(_expr_name(e, len(fields)), e.dtype,
                                        True))
        return T.StructType(fields)

    @property
    def num_partitions(self):
        return 1


class GenerateNode(PlanNode):
    """explode/posexplode of an array column, ``outer`` or not (the
    GpuGenerateExec analog; ``exec/generate.py`` runs it). The output is the
    child's columns but the generator, then ``pos`` (posexplode) and
    ``col``."""

    def __init__(self, generator_col: str, child: PlanNode,
                 outer: bool = False, element_type: T.DataType = None,
                 pos: bool = False):
        super().__init__(child)
        self.generator_col = generator_col
        self.outer = outer
        self.pos = pos
        self.element_type = element_type or T.LONG
        taken = {f.name for f in child.output if f.name != generator_col}
        for out_name in (("pos", "col") if pos else ("col",)):
            if out_name in taken:   # Spark allows duplicate names; the port not
                raise ValueError(
                    f"explode output column '{out_name}' collides with an "
                    "input column: rename the input first")

    @property
    def output(self):
        from spark_rapids_tpu_torch.exec.generate import generate_output
        return generate_output(self.child.output, self.generator_col,
                               self.element_type, self.pos, self.outer)


def union_output(outputs: list) -> T.StructType:
    """The schema of a union of children with these outputs: equal column
    types (the SQL lowering casts the arms first), the first child's names,
    and a column nullable when it is in any child (Spark's Union; the
    reference takes the first child's nullability)."""
    types = [[f.data_type for f in o] for o in outputs]
    if any(t != types[0] for t in types[1:]):
        raise ValueError(f"union of unlike column types {types}")
    return T.StructType([
        T.StructField(f.name, f.data_type,
                      any(o.fields[i].nullable for o in outputs))
        for i, f in enumerate(outputs[0].fields)])


class UnionNode(PlanNode):
    """UNION ALL: the children's partitions, one after another."""

    def __init__(self, *children: PlanNode):
        super().__init__(*children)
        self._out = union_output([c.output for c in children])

    @property
    def output(self):
        return self._out

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)


class ExpandNode(PlanNode):
    """Each input row becomes ``len(projections)`` rows, one per projection,
    interleaved (r0p0, r0p1, ..., r1p0, ...) as Spark's Expand emits them
    (the GpuExpandExec analog; ``exec/expand.py`` runs it)."""

    def __init__(self, projections: list, out_fields: list, child: PlanNode):
        super().__init__(child)
        self.projections = [[E.bind_references(e, child.output) for e in proj]
                            for proj in projections]
        self._out = T.StructType(out_fields)
        if not self.projections or any(len(p) != len(out_fields)
                                       for p in self.projections):
            raise ValueError("every Expand projection must have one "
                             "expression per output column")

    @property
    def output(self):
        return self._out


def build_rollup_expand(child: PlanNode, keys: list):
    """ROLLUP(k1, ..., kn) as the grouping sets [k1..kn], [k1..kn-1], ...,
    [] through ``build_grouping_sets_expand``; the SQL lowering and
    ``DataFrame.rollup`` share it."""
    n = len(keys)
    return build_grouping_sets_expand(
        child, keys, [list(range(level)) for level in range(n, -1, -1)])


def build_grouping_sets_expand(child: PlanNode, keys: list, sets: list):
    """GROUPING SETS (and CUBE and ROLLUP) as Spark's Expand: one projection
    per grouping set, which keeps the child's columns, nulls the keys
    outside the set, and appends the grouping id, whose bit ``n-1-i`` (the
    most significant bit for the first key) is 1 when key ``i`` is nulled.
    ``keys`` are bound column references; ``sets`` lists the indices of
    the keys each set keeps. Returns (expand node, the key references over
    its output, the grouping id's reference)."""
    fields = list(child.output.fields)
    n = len(keys)
    projections = []
    for kept in sets:
        kept = set(kept)
        gid = sum(1 << (n - 1 - i) for i in range(n) if i not in kept)
        proj = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                for i, f in enumerate(fields)]
        for gi, g in enumerate(keys):
            proj.append(g if gi in kept else E.Literal(None, g.dtype))
        proj.append(E.Literal(gid, T.INT))
        projections.append(proj)
    out_fields = fields + [
        T.StructField(f"_g{i}", g.dtype, True) for i, g in enumerate(keys)
    ] + [T.StructField("_gid", T.INT, False)]
    expand = ExpandNode(projections, out_fields, child)
    base = len(fields)
    group_refs = [E.BoundReference(base + i, g.dtype, True,
                                   getattr(g, "name", None) or f"_g{i}")
                  for i, g in enumerate(keys)]
    gid_ref = E.BoundReference(base + n, T.INT, False, "_gid")
    return expand, group_refs, gid_ref


def agg_fn(e) -> AggregateFunction:
    f = e.child if isinstance(e, E.Alias) else e
    if not isinstance(f, AggregateFunction):
        raise ValueError(f"agg() requires aggregate expressions, got {e!r}")
    return f
