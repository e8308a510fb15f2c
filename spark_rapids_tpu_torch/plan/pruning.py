"""Column pruning: narrow file scans to the columns the plan uses.

The port's copy of ``spark_rapids_tpu/plan/pruning.py`` (Spark's Catalyst
ColumnPruning and SchemaPruning feeding the scan a pruned read schema). Plans
are built with eagerly BOUND ordinals (``plan/nodes.py`` binds at
construction), so the pass both narrows the ``FileScanNode`` schema and
rebinds every ordinal above it; the scan then parses, uploads and decodes
only the kept columns (``io/filescan.py``).

``_prune(node, required)`` returns ``(new_node, mapping)``, where
``required`` is the set of output ordinals the parent consumes (None = all)
and ``mapping`` maps old output ordinals to new ones for every column that
survived. Nodes whose output is expression-defined (Project, Aggregate)
absorb the remapping; pass-through nodes (Filter, Sort, Limit, Exchange)
propagate it. Any other node type requires all of its children's columns,
so correctness never depends on a node being listed here. Beyond the
reference, an Expand keeps only its required output columns (each
projection's expressions at those positions), and a Union asks each child
for the columns its parent requires, projecting a child whose columns came
back in another layout: without them a ROLLUP, or a union of SELECT *
arms, would read every column of the tables below it. Likewise a window
node asks its child only for the columns above it and its expressions
read (the SQL form puts the window over the whole FROM clause).

The rewrite preserves identity: a subtree where nothing narrows comes back
as the ORIGINAL node objects, and the input plan is never mutated, so a
DataFrame can be collected again. ``DataFrame.physical_plan`` runs the pass
once, at the root, before the override rules (the reference runs it first
in ``TpuOverrides.apply``). A narrowed scan keeps every hive partition
column, after the kept data columns, and every column its pushed filter
names, as the reference's does. The port has no cache node, so the
reference's barrier has nothing to act on here.

Beyond the reference, a generate node (explode) asks its child for the
columns its parent requires and the generator column; and a struct or map
built and then extracted in a projection or a filter
(``struct(..).f``, ``map(lit, x, lit, y)[lit]``) is first replaced by the
extracted value (``complexexprs.simplify_extract``), so the other fields'
columns are not read.

Parquet and ORC scans narrow as the reference's do. A CSV scan with a header
narrows too, where the reference keeps every field: its arrow reader and
its device parse both match the narrowed schema's fields to the header by
name, so the narrowed read returns the same columns, and the device parse
reads only the kept fields. A CSV scan without a header keeps its schema.
"""

from __future__ import annotations

import copy

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.complexexprs import simplify_extract
from spark_rapids_tpu_torch.io.filescan import FileScanNode
from spark_rapids_tpu_torch.plan import nodes as N


def _refs(expr) -> set:
    return {e.ordinal for e in
            expr.collect(lambda x: isinstance(x, E.BoundReference))}


def _is_ident(mapping: dict) -> bool:
    return all(o == n for o, n in mapping.items())


def _remap(expr, mapping: dict):
    if _is_ident(mapping):
        return expr

    def fn(e):
        if isinstance(e, E.BoundReference):
            return E.BoundReference(mapping[e.ordinal], e.dtype, e.nullable,
                                    e.name)
        return e
    return expr.transform(fn)


def _identity(node):
    return node, {i: i for i in range(len(node.output.fields))}


def _all(node) -> set:
    return set(range(len(node.output.fields)))


def prune_columns(root: N.PlanNode) -> N.PlanNode:
    """An equivalent plan whose file scans read only live columns. Subtrees
    with nothing to narrow come back as the original objects."""
    new_root, _ = _prune(root, None)
    return new_root


def _prune(node: N.PlanNode, required: set | None):
    if isinstance(node, FileScanNode):
        return _prune_scan(node, required)
    if isinstance(node, N.ProjectNode):
        keep = (sorted(required) if required is not None
                else list(range(len(node.project_list))))
        if not keep:                       # count(*)-style: keep one column
            keep = [0]
        kept_exprs = [simplify_extract(node.project_list[i]) for i in keep]
        child_req = set()
        for e in kept_exprs:
            child_req |= _refs(e)
        child, cmap = _prune(node.child, child_req)
        mapping = {o: i for i, o in enumerate(keep)}
        if child is node.child and _is_ident(cmap) and _is_ident(mapping) \
                and len(keep) == len(node.project_list) and all(
                    k is node.project_list[i]
                    for k, i in zip(kept_exprs, keep)):
            return node, mapping
        return N.ProjectNode([_remap(e, cmap) for e in kept_exprs],
                             child), mapping
    if isinstance(node, N.FilterNode):
        req = required if required is not None else _all(node)
        cond = simplify_extract(node.condition)
        child, cmap = _prune(node.child, req | _refs(cond))
        if child is node.child and _is_ident(cmap) and cond is node.condition:
            return node, cmap
        return N.FilterNode(_remap(cond, cmap), child), cmap
    if isinstance(node, N.SortNode):
        need = set(required if required is not None else _all(node))
        for e, _, _ in node.sort_exprs:
            need |= _refs(e)
        child, cmap = _prune(node.child, need)
        if child is node.child and _is_ident(cmap):
            return node, cmap
        return N.SortNode([(_remap(e, cmap), asc, nf)
                           for (e, asc, nf) in node.sort_exprs],
                          child, node.global_sort), cmap
    if isinstance(node, N.LimitNode):
        child, cmap = _prune(node.child, required)
        if child is node.child:
            return node, cmap
        return N.LimitNode(node.n, child, node.global_limit), cmap
    if isinstance(node, N.ExchangeNode):
        need = set(required if required is not None else _all(node))
        for e in node.keys:
            need |= _refs(e)
        child, cmap = _prune(node.child, need)
        if child is node.child and _is_ident(cmap):
            return node, cmap
        return N.ExchangeNode(child, node.partitioning, node.num_out,
                              [_remap(e, cmap) for e in node.keys]), cmap
    if isinstance(node, N.AggregateNode):
        child_req = set()
        for e in node.group_exprs + node.agg_exprs:
            child_req |= _refs(e)
        child, cmap = _prune(node.child, child_req)
        if child is node.child and _is_ident(cmap):
            return _identity(node)
        return _identity(N.AggregateNode(
            [_remap(e, cmap) for e in node.group_exprs],
            [_remap(e, cmap) for e in node.agg_exprs], child))
    if isinstance(node, N.JoinNode):
        return _prune_join(node, required)
    if isinstance(node, N.ExpandNode):
        return _prune_expand(node, required)
    if isinstance(node, N.UnionNode):
        return _prune_union(node, required)
    if isinstance(node, N.WindowNode):
        return _prune_window(node, required)
    if isinstance(node, N.GenerateNode):
        return _prune_generate(node, required)
    # any other node: require ALL columns of every child (children may still
    # narrow deeper inside their own subtrees)
    new_children = [_prune(c, None)[0] for c in node.children]
    if any(nc is not oc for nc, oc in zip(new_children, node.children)):
        node = copy.copy(node)
        node.children = list(new_children)
    return _identity(node)


def _prune_join(node: N.JoinNode, required: set | None):
    nleft = len(node.left.output.fields)
    semi = node.join_type in ("leftsemi", "leftanti")
    req = required if required is not None else _all(node)
    lreq = {i for i in req if i < nleft}
    rreq = set() if semi else {i - nleft for i in req if i >= nleft}
    for e in node.left_keys:
        lreq |= _refs(e)
    for e in node.right_keys:
        rreq |= _refs(e)
    if node.condition is not None:
        # the residual condition is stored unbound (resolved by name later):
        # keep every column it names, on whichever side defines it
        names = {a.name for a in node.condition.collect(
            lambda x: isinstance(x, (E.AttributeReference,
                                     E.BoundReference)))}
        lreq |= {i for i, f in enumerate(node.left.output.fields)
                 if f.name in names}
        rreq |= {i for i, f in enumerate(node.right.output.fields)
                 if f.name in names}
    left, lmap = _prune(node.left, lreq)
    right, rmap = _prune(node.right, rreq)
    if left is node.left and right is node.right and _is_ident(lmap) \
            and _is_ident(rmap):
        return _identity(node)
    new = N.JoinNode(left, right,
                     [_remap(e, lmap) for e in node.left_keys],
                     [_remap(e, rmap) for e in node.right_keys],
                     node.join_type, node.condition)
    nleft_new = len(left.output.fields)
    mapping = dict(lmap)
    if not semi:
        for o, n2 in rmap.items():
            mapping[o + nleft] = n2 + nleft_new
    return new, mapping


def _prune_expand(node: N.ExpandNode, required: set | None):
    n_out = len(node.output.fields)
    keep = (sorted(required) if required is not None
            else list(range(n_out))) or [0]
    child_req = set()
    for proj in node.projections:
        for i in keep:
            child_req |= _refs(proj[i])
    child, cmap = _prune(node.child, child_req)
    mapping = {o: i for i, o in enumerate(keep)}
    if child is node.child and _is_ident(cmap) and len(keep) == n_out:
        return node, mapping
    return N.ExpandNode(
        [[_remap(proj[i], cmap) for i in keep] for proj in node.projections],
        [node.output.fields[i] for i in keep], child), mapping


def _prune_union(node: N.UnionNode, required: set | None):
    keep = (sorted(required) if required is not None
            else list(range(len(node.output.fields)))) or [0]
    kids = []
    for c in node.children:
        kid, cmap = _prune(c, set(keep))
        cols = [cmap[o] for o in keep]
        if cols != list(range(len(kid.output.fields))):
            out = kid.output.fields
            kid = N.ProjectNode(
                [E.Alias(E.BoundReference(j, out[j].data_type,
                                          out[j].nullable, out[j].name),
                         out[j].name) for j in cols], kid)
        kids.append(kid)
    mapping = {o: i for i, o in enumerate(keep)}
    if all(k is c for k, c in zip(kids, node.children)):
        return node, mapping
    return N.UnionNode(*kids), mapping


def _prune_window(node: N.WindowNode, required: set | None):
    """A window node keeps every window expression and asks its child for
    the columns its parent requires among the child's, and those the
    window expressions read (their inputs and their partition and order
    keys)."""
    n_child = len(node.child.output.fields)
    req = required if required is not None else _all(node)
    child_req = {i for i in req if i < n_child}
    for e in node.window_exprs:
        child_req |= _refs(e)
    child, cmap = _prune(node.child, child_req)
    if child is node.child and _is_ident(cmap):
        return _identity(node)
    new = N.WindowNode([_remap(e, cmap) for e in node.window_exprs], child)
    n_new = len(child.output.fields)
    mapping = dict(cmap)
    for i in range(len(node.window_exprs)):
        mapping[n_child + i] = n_new + i
    return new, mapping


def _prune_generate(node: N.GenerateNode, required: set | None):
    """An explode asks its child for the generator column and the columns
    its parent requires among the child's (the output is the child's
    columns but the generator, then pos and col)."""
    fields = node.child.output.fields
    g = node.child.output.index_of(node.generator_col)
    others = [j for j in range(len(fields)) if j != g]
    n_out = len(node.output.fields)
    req = required if required is not None else set(range(n_out))
    child_req = {others[o] for o in req if o < len(others)} | {g}
    child, cmap = _prune(node.child, child_req)
    if child is node.child and _is_ident(cmap):
        return _identity(node)
    new = N.GenerateNode(node.generator_col, child, node.outer,
                         node.element_type, node.pos)
    new_others = sorted(cmap[j] for j in others if j in cmap)
    mapping = {o: new_others.index(cmap[j])
               for o, j in enumerate(others) if j in cmap}
    extra = n_out - len(others)         # pos and col
    for k in range(extra):
        mapping[len(others) + k] = len(new_others) + k
    return new, mapping


def _prune_scan(node: FileScanNode, required: set | None):
    fields = node.output.fields
    if required is None or len(required) >= len(fields):
        return _identity(node)
    if node.fmt == "csv" and not node.reader.header:
        # without a header the schema names the file's columns in order, so
        # a subset of it would misname them
        return _identity(node)
    n_data = len(fields) - node._n_partition_cols
    # partition-value columns are per-file constants appended after the data
    # columns; keep them all so _append_partition_values stays aligned
    kept = ([i for i in sorted(required) if i < n_data] or [0]) \
        + list(range(n_data, len(fields)))
    if node.pushed_filter is not None:
        # a pushed filter resolves by name against the scan's schema: its
        # columns survive the narrowing (reference rule)
        names = {a.name for a in node.pushed_filter.collect(
            lambda x: isinstance(x, (E.AttributeReference,
                                     E.BoundReference)))}
        kept = sorted(set(kept) | {i for i, f in enumerate(fields[:n_data])
                                   if f.name in names})
    if len(kept) == len(fields):
        return _identity(node)
    new = copy.copy(node)
    new._schema = T.StructType([fields[i] for i in kept])
    return new, {o: i for i, o in enumerate(kept)}
