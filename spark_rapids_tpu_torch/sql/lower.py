"""SQL AST → logical plan lowering (the Catalyst-analyzer role).

Counterpart of ``spark_rapids_tpu/sql/lower.py``, for the SELECT core. Per
SELECT block, the moves Spark's analyzer and optimizer make before the
reference plugin sees a plan:

1. FROM: resolve tables (temp views, CTEs, derived tables), then plan the
   join graph: single-relation WHERE conjuncts push down as filters under
   the joins, two-relation equi conjuncts become join keys (a greedy
   connected join order from the relation with the most edges), and the
   rest lands in a filter above the joins. A conjunct common to every
   branch of an OR is hoisted out of it first. Explicit JOIN ... ON splits
   its condition the same way.
2. Aggregation: distinct ``AggregateFunction`` subtrees (keyed by the
   structural key of ``expr/exprkey.py``) become AggregateNode columns.
3. HAVING → Filter; SELECT → Project; DISTINCT → group-by-all; ORDER BY
   resolves output names, aliases, ordinals and select-list expressions
   (other expressions ride as hidden columns, dropped after the sort);
   LIMIT → a global LimitNode.

What the port cannot plan raises ``NotImplementedError`` here, while the
text is lowered, never at run time: window functions, ROLLUP/CUBE/GROUPING
SETS, set operations, DISTINCT aggregates, scalar, IN and EXISTS
subqueries (the reference runs the uncorrelated ones eagerly at lowering),
SELECT without FROM, and every expression outside the ported ones (CASE,
LIKE, IS NULL, the string, math and null functions, division, negation of a
column, TIMESTAMP literals). Text the grammar or the catalog refuses raises
``SqlParseError`` or ``SqlAnalysisError``, as in the reference.
"""

from __future__ import annotations

import datetime as _dt

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import predicates as PR
from spark_rapids_tpu_torch.expr.aggregates import (
    AggregateFunction, Average, Count, First, Last, Max, Min, Sum)
from spark_rapids_tpu_torch.expr.exprkey import expr_key
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.sql import parser as P


class SqlAnalysisError(ValueError):
    pass


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


# -- scopes -------------------------------------------------------------------

class Scope:
    """Columns of the current relation: (qualifier, name, dtype, nullable)
    per output position."""

    def __init__(self, cols):
        self.cols = list(cols)

    @classmethod
    def for_relation(cls, plan, qualifier):
        return cls([(qualifier, f.name, f.data_type, f.nullable)
                    for f in plan.output])

    def concat(self, other: "Scope") -> "Scope":
        return Scope(self.cols + other.cols)

    def find(self, parts) -> list:
        """Matching positions for a (possibly qualified) identifier."""
        if len(parts) == 1:
            name = parts[0].lower()
            return [i for i, (_, n, _, _) in enumerate(self.cols)
                    if n.lower() == name]
        qual, name = parts[0].lower(), parts[1].lower()
        return [i for i, (q, n, _, _) in enumerate(self.cols)
                if q is not None and q.lower() == qual and n.lower() == name]

    def resolve(self, parts) -> E.BoundReference:
        hits = self.find(parts)
        if not hits:
            raise SqlAnalysisError(f"column not found: {'.'.join(parts)}")
        if len(hits) > 1:
            raise SqlAnalysisError(f"ambiguous column: {'.'.join(parts)}")
        i = hits[0]
        _, name, dtype, nullable = self.cols[i]
        return E.BoundReference(i, dtype, nullable, name)


_TYPE_MAP = {
    "int": T.INT, "integer": T.INT, "bigint": T.LONG, "long": T.LONG,
    "double": T.DOUBLE, "string": T.STRING, "date": T.DATE,
    "boolean": T.BOOLEAN, "char": T.STRING, "varchar": T.STRING,
}
# types the reference's lowering knows and the port's type system lacks
_UNPORTED_TYPES = ("smallint", "tinyint", "float", "real", "timestamp",
                   "decimal", "numeric")


def _sql_type(name: str) -> T.DataType:
    if name in _TYPE_MAP:
        return _TYPE_MAP[name]
    if name in _UNPORTED_TYPES:
        raise _not_ported(f"the SQL type {name}")
    raise SqlAnalysisError(f"unsupported cast type {name}")


_AGG_FUNCS = {"sum": Sum, "min": Min, "max": Max, "avg": Average,
              "first": First, "last": Last}
# aggregates the reference lowers and the port has not ported
_UNPORTED_AGGS = ("stddev_samp", "stddev", "stddev_pop", "var_samp",
                  "variance", "var_pop")
# scalar functions the reference lowers and the port has not ported
_UNPORTED_FUNCS = ("substr", "substring", "coalesce", "nullif", "abs",
                   "grouping", "least", "greatest", "upper", "ucase", "lower",
                   "lcase", "length", "trim", "concat", "round", "sqrt",
                   "floor", "ceil", "ceiling", "row_number", "rank",
                   "dense_rank", "lead", "lag")


# -- expression conversion ----------------------------------------------------

class _ExprConverter:
    def __init__(self, scope: Scope):
        self.scope = scope

    def convert(self, a) -> E.Expression:
        c = self.convert
        if isinstance(a, P.Lit):
            return E.Literal(a.value)
        if isinstance(a, P.Ident):
            return self.scope.resolve(a.parts)
        if isinstance(a, P.UnOp):
            if a.op == "-":
                inner = c(a.operand)
                if isinstance(inner, E.Literal) and isinstance(
                        inner.value, (int, float)) and not isinstance(
                        inner.value, bool):
                    return E.Literal(-inner.value, inner.dtype)
                raise _not_ported("UnaryMinus")
            return PR.Not(c(a.operand))
        if isinstance(a, P.BinOp):
            from spark_rapids_tpu_torch.expr import arithmetic as AR
            if isinstance(a.right, P.IntervalAst) and a.op in ("+", "-"):
                return _date_interval(c(a.left), a.right, a.op)
            table = {
                "+": AR.Add, "-": AR.Subtract, "*": AR.Multiply,
                "=": PR.EqualTo, "<": PR.LessThan, "<=": PR.LessThanOrEqual,
                ">": PR.GreaterThan, ">=": PR.GreaterThanOrEqual,
                "<>": PR.NotEqual, "!=": PR.NotEqual,
                "and": PR.And, "or": PR.Or,
            }
            if a.op not in table:
                raise _not_ported(f"the SQL operator {a.op!r}")
            return table[a.op](c(a.left), c(a.right))
        if isinstance(a, P.CastAst):
            return self._cast(a)
        if isinstance(a, P.BetweenAst):
            e = c(a.expr)
            cond = PR.And(PR.GreaterThanOrEqual(e, c(a.lo)),
                          PR.LessThanOrEqual(e, c(a.hi)))
            return PR.Not(cond) if a.negated else cond
        if isinstance(a, P.InAst):
            if isinstance(a.values, (P.Select, P.SetOp)):
                raise _not_ported("IN (subquery)")
            vals = []
            for v in a.values:
                ve = c(v)
                if not isinstance(ve, E.Literal):
                    raise _not_ported("IN over a non-literal list")
                vals.append(ve.value)
            ins = PR.InSet(c(a.expr), vals)
            return PR.Not(ins) if a.negated else ins
        if isinstance(a, P.CaseAst):
            raise _not_ported("CASE")
        if isinstance(a, P.LikeAst):
            raise _not_ported("LIKE")
        if isinstance(a, P.IsNullAst):
            raise _not_ported("IS [NOT] NULL")
        if isinstance(a, P.SubqueryExpr):
            raise _not_ported("a scalar subquery")
        if isinstance(a, P.FuncCall):
            return self.func(a)
        if isinstance(a, P.ExistsAst):
            raise _not_ported("EXISTS")
        if isinstance(a, P.Star):
            raise SqlAnalysisError("* only allowed at select-list top level "
                                   "or in count(*)")
        raise SqlAnalysisError(f"unsupported SQL construct: {a!r}")

    def _cast(self, a: P.CastAst) -> E.Expression:
        from spark_rapids_tpu_torch.expr.cast import Cast
        to = _sql_type(a.type_name)
        # a typed literal (DATE '...') folds to a constant at plan time
        # (Spark's literal parsing); an explicit cast() keeps its run-time
        # cast semantics
        if a.typed_literal and isinstance(a.expr, P.Lit) \
                and isinstance(a.expr.value, str):
            s = a.expr.value.strip()
            if s.lower() in ("epoch", "now", "today", "yesterday",
                             "tomorrow"):
                raise _not_ported(f"the special date string {s!r}")
            try:
                d = _dt.date.fromisoformat(s)
            except ValueError as e:
                raise P.SqlParseError(
                    f"invalid {a.type_name} literal {s!r}: {e}") from e
            return E.Literal((d - _dt.date(1970, 1, 1)).days, T.DATE)
        return Cast(self.convert(a.expr), to)

    def func(self, a: P.FuncCall) -> E.Expression:
        c = self.convert
        name = a.name
        if a.over is not None:
            raise _not_ported("window functions")
        if name in _AGG_FUNCS:
            if len(a.args) != 1:
                raise SqlAnalysisError(f"{name} takes one argument")
            if a.distinct and name not in ("min", "max"):
                # min/max are insensitive to DISTINCT
                raise _not_ported(f"DISTINCT aggregate {name}")
            return _AGG_FUNCS[name](c(a.args[0]))
        if name == "count":
            if a.distinct:
                raise _not_ported("DISTINCT aggregate count")
            if not a.args or isinstance(a.args[0], P.Star):
                return Count(None)
            return Count(c(a.args[0]))
        if name in _UNPORTED_AGGS or name in _UNPORTED_FUNCS:
            raise _not_ported(f"the SQL function {name}")
        raise SqlAnalysisError(f"unknown function {name}")


# -- lowering -----------------------------------------------------------------

def _flatten_and(a) -> list:
    if isinstance(a, P.BinOp) and a.op == "and":
        return _flatten_and(a.left) + _flatten_and(a.right)
    return [a]


def _flatten_or(a) -> list:
    if isinstance(a, P.BinOp) and a.op == "or":
        return _flatten_or(a.left) + _flatten_or(a.right)
    return [a]


def _and_of(conjs):
    out = conjs[0]
    for c in conjs[1:]:
        out = P.BinOp("and", out, c)
    return out


def _hoist_common_or_conjuncts(conj) -> list:
    """(a AND x) OR (a AND y) → [a, (x OR y)]: Catalyst's common-predicate
    extraction from disjunctions, which turns equi conditions repeated in
    every OR branch into join keys."""
    if not (isinstance(conj, P.BinOp) and conj.op == "or"):
        return [conj]
    branch_conjs = [_flatten_and(b) for b in _flatten_or(conj)]
    common = [c for c in branch_conjs[0]
              if all(any(c == d for d in bc) for bc in branch_conjs[1:])]
    if not common:
        return [conj]
    residuals = []
    for bc in branch_conjs:
        rem = list(bc)
        for c in common:
            rem.remove(next(d for d in rem if d == c))
        residuals.append(rem)
    if any(not rem for rem in residuals):
        return common    # one branch became TRUE → the OR is implied
    ors = [_and_of(rem) for rem in residuals]
    out = ors[0]
    for o in ors[1:]:
        out = P.BinOp("or", out, o)
    return common + [out]


def _ast_idents(a) -> list:
    """Every column identifier of an AST expression (not descending into
    subqueries, which resolve in their own scope)."""
    out = []

    def walk(x):
        if isinstance(x, P.Ident):
            out.append(x)
        elif isinstance(x, (P.SubqueryExpr, P.ExistsAst)):
            return
        elif isinstance(x, P.FuncCall):
            for ar in x.args:
                walk(ar)
            if x.over:
                for p_ in x.over.partition_by:
                    walk(p_)
                for (e_, _, _) in x.over.order_by:
                    walk(e_)
        elif isinstance(x, P.BinOp):
            walk(x.left)
            walk(x.right)
        elif isinstance(x, P.UnOp):
            walk(x.operand)
        elif isinstance(x, P.CaseAst):
            if x.operand is not None:
                walk(x.operand)
            for w, v in x.branches:
                walk(w)
                walk(v)
            if x.else_ is not None:
                walk(x.else_)
        elif isinstance(x, P.CastAst):
            walk(x.expr)
        elif isinstance(x, P.BetweenAst):
            walk(x.expr)
            walk(x.lo)
            walk(x.hi)
        elif isinstance(x, P.InAst):
            walk(x.expr)
            if isinstance(x.values, list):
                for v in x.values:
                    walk(v)
        elif isinstance(x, (P.LikeAst, P.IsNullAst)):
            walk(x.expr)
    walk(a)
    return out


def _date_interval(date_expr, iv, op: str):
    """date ± INTERVAL literal → DateAddInterval / AddMonths (Spark lowers
    calendar intervals the same way: day and week are fixed-length, month
    and year are calendar adds)."""
    from spark_rapids_tpu_torch.expr.datetime import AddMonths, DateAddInterval
    try:
        n = int(iv.value)
    except ValueError as e:
        raise P.SqlParseError(f"invalid interval value {iv.value!r}") from e
    if op == "-":
        n = -n
    unit = iv.unit
    if unit in ("day", "week"):
        days = n * (7 if unit == "week" else 1)
        return DateAddInterval(date_expr, E.Literal(days, T.INT))
    if unit in ("month", "year"):
        months = n * (12 if unit == "year" else 1)
        return AddMonths(date_expr, E.Literal(months, T.INT))
    raise P.SqlParseError(f"unsupported interval unit {iv.unit!r}")


def _and_all(conv: _ExprConverter, conjs):
    cond = conv.convert(conjs[0])
    for cj in conjs[1:]:
        cond = PR.And(cond, conv.convert(cj))
    return cond


class _Relation:
    """One FROM item during join planning."""

    def __init__(self, plan, scope: Scope):
        self.plan = plan
        self.scope = scope


class _Lowerer:
    def __init__(self, session, views: dict):
        self.session = session
        self.views = dict(views)

    def lower(self, q):
        for name, cte in q.ctes:
            self.views = dict(self.views)
            self.views[name] = self.dataframe(cte)
        if isinstance(q, P.SetOp):
            raise _not_ported(f"the set operation {q.op.upper()}")
        return self._select(q)

    def dataframe(self, q):
        from spark_rapids_tpu_torch.session import DataFrame
        return DataFrame(_Lowerer(self.session, self.views).lower(q),
                         self.session)

    # -- FROM/join planning ---------------------------------------------------
    def _base_relation(self, item) -> _Relation:
        if isinstance(item, P.TableRef):
            if item.name not in self.views:
                raise SqlAnalysisError(f"table not found: {item.name}")
            df = self.views[item.name]
            qual = item.alias or item.name
            return _Relation(df._plan, Scope.for_relation(df._plan, qual))
        if isinstance(item, P.SubqueryRef):
            df = self.dataframe(item.query)
            return _Relation(df._plan,
                             Scope.for_relation(df._plan, item.alias))
        if isinstance(item, P.JoinRef):
            return self._explicit_join(item)
        raise SqlAnalysisError(f"unsupported FROM item {item!r}")

    def _explicit_join(self, j: P.JoinRef) -> _Relation:
        left = self._base_relation(j.left)
        right = self._base_relation(j.right)
        combined = left.scope.concat(right.scope)
        how = {"semi": "leftsemi", "anti": "leftanti"}.get(j.how, j.how)
        lkeys, rkeys, residual = [], [], []
        if j.using:
            for nm in j.using:
                lkeys.append(left.scope.resolve((nm,)))
                rkeys.append(right.scope.resolve((nm,)))
        elif j.on is not None:
            for conj in _flatten_and(j.on):
                eq = self._as_equi(conj, left.scope, right.scope)
                if eq is not None:
                    lkeys.append(eq[0])
                    rkeys.append(eq[1])
                else:
                    residual.append(_ExprConverter(combined).convert(conj))
        cond = None
        if residual:
            cond = residual[0]
            for r in residual[1:]:
                cond = PR.And(cond, r)
        if how != "inner" or not lkeys:
            plan = NN.JoinNode(left.plan, right.plan, lkeys, rkeys,
                               "cross" if (how == "cross" or not lkeys)
                               else how, cond)
        else:
            plan = NN.JoinNode(left.plan, right.plan, lkeys, rkeys, "inner")
            if cond is not None:
                plan = NN.FilterNode(cond, plan)
        scope = (left.scope if how in ("leftsemi", "leftanti")
                 else combined)
        return _Relation(plan, scope)

    @staticmethod
    def _as_equi(conj, lscope: Scope, rscope: Scope):
        """conj as (left_key, right_key) bound to each side, or None."""
        if not _Lowerer._is_equi_ast(conj):
            return None
        a, b = conj.left.parts, conj.right.parts
        if len(lscope.find(a)) == 1 and len(rscope.find(b)) == 1:
            return lscope.resolve(a), rscope.resolve(b)
        if len(lscope.find(b)) == 1 and len(rscope.find(a)) == 1:
            return lscope.resolve(b), rscope.resolve(a)
        return None

    @staticmethod
    def _is_equi_ast(conj):
        return (isinstance(conj, P.BinOp) and conj.op == "="
                and isinstance(conj.left, P.Ident)
                and isinstance(conj.right, P.Ident))

    def _plan_from(self, q: P.Select):
        """Comma-list join graph → (plan, scope)."""
        rels = [self._base_relation(item) for item in q.from_]
        conjuncts = _flatten_and(q.where) if q.where is not None else []
        conjuncts = [h for c in conjuncts
                     for h in _hoist_common_or_conjuncts(c)]

        # which relations does each conjunct touch? (by unique column name
        # or qualifier, on the AST, before any join order exists)
        def rel_ids_of(conj):
            ids = set()
            for ident in _ast_idents(conj):
                hit = None
                for ri, rel in enumerate(rels):
                    if rel.scope.find(ident.parts):
                        if hit is not None and hit != ri:
                            return None   # ambiguous name across relations
                        hit = ri
                if hit is None:
                    return None           # e.g. a select-alias reference
                ids.add(hit)
            return ids

        single = {}      # rel id -> [conjunct]
        edges = []       # (rid_a, rid_b, conj)
        leftover = []
        for conj in conjuncts:
            ids = rel_ids_of(conj)
            if ids is None:
                leftover.append(conj)
            elif len(ids) <= 1:
                single.setdefault(ids.pop() if ids else 0, []).append(conj)
            elif len(ids) == 2 and self._is_equi_ast(conj):
                a, b = sorted(ids)
                edges.append((a, b, conj))
            else:
                leftover.append(conj)

        # push single-relation filters down before joining
        for ri, conjs in single.items():
            rel = rels[ri]
            rel.plan = NN.FilterNode(_and_all(_ExprConverter(rel.scope),
                                              conjs), rel.plan)

        n = len(rels)
        if n == 1:
            plan, scope = rels[0].plan, rels[0].scope
            if leftover:
                # an unresolvable conjunct must raise (a misspelt column),
                # never drop the filter
                plan = NN.FilterNode(_and_all(_ExprConverter(scope),
                                              leftover), plan)
            return plan, scope
        # greedy join: start from the relation with the most edges (the fact
        # table of a star query), attach connected relations first
        degree = [0] * n
        for a, b, _ in edges:
            degree[a] += 1
            degree[b] += 1
        start = max(range(n), key=lambda i: degree[i])
        joined = {start}
        plan, scope = rels[start].plan, rels[start].scope
        remaining_edges = list(edges)
        while len(joined) < n:
            pick = None
            for a, b, _ in remaining_edges:
                if (a in joined) != (b in joined):
                    pick = b if a in joined else a
                    break
            if pick is None:    # disconnected → cross join the next one
                pick = next(i for i in range(n) if i not in joined)
            rel = rels[pick]
            lkeys, rkeys, rest = [], [], []
            for (a, b, conj) in remaining_edges:
                other = b if a in joined else a if b in joined else None
                if other != pick or (a in joined and b in joined):
                    rest.append((a, b, conj))
                    continue
                eq = self._as_equi(conj, scope, rel.scope)
                if eq is None:
                    leftover.append(conj)
                else:
                    lkeys.append(eq[0])
                    rkeys.append(eq[1])
            remaining_edges = rest
            plan = NN.JoinNode(plan, rel.plan, lkeys, rkeys,
                               "inner" if lkeys else "cross")
            scope = scope.concat(rel.scope)
            joined.add(pick)
        # edges whose endpoints both joined through another path, and
        # leftovers, filter above the joins
        leftover.extend(conj for (_, _, conj) in remaining_edges)
        if leftover:
            plan = NN.FilterNode(_and_all(_ExprConverter(scope), leftover),
                                 plan)
        return plan, scope

    # -- SELECT block ---------------------------------------------------------
    def _select(self, q: P.Select):
        if not q.from_:
            raise _not_ported("SELECT without FROM")
        if q.rollup or q.grouping_sets is not None:
            raise _not_ported("ROLLUP, CUBE and GROUPING SETS")
        plan, scope = self._plan_from(q)
        conv = _ExprConverter(scope)

        # expand stars, convert select items
        items = []       # (Expression, out_name)
        for it in q.items:
            if isinstance(it.expr, P.Star):
                qual = it.expr.qualifier
                for ci, (cq, nm, dt, nb) in enumerate(scope.cols):
                    if qual is None or (cq or "").lower() == qual.lower():
                        items.append((E.BoundReference(ci, dt, nb, nm), nm))
                continue
            e = conv.convert(it.expr)
            nm = it.alias or self._auto_name(it.expr, len(items))
            items.append((e, nm))

        having_e = conv.convert(q.having) if q.having is not None else None
        group_es = [self._group_expr(g, conv, items) for g in q.group_by]
        order_items = q.order_by

        has_agg = bool(group_es) or any(
            self._contains_agg(e) for e, _ in items) or (
            having_e is not None and self._contains_agg(having_e))
        if has_agg:
            plan, sub = self._aggregate(plan, group_es, items, having_e,
                                        order_items, conv)
            items = [(sub(e), nm) for e, nm in items]
            having_e = sub(having_e) if having_e is not None else None
        else:
            def sub(e):
                return e

        if having_e is not None:
            plan = NN.FilterNode(having_e, plan)

        plan = NN.ProjectNode([E.Alias(e, nm) for e, nm in items], plan)

        if q.distinct:
            plan = NN.AggregateNode([E.col(f.name) for f in plan.output], [],
                                    plan)

        if order_items:
            plan = self._order_by(plan, order_items, items, conv, sub)
        if q.limit is not None:
            plan = NN.LimitNode(q.limit, plan, global_limit=True)
        return plan

    def _order_by(self, plan, order_items, items, conv, sub):
        # output-position map: by name and by substituted-expression key
        out_names = [nm for _, nm in items]
        key_to_idx = {}
        for i, (e, _) in enumerate(items):
            key_to_idx.setdefault(expr_key(e), i)
        sort_exprs, hidden = [], []
        for (ast, asc, nf) in order_items:
            nulls_first = asc if nf is None else nf
            try:
                e = self._resolve_order_item(ast, plan, out_names,
                                             key_to_idx, conv, sub)
            except SqlAnalysisError:
                # an expression over the projected output: carry it as a
                # hidden column, sort, then drop it
                out_conv = _ExprConverter(Scope.for_relation(plan, None))
                e = ("hidden", out_conv.convert(ast))
                hidden.append(e[1])
            sort_exprs.append((e, asc, nulls_first))
        if not hidden:
            return NN.SortNode(sort_exprs, plan)
        n0 = len(plan.output)
        keep = [E.Alias(E.BoundReference(i, f.data_type, f.nullable, f.name),
                        f.name)
                for i, f in enumerate(plan.output)]
        hcols = [E.Alias(h, f"_s{i}") for i, h in enumerate(hidden)]
        plan = NN.ProjectNode(keep + hcols, plan)
        hidx, fixed = n0, []
        for (e, asc, nf) in sort_exprs:
            if isinstance(e, tuple):
                f = plan.output[hidx]
                e = E.BoundReference(hidx, f.data_type, f.nullable, f.name)
                hidx += 1
            fixed.append((e, asc, nf))
        plan = NN.SortNode(fixed, plan)
        return NN.ProjectNode(keep, plan)

    def _resolve_order_item(self, ast, plan, out_names, key_to_idx, conv,
                            sub):
        out = plan.output
        if isinstance(ast, P.Lit) and isinstance(ast.value, int):
            idx = ast.value - 1
            if not (0 <= idx < len(out)):
                raise SqlAnalysisError(
                    f"ORDER BY position {ast.value} out of range")
            f = out[idx]
            return E.BoundReference(idx, f.data_type, f.nullable, f.name)
        if isinstance(ast, P.Ident):
            nm = ast.parts[-1].lower()
            hits = [i for i, onm in enumerate(out_names)
                    if onm.lower() == nm]
            if len(hits) == 1:
                f = out[hits[0]]
                return E.BoundReference(hits[0], f.data_type, f.nullable,
                                        f.name)
        # an expression: convert and substitute, then match a projected item
        k = expr_key(sub(conv.convert(ast)))
        if k in key_to_idx:
            i = key_to_idx[k]
            f = out[i]
            return E.BoundReference(i, f.data_type, f.nullable, f.name)
        raise SqlAnalysisError(
            f"ORDER BY item must reference an output column, alias, "
            f"ordinal, or a select-list expression (got {ast!r})")

    @staticmethod
    def _auto_name(ast, i):
        if isinstance(ast, P.Ident):
            return ast.parts[-1]
        if isinstance(ast, P.FuncCall):
            return f"{ast.name}"
        return f"col{i}"

    @staticmethod
    def _group_expr(g, conv, items):
        # GROUP BY <ordinal> / <select alias> / <expr>
        if isinstance(g, P.Lit) and isinstance(g.value, int):
            idx = g.value - 1
            if not (0 <= idx < len(items)):
                raise SqlAnalysisError(f"GROUP BY position {g.value} "
                                       "out of range")
            return items[idx][0]
        if isinstance(g, P.Ident) and len(g.parts) == 1:
            try:
                return conv.convert(g)
            except SqlAnalysisError:
                for e, nm in items:
                    if nm.lower() == g.parts[0].lower():
                        return e
                raise
        return conv.convert(g)

    @staticmethod
    def _contains_agg(e) -> bool:
        if isinstance(e, AggregateFunction):
            return True
        return any(_Lowerer._contains_agg(c) for c in e.children)

    def _aggregate(self, plan, group_es, items, having_e, order_items, conv):
        """Build the AggregateNode; return (plan, substitution fn)."""
        # distinct aggregates of every post-aggregation expression
        aggs = []        # [(key, AggregateFunction)]
        seen = {}

        def collect(e):
            if isinstance(e, AggregateFunction):
                k = expr_key(e)
                if k not in seen:
                    seen[k] = len(aggs)
                    aggs.append((k, e))
                return
            for c in e.children:
                collect(c)

        for e, _ in items:
            collect(e)
        if having_e is not None:
            collect(having_e)
        # ORDER BY expressions may name aggregates textually
        for (ast, _, _) in (order_items or []):
            try:
                collect(conv.convert(ast))
            except SqlAnalysisError:
                pass   # an alias or ordinal, resolved later

        agg_node = NN.AggregateNode(
            list(group_es), [E.Alias(a, f"_a{i}")
                             for i, (_, a) in enumerate(aggs)], plan)
        n_group = len(group_es)
        out = agg_node.output
        group_keys = {expr_key(g): i for i, g in enumerate(group_es)}

        def sub(e):
            if e is None:
                return None
            k = expr_key(e)
            if isinstance(e, AggregateFunction) and k in seen:
                i = seen[k]
                f = out[n_group + i]
                return E.BoundReference(n_group + i, f.data_type, True,
                                        f.name)
            if k in group_keys:
                i = group_keys[k]
                f = out[i]
                return E.BoundReference(i, f.data_type, f.nullable, f.name)
            if e.children:
                return e.with_children([sub(c) for c in e.children])
            if isinstance(e, (E.BoundReference, E.AttributeReference)):
                raise SqlAnalysisError(
                    f"column {e!r} is neither grouped nor aggregated")
            return e
        return agg_node, sub


def lower_sql(text: str, views: dict, session):
    """Parse and lower ``text`` against ``views`` ({name: DataFrame})."""
    return _Lowerer(session, views).lower(P.parse_sql(text))
