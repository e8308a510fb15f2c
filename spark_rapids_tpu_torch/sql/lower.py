"""SQL AST → logical plan lowering (the Catalyst-analyzer role).

Counterpart of ``spark_rapids_tpu/sql/lower.py``. Per SELECT block, the
moves Spark's analyzer and optimizer make before the reference plugin sees
a plan:

1. FROM: resolve tables (temp views, CTEs, derived tables), then plan the
   join graph: single-relation WHERE conjuncts push down as filters under
   the joins (``x IN (subquery)`` among them as a left semi join against
   the subquery's plan), two-relation equi conjuncts become join keys (a
   greedy connected join order from the relation with the most edges), and
   the rest lands in a filter above the joins. A conjunct common to every
   branch of an OR is hoisted out of it first. Explicit JOIN ... ON splits
   its condition the same way. [NOT] EXISTS conjuncts apply last, over the
   whole join graph: their equality correlations become the keys of a semi
   or anti join; an uncorrelated one is folded while the text is lowered.
2. Aggregation: distinct ``AggregateFunction`` subtrees (keyed by the
   structural key of ``expr/exprkey.py``) become AggregateNode columns,
   those inside a window function's input too (``avg(sum(x)) over (...)``).
   ROLLUP and GROUPING SETS (CUBE parses into grouping sets) lower through
   an ExpandNode with a grouping-id key, as Spark's Expand; ``grouping(c)``
   reads its bit. DISTINCT aggregates are rewritten as Spark's
   RewriteDistinctAggregates does: one distinct argument whose other
   aggregates are min/max or count/sum/avg of that argument takes two
   aggregates (``_rewrite_distinct``, TPC-DS q28's form); anything else
   takes the general Expand form (``_rewrite_distinct_expand``).
3. Window: the distinct ``OVER`` expressions, over the aggregate's output
   when there is one, become one WindowNode.
4. HAVING → Filter; SELECT → Project; DISTINCT → group-by-all; ORDER BY
   resolves output names, aliases, ordinals and select-list expressions
   (other expressions ride as hidden columns, dropped after the sort);
   LIMIT → a global LimitNode.
5. Set operations: UNION [ALL] is a UnionNode over the arms cast to their
   common column types (a group-by-all dedups UNION); INTERSECT and EXCEPT
   dedup the left arm and semi or anti join it to the right one on every
   column, null-safely; their ALL forms number each row's copies with a
   window ``row_number()`` first and join on the number too. ORDER BY and
   LIMIT over a set operation take output names and ordinals.

Uncorrelated subqueries that are not joins run eagerly while the text is
lowered, once each for the statement (``_Eager``), as Spark runs subquery
stages first: a scalar subquery becomes ``expr/misc.ScalarSubquery`` (NULL
on no row, an error on two), ``x [NOT] IN (subquery)`` outside a WHERE
conjunct an ``InSet`` of its values, and an uncorrelated EXISTS a constant.

The expressions lowered: column references, literals (``100.0`` is a
double, as the parser reads it; ``cast(x as decimal(p, s))`` makes a
decimal; NULL is the untyped null), + - * / %, ``||``, negation,
comparisons, AND/OR/NOT, BETWEEN, IN over literals, expressions or a
subquery, [NOT] LIKE, CASE, IS [NOT] NULL, DATE and TIMESTAMP literals and
intervals, casts to every scalar type, the aggregates
sum/min/max/avg/count/first/last and stddev/stddev_samp/stddev_pop/
variance/var_samp/var_pop (sum, avg and count also DISTINCT),
``grouping``, the functions abs, substr/substring, coalesce, nullif,
least, greatest, upper/ucase, lower/lcase, length, trim, concat, round,
sqrt, floor and ceil/ceiling (the reference's list), scalar subqueries,
and the window functions (row_number, rank, dense_rank, lead, lag and the
aggregates over a window). A SELECT without FROM reads one row. An ORDER
BY aggregate or ``grouping()`` that the select list lacks rides as a
hidden column. Joins: the comma list, and [INNER|LEFT|RIGHT|FULL] [OUTER]
JOIN ... ON/USING, semi, anti and cross joins.

What the port cannot plan raises ``NotImplementedError`` here, while the
text is lowered, never at run time (a calendar interval added to a
timestamp, an ORDER BY aggregate under SELECT DISTINCT). Text the grammar
or the catalog refuses raises ``SqlParseError`` or ``SqlAnalysisError``,
as in the reference; so do the subquery and DISTINCT shapes the reference
refuses.
"""

from __future__ import annotations

import datetime as _dt

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import predicates as PR
from spark_rapids_tpu_torch.expr.aggregates import (
    AggregateFunction, Average, Count, First, Last, Max, Min, StddevPop,
    StddevSamp, Sum, VariancePop, VarianceSamp)
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
    "int": T.INT, "integer": T.INT, "smallint": T.SHORT, "tinyint": T.BYTE,
    "bigint": T.LONG, "long": T.LONG, "float": T.FLOAT, "real": T.FLOAT,
    "double": T.DOUBLE, "string": T.STRING, "date": T.DATE,
    "timestamp": T.TIMESTAMP, "boolean": T.BOOLEAN, "char": T.STRING,
    "varchar": T.STRING,
}


def _sql_type(name: str, args: tuple = ()) -> T.DataType:
    if name in _TYPE_MAP:
        return _TYPE_MAP[name]
    if name in ("decimal", "numeric"):
        # the reference's defaults: decimal(10, 0), decimal(p, 0)
        p = int(args[0]) if args else 10
        s = int(args[1]) if len(args) > 1 else 0
        if p > T.DecimalType.MAX_PRECISION:
            raise _not_ported(f"decimal({p}, {s}) (precision above "
                              f"{T.DecimalType.MAX_PRECISION})")
        return T.DecimalType(p, s)
    raise SqlAnalysisError(f"unsupported cast type {name}")


_AGG_FUNCS = {
    "sum": Sum, "min": Min, "max": Max, "avg": Average,
    "stddev_samp": StddevSamp, "stddev": StddevSamp, "stddev_pop": StddevPop,
    "var_samp": VarianceSamp, "variance": VarianceSamp,
    "var_pop": VariancePop, "first": First, "last": Last,
}
# aggregates and scalar functions the reference lowers and the port has not
# ported: none
_UNPORTED_AGGS: tuple = ()
_UNPORTED_FUNCS: tuple = ()


class _Grouping(E.Expression):
    """``grouping(col)`` until the rollup lowering turns it into a bit test
    of the grouping id (``_Lowerer._grouping_bit``)."""

    def __init__(self, ref: E.Expression):
        self.children = [ref]

    @property
    def dtype(self):
        return T.INT

    def with_children(self, children):
        return _Grouping(children[0])

    def eval(self, ctx):
        raise SqlAnalysisError("grouping() outside GROUP BY ROLLUP")


class _DistinctAgg(AggregateFunction):
    """``fn(DISTINCT x)`` until ``_Lowerer._aggregate`` rewrites it into
    two aggregates (Spark's RewriteDistinctAggregates)."""

    def __init__(self, fn_cls, child):
        super().__init__(child)
        self.fn_cls = fn_cls

    def make(self, ref):
        return self.fn_cls(ref)

    @property
    def dtype(self):
        return self.fn_cls(self.child).dtype

    def with_children(self, children):
        return _DistinctAgg(self.fn_cls, children[0])

    @property
    def state_types(self):
        raise SqlAnalysisError("DISTINCT aggregate outside its rewrite")


# -- expression conversion ----------------------------------------------------

class _ExprConverter:
    def __init__(self, scope: Scope, lowerer: "_Lowerer"):
        self.scope = scope
        self.lowerer = lowerer

    def convert(self, a) -> E.Expression:
        c = self.convert
        if isinstance(a, P.Lit):
            return E.Literal(a.value)
        if isinstance(a, P.Ident):
            return self.scope.resolve(a.parts)
        if isinstance(a, P.UnOp):
            if a.op == "-":
                from spark_rapids_tpu_torch.expr.arithmetic import UnaryMinus
                inner = c(a.operand)
                if isinstance(inner, E.Literal) and isinstance(
                        inner.value, (int, float)) and not isinstance(
                        inner.value, bool):
                    return E.Literal(-inner.value, inner.dtype)
                return UnaryMinus(inner)
            return PR.Not(c(a.operand))
        if isinstance(a, P.BinOp):
            from spark_rapids_tpu_torch.expr import arithmetic as AR
            if isinstance(a.right, P.IntervalAst) and a.op in ("+", "-"):
                return _date_interval(c(a.left), a.right, a.op)
            if a.op == "||":
                from spark_rapids_tpu_torch.expr.strings import Concat
                return Concat(c(a.left), c(a.right))
            table = {
                "+": AR.Add, "-": AR.Subtract, "*": AR.Multiply,
                "/": AR.Divide, "%": AR.Remainder,
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
                return self._in_subquery(a)
            vals = [c(v) for v in a.values]
            if all(isinstance(ve, E.Literal) for ve in vals):
                ins = PR.InSet(c(a.expr), [ve.value for ve in vals])
            else:
                # x IN (e1, e2, ...) is the Kleene OR of x = ei: true on a
                # match, else null when any side is null, else false
                x = c(a.expr)
                ins = PR.EqualTo(x, vals[0])
                for ve in vals[1:]:
                    ins = PR.Or(ins, PR.EqualTo(x, ve))
            return PR.Not(ins) if a.negated else ins
        if isinstance(a, P.CaseAst):
            return self._case(a)
        if isinstance(a, P.LikeAst):
            from spark_rapids_tpu_torch.expr.strings import Like
            lk = Like(c(a.expr), E.Literal(a.pattern, T.STRING))
            return PR.Not(lk) if a.negated else lk
        if isinstance(a, P.IsNullAst):
            from spark_rapids_tpu_torch.expr.nullexprs import IsNotNull, IsNull
            return (IsNotNull if a.negated else IsNull)(c(a.expr))
        if isinstance(a, P.SubqueryExpr):
            return self.lowerer.scalar_subquery(a.query)
        if isinstance(a, P.FuncCall):
            return self.func(a)
        if isinstance(a, P.ExistsAst):
            raise SqlAnalysisError(
                "EXISTS is supported only as a top-level WHERE conjunct "
                "(where it lowers to a semi/anti join); rewrite this "
                "occurrence as a join")
        if isinstance(a, P.Star):
            raise SqlAnalysisError("* only allowed at select-list top level "
                                   "or in count(*)")
        raise SqlAnalysisError(f"unsupported SQL construct: {a!r}")

    def _in_subquery(self, a: P.InAst) -> E.Expression:
        """``x [NOT] IN (subquery)`` where no semi join can stand for it
        (NOT IN, or inside an OR): the subquery runs once, eagerly, and its
        distinct values become an ``InSet``, both sides widened to their
        common type as Spark does. A NULL among them makes a non-match NULL
        (NOT IN then keeps no row), the three-valued rule of ``In``. Over no
        values IN is false and NOT IN true, for a NULL ``x`` too (Spark's
        null-aware anti join; the reference's ``InSet`` of no values is
        NULL there)."""
        from spark_rapids_tpu_torch.expr.arithmetic import promote
        from spark_rapids_tpu_torch.expr.cast import Cast
        vals, sub_dt = self.lowerer.in_subquery_values(a.values)
        lhs = self.convert(a.expr)
        if not vals:
            return E.Literal(bool(a.negated), T.BOOLEAN)
        if lhs.dtype != sub_dt:
            try:
                target = promote(lhs.dtype, sub_dt)
            except NotImplementedError as e:
                raise SqlAnalysisError(
                    f"IN (subquery): {lhs.dtype} vs {sub_dt}") from e
            if target != lhs.dtype:
                lhs = Cast(lhs, target)
        ins = PR.InSet(lhs, vals)
        return PR.Not(ins) if a.negated else ins

    def _case(self, a: P.CaseAst) -> E.Expression:
        """CASE [x] WHEN ... THEN ... [ELSE ...] END. A NULL branch takes
        the type of the first typed branch (the reference's
        ``_retype_nulls``: the port has no untyped null)."""
        from spark_rapids_tpu_torch.expr.conditional import CaseWhen
        c = self.convert

        def value(x):
            return (None if isinstance(x, P.Lit) and x.value is None
                    else c(x))
        if a.operand is not None:
            op = c(a.operand)
            preds = [PR.EqualTo(op, c(w)) for w, _ in a.branches]
        else:
            preds = [c(w) for w, _ in a.branches]
        vals = [value(v) for _, v in a.branches]
        else_e = value(a.else_) if a.else_ is not None else None
        typed = [v.dtype for v in vals + [else_e] if v is not None]
        if not typed:
            raise _not_ported("a CASE whose every branch is NULL")
        vals = [E.Literal(None, typed[0]) if v is None else v for v in vals]
        if a.else_ is not None and else_e is None:
            else_e = E.Literal(None, typed[0])
        return CaseWhen(list(zip(preds, vals)), else_e)

    def _cast(self, a: P.CastAst) -> E.Expression:
        from spark_rapids_tpu_torch.expr.cast import Cast
        to = _sql_type(a.type_name, a.type_args)
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
                if isinstance(to, T.TimestampType):
                    # the session zone is UTC: the literal is read there
                    ts = _dt.datetime.fromisoformat(s).replace(
                        tzinfo=_dt.timezone.utc)
                    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
                    return E.Literal(
                        (ts - epoch) // _dt.timedelta(microseconds=1),
                        T.TIMESTAMP)
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
            return self._window(a)
        if name in _AGG_FUNCS:
            if len(a.args) != 1:
                raise SqlAnalysisError(f"{name} takes one argument")
            if a.distinct and name not in ("min", "max"):
                # min/max are insensitive to DISTINCT
                if name not in ("sum", "avg"):
                    raise SqlAnalysisError(
                        f"DISTINCT aggregate {name} not supported")
                return _DistinctAgg(_AGG_FUNCS[name], c(a.args[0]))
            return _AGG_FUNCS[name](c(a.args[0]))
        if name == "count":
            if not a.args or isinstance(a.args[0], P.Star):
                if a.distinct:
                    raise SqlAnalysisError("count(DISTINCT *) not supported")
                return Count(None)
            if a.distinct:
                if len(a.args) != 1:
                    raise SqlAnalysisError(
                        "count(DISTINCT a, b, ...) not supported")
                return _DistinctAgg(Count, c(a.args[0]))
            return Count(c(a.args[0]))
        if name == "grouping":
            if len(a.args) != 1:
                raise SqlAnalysisError("grouping takes one argument")
            return _Grouping(c(a.args[0]))
        if name in ("substr", "substring"):
            from spark_rapids_tpu_torch.expr.strings import Substring
            if len(a.args) not in (2, 3):
                raise SqlAnalysisError(f"{name} takes two or three arguments")
            return Substring(*[c(x) for x in a.args])
        if name == "coalesce":
            from spark_rapids_tpu_torch.expr.nullexprs import Coalesce
            return Coalesce(*[c(x) for x in a.args])
        if name == "abs":
            from spark_rapids_tpu_torch.expr.arithmetic import Abs
            return Abs(c(a.args[0]))
        scalar = self._scalar_func(a)
        if scalar is not None:
            return scalar
        if name in ("row_number", "rank", "dense_rank", "lead", "lag"):
            raise SqlAnalysisError(f"{name}() requires an OVER clause")
        if name in _UNPORTED_AGGS or name in _UNPORTED_FUNCS:
            raise _not_ported(f"the SQL function {name}")
        raise SqlAnalysisError(f"unknown function {name}")

    def _scalar_func(self, a: P.FuncCall):
        """The reference's scalar functions beyond abs/substr/coalesce:
        nullif, least, greatest, upper/ucase, lower/lcase, length, trim,
        concat, round, sqrt, floor, ceil/ceiling. None for another name."""
        from spark_rapids_tpu_torch.expr import conditional as CX
        from spark_rapids_tpu_torch.expr import mathexprs as MX
        from spark_rapids_tpu_torch.expr import strings as SX
        name = a.name
        args = [self.convert(x) for x in a.args]

        def arity(*ns):
            if len(args) not in ns:
                raise SqlAnalysisError(
                    f"{name} takes {' or '.join(map(str, ns))} argument(s)")
        if name == "nullif":
            arity(2)
            x, y = args
            return CX.If(PR.EqualTo(x, y), E.Literal(None, x.dtype), x)
        if name in ("least", "greatest"):
            if len(args) < 2:
                raise SqlAnalysisError(f"{name} takes two or more arguments")
            return (CX.Least if name == "least" else CX.Greatest)(*args)
        unary = {"upper": SX.Upper, "ucase": SX.Upper, "lower": SX.Lower,
                 "lcase": SX.Lower, "length": SX.Length, "trim": SX.Trim,
                 "sqrt": MX.Sqrt, "floor": MX.Floor, "ceil": MX.Ceil,
                 "ceiling": MX.Ceil}
        if name in unary:
            arity(1)
            return unary[name](args[0])
        if name == "concat":
            if not args:
                raise SqlAnalysisError("concat takes one or more arguments")
            return SX.Concat(*args)
        if name == "round":
            arity(1, 2)
            scale = 0
            if len(args) > 1:
                if not (isinstance(args[1], E.Literal)
                        and isinstance(args[1].value, int)):
                    raise SqlAnalysisError(
                        "round's scale must be an integer literal")
                scale = args[1].value
            return MX.Round(args[0], scale)
        return None

    def _window(self, a: P.FuncCall) -> E.Expression:
        """fn(...) OVER (PARTITION BY ... ORDER BY ... [frame]) as a
        WindowExpression (the reference's ``_window``): no ORDER BY means
        the whole partition, an ORDER BY without a frame Spark's default
        RANGE UNBOUNDED PRECEDING..CURRENT ROW."""
        from spark_rapids_tpu_torch.expr import windows as WX
        spec_ast = a.over
        if a.distinct:
            raise _not_ported(f"DISTINCT aggregate {a.name} in a window")
        name = a.name
        if name == "row_number":
            func = WX.RowNumber()
        elif name == "rank":
            func = WX.Rank()
        elif name == "dense_rank":
            func = WX.DenseRank()
        elif name in ("lead", "lag"):
            args = [self.convert(x) for x in a.args]
            for x in args[1:]:
                if not isinstance(x, E.Literal):
                    raise _not_ported(f"{name} with a non-literal offset or "
                                      "default")
            off = int(args[1].value) if len(args) > 1 else 1
            default = args[2].value if len(args) > 2 else None
            cls = WX.Lead if name == "lead" else WX.Lag
            func = cls(args[0], off, default)
        else:
            func = self.func(P.FuncCall(a.name, a.args, a.distinct, None))
            if not isinstance(func, AggregateFunction):
                raise SqlAnalysisError(f"{name} is not a window function")
        parts = tuple(self.convert(p) for p in spec_ast.partition_by)
        orders = tuple((self.convert(e), asc, asc if nf is None else nf)
                       for (e, asc, nf) in spec_ast.order_by)
        if spec_ast.frame is not None:
            ftype, lo, hi = spec_ast.frame
            # the exec's offsets count back from the lower bound and on
            # from the upper one, each non-negative
            if (lo is not None and lo > 0) or (hi is not None and hi < 0):
                raise _not_ported("a window frame that starts FOLLOWING or "
                                  "ends PRECEDING the current row")
            frame = WX.WindowFrame(ftype, None if lo is None else -lo, hi)
        elif orders:
            frame = WX.DEFAULT_FRAME
        else:
            frame = WX.FULL_FRAME     # no ORDER BY: the whole partition
        return WX.WindowExpression(func, WX.WindowSpec(parts, orders, frame))


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


def _ast_nodes(a):
    """Every node of an AST expression, ``a`` first (not descending into
    subqueries, which resolve in their own scope)."""
    if a is None or isinstance(a, (P.SubqueryExpr, P.ExistsAst)):
        return
    yield a
    if isinstance(a, P.FuncCall):
        kids = list(a.args)
        if a.over:
            kids += list(a.over.partition_by)
            kids += [e for e, _, _ in a.over.order_by]
    elif isinstance(a, P.BinOp):
        kids = [a.left, a.right]
    elif isinstance(a, P.UnOp):
        kids = [a.operand]
    elif isinstance(a, P.CaseAst):
        kids = [a.operand, *(x for b in a.branches for x in b), a.else_]
    elif isinstance(a, P.CastAst):
        kids = [a.expr]
    elif isinstance(a, P.BetweenAst):
        kids = [a.expr, a.lo, a.hi]
    elif isinstance(a, P.InAst):
        kids = [a.expr] + (a.values if isinstance(a.values, list) else [])
    elif isinstance(a, (P.LikeAst, P.IsNullAst)):
        kids = [a.expr]
    else:
        kids = []
    for k in kids:
        yield from _ast_nodes(k)


def _ast_idents(a) -> list:
    """Every column identifier of an AST expression, outside subqueries."""
    return [x for x in _ast_nodes(a) if isinstance(x, P.Ident)]


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
    if isinstance(date_expr.dtype, T.TimestampType):
        # a fixed-length interval moves a timestamp by its microseconds
        # (Spark's TimeAdd); a calendar one is refused, as the reference
        # refuses it on the device
        from spark_rapids_tpu_torch.expr.datetime import TimeAdd
        per = {"day": 86_400, "week": 7 * 86_400, "hour": 3600,
               "minute": 60, "second": 1}.get(unit)
        if per is None:
            raise _not_ported(f"a timestamp ± INTERVAL in {unit}s")
        return TimeAdd(date_expr, E.Literal(n * per * 1_000_000, T.LONG))
    if unit in ("day", "week"):
        days = n * (7 if unit == "week" else 1)
        return DateAddInterval(date_expr, E.Literal(days, T.INT))
    if unit in ("month", "year"):
        months = n * (12 if unit == "year" else 1)
        return AddMonths(date_expr, E.Literal(months, T.INT))
    raise P.SqlParseError(f"unsupported interval unit {iv.unit!r}")


def _and_all(conv: "_ExprConverter", conjs):
    cond = conv.convert(conjs[0])
    for cj in conjs[1:]:
        cond = PR.And(cond, conv.convert(cj))
    return cond


class _Relation:
    """One FROM item during join planning."""

    def __init__(self, plan, scope: Scope):
        self.plan = plan
        self.scope = scope


class _Eager:
    """The eager subqueries of one statement: each result, keyed by the
    subquery's text and the views it resolves against (q14 reads one
    CTE-backed subquery from three UNION ALL arms: one run serves them),
    and the physical plans that ran, so that a caller can count their
    scans and launches with the statement's."""

    def __init__(self):
        self.cache: dict = {}
        self.plans: list = []

    def collect(self, plan, session):
        from spark_rapids_tpu_torch.session import DataFrame
        phys = DataFrame(plan, session).physical_plan()
        self.plans.append(phys)
        return phys.execute_collect()


class _Lowerer:
    def __init__(self, session, views: dict, eager: _Eager | None = None):
        self.session = session
        self.views = dict(views)
        self.eager = eager if eager is not None else _Eager()

    def lower(self, q):
        for name, cte in q.ctes:
            self.views = dict(self.views)
            self.views[name] = self.dataframe(cte)
        return self._query(q)

    def _query(self, q):
        return self._setop(q) if isinstance(q, P.SetOp) else self._select(q)

    def _sub(self) -> "_Lowerer":
        return _Lowerer(self.session, self.views, self.eager)

    def dataframe(self, q):
        from spark_rapids_tpu_torch.session import DataFrame
        return DataFrame(self._sub().lower(q), self.session)

    # -- eager subqueries -----------------------------------------------------
    def _eager_key(self, kind, q):
        return (kind, repr(q),
                tuple(sorted((n, id(df)) for n, df in self.views.items())))

    def scalar_subquery(self, q):
        """A scalar subquery, run once (the reference's
        ``ScalarSubquery.from_dataframe``)."""
        from spark_rapids_tpu_torch.expr.misc import ScalarSubquery
        key = self._eager_key("scalar", q)
        hit = self.eager.cache.get(key)
        if hit is None:
            plan = self.dataframe(q)._plan
            if len(plan.output) != 1:
                raise SqlAnalysisError(
                    "a scalar subquery must return one column")
            hit = ScalarSubquery.from_table(
                self.eager.collect(plan, self.session),
                plan.output[0].data_type)
            self.eager.cache[key] = hit
        return hit

    def in_subquery_values(self, q):
        """The distinct values of an IN subquery's one column, in their
        first order, and its type; run once."""
        key = self._eager_key("in", q)
        hit = self.eager.cache.get(key)
        if hit is None:
            plan = self.dataframe(q)._plan
            if len(plan.output) != 1:
                raise SqlAnalysisError(
                    "IN (subquery) must return exactly one column")
            tbl = self.eager.collect(plan, self.session)
            from spark_rapids_tpu_torch.expr.misc import device_value
            hit = ([device_value(v) for v in
                    dict.fromkeys(tbl.column(0).to_pylist())],
                   plan.output[0].data_type)
            self.eager.cache[key] = hit
        return hit

    # -- set operations -------------------------------------------------------
    def _setop(self, s: P.SetOp):
        """UNION [ALL], INTERSECT [ALL] and EXCEPT [ALL] (Spark's
        ResolveSetOperations and the optimizer's rewrites of them):

        - UNION ALL: a UnionNode; UNION dedups it by a group-by-all;
        - INTERSECT: the deduped left arm LEFT SEMI joined to the right on
          every column, null-safely (a set operation's NULLs are equal,
          unlike a join key's); EXCEPT: a LEFT ANTI join the same way;
        - INTERSECT ALL and EXCEPT ALL: each arm numbers its copies of a
          row with ``row_number() over (partition by every column)``, and
          the semi or anti join on (the columns, the number) keeps
          min(l, r) or max(l - r, 0) copies."""
        def arm(q):
            # a parenthesized arm may carry a WITH of its own
            if getattr(q, "ctes", None):
                return self.dataframe(q)._plan
            return self._query(q)
        left, right = self._align_setop(arm(s.left), arm(s.right), s.op)
        if s.op == "union":
            plan = NN.UnionNode(left, right)
            if not s.all:
                plan = self._dedup(plan)
        elif not s.all:
            jt = "leftsemi" if s.op == "intersect" else "leftanti"
            dl = self._dedup(left)
            lkeys, rkeys = self._nullsafe_keys(dl, right)
            plan = NN.JoinNode(dl, right, lkeys, rkeys, jt)
        else:
            plan = self._setop_all(left, right, s.op)
        if s.order_by:
            plan = self._order_union(plan, s.order_by)
        if s.limit is not None:
            plan = NN.LimitNode(s.limit, plan, global_limit=True)
        return plan

    @staticmethod
    def _align_setop(left, right, op):
        """Spark's WidenSetOperationTypes: equal arity, and each column cast
        to the arms' common type where they differ."""
        from spark_rapids_tpu_torch.expr.arithmetic import promote
        from spark_rapids_tpu_torch.expr.cast import Cast
        lo, ro = left.output, right.output
        if len(lo) != len(ro):
            raise SqlAnalysisError(
                f"{op.upper()} arms have {len(lo)} vs {len(ro)} columns")
        targets = []
        for lf, rf in zip(lo.fields, ro.fields):
            if lf.data_type == rf.data_type:
                targets.append(lf.data_type)
                continue
            try:
                targets.append(promote(lf.data_type, rf.data_type))
            except NotImplementedError as e:
                raise SqlAnalysisError(
                    f"{op.upper()} column {lf.name}: incompatible types "
                    f"{lf.data_type} vs {rf.data_type}") from e

        def cast_arm(plan, out):
            if all(f.data_type == t for f, t in zip(out.fields, targets)):
                return plan
            proj = []
            for i, (f, t) in enumerate(zip(out.fields, targets)):
                r = E.BoundReference(i, f.data_type, f.nullable, f.name)
                proj.append(E.Alias(r if f.data_type == t else Cast(r, t),
                                    f.name))
            return NN.ProjectNode(proj, plan)
        return cast_arm(left, lo), cast_arm(right, ro)

    @staticmethod
    def _dedup(plan):
        """DISTINCT as a group-by-all (Spark's
        ReplaceDistinctWithAggregate)."""
        keys = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                for i, f in enumerate(plan.output)]
        return NN.AggregateNode(keys, [], plan)

    @staticmethod
    def _nullsafe_zero(dt):
        if isinstance(dt, T.StringType):
            return ""
        if isinstance(dt, T.BooleanType):
            return False
        if isinstance(dt, T.DoubleType):
            return 0.0
        return 0

    def _nullsafe_keys(self, left, right, extra=0):
        """Join keys on every column with a set operation's NULL = NULL: a
        column that is nullable in either arm joins on the pair (IS NULL,
        coalesce(col, zero)), both never null, so the join's rule that a
        null key never matches is not reached (the role of Spark's
        ``<=>``). The last ``extra`` columns (a row number) join as they
        are."""
        from spark_rapids_tpu_torch.expr.nullexprs import Coalesce, IsNull
        lkeys, rkeys = [], []
        n = len(left.output) - extra
        nullable = [lf.nullable or rf.nullable
                    for lf, rf in zip(left.output.fields,
                                      right.output.fields)]
        for keys, out in ((lkeys, left.output), (rkeys, right.output)):
            for i, f in enumerate(out.fields):
                r = E.BoundReference(i, f.data_type, f.nullable, f.name)
                if i >= n or not nullable[i]:
                    keys.append(r)
                    continue
                keys.append(IsNull(r))
                keys.append(Coalesce(r, E.Literal(
                    self._nullsafe_zero(f.data_type), f.data_type)))
        return lkeys, rkeys

    @staticmethod
    def _number_duplicates(plan):
        """Append ``_n = row_number() over (partition by every column)``:
        the k-th copy of a row gets k (equal rows are interchangeable, so
        the order inside a partition does not matter)."""
        from spark_rapids_tpu_torch.expr.windows import (
            RowNumber, WindowExpression, WindowSpec)
        refs = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                for i, f in enumerate(plan.output)]
        spec = WindowSpec(tuple(refs), ((refs[0], True, True),))
        return NN.WindowNode(
            [E.Alias(WindowExpression(RowNumber(), spec), "_n")], plan)

    def _setop_all(self, left, right, op):
        ln = self._number_duplicates(left)
        rn = self._number_duplicates(right)
        lkeys, rkeys = self._nullsafe_keys(ln, rn, extra=1)
        jt = "leftsemi" if op == "intersect" else "leftanti"
        joined = NN.JoinNode(ln, rn, lkeys, rkeys, jt)
        # drop the row number
        proj = [E.Alias(E.BoundReference(i, f.data_type, f.nullable, f.name),
                        f.name)
                for i, f in enumerate(joined.output.fields[:-1])]
        return NN.ProjectNode(proj, joined)

    @staticmethod
    def _order_union(plan, order_items):
        """ORDER BY over a set operation: output names and ordinals."""
        sort_exprs = []
        for (ast, asc, nf) in order_items:
            nulls_first = asc if nf is None else nf
            if isinstance(ast, P.Lit) and isinstance(ast.value, int):
                idx = ast.value - 1
                if not (0 <= idx < len(plan.output)):
                    raise SqlAnalysisError(
                        f"ORDER BY position {ast.value} out of range")
            elif isinstance(ast, P.Ident) and len(ast.parts) == 1:
                idx = plan.output.index_of(ast.parts[-1])
            else:
                raise SqlAnalysisError(
                    "ORDER BY over a set operation takes output names and "
                    f"ordinals only (got {ast!r})")
            f = plan.output[idx]
            sort_exprs.append((E.BoundReference(idx, f.data_type, f.nullable,
                                                f.name), asc, nulls_first))
        return NN.SortNode(sort_exprs, plan)

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
                    residual.append(
                        _ExprConverter(combined, self).convert(conj))
        cond = None
        if residual:
            cond = residual[0]
            for r in residual[1:]:
                cond = PR.And(cond, r)
        if how != "inner" or not lkeys:
            # an outer, semi or anti join without equi keys keeps its type
            # (the nested-loop join runs it); the reference makes it a
            # cross join, which drops its unmatched rows
            plan = NN.JoinNode(left.plan, right.plan, lkeys, rkeys,
                               "cross" if (how in ("cross", "inner")
                                           and not lkeys) else how, cond)
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

        # [NOT] EXISTS conjuncts apply as semi/anti joins over the whole
        # join graph (the correlation may name several outer relations)
        exists_list, rest = [], []
        for c in conjuncts:
            if isinstance(c, P.ExistsAst):
                exists_list.append((c.query, c.negated))
            elif isinstance(c, P.UnOp) and c.op == "not" \
                    and isinstance(c.operand, P.ExistsAst):
                exists_list.append((c.operand.query, not c.operand.negated))
            else:
                rest.append(c)
        conjuncts = rest

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

        # push single-relation filters down before joining; `x IN
        # (subquery)` becomes a LEFT SEMI join against the subquery's plan
        # (Spark's RewritePredicateSubquery) rather than a literal set
        # whose comparisons grow with the subquery's rows
        for ri, conjs in single.items():
            rel = rels[ri]
            conv = _ExprConverter(rel.scope, self)
            plain = [cj for cj in conjs if not self._is_in_subquery(cj)]
            if plain:
                rel.plan = NN.FilterNode(_and_all(conv, plain), rel.plan)
            for cj in conjs:
                if not self._is_in_subquery(cj):
                    continue
                sub = self.dataframe(cj.values)._plan
                if len(sub.output) != 1:
                    raise SqlAnalysisError(
                        "IN (subquery) must return exactly one column")
                f0 = sub.output[0]
                rel.plan = NN.JoinNode(
                    rel.plan, sub, [conv.convert(cj.expr)],
                    [E.BoundReference(0, f0.data_type, f0.nullable,
                                      f0.name)], "leftsemi")

        n = len(rels)
        if n == 1:
            plan, scope = rels[0].plan, rels[0].scope
            if leftover:
                # an unresolvable conjunct must raise (a misspelt column),
                # never drop the filter
                plan = NN.FilterNode(_and_all(_ExprConverter(scope, self),
                                              leftover), plan)
            for sub_q, negated in exists_list:
                plan = self._apply_exists(plan, scope, sub_q, negated)
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
            plan = NN.FilterNode(_and_all(_ExprConverter(scope, self),
                                          leftover), plan)
        for sub_q, negated in exists_list:
            plan = self._apply_exists(plan, scope, sub_q, negated)
        return plan, scope

    @staticmethod
    def _is_in_subquery(cj) -> bool:
        return (isinstance(cj, P.InAst) and not cj.negated
                and isinstance(cj.values, (P.Select, P.SetOp)))

    def _apply_exists(self, plan, scope, q2, negated: bool):
        """[NOT] EXISTS (subquery) over the planned outer relation (Spark's
        RewritePredicateSubquery; the reference runs the result as a
        broadcast semi or anti join). The correlation must be equalities in
        the subquery's WHERE between an outer and an inner column: they
        become the join keys, and every other conjunct must resolve inside
        the subquery. An uncorrelated EXISTS is folded now: the subquery
        runs once, with LIMIT 1."""
        if not isinstance(q2, P.Select) or q2.group_by or q2.having \
                or q2.grouping_sets is not None or q2.ctes \
                or q2.limit == 0 \
                or any(self._ast_has_agg(it.expr) for it in q2.items
                       if not isinstance(it.expr, P.Star)):
            # an aggregate without GROUP BY yields one row whatever its
            # input: the existence of its input rows is not what it asks
            raise SqlAnalysisError(
                "EXISTS subqueries support plain SELECT ... FROM ... WHERE "
                "shapes (no GROUP BY/HAVING/CTE/aggregates/LIMIT 0)")
        sub = self._sub()
        # the scopes of the inner relations alone: the plan is built once,
        # below, with the inner conjuncts as its WHERE
        iscope = None
        for item in q2.from_:
            s2 = sub._base_relation(item).scope
            iscope = s2 if iscope is None else iscope.concat(s2)
        pairs, inner_only = [], []      # [(outer parts, inner parts)]
        for cj in (_flatten_and(q2.where) if q2.where is not None else []):
            if self._is_equi_ast(cj):
                li, ri = cj.left.parts, cj.right.parts
                l_in, r_in = len(iscope.find(li)), len(iscope.find(ri))
                # a name in both scopes resolves inside (Spark's rule)
                if l_in == 0 and r_in == 1 and len(scope.find(li)) == 1:
                    pairs.append((li, ri))
                    continue
                if r_in == 0 and l_in == 1 and len(scope.find(ri)) == 1:
                    pairs.append((ri, li))
                    continue
            if all(iscope.find(i.parts) for i in _ast_idents(cj)):
                inner_only.append(cj)
                continue
            raise SqlAnalysisError(
                "EXISTS: only equality correlation to the outer query "
                f"is supported (got {cj!r})")
        iplan, iscope = self._sub()._plan_from(
            P.Select(q2.items, q2.from_,
                     _and_of(inner_only) if inner_only else None))
        lkeys = [scope.resolve(op) for op, _ in pairs]
        rkeys = [iscope.resolve(ip) for _, ip in pairs]
        if not lkeys:
            n = self.eager.collect(NN.LimitNode(1, iplan, global_limit=True),
                                   self.session).num_rows
            if (n > 0) != negated:
                return plan
            return NN.FilterNode(E.Literal(False, T.BOOLEAN), plan)
        return NN.JoinNode(plan, iplan, lkeys, rkeys,
                           "leftanti" if negated else "leftsemi")

    @staticmethod
    def _ast_has_agg(a) -> bool:
        """Whether an AST expression calls an aggregate (outside a window
        and a subquery)."""
        agg_names = set(_AGG_FUNCS) | set(_UNPORTED_AGGS) | {"count"}
        return any(isinstance(x, P.FuncCall) and x.over is None
                   and x.name in agg_names for x in _ast_nodes(a))

    # -- SELECT block ---------------------------------------------------------
    def _select(self, q: P.Select):
        if not q.from_:
            # SELECT <expressions>: over a one-row relation
            import pyarrow as pa
            plan = NN.ScanNode([pa.table({"_one": pa.array([1],
                                                            pa.int32())})])
            scope = Scope.for_relation(plan, None)
        else:
            plan, scope = self._plan_from(q)
        conv = _ExprConverter(scope, self)

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
        if having_e is not None:
            from spark_rapids_tpu_torch.expr.windows import WindowExpression
            if having_e.collect(lambda x: isinstance(x, WindowExpression)):
                raise _not_ported("a window function in HAVING")  # as Spark
        group_es = [self._group_expr(g, conv, items) for g in q.group_by]
        order_items = q.order_by

        has_agg = bool(group_es) or any(
            self._contains_agg(e) for e, _ in items) or (
            having_e is not None and self._contains_agg(having_e))
        if has_agg:
            grouping = (q.grouping_sets if q.grouping_sets is not None
                        else q.rollup)
            plan, sub = self._aggregate(plan, group_es, items, having_e,
                                        grouping, order_items, conv)
            items = [(sub(e), nm) for e, nm in items]
            having_e = sub(having_e) if having_e is not None else None
        else:
            if any(e.collect(lambda x: isinstance(x, _Grouping))
                   for e, _ in items):
                raise SqlAnalysisError("grouping() outside GROUP BY ROLLUP")

            def sub(e):
                return e

        # HAVING filters the groups before any window sees them, as in
        # Spark
        if having_e is not None:
            plan = NN.FilterNode(having_e, plan)

        plan, wsub = self._windows(plan, items)
        items = [(wsub(e), nm) for e, nm in items]
        n_items = len(items)
        if has_agg and order_items and not q.distinct:
            items = items + self._hidden_order_aggs(order_items, items, conv,
                                                    lambda e: wsub(sub(e)))

        plan = NN.ProjectNode([E.Alias(e, nm) for e, nm in items], plan)

        if q.distinct:
            plan = self._dedup(plan)

        if order_items:
            plan = self._order_by(plan, order_items, items, conv,
                                  lambda e: wsub(sub(e)))
        if len(items) > n_items:
            # the ORDER BY's own aggregates ride to the sort and go
            plan = NN.ProjectNode(
                [E.Alias(E.BoundReference(i, f.data_type, f.nullable, f.name),
                         f.name)
                 for i, f in enumerate(plan.output.fields[:n_items])], plan)
        if q.limit is not None:
            plan = NN.LimitNode(q.limit, plan, global_limit=True)
        return plan

    def _hidden_order_aggs(self, order_items, items, conv, sub) -> list:
        """ORDER BY expressions over aggregates or ``grouping()`` that the
        select list does not hold (``select g ... order by sum(x)``): each
        becomes a hidden column of the projection, as Spark's analyzer adds
        it below the sort; the caller drops them after the sort."""
        keys = {expr_key(e) for e, _ in items}
        names = {nm.lower() for _, nm in items}
        extra = []
        for (ast, _, _) in order_items:
            if isinstance(ast, P.Lit) or (isinstance(ast, P.Ident)
                                          and ast.parts[-1].lower() in names):
                continue
            try:
                e = conv.convert(ast)
            except SqlAnalysisError:
                continue
            if not e.collect(lambda x: isinstance(
                    x, (_Grouping, AggregateFunction))):
                continue
            se = sub(e)
            k = expr_key(se)
            if k not in keys:
                keys.add(k)
                extra.append((se, f"_o{len(extra)}"))
        return extra

    @staticmethod
    def _windows(plan, items):
        """The distinct window expressions of the select list as one
        WindowNode over ``plan`` (after the aggregate and HAVING, when there
        are); returns the plan and the substitution of each window
        expression by its column."""
        from spark_rapids_tpu_torch.expr.windows import WindowExpression
        found = []
        for e, _ in items:
            found += e.collect(lambda x: isinstance(x, WindowExpression))
        if not found:
            return plan, lambda e: e
        base_n = len(plan.output)
        named, keys = [], {}
        for w in found:
            k = expr_key(w)
            if k in keys:
                continue
            nm = f"_w{len(named)}"
            keys[k] = (base_n + len(named), nm, w.dtype)
            named.append(E.Alias(w, nm))
        plan = NN.WindowNode(named, plan)

        def wsub(e):
            if e is None:
                return None
            k = expr_key(e)
            if k in keys:
                idx, nm, dt = keys[k]
                return E.BoundReference(idx, dt, True, nm)
            return (e.with_children([wsub(c) for c in e.children])
                    if e.children else e)
        return plan, wsub

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
                out_conv = _ExprConverter(Scope.for_relation(plan, None),
                                          self)
                e = ("hidden", out_conv.convert(ast))
                if e[1].collect(lambda x: isinstance(
                        x, (_Grouping, AggregateFunction))):
                    # Spark computes it below the projection; the
                    # reference cannot either
                    raise _not_ported("an ORDER BY aggregate or grouping() "
                                      "outside the select list")
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
        """An aggregate outside a window function: a WindowExpression's
        children are its function's inputs, so ``avg(sum(x)) over (...)``
        counts (through ``sum``) and ``sum(x) over (...)`` does not."""
        if isinstance(e, AggregateFunction):
            return True
        return any(_Lowerer._contains_agg(c) for c in e.children)

    # -- aggregation ----------------------------------------------------------
    def _aggregate(self, plan, group_es, items, having_e, grouping,
                   order_items, conv):
        """Build the (Expand →) AggregateNode, or a DISTINCT rewrite of it;
        return (plan, substitution fn). ``grouping`` is True for ROLLUP, a
        list of grouping sets, or falsy."""
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

        gid_ref = None
        if grouping:
            sets = grouping if isinstance(grouping, list) else None
            plan, group_refs, gid_ref = self._expand_rollup(plan, group_es,
                                                            sets)
            group_bound = group_refs + [gid_ref]
        else:
            group_bound = list(group_es)

        if any(isinstance(a, _DistinctAgg) for _, a in aggs):
            if self._fast_distinct_ok(aggs, grouping):
                agg_node, n_group = self._rewrite_distinct(plan, group_bound,
                                                           aggs)
            else:
                agg_node, n_group = self._rewrite_distinct_expand(
                    plan, group_bound, aggs)
        else:
            agg_node = NN.AggregateNode(
                group_bound, [E.Alias(a, f"_a{i}")
                              for i, (_, a) in enumerate(aggs)], plan)
            n_group = len(group_bound)
        out = agg_node.output
        group_keys = {expr_key(g): i for i, g in enumerate(group_es)}

        def sub(e):
            if e is None:
                return None
            if isinstance(e, _Grouping):
                if gid_ref is None:
                    raise SqlAnalysisError(
                        "grouping() outside GROUP BY ROLLUP")
                return self._grouping_bit(e, group_es, n_group, out)
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

    @staticmethod
    def _grouping_bit(g: _Grouping, group_es, n_group, out_schema):
        """grouping(col) → (gid >> bit) & 1 over the aggregate output's
        grouping id, its last key (Spark's: the first GROUP BY column is the
        most significant bit)."""
        from spark_rapids_tpu_torch.expr.arithmetic import (BitwiseAnd,
                                                           ShiftRight)
        target = expr_key(g.children[0])
        pos = next((i for i, ge in enumerate(group_es)
                    if expr_key(ge) == target), None)
        if pos is None:
            raise SqlAnalysisError("grouping() argument must be a GROUP BY "
                                   "column")
        gid_idx = n_group - 1
        f = out_schema[gid_idx]
        gid = E.BoundReference(gid_idx, f.data_type, False, f.name)
        bit = len(group_es) - 1 - pos
        shifted = ShiftRight(gid, E.Literal(bit)) if bit else gid
        return BitwiseAnd(shifted, E.Literal(1))

    @staticmethod
    def _expand_rollup(plan, group_es, sets=None):
        """ROLLUP / CUBE / GROUPING SETS as Spark's Expand
        (``plan/nodes.build_grouping_sets_expand``, which
        ``DataFrame.rollup`` shares). ``sets`` lists the kept key indices of
        each grouping set, or is None for ROLLUP."""
        for g in group_es:
            if not isinstance(g, (E.BoundReference, E.AttributeReference)):
                raise SqlAnalysisError(
                    "GROUP BY ROLLUP/CUBE/GROUPING SETS supports plain "
                    "columns only")
        if sets is None:
            return NN.build_rollup_expand(plan, group_es)
        return NN.build_grouping_sets_expand(plan, group_es, sets)

    # -- DISTINCT aggregates --------------------------------------------------
    @staticmethod
    def _fast_distinct_ok(aggs, grouping) -> bool:
        """Whether the two-aggregate rewrite (``_rewrite_distinct``) applies:
        no grouping sets, ONE distinct argument, and every other aggregate
        a min/max, or a count/sum/avg of that argument (not a decimal)."""
        if grouping:
            return False
        xkeys = {expr_key(a.child) for _, a in aggs
                 if isinstance(a, _DistinctAgg)}
        if len(xkeys) != 1:
            return False
        xkey = next(iter(xkeys))
        x = next(a.child for _, a in aggs if isinstance(a, _DistinctAgg))

        def same_col(a):
            return (isinstance(a, (Count, Sum, Average))
                    and a.child is not None and expr_key(a.child) == xkey)
        others = [a for _, a in aggs if not isinstance(a, _DistinctAgg)
                  and not same_col(a)]
        if not all(isinstance(a, (Min, Max)) for a in others):
            return False
        need_cnt = any(same_col(a) for _, a in aggs
                       if not isinstance(a, _DistinctAgg))
        return not (need_cnt and isinstance(x.dtype, T.DecimalType))

    def _rewrite_distinct(self, plan, group_bound, aggs):
        """Spark's RewriteDistinctAggregates for one distinct argument x:
        the inner aggregate groups by (keys, x), which dedups x per group,
        and the outer one re-reduces by the keys. The other aggregates:

        - min/max of anything, re-reduced from the inner partials;
        - count/sum/avg of x itself (TPC-DS q28's form): the inner also
          counts cnt = count(x) per (keys, x), and the outer derives
          count(x) = sum(cnt), sum(x) = sum(x*cnt) and
          avg(x) = sum(x*cnt) / sum(cnt) (a double, summed in another order
          than a plain avg)."""
        from spark_rapids_tpu_torch.expr.arithmetic import Divide, Multiply
        from spark_rapids_tpu_torch.expr.cast import Cast
        from spark_rapids_tpu_torch.expr.nullexprs import Coalesce
        xkey = next(expr_key(a.child) for _, a in aggs
                    if isinstance(a, _DistinctAgg))
        x = next(a.child for _, a in aggs if isinstance(a, _DistinctAgg))

        def same_col(a):
            return (isinstance(a, (Count, Sum, Average))
                    and a.child is not None and expr_key(a.child) == xkey)

        others = [(k, a) for k, a in aggs if not isinstance(a, _DistinctAgg)
                  and not same_col(a)]
        need_cnt = any(same_col(a) for _, a in aggs
                       if not isinstance(a, _DistinctAgg))
        inner_aggs = [E.Alias(a, f"_m{i}") for i, (_, a) in enumerate(others)]
        if need_cnt:
            inner_aggs.append(E.Alias(Count(x), "_cnt"))
        inner = NN.AggregateNode(list(group_bound) + [x], inner_aggs, plan)
        iout = inner.output
        ng = len(group_bound)

        def ref(j):
            return E.BoundReference(j, iout.fields[j].data_type, True,
                                    iout.fields[j].name)

        x_ref = ref(ng)
        other_pos = {k: ng + 1 + i for i, (k, _) in enumerate(others)}
        cnt_ref = ref(ng + 1 + len(others)) if need_cnt else None
        # the outer aggregates are plain functions (AggregateNode's
        # contract); an avg takes two of them and a division, so a Project
        # above maps each original aggregate to its value
        outer_aggs = []       # Alias(AggregateFunction)
        final = []            # per original aggregate: ordinal | ("div", i, j)
        memo = {}             # expr key -> ordinal (avg and count share)

        def add(agg_fn):
            k = expr_key(agg_fn)
            if k not in memo:
                outer_aggs.append(E.Alias(agg_fn, f"_o{len(outer_aggs)}"))
                memo[k] = len(outer_aggs) - 1
            return memo[k]

        for k, a in aggs:
            if isinstance(a, _DistinctAgg):
                final.append(add(a.make(x_ref)))
            elif isinstance(a, (Min, Max)):
                final.append(add(type(a)(ref(other_pos[k]))))
            elif isinstance(a, Count):       # count(x) = sum(cnt)
                final.append(add(Sum(cnt_ref)))
            elif isinstance(a, Average):     # avg(x) = sum(x*cnt)/sum(cnt)
                num = add(Sum(Multiply(Cast(x_ref, T.DOUBLE),
                                       Cast(cnt_ref, T.DOUBLE))))
                den = add(Sum(cnt_ref))
                final.append(("div", num, den))
            else:                            # sum(x) = sum(x*cnt)
                st = Sum(x_ref).dtype
                final.append(add(
                    Sum(Multiply(Cast(x_ref, st), Cast(cnt_ref, st)))))
        outer_groups = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                        for i, f in enumerate(iout.fields[:ng])]
        agg_node = NN.AggregateNode(outer_groups, outer_aggs, inner)
        aout = agg_node.output
        proj = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                for i, f in enumerate(aout.fields[:ng])]
        for i, spec in enumerate(final):
            if isinstance(spec, tuple):
                _, num, den = spec
                e = Divide(
                    E.BoundReference(ng + num, aout.fields[ng + num].data_type,
                                     True, "n"),
                    Cast(E.BoundReference(ng + den,
                                          aout.fields[ng + den].data_type,
                                          True, "d"), T.DOUBLE))
            else:
                j = ng + spec
                e = E.BoundReference(j, aout.fields[j].data_type, True,
                                     aout.fields[j].name)
                if isinstance(aggs[i][1], Count):
                    # count over no rows is 0, not the NULL of an empty sum
                    e = Coalesce(e, E.Literal(0, T.LONG))
            proj.append(E.Alias(e, f"_a{i}"))
        return NN.ProjectNode(proj, agg_node), ng

    def _rewrite_distinct_expand(self, plan, group_bound, aggs):
        """Spark's RewriteDistinctAggregates in its general Expand form:
        several distinct arguments, and any count/sum/avg/min/max beside
        them. The Expand emits one projection per distinct argument, plus
        one for the regular aggregates when there are any, told apart by a
        branch id: the branch of argument x_i carries x_i and NULL for every
        other distinct and regular input; the regular branch carries the
        regular inputs and NULL x's. The inner aggregate groups by (keys,
        branch id, x_1..x_m), which dedups each distinct argument per group
        while the regular partials reduce (their inputs are NULL on the
        distinct branches); the outer one groups by the keys, applies the
        distinct functions to the deduped x's and merges the partials. With
        ROLLUP, ``plan`` is already the rollup's Expand, its grouping id the
        last of ``group_bound``."""
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        from spark_rapids_tpu_torch.expr.cast import Cast
        from spark_rapids_tpu_torch.expr.nullexprs import Coalesce

        # the distinct arguments, one branch each
        dkeys, dexpr = [], {}
        for _, a in aggs:
            if isinstance(a, _DistinctAgg):
                ck = expr_key(a.child)
                if ck not in dexpr:
                    dexpr[ck] = a.child
                    dkeys.append(ck)
        regulars = [(k, a) for k, a in aggs if not isinstance(a, _DistinctAgg)]
        for _, a in regulars:
            if not isinstance(a, (Min, Max, Count, Sum, Average)):
                raise SqlAnalysisError(
                    f"aggregate {a!r} cannot mix with DISTINCT aggregates")
            if isinstance(a, (Sum, Average)) and a.child is not None \
                    and isinstance(a.child.dtype, T.DecimalType):
                raise SqlAnalysisError(
                    "DECIMAL sum/avg mixed with DISTINCT aggregates "
                    "not supported")
        nk, m = len(group_bound), len(dkeys)
        # one input column per regular aggregate (count(*) counts a live 1)
        rcols = [E.Literal(1, T.INT) if a.child is None else a.child
                 for _, a in regulars]

        def null_of(e):
            return E.Literal(None, e.dtype)

        branches = ([("regular", None)] if regulars else []) \
            + [("distinct", i) for i in range(m)]
        projections = []
        for kind, di in branches:
            proj = list(group_bound)
            proj.append(E.Literal(len(projections), T.INT))
            for i, ck in enumerate(dkeys):
                e = dexpr[ck]
                proj.append(e if (kind == "distinct" and i == di)
                            else null_of(e))
            for rc in rcols:
                proj.append(rc if kind == "regular" else null_of(rc))
            projections.append(proj)
        out_fields = (
            [T.StructField(f"_k{i}", g.dtype, True)
             for i, g in enumerate(group_bound)]
            + [T.StructField("_bid", T.INT, False)]
            + [T.StructField(f"_x{i}", dexpr[ck].dtype, True)
               for i, ck in enumerate(dkeys)]
            + [T.StructField(f"_rc{j}", rc.dtype, True)
               for j, rc in enumerate(rcols)])
        expand = NN.ExpandNode(projections, out_fields, plan)
        eout = expand.output

        def eref(j):
            f = eout[j]
            return E.BoundReference(j, f.data_type, f.nullable, f.name)

        # inner: GROUP BY (keys, bid, x's); the regular partials
        inner_groups = [eref(j) for j in range(nk + 1 + m)]
        inner_aggs = []
        partial = []     # per regular aggregate: its inner ordinals

        def padd(fn):
            inner_aggs.append(E.Alias(fn, f"_p{len(inner_aggs)}"))
            return len(inner_aggs) - 1
        rbase = nk + 1 + m
        for j, (_, a) in enumerate(regulars):
            rc_ref = eref(rbase + j)
            if isinstance(a, (Min, Max)):
                partial.append([padd(type(a)(rc_ref))])
            elif isinstance(a, Count):
                partial.append([padd(Count(rc_ref))])
            elif isinstance(a, Sum):
                partial.append([padd(Sum(rc_ref))])
            else:                      # Average: sum and count partials
                partial.append([padd(Sum(Cast(rc_ref, T.DOUBLE))),
                                padd(Count(rc_ref))])
        inner = NN.AggregateNode(inner_groups, inner_aggs, expand)
        iout = inner.output

        def iref(j):
            f = iout[j]
            return E.BoundReference(j, f.data_type, True, f.name)

        outer_groups = [E.BoundReference(i, iout[i].data_type,
                                         iout[i].nullable, iout[i].name)
                        for i in range(nk)]
        x_pos = {ck: nk + 1 + i for i, ck in enumerate(dkeys)}
        pbase = nk + 1 + m
        outer_aggs, final, memo = [], [], {}

        def add(agg_fn):
            k = expr_key(agg_fn)
            if k not in memo:
                outer_aggs.append(E.Alias(agg_fn, f"_o{len(outer_aggs)}"))
                memo[k] = len(outer_aggs) - 1
            return memo[k]

        ri = iter(range(len(regulars)))
        for _, a in aggs:
            if isinstance(a, _DistinctAgg):
                final.append(add(a.make(iref(x_pos[expr_key(a.child)]))))
                continue
            j = next(ri)
            prefs = [iref(pbase + p) for p in partial[j]]
            if isinstance(a, (Min, Max)):
                final.append(add(type(a)(prefs[0])))
            elif isinstance(a, Count):       # the partial counts' sum
                final.append(("cnt", add(Sum(prefs[0]))))
            elif isinstance(a, Sum):
                final.append(add(Sum(prefs[0])))
            else:                            # sum(sums) / sum(counts)
                final.append(("div", add(Sum(prefs[0])),
                              add(Sum(prefs[1]))))
        agg_node = NN.AggregateNode(outer_groups, outer_aggs, inner)
        aout = agg_node.output

        def aref(j):
            f = aout[j]
            return E.BoundReference(j, f.data_type, True, f.name)

        proj = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                for i, f in enumerate(aout.fields[:nk])]
        for i, spec in enumerate(final):
            a = aggs[i][1]
            if isinstance(spec, tuple) and spec[0] == "div":
                e = Divide(aref(nk + spec[1]),
                           Cast(aref(nk + spec[2]), T.DOUBLE))
            elif isinstance(spec, tuple):    # ("cnt", ordinal): no rows → 0
                e = Coalesce(aref(nk + spec[1]), E.Literal(0, T.LONG))
            else:
                e = aref(nk + spec)
            if e.dtype != a.dtype:           # back to Spark's result type
                e = Cast(e, a.dtype)
            proj.append(E.Alias(e, f"_a{i}"))
        return NN.ProjectNode(proj, agg_node), nk


def lower_sql(text: str, views: dict, session):
    """Parse and lower ``text`` against ``views`` ({name: DataFrame});
    returns the plan and the physical plans of the subqueries that ran
    while it was lowered."""
    low = _Lowerer(session, views)
    return low.lower(P.parse_sql(text)), list(low.eager.plans)
