"""SQL lexer + recursive-descent parser producing a small AST.

The port's copy of ``spark_rapids_tpu/sql/parser.py``, whole: it is pure
Python, and the port imports nothing of the JAX package. The grammar is the
subset the official TPC-DS/TPC-H query text needs; ``sql/lower.py`` converts
the AST to plan nodes and expressions, and refuses what the port has not
ported.
"""

from __future__ import annotations

import dataclasses
import typing


class SqlParseError(ValueError):
    pass


# -- tokens -------------------------------------------------------------------

_TWO_CHAR = ("<=", ">=", "<>", "!=", "||")
_ONE_CHAR = "+-*/%(),.<>=;"


@dataclasses.dataclass
class Token:
    kind: str        # kw | ident | num | str | op | end
    value: typing.Any
    pos: int


_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "as", "and", "or", "not", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "join", "inner", "left",
    "right", "full", "outer", "cross", "on", "union", "all", "over",
    "partition", "rows", "range", "unbounded", "preceding", "following",
    "current", "row", "asc", "desc", "nulls", "first", "last", "rollup",
    "with", "exists", "intersect", "except", "semi", "anti", "using",
}


def tokenize(text: str) -> list:
    toks = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in " \t\r\n":
            i += 1
            continue
        if ch == "-" and text[i:i + 2] == "--":           # line comment
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if ch == "/" and text[i:i + 2] == "/*":           # block comment
            j = text.find("*/", i)
            if j < 0:
                raise SqlParseError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if ch == "'":                                      # string ('' escape)
            j, buf = i + 1, []
            while True:
                if j >= n:
                    raise SqlParseError(f"unterminated string at {i}")
                if text[j] == "'":
                    if text[j:j + 2] == "''":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            toks.append(Token("str", "".join(buf), i))
            i = j + 1
            continue
        if ch == '"':                                      # quoted identifier
            j = text.find('"', i + 1)
            if j < 0:
                raise SqlParseError(f"unterminated quoted identifier at {i}")
            toks.append(Token("ident", text[i + 1:j], i))
            i = j + 1
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                c = text[j]
                if c.isdigit():
                    j += 1
                elif c == "." and not seen_dot and not seen_exp:
                    # "1." followed by an ident char is `1 . ident` (unlikely
                    # in SQL); treat dot-digit only
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_exp and j + 1 < n and (
                        text[j + 1].isdigit() or text[j + 1] in "+-"):
                    seen_exp = True
                    j += 2 if text[j + 1] in "+-" else 1
                else:
                    break
            s = text[i:j]
            toks.append(Token("num", float(s) if (seen_dot or seen_exp)
                              else int(s), i))
            i = j
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            lw = word.lower()
            if lw in _KEYWORDS:
                toks.append(Token("kw", lw, i))
            else:
                toks.append(Token("ident", word, i))
            i = j
            continue
        if text[i:i + 2] in _TWO_CHAR:
            toks.append(Token("op", text[i:i + 2], i))
            i += 2
            continue
        if ch in _ONE_CHAR:
            toks.append(Token("op", ch, i))
            i += 1
            continue
        raise SqlParseError(f"unexpected character {ch!r} at {i}")
    toks.append(Token("end", None, n))
    return toks


# -- AST ----------------------------------------------------------------------

@dataclasses.dataclass
class Ident:
    parts: tuple     # ("col",) or ("tbl", "col")


@dataclasses.dataclass
class Lit:
    value: typing.Any


@dataclasses.dataclass
class Star:
    qualifier: str | None = None


@dataclasses.dataclass
class BinOp:
    op: str
    left: typing.Any
    right: typing.Any


@dataclasses.dataclass
class UnOp:
    op: str          # "-" | "not"
    operand: typing.Any


@dataclasses.dataclass
class FuncCall:
    name: str
    args: list
    distinct: bool = False
    over: "WindowSpecAst | None" = None


@dataclasses.dataclass
class CaseAst:
    operand: typing.Any          # CASE x WHEN v ... or None for searched CASE
    branches: list               # [(when_expr, then_expr)]
    else_: typing.Any


@dataclasses.dataclass
class IntervalAst:
    """INTERVAL '<n>' <unit> literal (TPC-H/DS date arithmetic)."""
    value: str
    unit: str


@dataclasses.dataclass
class CastAst:
    expr: typing.Any
    type_name: str
    type_args: tuple = ()
    #: True for DATE '...' / TIMESTAMP '...' typed literals — folded to
    #: constants at plan time; explicit cast() keeps Spark runtime semantics
    typed_literal: bool = False


@dataclasses.dataclass
class InAst:
    expr: typing.Any
    values: list                 # list of exprs, or a Select (subquery)
    negated: bool = False


@dataclasses.dataclass
class BetweenAst:
    expr: typing.Any
    lo: typing.Any
    hi: typing.Any
    negated: bool = False


@dataclasses.dataclass
class LikeAst:
    expr: typing.Any
    pattern: str
    negated: bool = False


@dataclasses.dataclass
class IsNullAst:
    expr: typing.Any
    negated: bool = False


@dataclasses.dataclass
class ExistsAst:
    query: "Select"
    negated: bool = False


@dataclasses.dataclass
class SubqueryExpr:
    query: "Select"


@dataclasses.dataclass
class WindowSpecAst:
    partition_by: list
    order_by: list               # [(expr, asc, nulls_first|None)]
    frame: tuple | None = None   # ("rows"|"range", lo, hi); None=unset


@dataclasses.dataclass
class TableRef:
    name: str
    alias: str | None = None


@dataclasses.dataclass
class SubqueryRef:
    query: "Select"
    alias: str = ""


@dataclasses.dataclass
class JoinRef:
    left: typing.Any
    right: typing.Any
    how: str                     # inner|left|right|full|cross|semi|anti
    on: typing.Any = None        # expr or None
    using: list | None = None    # [col names] for USING


@dataclasses.dataclass
class SelectItem:
    expr: typing.Any
    alias: str | None = None


@dataclasses.dataclass
class Select:
    items: list                  # [SelectItem] (Star allowed as expr)
    from_: list                  # [TableRef|SubqueryRef|JoinRef]; [] = no FROM
    where: typing.Any = None
    group_by: list = dataclasses.field(default_factory=list)
    rollup: bool = False         # legacy flag: GROUP BY ROLLUP(all group_by)
    having: typing.Any = None
    order_by: list = dataclasses.field(default_factory=list)
    limit: int | None = None
    distinct: bool = False
    ctes: list = dataclasses.field(default_factory=list)   # [(name, Select)]
    grouping_sets: list | None = None   # [[expr, ...], ...] (CUBE/ROLLUP/
    #                       GROUPING SETS normalize to explicit set lists)


@dataclasses.dataclass
class SetOp:
    """UNION/INTERSECT/EXCEPT tree over Select/SetOp arms. INTERSECT binds
    tighter than UNION/EXCEPT (standard precedence); trailing ORDER BY/LIMIT
    apply to the whole expression and ride the root node."""
    op: str                      # union|intersect|except
    all: bool
    left: typing.Any             # Select | SetOp
    right: typing.Any
    order_by: list = dataclasses.field(default_factory=list)
    limit: int | None = None
    ctes: list = dataclasses.field(default_factory=list)


# -- parser -------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: list):
        self.toks = toks
        self.i = 0

    # token helpers
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def eat_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw):
        if not self.eat_kw(kw):
            t = self.peek()
            raise SqlParseError(f"expected {kw.upper()} at pos {t.pos}, "
                                f"got {t.value!r}")

    def at_op(self, *ops) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op):
        if not self.eat_op(op):
            t = self.peek()
            raise SqlParseError(f"expected {op!r} at pos {t.pos}, "
                                f"got {t.value!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            self.next()
            return t.value
        # soft keywords usable as identifiers/aliases in practice
        if t.kind == "kw" and t.value in ("first", "last", "row", "rows",
                                          "current", "range", "all"):
            self.next()
            return t.value
        raise SqlParseError(f"expected identifier at pos {t.pos}, "
                            f"got {t.value!r}")

    # -- query ---------------------------------------------------------------
    def parse_query(self):
        ctes = []
        if self.eat_kw("with"):
            while True:
                name = self.ident()
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                ctes.append((name, q))
                if not self.eat_op(","):
                    break
        q = self.parse_select()
        q.ctes = ctes
        return q

    def parse_select(self):
        """Select expression with standard set-op precedence: INTERSECT
        binds tighter than UNION/EXCEPT; trailing ORDER BY/LIMIT apply to
        the whole expression. Returns Select or SetOp."""
        q = self._setop_term()
        while True:
            if self.at_kw("union", "except"):
                op = self.next().value
            elif self.peek().kind == "ident" \
                    and self.peek().value.lower() == "minus":
                self.next()
                op = "except"     # Spark: MINUS is EXCEPT DISTINCT
            else:
                break
            all_ = self.eat_kw("all")
            if not all_:
                self.eat_kw("distinct")   # explicit DISTINCT is the default
            q = SetOp(op, all_, q, self._setop_term())
        if self.at_kw("order", "limit") and (q.order_by or
                                             q.limit is not None):
            # '(select ... order by a limit 5) order by b': the inner
            # clauses already bound inside the parens — wrap in a derived
            # table so the outer ORDER BY/LIMIT stack on top instead of
            # appending to (or overwriting) the inner ones
            q = Select([SelectItem(Star())], [SubqueryRef(q, "_sq")])
        self._order_limit_tail(q)
        return q

    def _setop_term(self):
        q = self._setop_primary()
        while self.eat_kw("intersect"):
            all_ = self.eat_kw("all")
            if not all_:
                self.eat_kw("distinct")
            q = SetOp("intersect", all_, q, self._setop_primary())
        return q

    def _setop_primary(self):
        if self.at_op("("):
            self.next()
            q = self.parse_query()     # parenthesized arm, may nest set ops
            self.expect_op(")")
            return q
        return self.parse_select_atom()

    def _order_limit_tail(self, sel):
        if self.eat_kw("order"):
            self.expect_kw("by")
            sel.order_by.append(self.parse_order_item())
            while self.eat_op(","):
                sel.order_by.append(self.parse_order_item())
        if self.eat_kw("limit"):
            t = self.next()
            if t.kind != "num" or not isinstance(t.value, int):
                raise SqlParseError(f"LIMIT needs an integer at pos {t.pos}")
            sel.limit = t.value

    def _group_expr_list(self) -> list:
        self.expect_op("(")
        out = []
        if not self.at_op(")"):       # GROUPING SETS allows the empty set ()
            out.append(self.parse_expr())
            while self.eat_op(","):
                out.append(self.parse_expr())
        self.expect_op(")")
        return out

    def parse_select_atom(self) -> Select:
        self.expect_kw("select")
        distinct = self.eat_kw("distinct")
        items = [self.parse_select_item()]
        while self.eat_op(","):
            items.append(self.parse_select_item())
        from_ = []
        if self.eat_kw("from"):
            from_ = [self.parse_table_ref()]
            while self.eat_op(","):
                from_.append(self.parse_table_ref())
        where = self.parse_expr() if self.eat_kw("where") else None
        group_by, rollup, gsets = [], False, None
        if self.eat_kw("group"):
            self.expect_kw("by")
            t = self.peek()
            soft = t.value.lower() if t.kind == "ident" else ""
            if self.eat_kw("rollup"):
                rollup = True
                group_by = self._group_expr_list()
            elif soft == "cube":
                self.next()
                group_by = self._group_expr_list()
                n = len(group_by)
                # all 2^n subsets, largest first (Spark emits gid ascending;
                # gid order is irrelevant to grouping correctness)
                gsets = [[i for i in range(n) if not (mask >> (n - 1 - i)) & 1]
                         for mask in range(1 << n)]
            elif soft == "grouping" and len(self.toks) > self.i + 1 \
                    and self.toks[self.i + 1].kind == "ident" \
                    and self.toks[self.i + 1].value.lower() == "sets":
                self.next()
                self.next()
                self.expect_op("(")
                sets_exprs = []
                while True:
                    if self.at_op("("):
                        sets_exprs.append(self._group_expr_list())
                    else:
                        sets_exprs.append([self.parse_expr()])
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                # normalize: group_by = deduped union of all set exprs (by
                # textual identity); each set lists indices into group_by
                keyed = []
                gsets = []
                for se in sets_exprs:
                    idxs = []
                    for e in se:
                        k = repr(e)
                        for j, (k2, _) in enumerate(keyed):
                            if k2 == k:
                                idxs.append(j)
                                break
                        else:
                            keyed.append((k, e))
                            idxs.append(len(keyed) - 1)
                    gsets.append(idxs)
                group_by = [e for _, e in keyed]
            else:
                group_by.append(self.parse_expr())
                while self.eat_op(","):
                    group_by.append(self.parse_expr())
        having = self.parse_expr() if self.eat_kw("having") else None
        return Select(items, from_, where, group_by, rollup, having,
                      distinct=distinct, grouping_sets=gsets)

    def parse_select_item(self) -> SelectItem:
        if self.at_op("*"):
            self.next()
            return SelectItem(Star())
        e = self.parse_expr()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        return SelectItem(e, alias)

    def parse_order_item(self):
        e = self.parse_expr()
        asc = True
        if self.eat_kw("desc"):
            asc = False
        else:
            self.eat_kw("asc")
        nulls_first = None
        if self.eat_kw("nulls"):
            if self.eat_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return (e, asc, nulls_first)

    # -- FROM ----------------------------------------------------------------
    def parse_table_ref(self):
        left = self.parse_table_primary()
        while True:
            how = None
            if self.eat_kw("cross"):
                self.expect_kw("join")
                how = "cross"
            elif self.at_kw("join", "inner", "left", "right", "full"):
                if self.eat_kw("inner"):
                    how = "inner"
                elif self.eat_kw("left"):
                    how = ("semi" if self.eat_kw("semi")
                           else "anti" if self.eat_kw("anti") else "left")
                    self.eat_kw("outer")
                elif self.eat_kw("right"):
                    how = "right"
                    self.eat_kw("outer")
                elif self.eat_kw("full"):
                    how = "full"
                    self.eat_kw("outer")
                else:
                    how = "inner"
                self.expect_kw("join")
            else:
                return left
            right = self.parse_table_primary()
            on = using = None
            if how != "cross":
                if self.eat_kw("using"):
                    self.expect_op("(")
                    using = [self.ident()]
                    while self.eat_op(","):
                        using.append(self.ident())
                    self.expect_op(")")
                else:
                    self.expect_kw("on")
                    on = self.parse_expr()
            left = JoinRef(left, right, how, on, using)

    def _query_ahead(self) -> bool:
        """At a '('-led position: does SELECT/WITH follow the open parens?
        A necessary (not sufficient) sign of a parenthesized query
        expression — '((select ...) except (select ...))'; the caller still
        backtracks if the full parse doesn't close cleanly, because
        '((select ...) a join ...)' starts identically but is a join tree."""
        j = self.i
        while j < len(self.toks) and self.toks[j].kind == "op" \
                and self.toks[j].value == "(":
            j += 1
        t = self.toks[j] if j < len(self.toks) else self.toks[-1]
        return t.kind == "kw" and t.value in ("select", "with")

    def parse_table_primary(self):
        if self.eat_op("("):
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                self.eat_kw("as")
                alias = self.ident()
                return SubqueryRef(q, alias)
            if self._query_ahead():
                # '((select' is ambiguous: a set-op tree with parenthesized
                # arms, or a join tree whose first element is an aliased
                # subquery. Try the query-expression parse; backtrack to the
                # join tree unless it closes at our ')'.
                save = self.i
                q = None
                try:
                    q = self.parse_query()
                    if not self.at_op(")"):
                        q = None
                except SqlParseError:
                    q = None
                if q is not None:
                    self.next()          # the ')'
                    self.eat_kw("as")
                    alias = self.ident()
                    return SubqueryRef(q, alias)
                self.i = save
            # parenthesized join tree
            t = self.parse_table_ref()
            self.expect_op(")")
            return t
        name = self.ident()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident" \
                and self.peek().value.lower() != "minus":
            # MINUS is the EXCEPT synonym, not an implicit alias
            alias = self.ident()
        return TableRef(name, alias)

    # -- expressions (precedence climbing) ------------------------------------
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.eat_kw("or"):
            e = BinOp("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.eat_kw("and"):
            e = BinOp("and", e, self.parse_not())
        return e

    def parse_not(self):
        if self.eat_kw("not"):
            return UnOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self):
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return ExistsAst(q)
        e = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                e = BinOp("=" if op == "==" else op, e, self.parse_additive())
                continue
            negated = False
            save = self.i
            if self.eat_kw("not"):
                negated = True
            if self.eat_kw("between"):
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                e = BetweenAst(e, lo, hi, negated)
                continue
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    e = InAst(e, q, negated)
                else:
                    vals = [self.parse_expr()]
                    while self.eat_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    e = InAst(e, vals, negated)
                continue
            if self.eat_kw("like"):
                t = self.next()
                if t.kind != "str":
                    raise SqlParseError(
                        f"LIKE needs a string literal at pos {t.pos}")
                e = LikeAst(e, t.value, negated)
                continue
            if negated:
                self.i = save   # bare NOT belongs to parse_not
                break
            if self.eat_kw("is"):
                neg = self.eat_kw("not")
                self.expect_kw("null")
                e = IsNullAst(e, neg)
                continue
            break
        return e

    def parse_additive(self):
        e = self.parse_multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                e = BinOp(op, e, self.parse_multiplicative())
            elif self.at_op("||"):
                self.next()
                e = BinOp("||", e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self):
        e = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            e = BinOp(op, e, self.parse_unary())
        return e

    def parse_unary(self):
        if self.eat_op("-"):
            return UnOp("-", self.parse_unary())
        if self.eat_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            return Lit(t.value)
        if t.kind == "str":
            self.next()
            return Lit(t.value)
        if self.at_kw("null"):
            self.next()
            return Lit(None)
        if self.at_kw("case"):
            return self.parse_case()
        if self.at_kw("cast"):
            return self.parse_cast()
        if self.eat_op("("):
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return SubqueryExpr(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind in ("ident", "kw"):
            # typed literals: DATE '...', TIMESTAMP '...', INTERVAL 'n' unit
            low = str(t.value).lower()
            if low in ("date", "timestamp") and self.toks[self.i + 1].kind \
                    == "str":
                self.next()
                lit = self.next()
                return CastAst(Lit(lit.value), low, typed_literal=True)
            if low == "interval" and self.toks[self.i + 1].kind == "str":
                self.next()
                val = self.next().value
                unit = self.ident().lower().rstrip("s")
                return IntervalAst(val, unit)
            # function call or (qualified) identifier; soft keywords allowed
            name = self.ident()
            if self.at_op("("):
                return self.parse_func(name)
            parts = [name]
            while self.eat_op("."):
                if self.at_op("*"):
                    self.next()
                    return Star(qualifier=parts[0])
                parts.append(self.ident())
            return Ident(tuple(parts))
        raise SqlParseError(f"unexpected token {t.value!r} at pos {t.pos}")

    def parse_func(self, name: str):
        self.expect_op("(")
        distinct = self.eat_kw("distinct")
        args = []
        if self.at_op("*"):
            self.next()
            args.append(Star())
        elif not self.at_op(")"):
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        over = None
        if self.eat_kw("over"):
            over = self.parse_window_spec()
        return FuncCall(name.lower(), args, distinct, over)

    def parse_window_spec(self) -> WindowSpecAst:
        self.expect_op("(")
        parts, orders, frame = [], [], None
        if self.eat_kw("partition"):
            self.expect_kw("by")
            parts.append(self.parse_expr())
            while self.eat_op(","):
                parts.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            orders.append(self.parse_order_item())
            while self.eat_op(","):
                orders.append(self.parse_order_item())
        if self.at_kw("rows", "range"):
            ftype = self.next().value
            self.expect_kw("between")
            lo = self.parse_frame_bound(upper=False)
            self.expect_kw("and")
            hi = self.parse_frame_bound(upper=True)
            frame = (ftype, lo, hi)
        self.expect_op(")")
        return WindowSpecAst(parts, orders, frame)

    def parse_frame_bound(self, upper: bool):
        """None = unbounded; 0 = current row; +n following / -n preceding.
        UNBOUNDED FOLLOWING opens no lower bound and UNBOUNDED PRECEDING
        closes no upper one (Spark refuses both)."""
        if self.eat_kw("unbounded"):
            wrong, right = (("preceding", "following") if upper
                            else ("following", "preceding"))
            if self.at_kw(wrong):
                raise SqlParseError(
                    f"UNBOUNDED {wrong.upper()} cannot be a frame's "
                    f"{'upper' if upper else 'lower'} bound at pos "
                    f"{self.peek().pos}")
            self.expect_kw(right)
            return None
        if self.eat_kw("current"):
            self.expect_kw("row")
            return 0
        t = self.next()
        if t.kind != "num":
            raise SqlParseError(f"bad frame bound at pos {t.pos}")
        if self.eat_kw("preceding"):
            return -int(t.value)
        self.expect_kw("following")
        return int(t.value)

    def parse_case(self):
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        branches = []
        while self.eat_kw("when"):
            w = self.parse_expr()
            self.expect_kw("then")
            v = self.parse_expr()
            branches.append((w, v))
        else_ = self.parse_expr() if self.eat_kw("else") else None
        self.expect_kw("end")
        return CaseAst(operand, branches, else_)

    def parse_cast(self):
        self.expect_kw("cast")
        self.expect_op("(")
        e = self.parse_expr()
        self.expect_kw("as")
        tname = self.ident().lower()
        targs = ()
        if self.eat_op("("):
            ts = [self.next().value]
            while self.eat_op(","):
                ts.append(self.next().value)
            self.expect_op(")")
            targs = tuple(ts)
        self.expect_op(")")
        return CastAst(e, tname, targs)


def parse_sql(text: str) -> Select:
    p = _Parser(tokenize(text))
    q = p.parse_query()
    p.eat_op(";")
    t = p.peek()
    if t.kind != "end":
        raise SqlParseError(f"trailing input at pos {t.pos}: {t.value!r}")
    return q
