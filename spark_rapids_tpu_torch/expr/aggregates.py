"""Aggregate functions with Spark two-phase (update/merge) semantics.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py``: Sum, Count,
Average, Min, Max, First, Last and the central moments StddevPop,
StddevSamp, VariancePop and VarianceSamp. Each names its partial-state columns
(``state_types``), segment-reduces raw values into them on the sort path
(``update``) and partial states of several batches into one (``merge``),
and computes the final value from merged states (``evaluate``). The dense
small-domain path of the aggregate exec (``exec/aggregate.py``) reduces
Sum, Count, Average and the central moments by its own route.

Null semantics: COUNT(x) counts non-nulls and is never null; SUM, AVG, MIN
and MAX ignore nulls and are null iff no input was non-null; SUM of
integrals is long, of doubles double, of ``decimal(p, s)``
``decimal(min(p + 10, 18), s)`` (exact int64 sums, no float route); AVG of
integrals and doubles is double, of ``decimal(p, s)`` ``decimal(18,
s + 4)``, the sum rescaled and divided by the count with HALF_UP on the
magnitude in int64; COUNT(*) counts rows. The central moments keep the
reference's buffers (count, sum, sum of squares, as doubles) and finish as
``m2 = max(s2 - s * mean, 0)`` over n or n - 1; a sample moment of one row
is null (Spark's legacy statistical aggregate gives NaN; the reference and
Spark 3.1+ give null).

First and Last take a nested value too (its row gathered), and
``collect_list`` of a nested value gives an ``array<array<..>>`` or an
``array<struct<..>>``. Min and Max take an array of scalars or of such
arrays, and ``collect_set`` any nested value without a map, through the
order over whole nested values (``ops/nested.order_ranks``); a struct or
map in a Min or Max, and a map in a ``collect_set``, are refused when
typed.

CollectList, CollectSet and PivotFirst have an array state (a list column,
``ops/nested.py``) and run on the segment path only, with the reference's
host semantics (``plan/nodes.py`` ``AggregateNode._agg_one``):
``collect_list`` keeps each group's non-null values in input order (the
segment sort is stable), ``collect_set`` keeps one of each (in value order;
Spark leaves the order unspecified), an all-null group gives an empty
array, never null; ``PivotFirst`` gives each group one slot a pivot value,
holding the first non-null value of the rows with that pivot value.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression
from spark_rapids_tpu_torch.ops import grouping as G


class AggregateFunction(Expression):
    """Declarative aggregate. ``state_types`` names the partial-state columns."""

    def __init__(self, child: Expression | None):
        if child is None and not isinstance(self, Count):
            raise NotImplementedError(
                f"{type(self).__name__.lower()}(*) is not ported yet")
        self.children = [child] if child is not None else []

    @property
    def child(self):
        return self.children[0] if self.children else None

    def with_children(self, children):
        return type(self)(children[0] if children else None)

    @property
    def state_types(self) -> list:
        raise NotImplementedError

    def update(self, in_col: Col, segctx: "G.SegCtx") -> list:
        """Raw column -> list of state Cols (one per state_types entry)."""
        raise NotImplementedError

    def merge(self, state_cols: list, segctx: "G.SegCtx") -> list:
        """Partial states -> merged states."""
        raise NotImplementedError

    def evaluate(self, state_cols: list) -> Col:
        """Merged states → final value column."""
        raise NotImplementedError

    def eval(self, ctx):
        raise RuntimeError(
            "aggregate functions are evaluated by the aggregate exec")

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child!r})"


def _sum_result_type(t: T.DataType) -> T.DataType:
    if isinstance(t, T.DecimalType):
        return T.DecimalType(min(t.precision + 10,
                                 T.DecimalType.MAX_PRECISION), t.scale)
    if isinstance(t, T.IntegralType):
        return T.LONG
    if isinstance(t, T.FractionalType):
        return T.DOUBLE
    raise NotImplementedError(f"sum/avg over {t} is not ported yet")


class Sum(AggregateFunction):
    @property
    def dtype(self):
        return _sum_result_type(self.child.dtype)

    @property
    def state_types(self):
        return [self.dtype]

    def update(self, in_col, segctx):
        vals = in_col.values.to(self.dtype.torch_dtype)
        s, cnt = G.segment_sum(vals, in_col.validity, segctx)
        return [Col(s, cnt > 0, self.dtype)]

    def merge(self, state_cols, segctx):
        st = state_cols[0]
        s, cnt = G.segment_sum(st.values, st.validity, segctx)
        return [Col(s, cnt > 0, self.dtype)]

    def evaluate(self, state_cols):
        return state_cols[0].canonicalized()


class Count(AggregateFunction):
    """COUNT(expr) counts non-null rows; COUNT(*) (child None) counts rows:
    the exec passes a placeholder column whose validity is the row's
    liveness."""

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    @property
    def state_types(self):
        return [T.LONG]

    def update(self, in_col, segctx):
        validity = in_col.validity
        s, _ = G.segment_sum(validity.to(torch.int64),
                             torch.ones_like(validity), segctx)
        return [Col(s, torch.ones_like(s, dtype=torch.bool), T.LONG)]

    def merge(self, state_cols, segctx):
        st = state_cols[0]
        s, _ = G.segment_sum(st.values, st.validity, segctx)
        return [Col(s, torch.ones_like(s, dtype=torch.bool), T.LONG)]

    def evaluate(self, state_cols):
        return state_cols[0]

    def __repr__(self):
        return f"count({self.child!r})" if self.children else "count(*)"


class _Extreme(AggregateFunction):
    """MIN/MAX: one state of the child's type; merge is update over the
    states (the extreme of extremes). ``_reduce`` is the segment reduction
    (``G.segment_min`` or ``G.segment_max``), ``_largest`` says which. An
    array of scalars (or of
    such arrays) is ranked under Spark's ordering (``ops/nested.
    order_ranks``), and each group's first row of the least or greatest
    rank is gathered whole; a type that holds a struct or a map is refused
    (the reference's host comparator raises on a struct, Spark orders no
    map)."""

    @property
    def dtype(self):
        t = self.child.dtype
        if T.is_nested(t) and not T.ordered_array(t):
            raise NotImplementedError(
                f"HashAggregateExec: {type(self).__name__.lower()} of a "
                f"{t!r} value is not ported (arrays of scalars or of such "
                "arrays only: a struct or a map has no order here)")
        return t

    @property
    def state_types(self):
        return [self.dtype]

    def update(self, in_col, segctx):
        if in_col.nested is not None:
            from spark_rapids_tpu_torch.ops.filtering import gather_cols
            from spark_rapids_tpu_torch.ops.nested import order_ranks
            pos, found = G.segment_arg_extreme(
                order_ranks(in_col), in_col.validity, segctx, self._largest)
            return gather_cols([in_col], pos.long(), found)
        m = self._reduce(in_col.values, in_col.validity, segctx, self.dtype)
        cnt = G.segment_count(in_col.validity, segctx)
        return [Col(m, cnt > 0, self.dtype, in_col.dictionary)]

    def merge(self, state_cols, segctx):
        return self.update(state_cols[0], segctx)

    def evaluate(self, state_cols):
        st = state_cols[0]
        return st if st.nested is not None else st.canonicalized()


class Min(_Extreme):
    _reduce = staticmethod(G.segment_min)
    _largest = False


class Max(_Extreme):
    _reduce = staticmethod(G.segment_max)
    _largest = True


class Average(AggregateFunction):
    """AVG: (sum, count) state; a double result, or ``decimal(18, s + 4)``
    over ``decimal(p, s)`` (Spark's +4 scale)."""

    @property
    def dtype(self):
        ct = self.child.dtype
        _sum_result_type(ct)
        if isinstance(ct, T.DecimalType):
            return T.DecimalType(T.DecimalType.MAX_PRECISION,
                                 min(ct.scale + 4,
                                     T.DecimalType.MAX_PRECISION))
        return T.DOUBLE

    @property
    def state_types(self):
        return [_sum_result_type(self.child.dtype), T.LONG]

    def update(self, in_col, segctx):
        sum_t = self.state_types[0]
        vals = in_col.values.to(sum_t.torch_dtype)
        s, cnt = G.segment_sum(vals, in_col.validity, segctx)
        return [Col(s, cnt > 0, sum_t),
                Col(cnt, torch.ones_like(cnt, dtype=torch.bool), T.LONG)]

    def merge(self, state_cols, segctx):
        s_st, c_st = state_cols
        s, _ = G.segment_sum(s_st.values, s_st.validity, segctx)
        c, _ = G.segment_sum(c_st.values, c_st.validity, segctx)
        return [Col(s, c > 0, self.state_types[0]),
                Col(c, torch.ones_like(c, dtype=torch.bool), T.LONG)]

    def evaluate(self, state_cols):
        s_st, c_st = state_cols
        cnt = c_st.values
        ok = cnt > 0
        safe = torch.where(ok, cnt, torch.ones_like(cnt))
        if isinstance(self.dtype, T.DecimalType):
            # the sum at the result's scale (up <= 4 digits: 10 ** up fits),
            # divided HALF_UP on the magnitude
            up = self.dtype.scale - self.state_types[0].scale
            num = s_st.values * (10 ** up)
            qm = torch.div(num.abs() + torch.div(safe, 2,
                                                 rounding_mode="floor"),
                           safe, rounding_mode="floor")
            vals = torch.where(num < 0, -qm, qm)
        else:
            vals = s_st.values.to(torch.float64) / safe
        return Col(vals, ok, self.dtype).canonicalized()

    def __repr__(self):
        return f"avg({self.child!r})"


class _Positional(AggregateFunction):
    """FIRST/LAST(ignoreNulls): the value at the group's first or last row
    in sorted order (reference GpuFirst, GpuLast); merge takes the first or
    last of the partial states. ``_pick`` is ``G.segment_first`` or
    ``G.segment_last``; a nested value (an array, a struct, a map) is
    gathered from the row ``_index`` picks (``G.segment_first_index`` or
    ``G.segment_last_index``)."""

    def __init__(self, child, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def state_types(self):
        return [self.dtype]

    def update(self, in_col, segctx):
        if in_col.nested is not None:
            from spark_rapids_tpu_torch.ops.filtering import gather_cols
            pos, found = self._index(in_col.validity, segctx,
                                     self.ignore_nulls)
            return gather_cols([in_col], pos.long(), found)
        vals, valid = self._pick(in_col.values, in_col.validity, segctx,
                                 self.ignore_nulls)
        return [Col(vals, valid, self.dtype, in_col.dictionary)]

    def merge(self, state_cols, segctx):
        return self.update(state_cols[0], segctx)

    def evaluate(self, state_cols):
        st = state_cols[0]
        return st if st.nested is not None else st.canonicalized()


class First(_Positional):
    _pick = staticmethod(G.segment_first)
    _index = staticmethod(G.segment_first_index)


class Last(_Positional):
    _pick = staticmethod(G.segment_last)
    _index = staticmethod(G.segment_last_index)


class CentralMoment(AggregateFunction):
    """Variance and standard deviation over (n, sum, sum of squares)
    states, each merged by summing (the reference's ``_CentralMoment``)."""

    @property
    def dtype(self):
        t = self.child.dtype
        if not isinstance(t, T.NumericType):
            raise NotImplementedError(
                f"{type(self).__name__.lower()} of a {t} is not ported yet")
        return T.DOUBLE

    @property
    def state_types(self):
        return [T.LONG, T.DOUBLE, T.DOUBLE]

    @staticmethod
    def as_double(in_col: Col) -> torch.Tensor:
        """The input as doubles, 0 where it is null (a decimal unscaled)."""
        v = in_col.values.to(torch.float64)
        if isinstance(in_col.dtype, T.DecimalType):
            v = v / float(10 ** in_col.dtype.scale)
        return torch.where(in_col.validity, v, torch.zeros_like(v))

    def update(self, in_col, segctx):
        v = self.as_double(in_col)
        s, cnt = G.segment_sum(v, in_col.validity, segctx)
        s2, _ = G.segment_sum(v * v, in_col.validity, segctx)
        ones = torch.ones_like(cnt, dtype=torch.bool)
        return [Col(cnt, ones, T.LONG), Col(s, ones, T.DOUBLE),
                Col(s2, ones, T.DOUBLE)]

    def merge(self, state_cols, segctx):
        outs = []
        for st, t in zip(state_cols, self.state_types):
            v, _ = G.segment_sum(st.values, st.validity, segctx)
            outs.append(Col(v, torch.ones_like(v, dtype=torch.bool), t))
        return outs

    def evaluate(self, state_cols):
        n = state_cols[0].values
        s = state_cols[1].values
        s2 = state_cols[2].values
        safe = torch.where(n > 0, n.to(torch.float64),
                           torch.ones_like(s))
        m2 = torch.clamp(s2 - s * (s / safe), min=0.0)
        denom = self.denominator(n)
        ok = denom > 0
        var = m2 / torch.where(ok, denom, torch.ones_like(denom))
        return Col(self.finish(var), ok, T.DOUBLE).canonicalized()

    def finish(self, var):
        return var


class VariancePop(CentralMoment):
    def denominator(self, n):
        return n.to(torch.float64)


class VarianceSamp(CentralMoment):
    def denominator(self, n):
        return (n - 1).to(torch.float64)


class StddevPop(VariancePop):
    def finish(self, var):
        return torch.sqrt(var)


class StddevSamp(VarianceSamp):
    def finish(self, var):
        return torch.sqrt(var)


def _list_state(elems: Col, rows, total: int, capacity: int,
                dtype: T.DataType, dedupe: bool) -> Col:
    from spark_rapids_tpu_torch.ops import nested as N
    return Col.from_vector(N.from_tagged_elements(elems, rows, total,
                                                  capacity, dtype, dedupe))


class CollectList(AggregateFunction):
    """collect_list(x): each group's non-null values, in input order. The
    state is the list itself: an update tags each sorted row's value with
    its segment's first row; a merge concatenates the partial lists of a
    segment in row order. The aggregate exec concatenates earlier partials
    before later ones and its sort is stable, so the order holds across
    batches."""

    dedupe = False

    @property
    def dtype(self):
        return T.ArrayType(self.child.dtype)

    @property
    def nullable(self):
        return False

    @property
    def state_types(self):
        return [self.dtype]

    def update(self, in_col, segctx):
        from spark_rapids_tpu_torch.ops.filtering import gather_cols
        from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
        keep = torch.nonzero(in_col.validity).squeeze(1)
        total = int(keep.shape[0])
        ecap = bucket_capacity(total)
        dev = keep.device
        idx = torch.zeros((ecap,), dtype=torch.int64, device=dev)
        idx[:total] = keep
        elems = gather_cols([in_col], idx,
                            torch.arange(ecap, device=dev) < total)[0]
        rows = segctx.seg_start.long()[keep]
        return [_list_state(elems, rows, total, segctx.capacity, self.dtype,
                            self.dedupe)]

    def merge(self, state_cols, segctx):
        from spark_rapids_tpu_torch.ops import nested as N
        vec = state_cols[0].nested
        rows = segctx.seg_start.long()[N.element_rows(vec.data, vec.total)]
        return [_list_state(Col.from_vector(vec.flat), rows, vec.total,
                            segctx.capacity, self.dtype, self.dedupe)]

    def evaluate(self, state_cols):
        return state_cols[0]


class CollectSet(CollectList):
    """collect_set(x): each group's distinct non-null values, in value
    order (Spark leaves the order unspecified, the reference keeps the
    first seen). A nested value dedupes on its rank (``ops/nested.
    order_ranks``), so the values ``equiv`` calls equal are one; a type
    that holds a map is refused, as Spark's ``CollectSet`` refuses it."""

    dedupe = True

    @property
    def dtype(self):
        t = self.child.dtype
        if T.holds_map(t):
            raise NotImplementedError(
                f"HashAggregateExec: collect_set of a {t!r} value is not "
                "ported (Spark's collect_set refuses a map)")
        return T.ArrayType(t)


class PivotFirst(AggregateFunction):
    """PivotFirst(value, pivot, pivot_values): per group an array with one
    slot a pivot value, holding the first non-null value among the rows
    whose pivot equals it (the reference's host semantics; Spark plans it
    over one row per group and pivot value, where first and last agree).
    Its input is ``struct(value, pivot)``, so it rides the exec's one input
    column; the state is the array."""

    def __init__(self, value, pivot, pivot_values: list):
        self.children = [value, pivot]
        self.pivot_values = list(pivot_values)

    def with_children(self, children):
        return PivotFirst(children[0], children[1], self.pivot_values)

    @property
    def child(self):
        from spark_rapids_tpu_torch.expr.complexexprs import CreateNamedStruct
        from spark_rapids_tpu_torch.expr.core import Literal
        return CreateNamedStruct(Literal("value"), self.children[0],
                                 Literal("pivot"), self.children[1])

    @property
    def dtype(self):
        t = self.children[0].dtype
        if T.is_nested(t):
            raise NotImplementedError(
                f"HashAggregateExec: a pivot of a {t!r} value is not ported")
        return T.ArrayType(t)

    @property
    def nullable(self):
        return False

    @property
    def state_types(self):
        return [self.dtype]

    def _slots(self, picks: list, segctx) -> Col:
        from spark_rapids_tpu_torch.ops import nested as N
        cap = segctx.capacity
        return Col.from_vector(N.from_columns(self.dtype, picks, cap, cap))

    def update(self, in_col, segctx):
        value, pivot = (Col.from_vector(f) for f in in_col.nested.fields)
        picks = []
        for pv in self.pivot_values:
            match = _equals_value(pivot, pv) & value.validity
            v, ok = G.segment_first(value.values, match, segctx, True)
            picks.append(Col(v, ok, value.dtype, value.dictionary))
        return [self._slots(picks, segctx)]

    def merge(self, state_cols, segctx):
        from spark_rapids_tpu_torch.expr.complexexprs import list_item
        vec = state_cols[0].nested
        cap = segctx.capacity
        dev = vec.data.device
        every = torch.ones((cap,), dtype=torch.bool, device=dev)
        picks = []
        for j in range(len(self.pivot_values)):
            slot = list_item(vec, Col(torch.full((cap,), j, dtype=torch.int64,
                                                 device=dev), every, T.LONG),
                             every)
            v, ok = G.segment_first(slot.values, slot.validity, segctx, True)
            picks.append(Col(v, ok, slot.dtype, slot.dictionary))
        return [self._slots(picks, segctx)]

    def evaluate(self, state_cols):
        return state_cols[0]

    def __repr__(self):
        return (f"pivotfirst({self.children[0]!r}, {self.children[1]!r}, "
                f"{self.pivot_values!r})")


def _equals_value(c: Col, v) -> torch.Tensor:
    """Rows of ``c`` equal to the host value ``v`` (a string by its code in
    ``c``'s dictionary; none when it is not there)."""
    if v is None:
        return torch.zeros_like(c.validity)
    if c.is_string:
        import pyarrow.compute as pc
        d = c.dictionary
        code = (pc.index(d, v).as_py() if d is not None and len(d) else -1)
        if code < 0:
            return torch.zeros_like(c.validity)
        return c.validity & (c.values == code)
    return c.validity & (c.values == v)
