"""Window exec: one sort, then segmented scans for every frame.

Counterpart of ``spark_rapids_tpu/exec/window.py`` (reference
GpuWindowExec.scala:92 and GpuWindowExpression.scala ``windowAggregation``:
847). Each partition concatenates its input, sorts it by (partition keys,
order keys), derives the partition and tie boundaries, then computes every
window expression with ``ops/windowing.py``: the ranking functions,
lead/lag, and sum/count/min/max/avg over rows frames, range frames and
unbounded frames. Each frame becomes a per-row inclusive ``[lo, hi]``; sums
and counts difference one global cumsum, min and max read a sparse table.
The planner (``plan/overrides.py``) puts the rows of one window partition in
one exec partition (a hash exchange on ``partition_by``).

Four departures from the reference, each where it gives a wrong answer:

- a window ``avg`` over a decimal column is refused at planning
  (``supported_window_expr``). The reference divides the scaled int64 sum
  as a double and returns the unscaled mean (187.5 for 1.50 and 2.25 in
  decimal(7,2)), while its ``Average`` declares ``decimal(18, s + 4)``;
- the padding rows past the live ones start a partition of their own. In
  the reference they join the last partition when its keys are null or
  when there are no partition keys, so lead/lag with a default returns
  null instead of the default on the rows whose offset lands past the end
  (its host path, Spark's semantics, gives the default);
- ``lag`` looks back. The reference's ``Lag`` subclasses ``Lead`` and its
  exec tests ``isinstance(f, Lead)`` first, so its lag(v, n) is lead(v, n)
  (its host path does the same);
- a bounded RANGE frame over a decimal order key scales its offsets by
  ``10 ** scale``. The reference compares the scaled values with the
  unscaled offsets, so ``1 PRECEDING`` over decimal(7,2) spans 0.01.
"""

from __future__ import annotations

import threading

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.aggregates import (AggregateFunction,
                                                    Average, Count, Max, Min,
                                                    Sum)
from spark_rapids_tpu_torch.expr.core import (Alias, Col, EvalContext,
                                              bind_references)
from spark_rapids_tpu_torch.expr.windows import (DenseRank, Lag, Lead, Rank,
                                                 RowNumber, WindowExpression)
from spark_rapids_tpu_torch.ops import windowing as W
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.filtering import gather_cols
from spark_rapids_tpu_torch.ops.sorting import SortOrder, sort_permutation


def _unalias(e):
    return e.child if isinstance(e, Alias) else e


def supported_window_expr(we: WindowExpression) -> str | None:
    """Why the exec cannot evaluate ``we``, or None when it can."""
    f = we.func
    frame = we.spec.frame
    if isinstance(f, (Lead, Lag)):
        if isinstance(f.children[0].dtype, T.StringType) and \
                f.default is not None:
            return ("lead/lag over strings with a non-null default is not "
                    "supported on the device (the default is not a "
                    "dictionary code)")
        return None
    if isinstance(f, (RowNumber, Rank, DenseRank)):
        return None
    if isinstance(f, (Sum, Count, Min, Max, Average)):
        if isinstance(f, Average) and isinstance(f.children[0].dtype,
                                                 T.DecimalType):
            return ("a window avg over a decimal column is not ported (the "
                    "reference returns the unscaled mean as a double)")
        if frame.is_unbounded_to_current or frame.is_unbounded_both:
            return None
        if frame.frame_type == "rows":
            return None
        # a bounded RANGE frame: Spark requires exactly one order key, and
        # the search needs it numeric (int/long/double/date/decimal)
        ob = we.spec.order_by
        if len(ob) != 1:
            return ("bounded range frame needs exactly one order key, "
                    f"got {len(ob)}")
        okey_dt = ob[0][0].dtype
        if not isinstance(okey_dt, (T.NumericType, T.DateType)):
            return f"range frame over non-numeric order key {okey_dt}"
        return None
    return f"window function {type(f).__name__} not supported"


class WindowExec(TorchExec):
    def __init__(self, window_exprs: list, child: TorchExec, conf=None):
        """window_exprs: Alias(WindowExpression) list sharing one spec's
        partition and order keys (the reference's GpuWindowExec groups its
        expressions the same way)."""
        super().__init__(child, conf=conf)
        self.window_exprs = [bind_references(e, child.output)
                             for e in window_exprs]
        specs = {repr((_unalias(e).spec.partition_by,
                       _unalias(e).spec.order_by))
                 for e in self.window_exprs}
        if len(specs) != 1:
            raise ValueError(
                "one WindowExec handles one partition/order spec")
        for e in self.window_exprs:
            reason = supported_window_expr(_unalias(e))
            if reason:
                raise NotImplementedError(reason)
        #: rows in, partitions that had rows, rows out; partitions may run
        #: on an exchange's map threads, hence the lock
        self.stats = {"input_rows": 0, "partitions": 0, "output_rows": 0}
        self._lock = threading.Lock()

    @property
    def output(self):
        fields = list(self.child.output.fields)
        for i, e in enumerate(self.window_exprs):
            name = e.name if isinstance(e, Alias) else f"win{i}"
            fields.append(T.StructField(name, e.dtype, e.nullable))
        return T.StructType(fields)

    def execute_partition(self, split):
        batches = list(self.child.execute_partition(split))
        if not batches:
            return
        batch = concat_batches(batches)
        with self._lock:
            self.stats["input_rows"] += batch.num_rows
            self.stats["partitions"] += 1
            self.stats["output_rows"] += batch.num_rows
        yield self._compute(batch)

    def _compute(self, batch: ColumnarBatch) -> ColumnarBatch:
        cap = batch.capacity
        dev = self.device
        ctx = EvalContext.from_batch(batch, dev)
        spec0 = _unalias(self.window_exprs[0]).spec
        part_cols = [e.eval(ctx) for e in spec0.partition_by]
        order_cols = [e.eval(ctx) for (e, _, _) in spec0.order_by]
        orders = ([SortOrder() for _ in part_cols]
                  + [SortOrder(asc, nf) for (_, asc, nf) in spec0.order_by])
        num_rows = ctx.num_rows
        live = torch.arange(cap, device=dev) < num_rows
        if part_cols or order_cols:
            perm = sort_permutation(part_cols + order_cols, orders, num_rows,
                                    cap)
            sorted_in = gather_cols(ctx.cols, perm, live)
            sorted_part = gather_cols(part_cols, perm, live)
            sorted_order = gather_cols(order_cols, perm, live)
        else:   # no keys: one partition, in input order
            sorted_in, sorted_part, sorted_order = ctx.cols, [], []

        # the padding is a partition of its own (module docstring)
        part_b = (self._boundaries(sorted_part, cap, dev)
                  | (torch.arange(cap, device=dev) == num_rows))
        order_b = (part_b | self._boundaries(sorted_order, cap, dev)
                   if sorted_order else part_b)
        seg_ids = torch.cumsum(part_b.to(torch.int32), 0,
                               dtype=torch.int32) - 1

        sctx = EvalContext(sorted_in, num_rows, cap, dev)
        bounds_memo = {}
        out_cols = list(sorted_in)
        for e in self.window_exprs:
            we = _unalias(e)
            out_cols.append(self._eval_window(
                we, sctx, part_b, order_b, seg_ids, cap, live, sorted_order,
                bounds_memo).canonicalized())
        return ColumnarBatch([c.to_vector() for c in out_cols], num_rows,
                             self.output)

    @staticmethod
    def _boundaries(cols, cap, dev):
        """True where any key differs from the previous row (the first row
        is True)."""
        b = torch.zeros((cap,), dtype=torch.bool, device=dev)
        for c in cols:
            prev_vals = torch.roll(c.values, 1)
            prev_valid = torch.roll(c.validity, 1)
            if c.values.is_floating_point():
                both_nan = torch.isnan(c.values) & torch.isnan(prev_vals)
                differs = ~both_nan & ~(c.values == prev_vals)
            else:
                differs = c.values != prev_vals
            b = b | differs | (c.validity != prev_valid)
        b[0] = True
        return b

    def _eval_window(self, we, sctx, part_b, order_b, seg_ids, cap, live,
                     sorted_order, bounds_memo):
        f = we.func
        if isinstance(f, RowNumber):
            return Col(W.row_number(part_b, cap), live, T.INT)
        if isinstance(f, DenseRank):
            return Col(W.dense_rank(order_b, part_b), live, T.INT)
        if isinstance(f, Rank):
            return Col(W.rank(order_b, part_b, cap), live, T.INT)
        if isinstance(f, (Lead, Lag)):
            c = f.children[0].eval(sctx)
            off = -f.offset if isinstance(f, Lag) else f.offset
            if f.default is None:
                fill, fill_valid = c.dtype.default_value(), False
            else:
                fill, fill_valid = f.default, True
            vals, valid = W.shift_within_partition(
                c.values, c.validity, seg_ids, off, cap, fill, fill_valid)
            return Col(vals, valid & live, c.dtype, c.dictionary)
        assert isinstance(f, AggregateFunction), f
        return self._eval_agg_window(f, we, sctx, part_b, order_b, seg_ids,
                                     cap, live, sorted_order, bounds_memo)

    def _frame_lo_hi(self, we, part_b, order_b, seg_ids, cap, sorted_order,
                     bounds_memo):
        """Per-row inclusive [lo, hi] index bounds of the frame. Memoized per
        batch: every expression shares one partition/order spec and frames
        repeat, and the range search is the dearest step."""
        frame = we.spec.frame
        cached = bounds_memo.get(frame)
        if cached is not None:
            return cached
        idx = torch.arange(cap, dtype=torch.int32, device=part_b.device)
        pstart = W.seg_starts(part_b)
        pend = W.seg_ends(part_b)
        if frame.is_unbounded_both:
            lo, hi = pstart, pend
        elif frame.frame_type == "rows":
            if frame.is_unbounded_to_current:
                lo, hi = pstart, idx
            else:
                lo = pstart if frame.preceding is None else \
                    torch.maximum(idx - frame.preceding, pstart)
                hi = pend if frame.following is None else \
                    torch.minimum(idx + frame.following, pend)
        elif frame.is_unbounded_to_current:
            lo, hi = pstart, W.tie_group_ends(order_b, part_b)
        else:
            (okey, asc, _nf) = we.spec.order_by[0]
            oc = sorted_order[0]
            pre, fol = frame.preceding, frame.following
            if isinstance(okey.dtype, T.DecimalType):
                # the offsets are in the key's units, its values scaled
                # int64. Two decimal(p <= 18) values differ by less than
                # 2 * 10**18, so a larger offset spans the partition and is
                # clamped to stay inside int64
                unit = 10 ** okey.dtype.scale
                pre, fol = (None if x is None else min(x * unit, 2 * 10 ** 18)
                            for x in (pre, fol))
            lo, hi = W.range_frame_bounds(
                oc.values, oc.validity, seg_ids, asc, pre, fol, pstart, pend)
        bounds_memo[frame] = (lo, hi)
        return lo, hi

    @staticmethod
    def _range_sum(values, lo, hi):
        """Sum over [lo, hi] from one global inclusive cumsum (lo and hi
        never cross a partition, so the mass before it cancels)."""
        cs = torch.cumsum(values, 0)
        before = cs[(lo - 1).clamp(min=0).long()]
        return cs[hi.long()] - torch.where(lo > 0, before,
                                           torch.zeros_like(before))

    def _eval_agg_window(self, f, we, sctx, part_b, order_b, seg_ids, cap,
                         live, sorted_order, bounds_memo):
        dict_ = None
        if isinstance(f, Count) and not f.children:
            vals = torch.ones((cap,), dtype=torch.int64, device=live.device)
            valid = live
            dtype = T.LONG
        else:
            c = f.children[0].eval(sctx)
            vals, valid, dtype = c.values, c.validity & live, c.dtype
            dict_ = c.dictionary
        if isinstance(f, (Min, Max)) and vals.dtype == torch.bool:
            vals = vals.to(torch.int8)  # the sentinels need an int carrier

        lo, hi = self._frame_lo_hi(we, part_b, order_b, seg_ids, cap,
                                   sorted_order, bounds_memo)
        nonempty = hi >= lo
        lo_q = torch.where(nonempty, lo, torch.zeros_like(lo))
        hi_q = torch.where(nonempty, hi, torch.zeros_like(hi))

        cnt_w = torch.where(
            nonempty, self._range_sum(valid.to(torch.int64), lo_q, hi_q), 0)
        if isinstance(f, (Sum, Average, Count)):
            acc_dt = (torch.float64 if isinstance(dtype, T.FractionalType)
                      else torch.int64)
            data = torch.where(valid, vals,
                               torch.zeros_like(vals)).to(acc_dt)
            sum_w = self._range_sum(data, lo_q, hi_q)
            return self._finish(f, sum_w, cnt_w, None, live, None)

        # min/max: sparse-table range queries. Spark orders NaN as the
        # LARGEST value: min ignores NaN unless the frame is all NaN, max is
        # NaN as soon as the frame holds one
        combine = torch.minimum if isinstance(f, Min) else torch.maximum
        if isinstance(dtype, T.FractionalType):
            nan = torch.isnan(vals)
            nan_w = self._range_sum((valid & nan).to(torch.int32), lo_q, hi_q)
            nonnan_w = self._range_sum((valid & ~nan).to(torch.int32),
                                       lo_q, hi_q)
            eff_valid = valid & ~nan
            sent = float("inf") if isinstance(f, Min) else float("-inf")
        else:
            nan_w = None
            eff_valid = valid
            info = torch.iinfo(vals.dtype)
            sent = info.max if isinstance(f, Min) else info.min
        table = W.sparse_table(
            torch.where(eff_valid, vals, torch.full_like(vals, sent)),
            combine, sent)
        mm_w = W.range_query(table, combine, lo_q, hi_q)
        if nan_w is not None:
            nan_v = torch.full_like(mm_w, float("nan"))
            if isinstance(f, Min):  # an all-NaN frame is NaN
                mm_w = torch.where((nonnan_w == 0) & (nan_w > 0), nan_v, mm_w)
            else:                   # any NaN in the frame is NaN
                mm_w = torch.where(nan_w > 0, nan_v, mm_w)
        return self._finish(f, None, cnt_w, mm_w, live, dict_)

    @staticmethod
    def _finish(f, sum_w, cnt_w, mm_w, live, dict_):
        out_dtype = f.dtype
        if isinstance(f, Count):
            return Col(cnt_w.to(torch.int64), live, T.LONG)
        if isinstance(f, Average):
            vals = sum_w.to(torch.float64) / cnt_w.clamp(min=1)
            return Col(vals, (cnt_w > 0) & live, T.DOUBLE)
        if isinstance(f, Sum):
            return Col(sum_w.to(out_dtype.torch_dtype), (cnt_w > 0) & live,
                       out_dtype)
        # min/max: back to the value type (bools ran on an int8 carrier;
        # strings on dictionary codes, whose sorted dictionary rides along)
        if isinstance(out_dtype, T.BooleanType):
            mm_w = mm_w.to(torch.bool)
        return Col(mm_w, (cnt_w > 0) & live, out_dtype, dict_)

    def args_string(self):
        return str(self.window_exprs)
