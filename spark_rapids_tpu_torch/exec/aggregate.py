"""Hash aggregate exec — counterpart of ``spark_rapids_tpu/exec/aggregate.py``.

Ported: Spark's three modes — COMPLETE (update and finalize in one exec),
PARTIAL (emits keys + state columns ahead of the exchange) and FINAL (its
input is PARTIAL's layout; merges the states and finalizes) — with the
planner-hoisted prefilter/preproject (the whole-stage hoist of a child
Filter/Project into the aggregation), over the dense small-domain path
(``_agg_dense``): keys with statically known domains (dictionary strings,
booleans) and Sum/Count/Average reduce straight into D per-group buckets
(``ops/grouping.py``), the count-like ones of a batch through one launch
of the count kernel (``onehot_sums_f32``; one ``onehot_sum_f32`` call each
on a TPU). Batches aggregate incrementally: update (FINAL: merge)
per batch, then concat the partials and merge (the reference's update →
concat → merge loop); only COMPLETE and FINAL finalize.

Not ported yet: the sort-based segment group-by, keyless aggregation, HAVING
fusion and the chained update step.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.expr.core import Col, EvalContext, bind_references
from spark_rapids_tpu_torch.ops import grouping as G
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.filtering import compact_cols, selection_mask
from spark_rapids_tpu_torch.plan.nodes import agg_fn

PARTIAL = "partial"
FINAL = "final"
COMPLETE = "complete"

# off-TPU domain bound of the dense path (JAX package: max_dom = 4096)
_MAX_DENSE_DOMAIN = 4096


class HashAggregateExec(TorchExec):
    """group_exprs: grouping expressions; agg_exprs: Alias(AggregateFunction).
    With ``preproject`` set, group/agg exprs arrive bound against the hoisted
    project's output; ``prefilter`` masks rows inside the aggregation. In
    FINAL mode the keys are the child's first columns and the aggregates'
    states follow them; the aggregates are not evaluated, only merged."""

    def __init__(self, group_exprs: list, agg_exprs: list, child: TorchExec,
                 mode: str = COMPLETE, conf=None, prefilter=None,
                 preproject=None, prefilter_on_projected: bool = False):
        if mode not in (PARTIAL, FINAL, COMPLETE):
            raise ValueError(f"unknown aggregation mode {mode}")
        if not group_exprs:
            raise NotImplementedError(
                "aggregation without grouping keys is not ported yet")
        super().__init__(child, conf=conf)
        self.mode = mode
        self.preproject = list(preproject) if preproject is not None else None
        self.prefilter_on_projected = prefilter_on_projected
        if mode == FINAL:
            self.group_exprs = [bind_references(e, child.output)
                                for e in group_exprs]
            self.agg_exprs = list(agg_exprs)
        elif self.preproject is not None:
            self.group_exprs = list(group_exprs)
            self.agg_exprs = list(agg_exprs)
        else:
            self.group_exprs = [bind_references(e, child.output)
                                for e in group_exprs]
            self.agg_exprs = [bind_references(e, child.output)
                              for e in agg_exprs]
        self.prefilter = (prefilter if prefilter is None
                          or prefilter_on_projected
                          else bind_references(prefilter, child.output))
        self.fns = [agg_fn(e) for e in self.agg_exprs]
        if not all(isinstance(f, (Sum, Count, Average)) for f in self.fns):
            raise NotImplementedError(
                "only sum/count/avg aggregates are ported so far")

    @property
    def output(self):
        if self.mode == PARTIAL:
            return self._partial_schema()
        fields = [T.StructField(e.name, e.dtype, True)
                  for e in self.group_exprs]
        for e, f in zip(self.agg_exprs, self.fns):
            fields.append(T.StructField(e.name, f.dtype, True))
        return T.StructType(fields)

    def _partial_schema(self):
        fields = [T.StructField(e.name, e.dtype, True)
                  for e in self.group_exprs]
        for e, f in zip(self.agg_exprs, self.fns):
            for i, st in enumerate(f.state_types):
                fields.append(T.StructField(f"{e.name}#state{i}", st, True))
        return T.StructType(fields)

    # ------------------------------------------------------------------
    def _aggregate_batch(self, batch: ColumnarBatch,
                         merge: bool) -> ColumnarBatch:
        """One update (raw child rows) or merge (keys+state rows)
        aggregation; returns keys+state layout, one row per group."""
        ctx = EvalContext.from_batch(batch, self.device)
        cols, n_groups = self._agg_kernel(ctx, merge)
        return ColumnarBatch([c.to_vector() for c in cols], n_groups,
                             self._partial_schema())

    def _agg_kernel(self, ctx: EvalContext, merge: bool):
        cap = ctx.capacity
        keep = None

        def eval_keep(c):
            return selection_mask(self.prefilter.eval(c), c.num_rows, cap)

        if not merge:
            if self.prefilter is not None and not self.prefilter_on_projected:
                keep = eval_keep(ctx)
            if self.preproject is not None:
                cols = [e.eval(ctx) for e in self.preproject]
                ctx = EvalContext(cols, ctx.num_rows, cap, ctx.device)
            if self.prefilter is not None and self.prefilter_on_projected:
                keep = eval_keep(ctx)
        nkeys = len(self.group_exprs)
        key_cols = ([ctx.cols[i] for i in range(nkeys)] if merge
                    else [e.eval(ctx) for e in self.group_exprs])
        dense = self._agg_dense(ctx, merge, key_cols, live_mask=keep)
        if dense is None:
            raise NotImplementedError(
                "group keys without a small static domain need the "
                "sort-based group-by, which is not ported yet")
        return dense

    def _agg_dense(self, ctx: EvalContext, merge: bool, key_cols,
                   live_mask=None):
        """Sort-free small-domain aggregation: every bucket sum of the batch
        is recorded, resolved together by ``G.resolve_dense_group_sums``,
        then replayed into the state columns. Returns (cols, n_groups) or
        None when ineligible."""
        ks = G.compact_key_codes(key_cols, max_domain=_MAX_DENSE_DOMAIN)
        if ks is None:
            return None
        codes, strides = ks
        D = 1
        for d in strides:
            D *= d
        cap = ctx.capacity
        dev = ctx.device
        live = torch.arange(cap, dtype=torch.int32, device=dev) < ctx.num_rows
        if live_mask is not None:
            live = live & live_mask
        codes = torch.where(live, codes, torch.full_like(codes, D))

        # memoized child eval: aggregates sharing a child (sum(x) + avg(x) +
        # count(x)) feed IDENTICAL tensors to gsum, so the resolve pass
        # reduces each distinct request once. A count's values are its
        # validity itself (bool, counted as 0/1), which the count kernel
        # reads once
        child_memo: dict = {}

        def eval_child(e):
            k = repr(e)
            if k not in child_memo:
                child_memo[k] = e.eval(ctx)
            return child_memo[k]

        def state_cols_of(gsum):
            # the rows per group: no values and no mask, a count of every
            # row whose code is in the domain
            rows_per = gsum(None, None, torch.int32, count_like=True)
            state_cols = []
            off = len(key_cols)
            for f in self.fns:
                nstates = len(f.state_types)
                if merge:
                    ins = [ctx.cols[off + i] for i in range(nstates)]
                else:
                    ins = [eval_child(f.child)]
                off += nstates
                if isinstance(f, Count):
                    s = gsum(ins[0].validity if not merge else ins[0].values,
                             ins[0].validity, torch.int64,
                             count_like=not merge)  # update inputs are 0/1
                    state_cols.append(Col(s, torch.ones_like(s, dtype=torch.bool),
                                          T.LONG))
                    continue
                sum_t = f.state_types[0]
                s = gsum(ins[0].values, ins[0].validity, sum_t.torch_dtype)
                cnt = gsum(ins[0].validity, ins[0].validity, torch.int64,
                           count_like=True)   # validity is 0/1
                state_cols.append(Col(s, cnt > 0, sum_t))
                if isinstance(f, Average):
                    c2 = (gsum(ins[1].values, ins[1].validity, torch.int64)
                          if merge else cnt)
                    state_cols.append(Col(
                        c2, torch.ones_like(c2, dtype=torch.bool), T.LONG))
            return rows_per, state_cols

        # record pass enumerates the requests (outputs discarded), replay
        # pass rebuilds the states from the batched results
        reqs = []

        def record(vals, mask, acc_dtype, count_like=False):
            reqs.append((vals, mask, acc_dtype, count_like))
            return torch.zeros((D,), dtype=acc_dtype, device=dev)
        state_cols_of(record)
        results = iter(G.resolve_dense_group_sums(reqs, codes, D, live))

        def replay(vals, mask, acc_dtype, count_like=False):
            return next(results)
        rows_per, state_cols = state_cols_of(replay)

        # decode bucket index -> key columns (inverse of the stride mix)
        D_cap = bucket_capacity(D)
        bidx = torch.arange(D_cap, dtype=torch.int32, device=dev)
        key_out = []
        for ki, (c, d) in enumerate(zip(key_cols, strides)):
            tail = 1
            for d2 in strides[ki + 1:]:
                tail *= d2
            part = torch.div(bidx, tail, rounding_mode="floor") % d
            valid = (part != d - 1) & (bidx < D)
            if c.is_string:
                key_out.append(Col(torch.where(valid, part, 0), valid,
                                   T.STRING, c.dictionary))
            else:   # boolean
                key_out.append(Col((part == 1) & valid, valid, T.BOOLEAN))
        present = torch.zeros((D_cap,), dtype=torch.bool, device=dev)
        present[:D] = rows_per > 0

        def pad(col):
            v = torch.zeros((D_cap,), dtype=col.values.dtype, device=dev)
            v[:D] = col.values
            m = torch.zeros((D_cap,), dtype=torch.bool, device=dev)
            m[:D] = col.validity
            return Col(v, m & present, col.dtype, col.dictionary)

        return compact_cols(key_out + [pad(c) for c in state_cols], present)

    def _finalize(self, partial: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.from_batch(partial, self.device)
        nkeys = len(self.group_exprs)
        out = [ctx.cols[i] for i in range(nkeys)]
        off = nkeys
        for f in self.fns:
            n = len(f.state_types)
            out.append(f.evaluate(ctx.cols[off:off + n]))
            off += n
        return ColumnarBatch([c.to_vector() for c in out], partial.num_rows,
                             self.output)

    def execute_partition(self, split):
        merge_input = self.mode == FINAL
        acc = None
        for batch in self.child.execute_partition(split):
            partial = self._aggregate_batch(batch, merge=merge_input)
            if acc is None:
                acc = partial
            else:
                both = concat_batches([acc, partial])
                acc = self._aggregate_batch(both, merge=True)
        if acc is None:
            return  # grouped aggregation over empty input → no rows (Spark)
        yield acc if self.mode == PARTIAL else self._finalize(acc)

    def args_string(self):
        return (f"keys={self.group_exprs} aggs={self.agg_exprs} "
                f"mode={self.mode}")
