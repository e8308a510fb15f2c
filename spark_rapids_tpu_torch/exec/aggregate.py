"""Hash aggregate exec — counterpart of ``spark_rapids_tpu/exec/aggregate.py``.

Ported: Spark's three modes — COMPLETE (update and finalize in one exec),
PARTIAL (emits keys + state columns ahead of the exchange) and FINAL (its
input is PARTIAL's layout; merges the states and finalizes) — with the
planner-hoisted prefilter/preproject (the whole-stage hoist of a child
Filter/Project into the aggregation), over two group-by paths:

- the dense small-domain path (``_agg_dense``): keys with statically known
  domains (dictionary strings, booleans) and Sum/Count/Average and the
  central moments (stddev/variance: a count and two double sums each;
  the reference takes them through the sort) reduce straight into D
  per-group buckets (``ops/grouping.py``), the count-like
  ones of a batch through one launch of the count kernel
  (``onehot_sums_f32``; one ``onehot_sum_f32`` call each on a TPU);
- the sort-based segment path (the rest of ``_agg_kernel``): compact the
  prefiltered rows, sort them by key (``G.group_segments``), gather the
  keys and inputs, segment-reduce each aggregate's update or merge, and
  compact one row per group at the boundaries. A single 64-bit integer or
  timestamp key at a capacity of 2^17 or more is probed once per batch
  (``_key_stats``, below): live rows that arrive sorted with no null skip
  the sort and the gathers (TPC-H lineitem is ordered by ``l_orderkey``).

The collects (``collect_list``, ``collect_set``) and ``PivotFirst`` have
a list state (``ops/nested.py``) and always take the segment path, where
the keys would take the dense one; the stable sort keeps each group's rows
in input order, and each update → concat → merge step puts the earlier
batches' partial lists before the later batch's, so ``collect_list`` keeps
the input order across batches.

A keyless aggregate (``df.agg(...)``, no grouping keys) reduces the live
rows as one segment, in place of the sort (``_agg_keyless``), and yields
one row even over empty input (COUNT 0, the other aggregates null), as
Spark does; the planner gathers several input partitions into one first.

Batches aggregate incrementally: update (FINAL: merge) per batch, then
concat the partials and merge (the reference's update → concat → merge
loop); only COMPLETE and FINAL finalize. Each call costs one host sync for
its group count (none for a keyless call, whose count is one), and the
probe one more. Ported with it, under ``stageFusion.enabled``:

- the per-batch key probe (the reference's ``_key_range_hint``): a single
  64-bit integer or timestamp key at a capacity of 2^17 or more reads its
  minimum, maximum and sortedness in one host sync; presorted input skips
  the sort, else a range that fits ``62 - log2(capacity) - 1`` bits packs
  the key as ``value - min`` into the one-operand sort
  (``ops/sorting.py``'s packed tier, ``G.group_segments``' ``range_hint``);
- the stage-boundary right-sizing after each update and merge
  (``ops/filtering.maybe_host_resize``);
- the group-by chain (``_chain_step``, under
  ``stageFusion.groupBy.chain.enabled``): an update, a concat at the
  predicted bucket and a merge with their counts left on the device, and
  one status readback; the step is kept only when its bucket is the one
  the unchained loop would take, else the batch is redone unchained;
- HAVING fusion (``fuse_having``): a context-free filter directly above a
  COMPLETE or FINAL aggregate becomes its ``postfilter``, evaluated on the
  finalized rows, which are compacted and right-sized in the finalize.

Every sort tier and the chain give the unchained, unpacked results bit for
bit: each sort ends in the row order, and the chain's merge runs at the
capacity the unchained merge would.

The OOM ladder (``runtime/retry.py``) runs where the reference's does: each
batch's update under ``with_retry`` (scope "agg.update"; a split batch
gives two partials that the merge folds), each merge and each chained step
under spill-only ``call_with_retry`` ("agg.merge", "agg.chain"; an OOM the
chain cannot absorb sends the batch to the update loop). A batch acquires
the device semaphore before its device work.
"""

from __future__ import annotations

import threading
import time

import torch

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.aggregates import (Average, CentralMoment,
                                                     Count, Sum)
from spark_rapids_tpu_torch.expr.core import Col, EvalContext, bind_references
from spark_rapids_tpu_torch.expr.misc import is_context_sensitive
from spark_rapids_tpu_torch.ops import grouping as G
from spark_rapids_tpu_torch.ops import sorting as S
from spark_rapids_tpu_torch.ops.concat import concat_at, concat_batches
from spark_rapids_tpu_torch.ops.filtering import (compact_cols, gather_cols,
                                                  maybe_host_resize,
                                                  selection_mask)
from spark_rapids_tpu_torch.plan.nodes import agg_fn
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.semaphore import DeviceSemaphore

PARTIAL = "partial"
FINAL = "final"
COMPLETE = "complete"

# off-TPU domain bound of the dense path (JAX package: max_dom = 4096)
_MAX_DENSE_DOMAIN = 4096
# smallest capacity whose single 64-bit key is probed (sortedness, range)
_PRESORTED_MIN_CAPACITY = 1 << 17
# smallest batch capacity the group-by chain takes (reference: the fused
# program's compile could not amortize below it; kept for parity)
_CHAIN_MIN_CAPACITY = 1024


def _normalize_float_key(c: Col) -> Col:
    """``c`` with -0.0 as 0.0 and every NaN as the canonical NaN (Java's
    ``Double.NaN``/``Float.NaN`` bits); other types as they are."""
    if c.nested is not None or not isinstance(c.dtype, T.FractionalType):
        return c
    v = c.values
    v = torch.where(v == 0, torch.zeros_like(v), v)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
    return Col(v, c.validity, c.dtype, c.dictionary)


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
        #: a HAVING predicate folded into the finalize (``fuse_having``),
        #: bound to this exec's output
        self.postfilter = None
        #: per-run record of the aggregation calls: update and merge calls,
        #: those that took the segment path and those of them that skipped
        #: the sort, the key-stats probes (one host sync each) and those
        #: that gave a range hint, the sort tier of each sorted call, the
        #: chained steps and the mispredicted ones (redone unchained), the
        #: host syncs (group counts, probes, prefilter compactions, chain
        #: readbacks), the group count of every call, and host seconds
        #: inside the calls
        self.stats = {"updates": 0, "merges": 0, "segment": 0,
                      "presorted": 0, "probes": 0, "hinted": 0,
                      "tiers": {"packed": 0, "wide": 0, "multi": 0},
                      "chained": 0, "mispredicted": 0, "syncs": 0,
                      "groups": [], "seconds": 0.0}
        self._lock = threading.Lock()

    @property
    def output(self):
        if self.mode == PARTIAL:
            return self._partial_schema()
        fields = [T.StructField(e.name, e.dtype, True)
                  for e in self.group_exprs]
        for e, f in zip(self.agg_exprs, self.fns):
            fields.append(T.StructField(e.name, f.dtype, True))
        return T.StructType(fields)

    def fuse_having(self, condition) -> None:
        """Fold a HAVING predicate over this aggregate's output columns into
        its finalize (reference ``fuse_having``; COMPLETE and FINAL only: a
        PARTIAL output holds states, not the aggregates)."""
        if self.mode == PARTIAL:
            raise ValueError("a PARTIAL aggregate has no finalize to fuse "
                             "a HAVING into")
        from spark_rapids_tpu_torch.expr.predicates import And
        cond = bind_references(condition, self.output)
        self.postfilter = (cond if self.postfilter is None
                           else And(self.postfilter, cond))

    def _partial_schema(self):
        fields = [T.StructField(e.name, e.dtype, True)
                  for e in self.group_exprs]
        for e, f in zip(self.agg_exprs, self.fns):
            for i, st in enumerate(f.state_types):
                fields.append(T.StructField(f"{e.name}#state{i}", st, True))
        return T.StructType(fields)

    # ------------------------------------------------------------------
    def _fusible(self) -> bool:
        """No expression reads the task's context (the reference fuses, and
        right-sizes, only such aggregates)."""
        return not is_context_sensitive(
            *self.group_exprs, *self.agg_exprs, self.prefilter,
            *(self.preproject or []))

    def _record(self, merge: bool, path: str, n_groups: int, syncs: int,
                t0: float, probed: bool = False, hinted: bool = False,
                chained: bool = False) -> None:
        with self._lock:
            st = self.stats
            st["merges" if merge else "updates"] += 1
            st["segment"] += int(path != "dense")
            st["presorted"] += int(path == "presorted")
            if path in st["tiers"]:
                st["tiers"][path] += 1
            st["probes"] += int(probed)
            st["hinted"] += int(hinted)
            st["chained"] += int(chained)
            st["syncs"] += syncs
            st["groups"].append(n_groups)
            st["seconds"] += time.perf_counter() - t0

    def _aggregate_batch(self, batch: ColumnarBatch,
                         merge: bool) -> ColumnarBatch:
        """One update (raw child rows) or merge (keys+state rows)
        aggregation; returns keys+state layout, one row per group."""
        t0 = time.perf_counter()
        ctx = EvalContext.from_batch(batch, self.device)
        probe = self._key_stats(ctx, merge)
        presorted, hint = probe if probe is not None else (None, None)
        cols, n_groups, path = self._agg_kernel(
            ctx, merge, presorted=presorted, range_hint=hint)
        if self.conf.get(CFG.STAGE_FUSION_ENABLED) and self._fusible():
            resized = maybe_host_resize(cols, n_groups)
            if resized is not None:
                cols, n_groups = resized
        pre = int(not merge and self.prefilter is not None
                  and path != "dense")
        self._record(merge, path, n_groups,
                     int(path != "keyless") + int(probe is not None) + pre,
                     t0, probed=probe is not None, hinted=hint is not None)
        return ColumnarBatch([c.to_vector() for c in cols], n_groups,
                             self._partial_schema())

    def _key_stats(self, ctx: EvalContext, merge: bool):
        """The per-batch key probe (the reference's ``_key_range_hint``):
        ``(presorted, range_hint)`` from one reduction and ONE host sync,
        or None when the batch is not probed: several keys, a capacity
        below 2^17, a hoisted projection (the probe reads the raw batch), a
        key narrow enough to pack statically, or ``stageFusion.enabled``
        false. ``presorted`` says the live rows arrive sorted by the key
        with no null (the sort and the gathers are skipped; it wins over
        the hint); else ``range_hint=(vmin, True)`` when ``vmax - vmin``
        fits the bits the packed sort key leaves beside its ranks."""
        if (len(self.group_exprs) != 1
                or ctx.capacity < _PRESORTED_MIN_CAPACITY
                or (not merge and self.preproject is not None)
                or not self.conf.get(CFG.STAGE_FUSION_ENABLED)):
            return None
        e = self.group_exprs[0]
        if (not isinstance(e.dtype, (T.IntegralType, T.TimestampType))
                or e.dtype.torch_dtype != torch.int64):
            return None
        k = ctx.cols[0] if merge else e.eval(ctx)
        cap = ctx.capacity
        live = torch.arange(cap, device=ctx.device) < ctx.num_rows
        eligible = k.validity & live
        big = torch.iinfo(torch.int64).max
        vmin = torch.where(eligible, k.values, big).min()
        vmax = torch.where(eligible, k.values, ~big).max()
        all_valid = (k.validity | ~live).all()
        nondec = torch.where(live[1:], k.values[1:] >= k.values[:-1],
                             True).all()
        vmin, vmax, ordered = torch.stack(
            [vmin, vmax, (all_valid & nondec).to(torch.int64)]).tolist()
        presorted = bool(ordered)      # the probe's one host sync, above
        w = 62 - max((cap - 1).bit_length(), 1) - 1
        fits = vmax >= vmin and (vmax - vmin) < (1 << w) and not presorted
        return presorted, ((vmin, True) if fits else None)

    def _eval_keys(self, ctx: EvalContext) -> list:
        """The update's grouping keys, a float or double key normalized as
        Spark's NormalizeFloatingNumbers does: -0.0 becomes 0.0 and every
        NaN the canonical NaN, so a group's output key does not depend on
        which of its rows came first (the reference outputs the first)."""
        return [_normalize_float_key(e.eval(ctx)) for e in self.group_exprs]

    def _agg_kernel(self, ctx: EvalContext, merge: bool,
                    presorted: bool | None = None, range_hint=None,
                    sync: bool = True):
        """One batch's update or merge: ``(cols, n_groups, path)``, where
        ``path`` is ``dense``, ``keyless``, ``presorted`` or the sort tier
        (``packed``, ``wide``, ``multi``). ``presorted`` asserts that the
        probe proved the single key sorted and null-free: the sort and
        every row gather become the identity; ``range_hint`` goes to the
        packed sort of a single key. With ``sync`` false the compactions
        leave their counts on the device and ``n_groups`` is a 0-d
        tensor (the chain)."""
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
        if not nkeys:
            return (*self._agg_keyless(ctx, merge, keep), "keyless")
        key_cols = ([ctx.cols[i] for i in range(nkeys)] if merge
                    else self._eval_keys(ctx))
        dense = self._agg_dense(ctx, merge, key_cols, live_mask=keep,
                                sync=sync)
        if dense is not None:
            return (*dense, "dense")
        if keep is not None:
            # the segment path sorts by key: masked rows must become
            # padding, so compact them out first
            new_cols, cnt = compact_cols(ctx.cols, keep, sync=sync)
            ctx = EvalContext(new_cols, cnt, cap, ctx.device)
            key_cols = self._eval_keys(ctx)
        combined = G.combine_compact_keys(key_cols)
        presorted = bool(presorted) and combined is None
        sort_keys = [combined] if combined is not None else key_cols
        hint = range_hint if combined is None else None
        perm, seg_ids, boundary, live = G.group_segments(
            sort_keys, ctx.num_rows, cap, presorted=presorted,
            range_hint=hint)
        path = ("presorted" if presorted
                else S.sort_tier(sort_keys, cap, hint))

        def in_order(cols):
            if presorted:
                # a nested state's padding rows are already null and empty
                return [c if c.nested is not None else
                        Col(c.values, c.validity & live, c.dtype,
                            c.dictionary) for c in cols]
            return gather_cols(cols, perm, live)
        sorted_keys = in_order(key_cols)
        segctx = G.segment_structure(seg_ids, cap)
        # the states are per row (row i holds the aggregate of its whole
        # segment), so one compaction at the boundaries pulls keys and
        # states together
        state_cols = []
        off = nkeys
        for f in self.fns:
            nstates = len(f.state_types)
            if merge:
                outs = f.merge(in_order(ctx.cols[off:off + nstates]), segctx)
            else:
                outs = f.update(in_order([self._input(f, ctx)])[0], segctx)
            off += nstates
            state_cols.extend(outs)
        return (*compact_cols(sorted_keys + state_cols, boundary, sync=sync),
                path)

    def _agg_keyless(self, ctx: EvalContext, merge: bool, keep):
        """One batch's update or merge with no grouping keys: the live rows
        (prefiltered rows compacted out first, as on the segment path) are
        one segment, the padding another, and row 0 holds the result, so
        an empty batch gives COUNT 0 and null sums (reference
        ``_agg_kernel``'s keyless branch). Returns (state cols, 1)."""
        cap = ctx.capacity
        if keep is not None:
            new_cols, cnt = compact_cols(ctx.cols, keep)
            ctx = EvalContext(new_cols, cnt, cap, ctx.device)
        idx = torch.arange(cap, dtype=torch.int32, device=ctx.device)
        live = idx < ctx.num_rows
        seg_ids = torch.where(live, torch.zeros_like(idx),
                              torch.full_like(idx, cap - 1))
        segctx = G.segment_structure(seg_ids, cap)

        def masked(cols):
            return [c if c.nested is not None else
                    Col(c.values, c.validity & live, c.dtype, c.dictionary)
                    for c in cols]
        state_cols = []
        off = 0
        for f in self.fns:
            nstates = len(f.state_types)
            if merge:
                outs = f.merge(masked(ctx.cols[off:off + nstates]), segctx)
            else:
                outs = f.update(masked([self._input(f, ctx)])[0], segctx)
            off += nstates
            state_cols.extend(outs)
        # one output row: row 0's states; every other slot is padding
        return gather_cols(state_cols, idx.long(), idx == 0), 1

    @staticmethod
    def _input(f, ctx: EvalContext) -> Col:
        """An aggregate's raw input column; COUNT(*) (no child) counts a
        placeholder that is valid on every row, which the segment path's
        gather then masks to the live rows."""
        if f.child is None:
            dev = ctx.device
            return Col(torch.zeros((ctx.capacity,), dtype=torch.int32,
                                   device=dev),
                       torch.ones((ctx.capacity,), dtype=torch.bool,
                                  device=dev), T.INT)
        return f.child.eval(ctx)

    def _agg_dense(self, ctx: EvalContext, merge: bool, key_cols,
                   live_mask=None, sync: bool = True):
        """Sort-free small-domain aggregation: every bucket sum of the batch
        is recorded, resolved together by ``G.resolve_dense_group_sums``,
        then replayed into the state columns. Returns (cols, n_groups) or
        None when ineligible (a key without a small static domain, or an
        aggregate other than Sum/Count/Average and the central moments)."""
        if not all(isinstance(f, (Sum, Count, Average, CentralMoment))
                   for f in self.fns):
            return None
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

        def moment_inputs(e):
            # a central moment's doubles and their squares, once per child
            k = ("moment", repr(e))
            if k not in child_memo:
                v = CentralMoment.as_double(eval_child(e))
                child_memo[k] = (v, v * v)
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
                elif f.child is None:
                    # COUNT(*): the rows per group (non-live rows carry the
                    # code D, so a count of every row reads only the codes)
                    off += nstates
                    s = gsum(None, None, torch.int64, count_like=True)
                    state_cols.append(Col(
                        s, torch.ones_like(s, dtype=torch.bool), T.LONG))
                    continue
                else:
                    ins = [eval_child(f.child)]
                off += nstates
                if isinstance(f, CentralMoment):
                    if merge:
                        n = gsum(ins[0].values, ins[0].validity, torch.int64)
                        sv = gsum(ins[1].values, ins[1].validity,
                                  torch.float64)
                        sq = gsum(ins[2].values, ins[2].validity,
                                  torch.float64)
                    else:
                        v, v2 = moment_inputs(f.child)
                        valid = ins[0].validity
                        n = gsum(valid, valid, torch.int64, count_like=True)
                        sv = gsum(v, valid, torch.float64)
                        sq = gsum(v2, valid, torch.float64)
                    for val, t in ((n, T.LONG), (sv, T.DOUBLE),
                                   (sq, T.DOUBLE)):
                        ones = torch.ones_like(val, dtype=torch.bool)
                        state_cols.append(Col(val, ones, t))
                    continue
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

        return compact_cols(key_out + [pad(c) for c in state_cols], present,
                            sync=sync)

    def _finalize(self, partial: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext.from_batch(partial, self.device)
        nkeys = len(self.group_exprs)
        out = [ctx.cols[i] for i in range(nkeys)]
        off = nkeys
        for f in self.fns:
            n = len(f.state_types)
            out.append(f.evaluate(ctx.cols[off:off + n]))
            off += n
        num_rows = partial.num_rows
        if self.postfilter is not None:
            # the fused HAVING sees the finalized columns; its survivors are
            # compacted and right-sized here (the reference's host-indexed
            # compaction lands them at their bucket when it shrinks 4x)
            octx = EvalContext(out, num_rows, ctx.capacity, self.device)
            keep = selection_mask(self.postfilter.eval(octx), num_rows,
                                  ctx.capacity)
            out, num_rows = compact_cols(out, keep)
            resized = maybe_host_resize(out, num_rows, min_capacity=0)
            if resized is not None:
                out, num_rows = resized
        return ColumnarBatch([c.to_vector() for c in out], num_rows,
                             self.output)

    def _chainable(self) -> bool:
        """The chain runs only where its counts can stay on the device: an
        update (not FINAL's merge input) with keys and no context-reading
        expression, over flat columns (a nested column's gather and concat
        sync once a list level)."""
        return (self.mode != FINAL and bool(self.group_exprs)
                and self.conf.get(CFG.STAGE_FUSION_ENABLED)
                and self.conf.get(CFG.GROUPBY_CHAIN_ENABLED)
                and self._fusible()
                and not any(T.is_nested(f.data_type) for f in (
                    *self.child.output.fields,
                    *self._partial_schema().fields)))

    def _chain_step(self, acc: ColumnarBatch, batch: ColumnarBatch, A: int,
                    pred_P: int):
        """One update → concat → merge step of the group-by chain (reference
        ``_chain_step``): aggregate the batch, concat its partial after the
        accumulated one at the PREDICTED bucket ``bucket_capacity(A +
        pred_P)``, and merge, with every count left on the device, then
        ONE status readback (the merged and the update group counts). The
        update and merge are the unchained loop's own ``_agg_kernel``; the
        concat is ``ops/concat.concat_at``, ``concat_cols`` with the second
        count on the device. The step is accepted only when the predicted
        bucket is the one the unchained loop's concat would take, so its
        merge runs at the same capacity and the result is the unchained
        one bit for bit (no probe runs: every sort tier gives the same
        permutation). Returns ``(accepted, merged, mg_n, upd_n)``, or None
        when the batch is below the chain's capacity floor. The step runs
        under spill-only retry (scope "agg.chain"); an OOM it cannot absorb
        sends the batch to the splittable update loop."""
        if (batch.capacity < _CHAIN_MIN_CAPACITY or not batch.columns
                or not acc.columns):
            return None
        t0 = time.perf_counter()
        cap = bucket_capacity(max(A + pred_P, 1))
        uctx = EvalContext.from_batch(batch, self.device)
        upd_cols, upd_n, upd_path = self._agg_kernel(uctx, merge=False,
                                                     sync=False)
        acc_cols = [Col.from_vector(c) for c in acc.columns]
        cat = [concat_at(a, u, A, upd_n, cap)
               for a, u in zip(acc_cols, upd_cols)]
        mctx = EvalContext(cat, A + upd_n, cap, self.device)
        mg_cols, mg_n, mg_path = self._agg_kernel(mctx, merge=True,
                                                  sync=False)
        # the ONE host sync of the chained step
        mg_n, upd_n = torch.stack([mg_n.to(torch.int64),
                                   upd_n.to(torch.int64)]).tolist()
        accepted = bucket_capacity(max(A + upd_n, 1)) == cap
        self._record(False, upd_path, upd_n, 1, t0, chained=True)
        self._record(True, mg_path, mg_n, 0, time.perf_counter())
        if not accepted:
            with self._lock:
                self.stats["mispredicted"] += 1
            return False, None, mg_n, upd_n
        resized = maybe_host_resize(mg_cols, mg_n)
        if resized is not None:
            mg_cols, mg_n = resized
        return True, ColumnarBatch([c.to_vector() for c in mg_cols], mg_n,
                                   self._partial_schema()), mg_n, upd_n

    def execute_partition(self, split):
        merge_input = self.mode == FINAL
        acc = None
        # the chain's host-side predictors: A, the accumulated group count,
        # and pred_P, the next batch's update group count (the last seen)
        chain_ok = self._chainable()
        A = pred_P = 0
        sem = DeviceSemaphore.get()

        def agg_one(b):
            return self._aggregate_batch(b, merge=merge_input)

        for batch in self.child.execute_partition(split):
            # acquire once the data is here: a permit held while the child
            # blocks on a map stage would starve it
            sem.acquire_if_necessary()
            if acc is not None and chain_ok:
                try:
                    res = R.call_with_retry(
                        lambda a=acc, b=batch, A=A, P=pred_P:
                            self._chain_step(a, b, A, P),
                        scope="agg.chain")
                except R.DeviceOomError:
                    res = None   # the splittable update loop below
                if res is not None:
                    accepted, merged, mg_n, upd_n = res
                    if accepted:
                        acc, A, pred_P = merged, mg_n, upd_n
                        continue
                    # a capacity mispredict: the chained result is dropped
                    # and the batch redone unchained; the observed update
                    # count still improves the next prediction
                    pred_P = upd_n
            # the update under the OOM ladder: a split aggregates the halves
            # into two partials, which the merge below folds together, as if
            # the batch had come split
            for partial in R.with_retry([batch], agg_one, conf=self.conf,
                                        scope="agg.update"):
                if acc is None:
                    acc = partial
                    continue

                def merge_acc(a=acc, p=partial):
                    return self._aggregate_batch(concat_batches([a, p]),
                                                 merge=True)

                # the merge needs both partials at once: spill-only retry
                acc = R.call_with_retry(merge_acc, scope="agg.merge")
            if chain_ok:
                A = acc.num_rows
                pred_P = pred_P or A
        if acc is None:
            if self.group_exprs:
                return  # grouped aggregation over empty input → no rows
            # a keyless aggregation: one row even over empty input (Spark)
            sem.acquire_if_necessary()
            acc = self._aggregate_batch(ColumnarBatch.empty(
                self._partial_schema() if merge_input
                else self.child.output, self.device), merge=merge_input)
        yield acc if self.mode == PARTIAL else self._finalize(acc)

    def args_string(self):
        having = (f" having={self.postfilter!r}"
                  if self.postfilter is not None else "")
        return (f"keys={self.group_exprs} aggs={self.agg_exprs} "
                f"mode={self.mode}{having}")
