"""Join execs — counterpart of ``spark_rapids_tpu/exec/joins.py``
(``_int_backed``, ``_align_string_keys``, ``_emit_pairs``, the build and the
probes of ``_JoinCore``, ``HashJoinExec``, ``BroadcastHashJoinExec`` and
``NestedLoopJoinExec``, which also runs cross joins; reference GpuHashJoin,
GpuBroadcastHashJoinExec and GpuBroadcastNestedLoopJoinExec).

The build side is one device batch. ``_JoinCore`` evaluates its keys once.
One fixed-point key (``fast``) picks a probe mode in the reference's order
for a backend where scatters are cheap (``runtime/hw.scatters_cheap`` is
true off the TPU, so on a GPU):

1. build stats: the least and greatest eligible key (one host sync);
2. ``dense``: a direct-address table over the key range, when the range fits
   ``max(4 * capacity, 2^22)`` slots and the keys are unique (one more sync);
3. ``hash`` (the reference's ``pallas_hash``): the 8-slot Fibonacci table of
   ``cuda_kernels.hash_join_build``, for a build of at most 16,384 rows whose
   least key lies above int64 min; the build's ``ok`` is synced once, and a
   refused build (an overfull bucket or a duplicate key) goes on to
4. ``one`` / ``two``: the build keys sorted once (one int64 sort of packed
   ``(key - vmin, row)`` when the range allows, else two stable sorts), then
   one ``searchsorted`` and a compare for unique keys, two for the general
   case.

Several keys, or one string or double key, take the ``rank`` path (the
reference's ``_probe_batch_eager``): per stream batch, string keys are
remapped onto one dictionary of both sides (``_align_string_keys``), the
build's and the batch's key rows are ranked together by one multi-operand
sort (``ops/joining.join_ranks``), and the sorted build ranks are probed by
two ``searchsorted`` (``ops/joining.probe``).

Each stream batch probes on the device and gives each row a range
``[lo, hi)`` of build positions; ``_emit_pairs`` syncs the pair count once
per stream batch and expands the pairs in chunks, in stream order, so every
mode emits the rows in the same order. An inner join's residual condition
is evaluated there, on each chunk of expanded pairs, which keeps the pairs
it holds for.

The preserved side streams: a right outer join streams its right side and
builds its left one (an inner join may build either). A full outer join
streams its left side and also emits, once, the build rows no stream row
matched, null-extended on the stream side. Each stream batch ORs the build
rows it matched into a device flag per build row (``ops/joining.
matched_build``, from the probe's ranges); while that accumulator is live
the direct-address, hash and unique modes are off, as in the reference, so
the probe takes ``two`` or the rank path. Over a broadcast build the flags
of every stream partition are merged (``_SharedBroadcast``), and the last
stream partition to finish emits the unmatched build rows, after its own
pairs.

The nested-loop join (keyless and cross joins) broadcasts its right side
the same way and expands every (stream row, build row) pair in chunks of
``_MAX_CHUNK_ROWS``, left-major, filtered by an optional condition over
the pair schema: inner/cross, left outer, full outer, left semi and left
anti. Which stream rows matched is kept on the device (one ``index_add_``
of the kept pairs per chunk) and read once per stream batch, where the
unmatched rows are compacted; a full outer join keeps the build rows'
flags the same way, merged across stream partitions like the hash join's.

The planner hoists the stream side's filter and projection into an inner
join on one fixed-point key (``HashJoinExec``'s ``stream_prefilter`` and
``stream_preproject``; ``plan/overrides._stream_hoist``), and, under
``stageFusion.enabled``, collapses stacked inner single-key broadcast joins
into one ``BroadcastHashJoinChainExec`` (``maybe_chain``), which probes a
stream batch through every hop with one host sync. Neither changes a
result. The port's ``_int_backed`` leaves timestamps and decimals out, so a
join on such a key, which the reference hoists and chains, stays unhoisted
and unchained here, on the rank path, with the same rows.

Each stream batch's probe runs under the OOM ladder
(``R.with_retry(..., scope="joins.gather")``: an OOM spills, splits the
batch and probes the halves, the matched-build flags rolled back for each
attempt by ``_JoinCore.checkpoint``/``restore``); a chained batch retries
its whole pass through the hops the same way. The build is registered
spillable by ``exec/broadcast.py`` (scope "joins.build").

Not ported (the planner refuses them, ``plan/overrides.py``, as the
reference's ``tag_join`` does): a residual condition on an outer, semi or
anti equi-join, a keyless right outer join, and the shuffled/mesh route.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import (Col, EvalContext,
                                              bind_references)
from spark_rapids_tpu_torch.expr.misc import is_context_free
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.ops import joining as J
from spark_rapids_tpu_torch.ops.filtering import (compact_cols, gather_cols,
                                                  selection_mask,
                                                  slice_to_capacity)
from spark_rapids_tpu_torch.ops.strings import align_many
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.semaphore import DeviceSemaphore

# max pairs expanded per output chunk (the JoinGatherer row-target analog)
_MAX_CHUNK_ROWS = 1 << 20

#: the profiler range around a hash join's device work (its build's core,
#: each batch's probe, emit and chain pass; never across a yield), so that
#: a trace can tell the joins' device time from the rest
PROBE_RANGE = "HashJoin.probe"

#: whether the joins enter ``PROBE_RANGE``; a tracer sets it for the run it
#: traces, and with it off the hot path enters no range
TRACE_RANGES = False


def _probe_range():
    return (torch.profiler.record_function(PROBE_RANGE) if TRACE_RANGES
            else contextlib.nullcontext())


def _int_backed(dtype) -> bool:
    """Orderable fixed-point key: comparisons over raw device values are key
    comparisons (unlike string codes, which compare only under one shared
    dictionary, or floats, which need NaN totalization)."""
    return isinstance(dtype, (T.IntegralType, T.BooleanType, T.DateType))


def _align_string_keys(build_keys, stream_keys):
    """Remap each string key pair onto the sorted union of its two
    dictionaries, so that equal codes are equal strings."""
    out_b, out_s = [], []
    for b, s in zip(build_keys, stream_keys):
        if b.is_string:
            b, s = align_many([b, s])
        out_b.append(b)
        out_s.append(s)
    return out_b, out_s


def _key_values(k: Col) -> torch.Tensor:
    return k.values.to(torch.int8) if k.values.dtype == torch.bool \
        else k.values


def _emit_pairs(join_type, stream_is_left, condition, preproject,
                stream_batch, build_batch, build_perm, lo, hi, counts, total,
                out_schema, on_sync=None):
    """Expand the probe's pairs in chunks of at most ``_MAX_CHUNK_ROWS`` and
    yield output batches: stream columns, then build columns (swapped when
    the build side is the left one), null-extended where an outer join found
    no match; semi and anti joins emit the stream columns only. A hoisted
    ``preproject`` (reference ``:63``) re-derives the stream side's
    projection on the gathered stream rows of each chunk, so the projected
    stream batch never exists. A residual ``condition`` (inner joins only,
    bound to the output schema) keeps the pairs it holds for, compacted (one
    more host sync a chunk). ``on_sync()`` is called at each host sync."""
    with _probe_range():
        total = int(total)  # one host sync per stream batch
    if on_sync is not None:
        on_sync()
    semi_anti = join_type in (J.LEFT_SEMI, J.LEFT_ANTI)
    s_in = [Col.from_vector(c) for c in stream_batch.columns]
    b_in = ([] if semi_anti else
            [Col.from_vector(c) for c in build_batch.columns])
    pos = 0
    while pos < total:
        out_cap = bucket_capacity(min(total - pos, _MAX_CHUNK_ROWS))
        n_out = min(total - pos, out_cap)
        with _probe_range():
            s_idx, b_idx, b_matched, live = J.expand_pairs(
                build_perm, lo, hi, counts, pos, out_cap)
            cols = gather_cols(s_in, s_idx, live)
            if preproject is not None:
                pctx = EvalContext(cols, n_out, out_cap, live.device)
                cols = [e.eval(pctx) for e in preproject]
            if not semi_anti:
                b_cols = gather_cols(b_in, b_idx.long(), b_matched)
                cols = (cols + b_cols) if stream_is_left else (b_cols + cols)
            if condition is not None:
                pred = condition.eval(EvalContext(cols, n_out, out_cap,
                                                  live.device))
                cols, n_out = compact_cols(cols, selection_mask(
                    pred, n_out, out_cap))
            out = ColumnarBatch([c.to_vector() for c in cols], n_out,
                                out_schema)
        pos += out_cap
        if condition is not None and on_sync is not None:
            on_sync()
        if n_out:
            yield out


def _null_cols(schema, cap: int, device):
    """All-null columns of ``schema`` (an outer join's missing side); a
    string column gets an empty dictionary."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import empty_vector
    return [Col.from_vector(empty_vector(f.data_type, cap, device))
            if T.is_nested(f.data_type) else
            Col(torch.full((cap,), f.data_type.default_value(),
                           dtype=f.data_type.torch_dtype, device=device),
                torch.zeros((cap,), dtype=torch.bool, device=device),
                f.data_type,
                pa.array([], type=pa.string())
                if isinstance(f.data_type, T.StringType) else None)
            for f in schema]


def _emit_unmatched_build(matched, build_batch, stream_schema,
                          stream_is_left, out_schema):
    """The live build rows ``matched`` does not flag, null-extended on the
    stream side, as one batch (one host sync, the row count); yields
    nothing when every build row matched."""
    dev = matched.device
    live = (torch.arange(build_batch.capacity, device=dev)
            < build_batch.num_rows)
    idx = torch.nonzero(live & ~matched).flatten()
    n = int(idx.numel())
    if not n:
        return
    cap = bucket_capacity(n)
    pad = torch.zeros((cap,), dtype=torch.int64, device=dev)
    pad[:n] = idx
    b_cols = gather_cols([Col.from_vector(c) for c in build_batch.columns],
                         pad, torch.arange(cap, device=dev) < n)
    s_cols = _null_cols(stream_schema, cap, dev)
    cols = (s_cols + b_cols) if stream_is_left else (b_cols + s_cols)
    yield ColumnarBatch([c.to_vector() for c in cols], n, out_schema)


class _SharedBroadcast:
    """What the stream partitions of one broadcast join share (reference
    ``_SharedBroadcast``): a countdown of readers, so that the last one
    releases the broadcast batch, and the matched-build flags merged across
    every partition, so that a full outer join's unmatched build rows are
    emitted exactly once, by the last reader. A release also resets both,
    so the plan can run again."""

    def __init__(self, exchange, n_readers: int):
        self.exchange = exchange
        self.n_readers = n_readers
        self._lock = threading.Lock()
        self._readers_left = n_readers
        self.matched_acc = None

    def merge_matched(self, local) -> None:
        with self._lock:
            self.matched_acc = (local.clone() if self.matched_acc is None
                                else self.matched_acc | local)

    def _finish(self) -> bool:
        with self._lock:
            self._readers_left -= 1
            return self._readers_left == 0

    def close(self) -> None:
        with self._lock:
            self._readers_left = self.n_readers
            self.matched_acc = None
        self.exchange.release()

    def reader(self):
        """A per-partition handle whose ``finish_once()`` counts this reader
        down at most once and is True for the last reader overall. A
        partition calls it where its stream ends (to emit the unmatched
        build rows before it closes) and again in a ``finally``, so a
        partition abandoned midway (a limit above, an error) still counts
        down and the last one out releases the batch."""
        shared = self

        class _Reader:
            __slots__ = ("_counted",)

            def __init__(self):
                self._counted = False

            def finish_once(self) -> bool:
                if self._counted:
                    return False
                self._counted = True
                return shared._finish()

        return _Reader()


class _JoinCore:
    """Probe machinery over one materialized build batch (module docstring:
    the build order and the modes). ``stream_prefilter``, a hoisted stream
    filter, masks the probe's live rows on the single fixed-point key path,
    so filtered rows emit no pairs; the planner hoists one only there
    (reference ``:134-168``), and any other path refuses it. ``syncs``
    counts the build's host syncs."""

    def __init__(self, build_batch: ColumnarBatch, build_key_exprs,
                 stream_key_exprs, join_type: str, device,
                 stream_prefilter=None):
        self.device = torch.device(device)
        self.stream_key_exprs = stream_key_exprs
        self.stream_prefilter = stream_prefilter
        self.join_type = join_type
        self.syncs = 0
        bctx = EvalContext.from_batch(build_batch, self.device)
        self.build_keys_raw = [e.eval(bctx) for e in build_key_exprs]
        self.n_build = build_batch.num_rows
        self.build_cap = build_batch.capacity
        #: the reference's name of the probe mode ("hash" is "pallas_hash";
        #: "rank" is the multi-key path)
        self.probe_mode = "rank"
        self.hash_buckets = 0
        #: True when a hash build returned ok=False and the sorted modes took
        #: over (the reference's own contract, not a fallback)
        self.hash_refused = False
        #: a full outer join's flags of the build rows some stream row
        #: matched, ORed across the stream batches on the device
        self.build_matched_acc = (
            torch.zeros((self.build_cap,), dtype=torch.bool,
                        device=self.device)
            if join_type == J.FULL_OUTER else None)
        self.fast = (len(self.build_keys_raw) == 1
                     and _int_backed(self.build_keys_raw[0].dtype))
        if stream_prefilter is not None and not (
                self.fast and join_type == J.INNER
                and is_context_free(stream_prefilter, *stream_key_exprs)):
            # the planner's hoist rule guarantees this (the reference
            # asserts it); the rank path does not evaluate a prefilter
            raise ValueError("a hoisted stream filter needs an inner join "
                             "on one fixed-point key with context-free "
                             "terms")
        if self.fast:
            self._prep_fast_build()

    def _prep_fast_build(self):
        k = self.build_keys_raw[0]
        vals = _key_values(k)
        dev = vals.device
        cap = vals.shape[0]
        idx_bits = max(int(cap - 1).bit_length(), 1)
        rows = torch.arange(cap, device=dev)
        eligible = k.validity & (rows < self.n_build)
        info = torch.iinfo(vals.dtype)
        vmin_t = torch.where(eligible, vals, info.max).min()
        vmax_t = torch.where(eligible, vals, info.min).max()
        # one host sync per build
        vmin, vmax, n_valid = torch.stack(
            [vmin_t.long(), vmax_t.long(), eligible.sum()]).tolist()
        self.syncs += 1
        rng = max(vmax - vmin, 0)
        # vmax + 1 (the ineligible rows' sentinel) must stay representable
        packable = (self.n_build > 0 and rng < (1 << (62 - idx_bits))
                    and vmax < (1 << 62))
        dsize = rng + 2 if self.n_build > 0 else 1
        dense_budget = max(4 * cap, 1 << 22)
        self._vmin = vmin
        self._n_valid = n_valid
        # probe positions of the direct and hash tables are build rows
        self._build_perm = torch.arange(cap, dtype=torch.int32, device=dev)
        # the reference's direct-table gate also asks scatters_cheap(),
        # which holds in the port (a GPU or the CPU); the direct, hash and
        # unique modes are off while the matched-build flags are tracked
        tracking = self.build_matched_acc is not None
        if self.n_build > 0 and dsize <= dense_budget and not tracking:
            rel = torch.where(eligible, vals.long() - vmin,
                              torch.full_like(rows, dsize))
            hits = torch.zeros((dsize + 1,), dtype=torch.int32, device=dev)
            hits.scatter_add_(0, rel, torch.ones_like(rel, dtype=torch.int32))
            self.syncs += 1
            if bool((hits[:dsize] <= 1).all()):   # a duplicate key sorts
                self._dense_table = _direct_table(rel, dsize, cap)
                self._dense_size = dsize
                self.probe_mode = "dense"
                return
        nb = CK.hash_join_buckets(self.n_build)
        if nb and self.n_build > 0 and vmin > CK.HJ_EMPTY and not tracking:
            tk, tr, ok = CK.hash_join_build(vals.long(), eligible, nb)
            self.syncs += 1
            if bool(ok):    # one host sync per hash build
                self._hash_keys, self._hash_rows = tk, tr
                self.hash_buckets = nb
                self.probe_mode = "hash"
                return
            self.hash_refused = True
        in_valid = torch.arange(1, cap, device=dev) < n_valid
        if packable:
            # one int64 sort of (key - vmin) << idx_bits | row, ineligible
            # rows above every key
            rel = torch.where(eligible, vals.long() - vmin,
                              torch.full_like(rows, rng + 1))
            s = torch.sort((rel << idx_bits) | rows).values
            perm = s & ((1 << idx_bits) - 1)
            # int64 on purpose: the vmax + 1 tail must not wrap in a narrower
            # key type, or the order searchsorted needs would break
            sorted_vals = (s >> idx_bits) + vmin
            same = (s[1:] >> idx_bits) == (s[:-1] >> idx_bits)
        else:
            # eligibility first, then the key, then the row: two stable sorts
            masked = torch.where(eligible, vals, info.max)
            by_key = torch.sort(masked, stable=True).indices
            perm = by_key[torch.sort((~eligible)[by_key].to(torch.int8),
                                     stable=True).indices]
            sorted_vals = masked[perm]
            same = sorted_vals[1:] == sorted_vals[:-1]
        self._sorted_build = sorted_vals
        self._build_perm = perm.to(torch.int32)
        unique = (bool(~(same & in_valid).any()) if self.n_build > 0
                  else True)
        self.syncs += int(self.n_build > 0)
        self.probe_mode = "two"
        if unique and not tracking:
            self.probe_mode = "one"
            if dsize <= dense_budget:
                # direct-address table over the sorted order (reached only by
                # an empty build: a unique one took the direct table above)
                slot = torch.where(rows < n_valid, sorted_vals.long() - vmin,
                                   torch.full_like(rows, dsize))
                self._dense_table = _direct_table(slot, dsize, cap)
                self._dense_size = dsize
                self.probe_mode = "dense"

    @property
    def _stream_join_type(self):
        """The join type of the stream's own rows: a right or full outer
        join preserves its stream side as a left outer join does."""
        return (J.LEFT_OUTER if self.join_type in (J.FULL_OUTER,
                                                   J.RIGHT_OUTER)
                else self.join_type)

    def probe_batch(self, stream_batch: ColumnarBatch):
        """``(build_perm, lo, hi, counts, total)`` for one stream batch, all
        on the device; a full outer join also ORs the build rows this batch
        matched into ``build_matched_acc``."""
        out = (self._probe_batch_fast(stream_batch) if self.fast
               else self._probe_batch_ranks(stream_batch))
        if self.build_matched_acc is not None:
            build_perm, lo, hi = out[:3]
            self.build_matched_acc |= J.matched_build(build_perm, lo, hi,
                                                      self.build_cap)
        return out

    def checkpoint(self):
        """Snapshot the matched-build flags before a retried probe."""
        self._matched_ckpt = (None if self.build_matched_acc is None
                              else self.build_matched_acc.clone())

    def restore(self):
        """Roll the flags back after a probe that ran out of memory."""
        if getattr(self, "_matched_ckpt", None) is not None:
            self.build_matched_acc = self._matched_ckpt.clone()

    def _probe_batch_fast(self, stream_batch: ColumnarBatch):
        sctx = EvalContext.from_batch(stream_batch, self.device)
        k = self.stream_key_exprs[0].eval(sctx)
        svals = _key_values(k)
        scap = svals.shape[0]
        n_stream = stream_batch.num_rows
        if self.stream_prefilter is not None:
            live = selection_mask(self.stream_prefilter.eval(sctx), n_stream,
                                  scap)
        else:
            live = torch.arange(scap, device=svals.device) < n_stream
        if self.probe_mode == "two":
            # the general case: two searchsorted over the sorted build, with
            # both sides promoted to a common type
            common = torch.promote_types(svals.dtype,
                                         self._sorted_build.dtype)
            sc = self._sorted_build.to(common).contiguous()
            sv = svals.to(common).contiguous()
            n_valid = self._n_valid
            lo = torch.clamp(torch.searchsorted(sc, sv), max=n_valid)
            hi = torch.clamp(torch.searchsorted(sc, sv, right=True),
                             max=n_valid)
            hi = torch.where(k.validity & live, hi, lo)
        else:
            pos, found = self._unique_lookup(svals)
            hit = found & k.validity & live
            # "one" keeps its searchsorted position on a miss, as the
            # reference's probe does
            lo = pos if self.probe_mode == "one" else torch.where(hit, pos, 0)
            hi = torch.where(hit, lo + 1, lo)
        counts = J.pair_counts(lo, hi, n_stream, scap,
                               self._stream_join_type)
        return self._build_perm, lo, hi, counts, J.total_pairs(counts)

    def _probe_batch_ranks(self, stream_batch: ColumnarBatch):
        """The rank path (reference ``_probe_batch_eager``): the build's and
        the batch's keys ranked together, then the sorted build ranks
        probed."""
        sctx = EvalContext.from_batch(stream_batch, self.device)
        stream_keys = [e.eval(sctx) for e in self.stream_key_exprs]
        build_keys, stream_keys = _align_string_keys(self.build_keys_raw,
                                                     stream_keys)
        n_stream = stream_batch.num_rows
        b_ranks, s_ranks = J.join_ranks(
            build_keys, self.n_build, self.build_cap,
            stream_keys, n_stream, stream_batch.capacity)
        build_perm, lo, hi = J.probe(b_ranks, s_ranks)
        counts = J.pair_counts(lo, hi, n_stream, stream_batch.capacity,
                               self._stream_join_type)
        return build_perm, lo, hi, counts, J.total_pairs(counts)

    # -- the probe chain's surface (BroadcastHashJoinChainExec) -------------

    def chain_capable(self) -> bool:
        """True when a stream row matches at most one build row (reference
        ``chain_capable``): the single fixed-point key path over a
        unique-keyed build (probe mode ``dense``, ``one`` or ``hash``), no
        matched-rows accumulator, and context-free stream terms. Decided
        from the build's contents."""
        return (self.fast and self.build_matched_acc is None
                and self.probe_mode in ("dense", "one", "hash")
                and is_context_free(*self.stream_key_exprs,
                                    self.stream_prefilter))

    def _unique_lookup(self, svals: torch.Tensor):
        """``(position, found)`` of each stream key in a unique-keyed build
        (probe mode ``dense``, ``one`` or ``hash``); a position indexes
        ``_build_perm``. Validity and liveness are the caller's to mask. In
        ``hash`` mode this is one ``hash_join_probe`` launch."""
        mode = self.probe_mode
        if mode == "hash":
            # equality over int64 images is equality over any narrower key
            return CK.hash_join_probe(
                self._hash_keys, self._hash_rows,
                svals.to(torch.int64).contiguous(), self.hash_buckets)
        if mode == "dense":
            dsize = self._dense_size
            slot = svals.long() - self._vmin
            r = self._dense_table[torch.clamp(slot, 0, dsize - 1)]
            return r, (slot >= 0) & (slot < dsize - 1) & (r >= 0)
        # "one": mixed-width keys promote both sides (casting the stream down
        # would wrap values and fabricate matches)
        common = torch.promote_types(svals.dtype, self._sorted_build.dtype)
        sc = self._sorted_build.to(common).contiguous()
        sv = svals.to(common).contiguous()
        pos = torch.clamp(torch.searchsorted(sc, sv), max=self._n_valid)
        found = ((sc[torch.clamp(pos, 0, sc.shape[0] - 1)] == sv)
                 & (pos < self._n_valid))
        return pos, found

    def chain_lookup(self, k: Col):
        """``(build_row int64, hit bool)`` for each stream key of ``k``
        (reference ``chain_lookup``, ``:608-650``): ``_unique_lookup`` with
        the position mapped to its build row through ``_build_perm``.
        Validity and liveness are the caller's to mask."""
        pos, hit = self._unique_lookup(_key_values(k))
        perm = self._build_perm
        row = perm[torch.clamp(pos, 0, perm.shape[0] - 1)].long()
        return torch.where(hit, row, 0), hit


def _direct_table(rel, dsize: int, cap: int):
    """int32 table of ``dsize`` slots: ``table[rel[i]] = i``, -1 elsewhere;
    rows whose ``rel`` is ``dsize`` are dropped."""
    table = torch.full((dsize + 1,), -1, dtype=torch.int32, device=rel.device)
    table.scatter_(0, rel, torch.arange(cap, dtype=torch.int32,
                                        device=rel.device))
    return table[:dsize]


def _join_output(join_type, left_schema, right_schema) -> T.StructType:
    """Semi and anti joins keep the left columns; an outer join makes the
    columns of the side it may null-extend nullable."""
    lf, rf = list(left_schema), list(right_schema)
    if join_type in (J.LEFT_SEMI, J.LEFT_ANTI):
        return T.StructType(lf)
    if join_type in (J.LEFT_OUTER, J.FULL_OUTER):
        rf = [T.StructField(f.name, f.data_type, True) for f in rf]
    if join_type in (J.RIGHT_OUTER, J.FULL_OUTER):
        lf = [T.StructField(f.name, f.data_type, True) for f in lf]
    return T.StructType(lf + rf)


class HashJoinExec(TorchExec):
    """What every equi-join with a materialized build side shares (reference
    GpuShuffledHashJoinBase): keys, build side, output schema, the build's
    core and the probe loop. The co-partitioned (shuffled) route is not
    ported, so only the broadcast subclass executes.

    The planner may hoist the stream side's filter and projection into an
    inner join on one fixed-point key (reference ``:676-688``):
    ``stream_prefilter`` masks the probe rows of the raw stream child,
    ``stream_preproject`` re-derives the projection on each chunk's
    gathered stream rows, and ``stream_schema`` is that projection's
    schema, the stream side's part of ``output``."""

    def __init__(self, join_type: str, left_keys, right_keys,
                 left: TorchExec, right: TorchExec, condition=None,
                 build_side: str = "right", conf=None, stream_prefilter=None,
                 stream_preproject=None, stream_schema=None):
        super().__init__(left, right, conf=conf)
        self.stream_prefilter = stream_prefilter
        self.stream_preproject = (list(stream_preproject)
                                  if stream_preproject is not None else None)
        self._stream_schema = stream_schema
        jt = join_type.lower().replace("_", "")
        if jt not in (J.INNER, J.LEFT_OUTER, J.RIGHT_OUTER, J.FULL_OUTER,
                      J.LEFT_SEMI, J.LEFT_ANTI):
            raise NotImplementedError(
                f"{join_type} joins are not ported yet")
        if condition is not None and jt != J.INNER:
            # the reference's GpuHashJoin.tagJoin refuses them as well
            raise NotImplementedError(
                "a residual condition on an outer, semi or anti equi-join "
                "is not ported")
        self.join_type = jt
        self.left_keys = [bind_references(k, left.output) for k in left_keys]
        self.right_keys = [bind_references(k, right.output)
                           for k in right_keys]
        # the preserved side streams; an inner join may build either side
        self.stream_is_left = not (jt == J.RIGHT_OUTER or (
            jt == J.INNER and build_side == "left"))
        self.condition = (bind_references(condition, self.output)
                          if condition is not None else None)
        #: what the last build chose, how many stream partitions and batches
        #: it probed, how many unmatched build rows a full outer join
        #: emitted, and the host syncs of the builds and the probes;
        #: partitions may run on an exchange's map threads, hence the lock
        self.stats = {"build_rows": 0, "probe_mode": None, "hash_buckets": 0,
                      "hash_refused": 0, "stream_batches": 0,
                      "stream_partitions": 0, "unmatched_build_rows": 0,
                      "syncs": 0}
        self._lock = threading.Lock()

    @property
    def build_side(self) -> str:
        return "right" if self.stream_is_left else "left"

    @property
    def output(self) -> T.StructType:
        lo, ro = self.children[0].output, self.children[1].output
        if self._stream_schema is not None:
            if self.stream_is_left:
                lo = self._stream_schema
            else:
                ro = self._stream_schema
        return _join_output(self.join_type, lo, ro)

    @property
    def num_partitions(self):
        return self._stream_child.num_partitions

    @property
    def _stream_child(self):
        return self.children[0 if self.stream_is_left else 1]

    def _core(self, build_batch) -> _JoinCore:
        bk, sk = ((self.right_keys, self.left_keys) if self.stream_is_left
                  else (self.left_keys, self.right_keys))
        with _probe_range():
            core = _JoinCore(build_batch, bk, sk, self.join_type,
                             self.device,
                             stream_prefilter=self.stream_prefilter)
        with self._lock:
            self.stats.update(build_rows=core.n_build,
                              probe_mode=core.probe_mode,
                              hash_buckets=core.hash_buckets)
            self.stats["hash_refused"] += int(core.hash_refused)
            self.stats["syncs"] += core.syncs
        return core

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def _probe_batches(self, core, build_batch, batches, on_sync):
        """Probe and emit each of ``batches`` (one host sync a batch, the
        pair count, counted through ``on_sync``)."""
        out_schema = self.output

        def probe(b):
            with _probe_range(), R.with_restore_on_retry(core):
                return b, core.probe_batch(b)

        for stream_batch in batches:
            self._count("stream_batches")
            DeviceSemaphore.get().acquire_if_necessary()
            # an OOM spills, splits the stream batch and probes the halves,
            # with the matched-build flags rolled back for each attempt
            for piece, (build_perm, lo, hi, counts, total) in R.with_retry(
                    [stream_batch], probe, conf=self.conf,
                    scope="joins.gather"):
                yield from _emit_pairs(
                    self.join_type, self.stream_is_left, self.condition,
                    self.stream_preproject, piece, build_batch, build_perm,
                    lo, hi, counts, total, out_schema, on_sync)

    def _probe_stream(self, core, build_batch, split):
        self._count("stream_partitions")
        yield from self._probe_batches(
            core, build_batch, self._stream_child.execute_partition(split),
            lambda: self._count("syncs"))

    def _unmatched_build(self, matched, build_batch):
        self._count("syncs")
        for out in _emit_unmatched_build(
                matched, build_batch, self._stream_child.output,
                self.stream_is_left, self.output):
            with self._lock:
                self.stats["unmatched_build_rows"] += out.num_rows
            yield out

    def args_string(self):
        return (f"{self.join_type} lk={self.left_keys} rk={self.right_keys} "
                f"build={self.build_side}"
                + (f" cond={self.condition}" if self.condition is not None
                   else "")
                + (f" prefilter={self.stream_prefilter}"
                   if self.stream_prefilter is not None else "")
                + (f" preproject={self.stream_preproject}"
                   if self.stream_preproject is not None else ""))


class BroadcastHashJoinExec(HashJoinExec):
    """The build side is broadcast: a ``BroadcastExchangeExec`` materializes
    it once, every stream partition probes it, and the last stream partition
    to finish (or to be abandoned) releases it (reference
    GpuBroadcastHashJoinExec)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        from spark_rapids_tpu_torch.exec.broadcast import BroadcastExchangeExec
        bi = 1 if self.stream_is_left else 0
        self.exchange = BroadcastExchangeExec(self.children[bi],
                                              conf=self.conf)
        self.children[bi] = self.exchange
        self._shared = _SharedBroadcast(self.exchange, self.num_partitions)

    def execute_partition(self, split):
        reader = self._shared.reader()
        try:
            build_batch = self.exchange.broadcast()
            core = self._core(build_batch)
            yield from self._probe_stream(core, build_batch, split)
            if core.build_matched_acc is not None:
                self._shared.merge_matched(core.build_matched_acc)
            if reader.finish_once():
                try:
                    if self.join_type == J.FULL_OUTER:
                        yield from self._unmatched_build(
                            self._shared.matched_acc, build_batch)
                finally:
                    self._shared.close()
        finally:
            if reader.finish_once():
                self._shared.close()


def _chainable(node) -> bool:
    """A broadcast hash join the chain may absorb (reference ``_chainable``):
    inner, one key, both sides fixed-point (the port's ``_int_backed``: a
    timestamp or decimal key stays on the rank path, unchained), no
    residual condition, and every hoisted term context-free. Whether the
    build is unique-keyed is decided from its contents when it runs
    (``_JoinCore.chain_capable``)."""
    return (type(node) is BroadcastHashJoinExec
            and node.join_type == J.INNER and node.condition is None
            and len(node.left_keys) == 1
            and _int_backed(node.left_keys[0].dtype)
            and _int_backed(node.right_keys[0].dtype)
            and is_context_free(*node.left_keys, *node.right_keys,
                                node.stream_prefilter,
                                *(node.stream_preproject or ())))


def maybe_chain(join, conf=None):
    """Collapse a broadcast hash join whose stream child is another one (or
    a chain already formed below it) into one ``BroadcastHashJoinChainExec``
    (reference ``maybe_chain``; the planner calls it bottom-up under
    ``stageFusion.enabled``). Returns ``join`` itself when the stack does not
    qualify."""
    if not _chainable(join):
        return join
    stream = join._stream_child
    if isinstance(stream, BroadcastHashJoinChainExec):
        return BroadcastHashJoinChainExec(stream.children[0],
                                          stream.hops + [join], conf=conf)
    if _chainable(stream):
        return BroadcastHashJoinChainExec(stream._stream_child,
                                          [stream, join], conf=conf)
    return join


class BroadcastHashJoinChainExec(TorchExec):
    """A stack of inner single-key broadcast hash joins ("hops") probed one
    stream batch at a time in one pass (reference
    ``BroadcastHashJoinChainExec``, ``:939-1166``). Each hop keeps its
    ``BroadcastExchangeExec`` as a child of this exec; the chain takes over
    the probe side and owns each hop's broadcast reader.

    When every hop's build is unique-keyed (``_JoinCore.chain_capable``),
    a stream row matches at most one build row a hop, so one batch runs as
    eager torch on the device: for each hop in order, its prefilter into
    ``live``, its key, the lookup (``chain_lookup``; one
    ``hash_join_probe`` launch in ``hash`` mode), ``hit & validity &
    live``, a gather of the build columns, the hop's preproject over the
    current columns, and the columns in that hop's stream/build order;
    then one ``compact_cols`` with the batch's one host sync. The output
    batches are cut as the unfused emit cuts them: at most
    ``_MAX_CHUNK_ROWS`` rows each, at ``bucket_capacity`` of their rows. The
    reference predicts that capacity and reruns on a miss because its XLA
    program has a static shape; eager torch needs no prediction, so there
    is no predictor and no rerun. A batch with no survivor yields nothing.
    Nothing is compacted between hops, so every hop's lookup reads every
    slot of the stream batch, dead rows included, where an unchained hop
    reads the compacted output of the hop before it: the chain saves host
    syncs and intermediate batches, and a later hop (a ``hash_join_probe``
    launch in ``hash`` mode) does more device work than unchained.

    When some hop's build has duplicate keys (mode ``two``), every batch
    runs the hops one after another, probe and emit each (reference
    ``_fallback``): the reference's own contract, decided from the build's
    contents, and both routes run torch on the device. ``stats`` counts the
    ``chained_batches`` and ``degraded_batches``, the host syncs (builds
    and batches; a nested column's gather syncs its own element counts,
    which are not counted), and the rows in and out. Each hop's own
    ``stats`` is kept as its unchained exec would keep it."""

    def __init__(self, stream: TorchExec, hops, conf=None):
        super().__init__(stream, *[h.exchange for h in hops], conf=conf)
        self.hops = list(hops)
        self.stats = {"chained_batches": 0, "degraded_batches": 0,
                      "stream_batches": 0, "stream_partitions": 0,
                      "stream_rows": 0, "output_rows": 0, "syncs": 0}
        self._lock = threading.Lock()

    @property
    def output(self) -> T.StructType:
        return self.hops[-1].output

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def execute_partition(self, split):
        readers = [(h, h._shared.reader()) for h in self.hops]
        try:
            # the outermost hop's build first, as the nested unchained
            # iterators would materialize them
            builds = [None] * len(self.hops)
            for i in reversed(range(len(self.hops))):
                builds[i] = self.hops[i].exchange.broadcast()
            cores = [h._core(b) for h, b in zip(self.hops, builds)]
            self._count("syncs", sum(c.syncs for c in cores))
            self._count("stream_partitions")
            for h in self.hops:
                h._count("stream_partitions")
            chained = all(c.chain_capable() for c in cores)
            build_cols = [[Col.from_vector(c) for c in b.columns]
                          for b in builds]
            for stream_batch in self.children[0].execute_partition(split):
                self._count("stream_batches")
                self._count("stream_rows", stream_batch.num_rows)
                DeviceSemaphore.get().acquire_if_necessary()
                if chained:
                    self._count("chained_batches")
                    outs = [out for chunks in R.with_retry(
                        [stream_batch],
                        lambda b: self._chained(b, cores, build_cols),
                        conf=self.conf, scope="joins.gather")
                        for out in chunks]
                else:
                    self._count("degraded_batches")
                    outs = self._sequential(stream_batch, cores, builds)
                for out in outs:
                    self._count("output_rows", out.num_rows)
                    yield out
        finally:
            # also when abandoned midway (a limit above, an error): each
            # reader counts down, and the last one out releases its build
            for h, r in readers:
                if r.finish_once():
                    h._shared.close()

    def _chained(self, stream_batch, cores, build_cols) -> list:
        with _probe_range():
            return self._chain_pass(stream_batch, cores, build_cols)

    def _chain_pass(self, stream_batch, cores, build_cols) -> list:
        """One stream batch through every hop; the output batches."""
        dev = self.device
        scap, n = stream_batch.capacity, stream_batch.num_rows
        cur = [Col.from_vector(c) for c in stream_batch.columns]
        live = torch.arange(scap, device=dev) < n
        for h, core, b_cols in zip(self.hops, cores, build_cols):
            h._count("stream_batches")
            ctx = EvalContext(cur, n, scap, dev)
            if core.stream_prefilter is not None:
                live = live & selection_mask(
                    core.stream_prefilter.eval(ctx), n, scap)
            k = core.stream_key_exprs[0].eval(ctx)
            row, hit = core.chain_lookup(k)
            hit = hit & k.validity & live
            b_out = gather_cols(b_cols, row, hit)
            s_out = ([e.eval(ctx) for e in h.stream_preproject]
                     if h.stream_preproject is not None else cur)
            cur = (s_out + b_out) if h.stream_is_left else (b_out + s_out)
            live = hit
        cols, count = compact_cols(cur, live)   # the batch's one host sync
        self._count("syncs")
        out, pos = [], 0
        while pos < count:
            n_out = min(count - pos, _MAX_CHUNK_ROWS)
            cap = bucket_capacity(n_out)
            if pos == 0:
                chunk = slice_to_capacity(cols, n_out, cap)
            else:
                j = torch.arange(cap, device=dev)
                chunk = gather_cols(cols, torch.clamp(j + pos, max=scap - 1),
                                    j < n_out)
            pos += n_out
            out.append(ColumnarBatch([c.to_vector() for c in chunk], n_out,
                                     self.output))
        return out

    def _sequential(self, stream_batch, cores, builds):
        """Each hop probes and emits the batches of the hop before it, as
        the unchained joins would."""
        batches = iter([stream_batch])
        for h, core, build in zip(self.hops, cores, builds):
            batches = h._probe_batches(core, build, batches,
                                       lambda: self._count("syncs"))
        return batches

    def args_string(self):
        return " -> ".join(h.args_string() for h in self.hops)


class NestedLoopJoinExec(TorchExec):
    """Every (left row, right row) pair, kept where the optional condition
    holds (reference GpuBroadcastNestedLoopJoinExec): the right side is
    broadcast once and shared by every left (stream) partition; inner and
    cross joins emit the pairs, a left outer join also the unmatched left
    rows null-extended (a full outer join also, once, the right rows no
    kept pair reached), and semi and anti joins the left rows that matched
    or did not. A right outer join is not ported."""

    def __init__(self, join_type: str, left: TorchExec, right: TorchExec,
                 condition=None, conf=None):
        super().__init__(left, right, conf=conf)
        jt = join_type.lower().replace("_", "")
        jt = J.INNER if jt == J.CROSS else jt
        if jt not in (J.INNER, J.LEFT_OUTER, J.FULL_OUTER, J.LEFT_SEMI,
                      J.LEFT_ANTI):
            # a right outer join would need the left side built (the
            # reference refuses it too)
            raise NotImplementedError(
                f"{join_type} nested-loop joins are not ported yet")
        self.join_type = jt
        self.condition = (bind_references(condition, self._pair_schema())
                          if condition is not None else None)
        from spark_rapids_tpu_torch.exec.broadcast import BroadcastExchangeExec
        self.exchange = BroadcastExchangeExec(self.children[1],
                                              conf=self.conf)
        self.children[1] = self.exchange
        self._shared = _SharedBroadcast(self.exchange, self.num_partitions)
        #: rows in on each side, stream partitions, pairs expanded, rows out
        #: and a full outer join's unmatched build rows; partitions may run
        #: on an exchange's map threads, hence the lock
        self.stats = {"stream_rows": 0, "build_rows": 0, "partitions": 0,
                      "pairs": 0, "output_rows": 0,
                      "unmatched_build_rows": 0}
        self._lock = threading.Lock()

    def _pair_schema(self):
        return T.StructType(list(self.children[0].output)
                            + list(self.children[1].output))

    @property
    def output(self):
        return _join_output(self.join_type, self.children[0].output,
                            self.children[1].output)

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def execute_partition(self, split):
        reader = self._shared.reader()
        try:
            build = self.exchange.broadcast()
            with self._lock:
                self.stats["build_rows"] = build.num_rows
                self.stats["partitions"] += 1
            # a full outer join's flags of the build rows some pair kept
            rhits = (torch.zeros((build.capacity,), dtype=torch.int32,
                                 device=self.device)
                     if self.join_type == J.FULL_OUTER else None)
            for lb in self.children[0].execute_partition(split):
                for out in self._join_batch(lb, build, rhits):
                    with self._lock:
                        self.stats["output_rows"] += out.num_rows
                    yield out
            if rhits is not None:
                self._shared.merge_matched(rhits > 0)
            if reader.finish_once():
                try:
                    if rhits is not None:
                        for out in _emit_unmatched_build(
                                self._shared.matched_acc, build,
                                self.children[0].output, True, self.output):
                            with self._lock:
                                self.stats["output_rows"] += out.num_rows
                                self.stats["unmatched_build_rows"] += \
                                    out.num_rows
                            yield out
                finally:
                    self._shared.close()
        finally:
            if reader.finish_once():
                self._shared.close()

    def _join_batch(self, lb, build, rhits):
        n_left, n_build = lb.num_rows, build.num_rows
        dev = self.device
        jt = self.join_type
        out_schema = self.output
        lcols = [Col.from_vector(c) for c in lb.columns]
        rcols = [Col.from_vector(c) for c in build.columns]
        total = n_left * n_build
        with self._lock:
            self.stats["stream_rows"] += n_left
            self.stats["pairs"] += total
        emit_pairs = jt in (J.INNER, J.LEFT_OUTER, J.FULL_OUTER)
        if self.condition is None:
            # every pair is kept: a left row matched iff the right side has
            # rows, every build row iff the left batch has rows, and the
            # pairs need expanding only to be emitted
            if emit_pairs:
                yield from self._pair_chunks(lcols, rcols, lb.capacity,
                                             build.capacity, total, n_build,
                                             out_schema, None, None)
            if rhits is not None and total:
                rhits[:n_build] = 1
            if jt == J.INNER:
                return
            # semi keeps every left row or none, and anti and the outer
            # join's unmatched rows are the rest
            everything = (n_build > 0) == (jt == J.LEFT_SEMI)
            if not everything or not n_left:
                return
            keep_cols, count = lcols, n_left
        else:
            hits = torch.zeros((lb.capacity,), dtype=torch.int32, device=dev)
            yield from self._pair_chunks(lcols, rcols, lb.capacity,
                                         build.capacity, total, n_build,
                                         out_schema if emit_pairs else None,
                                         hits, rhits)
            if jt == J.INNER:
                return
            matched = hits > 0
            want = matched if jt == J.LEFT_SEMI else ~matched
            live = torch.arange(lb.capacity, device=dev) < n_left
            keep_cols, count = compact_cols(lcols, want & live)
            if not count:
                return
        if jt in (J.LEFT_OUTER, J.FULL_OUTER):
            nowhere = torch.zeros((lb.capacity,), dtype=torch.int64,
                                  device=dev)
            keep_cols = keep_cols + gather_cols(
                rcols, nowhere, torch.zeros_like(nowhere, dtype=torch.bool))
        yield ColumnarBatch([c.to_vector() for c in keep_cols], count,
                            out_schema)

    def _pair_chunks(self, lcols, rcols, lcap, rcap, total, n_build,
                     out_schema, hits, rhits):
        """Expand the pairs ``[0, total)`` left-major in chunks of at most
        ``_MAX_CHUNK_ROWS``. Without a condition, yield each chunk; with
        one, count the kept pairs of each left row into ``hits`` (and of
        each build row into ``rhits``, when given) and yield the kept pairs
        when ``out_schema`` is given (one host sync a chunk, the kept
        count)."""
        dev = self.device
        pos = 0
        while pos < total:
            n_out = min(total - pos, _MAX_CHUNK_ROWS)
            out_cap = bucket_capacity(n_out)
            j = torch.arange(out_cap, dtype=torch.int64, device=dev) + pos
            live = j < pos + n_out
            pos += n_out
            li = (j // n_build).clamp(max=lcap - 1)
            ri = (j % n_build).clamp(max=rcap - 1)
            cols = gather_cols(lcols, li, live) + gather_cols(rcols, ri, live)
            if self.condition is None:
                yield ColumnarBatch([c.to_vector() for c in cols], n_out,
                                    out_schema)
                continue
            pred = self.condition.eval(EvalContext(cols, n_out, out_cap, dev))
            keep = selection_mask(pred, n_out, out_cap)
            hits.index_add_(0, li, keep.to(torch.int32))
            if rhits is not None:
                rhits.index_add_(0, ri, keep.to(torch.int32))
            if out_schema is not None:
                kept, count = compact_cols(cols, keep)
                if count:
                    yield ColumnarBatch([c.to_vector() for c in kept], count,
                                        out_schema)

    def args_string(self):
        return f"{self.join_type}" + (f" cond={self.condition}"
                                      if self.condition is not None else "")
