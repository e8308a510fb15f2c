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
mode emits the rows in the same order.

The nested-loop join (keyless and cross joins) broadcasts its right side
the same way and expands every (stream row, build row) pair in chunks of
``_MAX_CHUNK_ROWS``, left-major, filtered by an optional condition over
the pair schema: inner/cross, left outer, left semi and left anti. Which
stream rows matched is kept on the device (one ``index_add_`` of the kept
pairs per chunk) and read once per stream batch, where the unmatched rows
are compacted.

Not ported (the planner refuses them, ``plan/overrides.py``): right and full
outer joins (matched-build tracking, ``track_matched``), residual
conditions on an equi-join, and the shuffled/mesh route. The reference's probe chain fusion and its stream
prefilter/preproject hoist change no result and are not ported either.
"""

from __future__ import annotations

import threading

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import (Col, EvalContext,
                                              bind_references)
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.ops import joining as J
from spark_rapids_tpu_torch.ops.filtering import (compact_cols, gather_cols,
                                                  selection_mask)
from spark_rapids_tpu_torch.ops.strings import align_many

# max pairs expanded per output chunk (the JoinGatherer row-target analog)
_MAX_CHUNK_ROWS = 1 << 20


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


def _emit_pairs(join_type, stream_is_left, stream_batch, build_batch,
                build_perm, lo, hi, counts, total, out_schema):
    """Expand the probe's pairs in chunks of at most ``_MAX_CHUNK_ROWS`` and
    yield output batches: stream columns, then build columns (swapped when
    the build side is the left one), null-extended where an outer join found
    no match; semi and anti joins emit the stream columns only."""
    total = int(total)  # one host sync per stream batch
    semi_anti = join_type in (J.LEFT_SEMI, J.LEFT_ANTI)
    s_in = [Col.from_vector(c) for c in stream_batch.columns]
    b_in = ([] if semi_anti else
            [Col.from_vector(c) for c in build_batch.columns])
    pos = 0
    while pos < total:
        out_cap = bucket_capacity(min(total - pos, _MAX_CHUNK_ROWS))
        s_idx, b_idx, b_matched, live = J.expand_pairs(
            build_perm, lo, hi, counts, pos, out_cap)
        cols = gather_cols(s_in, s_idx, live)
        if not semi_anti:
            b_cols = gather_cols(b_in, b_idx.long(), b_matched)
            cols = (cols + b_cols) if stream_is_left else (b_cols + cols)
        yield ColumnarBatch([c.to_vector() for c in cols],
                            min(total - pos, out_cap), out_schema)
        pos += out_cap


class _JoinCore:
    """Probe machinery over one materialized build batch (module docstring:
    the build order and the modes)."""

    def __init__(self, build_batch: ColumnarBatch, build_key_exprs,
                 stream_key_exprs, join_type: str, device):
        self.device = torch.device(device)
        self.stream_key_exprs = stream_key_exprs
        self.join_type = join_type
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
        self.fast = (len(self.build_keys_raw) == 1
                     and _int_backed(self.build_keys_raw[0].dtype))
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
        # the reference's direct-table gate also asks scatters_cheap() and no
        # full-outer matched-build tracking: both hold in the port (a GPU or
        # the CPU; full outer joins are refused at planning)
        if self.n_build > 0 and dsize <= dense_budget:
            rel = torch.where(eligible, vals.long() - vmin,
                              torch.full_like(rows, dsize))
            hits = torch.zeros((dsize + 1,), dtype=torch.int32, device=dev)
            hits.scatter_add_(0, rel, torch.ones_like(rel, dtype=torch.int32))
            if bool((hits[:dsize] <= 1).all()):   # a duplicate key sorts
                self._dense_table = _direct_table(rel, dsize, cap)
                self._dense_size = dsize
                self.probe_mode = "dense"
                return
        nb = CK.hash_join_buckets(self.n_build)
        if nb and self.n_build > 0 and vmin > CK.HJ_EMPTY:
            tk, tr, ok = CK.hash_join_build(vals.long(), eligible, nb)
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
        self.probe_mode = "two"
        if unique:
            self.probe_mode = "one"
            if dsize <= dense_budget:
                # direct-address table over the sorted order (reached only by
                # an empty build: a unique one took the direct table above)
                slot = torch.where(rows < n_valid, sorted_vals.long() - vmin,
                                   torch.full_like(rows, dsize))
                self._dense_table = _direct_table(slot, dsize, cap)
                self._dense_size = dsize
                self.probe_mode = "dense"

    def probe_batch(self, stream_batch: ColumnarBatch):
        """``(build_perm, lo, hi, counts, total)`` for one stream batch, all
        on the device."""
        if not self.fast:
            return self._probe_batch_ranks(stream_batch)
        sctx = EvalContext.from_batch(stream_batch, self.device)
        k = self.stream_key_exprs[0].eval(sctx)
        svals = _key_values(k)
        scap = svals.shape[0]
        n_stream = stream_batch.num_rows
        live = torch.arange(scap, device=svals.device) < n_stream
        mode = self.probe_mode
        if mode == "hash":
            # equality over int64 images is equality over any narrower key
            pos, found = CK.hash_join_probe(
                self._hash_keys, self._hash_rows,
                svals.to(torch.int64).contiguous(), self.hash_buckets)
            hit = found & k.validity & live
            lo = torch.where(hit, pos, 0)
            hi = torch.where(hit, pos + 1, lo)
        elif mode == "dense":
            dsize = self._dense_size
            slot = svals.long() - self._vmin
            in_dom = (slot >= 0) & (slot < dsize - 1)
            r = self._dense_table[torch.clamp(slot, 0, dsize - 1)]
            hit = in_dom & (r >= 0) & k.validity & live
            lo = torch.where(hit, r, 0)
            hi = torch.where(hit, r + 1, lo)
        else:
            # mixed-width keys: promote both sides (casting the stream down
            # would wrap values and fabricate matches)
            common = torch.promote_types(svals.dtype,
                                         self._sorted_build.dtype)
            sc = self._sorted_build.to(common).contiguous()
            sv = svals.to(common).contiguous()
            n_valid = self._n_valid
            lo = torch.clamp(torch.searchsorted(sc, sv), max=n_valid)
            if mode == "one":
                found = ((sc[torch.clamp(lo, 0, sc.shape[0] - 1)] == sv)
                         & (lo < n_valid) & k.validity & live)
                hi = torch.where(found, lo + 1, lo)
            else:
                hi = torch.clamp(torch.searchsorted(sc, sv, right=True),
                                 max=n_valid)
                hi = torch.where(k.validity & live, hi, lo)
        counts = J.pair_counts(lo, hi, n_stream, scap, self.join_type)
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
                               self.join_type)
        return build_perm, lo, hi, counts, J.total_pairs(counts)


def _direct_table(rel, dsize: int, cap: int):
    """int32 table of ``dsize`` slots: ``table[rel[i]] = i``, -1 elsewhere;
    rows whose ``rel`` is ``dsize`` are dropped."""
    table = torch.full((dsize + 1,), -1, dtype=torch.int32, device=rel.device)
    table.scatter_(0, rel, torch.arange(cap, dtype=torch.int32,
                                        device=rel.device))
    return table[:dsize]


class HashJoinExec(TorchExec):
    """What every equi-join with a materialized build side shares (reference
    GpuShuffledHashJoinBase): keys, build side, output schema, the build's
    core and the probe loop. The co-partitioned (shuffled) route is not
    ported, so only the broadcast subclass executes."""

    def __init__(self, join_type: str, left_keys, right_keys,
                 left: TorchExec, right: TorchExec,
                 build_side: str = "right", conf=None):
        super().__init__(left, right, conf=conf)
        jt = join_type.lower().replace("_", "")
        if jt not in (J.INNER, J.LEFT_OUTER, J.LEFT_SEMI, J.LEFT_ANTI):
            raise NotImplementedError(
                f"{join_type} joins are not ported yet")
        self.join_type = jt
        self.left_keys = [bind_references(k, left.output) for k in left_keys]
        self.right_keys = [bind_references(k, right.output)
                           for k in right_keys]
        # the preserved side streams; an inner join may build either side
        self.stream_is_left = not (jt == J.INNER and build_side == "left")
        #: what the last build chose and how many stream batches it probed;
        #: partitions may run on an exchange's map threads, hence the lock
        self.stats = {"build_rows": 0, "probe_mode": None, "hash_buckets": 0,
                      "hash_refused": 0, "stream_batches": 0}
        self._lock = threading.Lock()

    @property
    def build_side(self) -> str:
        return "right" if self.stream_is_left else "left"

    @property
    def output(self) -> T.StructType:
        lf = list(self.children[0].output)
        rf = list(self.children[1].output)
        if self.join_type in (J.LEFT_SEMI, J.LEFT_ANTI):
            return T.StructType(lf)
        if self.join_type == J.LEFT_OUTER:
            rf = [T.StructField(f.name, f.data_type, True) for f in rf]
        return T.StructType(lf + rf)

    @property
    def num_partitions(self):
        return self._stream_child.num_partitions

    @property
    def _stream_child(self):
        return self.children[0 if self.stream_is_left else 1]

    def _core(self, build_batch) -> _JoinCore:
        bk, sk = ((self.right_keys, self.left_keys) if self.stream_is_left
                  else (self.left_keys, self.right_keys))
        core = _JoinCore(build_batch, bk, sk, self.join_type, self.device)
        with self._lock:
            self.stats.update(build_rows=core.n_build,
                              probe_mode=core.probe_mode,
                              hash_buckets=core.hash_buckets)
            self.stats["hash_refused"] += int(core.hash_refused)
        return core

    def _probe_stream(self, core, build_batch, split):
        out_schema = self.output
        for stream_batch in self._stream_child.execute_partition(split):
            with self._lock:
                self.stats["stream_batches"] += 1
            build_perm, lo, hi, counts, total = core.probe_batch(stream_batch)
            yield from _emit_pairs(
                self.join_type, self.stream_is_left, stream_batch,
                build_batch, build_perm, lo, hi, counts, total, out_schema)

    def args_string(self):
        return (f"{self.join_type} lk={self.left_keys} rk={self.right_keys} "
                f"build={self.build_side}")


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
        self._readers_left = self.num_partitions

    def _finish_reader(self) -> None:
        with self._lock:
            self._readers_left -= 1
            last = self._readers_left == 0
            if last:
                self._readers_left = self.num_partitions
        if last:
            self.exchange.release()

    def execute_partition(self, split):
        try:
            build_batch = self.exchange.broadcast()
            core = self._core(build_batch)
            yield from self._probe_stream(core, build_batch, split)
        finally:
            self._finish_reader()


class NestedLoopJoinExec(TorchExec):
    """Every (left row, right row) pair, kept where the optional condition
    holds (reference GpuBroadcastNestedLoopJoinExec): the right side is
    broadcast once and shared by every left (stream) partition; inner and
    cross joins emit the pairs, a left outer join also the unmatched left
    rows null-extended, and semi and anti joins the left rows that matched
    or did not. Right and full outer joins are not ported."""

    def __init__(self, join_type: str, left: TorchExec, right: TorchExec,
                 condition=None, conf=None):
        super().__init__(left, right, conf=conf)
        jt = join_type.lower().replace("_", "")
        jt = J.INNER if jt == J.CROSS else jt
        if jt not in (J.INNER, J.LEFT_OUTER, J.LEFT_SEMI, J.LEFT_ANTI):
            raise NotImplementedError(
                f"{join_type} nested-loop joins are not ported yet")
        self.join_type = jt
        self.condition = (bind_references(condition, self._pair_schema())
                          if condition is not None else None)
        from spark_rapids_tpu_torch.exec.broadcast import BroadcastExchangeExec
        self.exchange = BroadcastExchangeExec(self.children[1],
                                              conf=self.conf)
        self.children[1] = self.exchange
        self._readers_left = self.num_partitions
        #: rows in on each side, stream partitions, pairs expanded and rows
        #: out; partitions may run on an exchange's map threads, hence the
        #: lock
        self.stats = {"stream_rows": 0, "build_rows": 0, "partitions": 0,
                      "pairs": 0, "output_rows": 0}
        self._lock = threading.Lock()

    def _pair_schema(self):
        return T.StructType(list(self.children[0].output)
                            + list(self.children[1].output))

    @property
    def output(self):
        lf, rf = list(self.children[0].output), list(self.children[1].output)
        if self.join_type in (J.LEFT_SEMI, J.LEFT_ANTI):
            return T.StructType(lf)
        if self.join_type == J.LEFT_OUTER:
            rf = [T.StructField(f.name, f.data_type, True) for f in rf]
        return T.StructType(lf + rf)

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def _finish_reader(self) -> None:
        with self._lock:
            self._readers_left -= 1
            last = self._readers_left == 0
            if last:
                self._readers_left = self.num_partitions
        if last:
            self.exchange.release()

    def execute_partition(self, split):
        try:
            build = self.exchange.broadcast()
            with self._lock:
                self.stats["build_rows"] = build.num_rows
                self.stats["partitions"] += 1
            for lb in self.children[0].execute_partition(split):
                for out in self._join_batch(lb, build):
                    with self._lock:
                        self.stats["output_rows"] += out.num_rows
                    yield out
        finally:
            self._finish_reader()

    def _join_batch(self, lb, build):
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
        emit_pairs = jt in (J.INNER, J.LEFT_OUTER)
        if self.condition is None:
            # every pair is kept: a left row matched iff the right side has
            # rows, and the pairs need expanding only to be emitted
            if emit_pairs:
                yield from self._pair_chunks(lcols, rcols, lb.capacity,
                                             build.capacity, total, n_build,
                                             out_schema, None)
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
                                         hits)
            if jt == J.INNER:
                return
            matched = hits > 0
            want = matched if jt == J.LEFT_SEMI else ~matched
            live = torch.arange(lb.capacity, device=dev) < n_left
            keep_cols, count = compact_cols(lcols, want & live)
            if not count:
                return
        if jt == J.LEFT_OUTER:
            nowhere = torch.zeros((lb.capacity,), dtype=torch.int64,
                                  device=dev)
            keep_cols = keep_cols + gather_cols(
                rcols, nowhere, torch.zeros_like(nowhere, dtype=torch.bool))
        yield ColumnarBatch([c.to_vector() for c in keep_cols], count,
                            out_schema)

    def _pair_chunks(self, lcols, rcols, lcap, rcap, total, n_build,
                     out_schema, hits):
        """Expand the pairs ``[0, total)`` left-major in chunks of at most
        ``_MAX_CHUNK_ROWS``. Without a condition, yield each chunk; with
        one, count the kept pairs of each left row into ``hits`` and yield
        the kept pairs when ``out_schema`` is given (one host sync a chunk,
        the kept count)."""
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
            if out_schema is not None:
                kept, count = compact_cols(cols, keep)
                if count:
                    yield ColumnarBatch([c.to_vector() for c in kept], count,
                                        out_schema)

    def args_string(self):
        return f"{self.join_type}" + (f" cond={self.condition}"
                                      if self.condition is not None else "")
