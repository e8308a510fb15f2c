"""Task-scoped OOM retry — counterpart of ``spark_rapids_tpu/runtime/retry.py``
(reference RmmRapidsRetryIterator / withRetry).

When a device allocation fails inside an operator, the task does not die:
the attempt's work is dropped, lower-priority buffers are spilled
synchronously, and the attempt runs again; a ``SplitAndRetryOom`` first
splits the input batch in half (``withRetry`` +
``splitSpillableInHalfByRows``).

Two things say that the card is full. The catalog's budget check
(runtime/memory.py) raises ``DeviceOomError`` under
``spark.rapids.tpu.memory.hbm.strictBudget`` when a registration cannot
spill back under the software budget; and the caching allocator raises
``torch.cuda.OutOfMemoryError`` when a tensor that the catalog does not
count cannot be allocated. ``_attempt`` maps the second to the first, inside
the attempt and nowhere else; an injected fault (runtime/faults.py) raises
the first directly. The ladder for each retryable OOM:

  1. count it (``counts``),
  2. spill lower-priority buffers down to half the device budget,
  3. split the input batch in half and queue the halves — down to
     ``spark.rapids.tpu.memory.retry.splitFloorBytes`` / a 2-row floor and
     at most ``spark.rapids.tpu.memory.retry.maxSplits`` times an input,
  4. when it cannot split, allow one spill-only retry, then re-raise.

The reference's resilience metrics, ``oom.retry`` span events and the
scheduler's cancellation check are not ported (runtime/metrics.py,
tracing.py and scheduler.py wait for the observability slice).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                    bucket_capacity)

#: OOMs retried, inputs split and bytes spilled for a retry since
#: ``reset_counts`` (the reference's resilience counters, process-wide)
counts = {"oom_retries": 0, "split_retries": 0, "spill_bytes": 0}
_counts_lock = threading.Lock()


def reset_counts() -> None:
    with _counts_lock:
        for k in counts:
            counts[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _counts_lock:
        counts[key] += n


def _rebuild_oom(cls, msg, requested, budget, spillable_bytes, pinned_bytes,
                 injected):
    return cls(msg, requested=requested, budget=budget,
               spillable_bytes=spillable_bytes, pinned_bytes=pinned_bytes,
               injected=injected)


class DeviceOomError(RuntimeError):
    """Device memory OOM — the RetryOOM analog. ``retryable`` marks it
    recoverable by the with_retry ladder. Pickles with its fields and its
    concrete class."""

    retryable = True

    def __init__(self, msg: str, *, requested: int = 0, budget: int = 0,
                 spillable_bytes: int = 0, pinned_bytes: int = 0,
                 injected: bool = False):
        super().__init__(msg)
        self.requested = requested
        self.budget = budget
        self.spillable_bytes = spillable_bytes
        self.pinned_bytes = pinned_bytes
        self.injected = injected

    def __reduce__(self):
        return (_rebuild_oom, (type(self), str(self), self.requested,
                               self.budget, self.spillable_bytes,
                               self.pinned_bytes, self.injected))


class SplitAndRetryOom(DeviceOomError):
    """Spilling alone cannot satisfy the attempt; the input must be split
    before the retry (reference SplitAndRetryOOM). Against an input that
    cannot split it propagates at once."""


class SpillCapacityError(DeviceOomError):
    """The disk-spill tier ran out of room (ENOSPC from the spill writer,
    or the injected ``disk_full`` fault). Retryable: the ladder answers it
    as it answers a device OOM, instead of letting a raw OSError escape the
    operator."""


@contextlib.contextmanager
def with_restore_on_retry(*checkpointables):
    """Snapshot operator state (objects with ``checkpoint()`` /
    ``restore()``) before an attempt; a retryable OOM rolls it back before
    it reaches the surrounding with_retry ladder, so a re-run never applies
    a side effect twice."""
    for c in checkpointables:
        c.checkpoint()
    try:
        yield
    except DeviceOomError as e:
        if getattr(e, "retryable", False):
            for c in checkpointables:
                c.restore()
        raise


# -- batch splitting ----------------------------------------------------------

def split_batch(batch: ColumnarBatch, floor_bytes: int = 0):
    """[first_half, second_half] by rows, or None when the batch cannot be
    split: fewer than 2 rows, halves below ``floor_bytes``, or a column
    that is not a plain ``TorchColumnVector`` (nested and encoded vectors,
    as the reference refuses its list and encoded vectors)."""
    n = batch.num_rows
    if n < 2:
        return None
    if batch.columns:
        if batch.device_memory_size() // 2 < floor_bytes:
            return None
        if any(type(c) is not TorchColumnVector for c in batch.columns):
            return None
    mid = n // 2
    return [_slice_rows(batch, 0, mid), _slice_rows(batch, mid, n)]


def _slice_rows(batch: ColumnarBatch, start: int, stop: int) -> ColumnarBatch:
    n = stop - start
    cap = bucket_capacity(n)
    cols = []
    for c in batch.columns:
        dev = c.data.device
        end = min(start + cap, c.capacity)
        v = c.data[start:end]
        m = c.validity[start:end]
        pad = cap - (end - start)
        if pad:
            v = torch.cat([v, torch.full((pad,), c.dtype.default_value(),
                                         dtype=v.dtype, device=dev)])
            m = torch.cat([m, torch.zeros((pad,), dtype=m.dtype,
                                          device=dev)])
        m = m & (torch.arange(cap, device=dev) < n)
        cols.append(TorchColumnVector(c.dtype, v, m, c.dictionary))
    return ColumnarBatch(cols, n, batch.schema, metadata=batch.metadata)


# -- the ladder ---------------------------------------------------------------

def _default_catalog():
    from spark_rapids_tpu_torch.runtime.memory import DeviceManager
    return DeviceManager.get().catalog


def _spill_for_retry(catalog=None) -> int:
    cat = catalog if catalog is not None else _default_catalog()
    spilled = cat.synchronous_spill(cat.device_budget // 2)
    if spilled:
        _count("spill_bytes", spilled)
    return spilled


def _attempt(site, call):
    """Run one attempt under the fault scope for `site` (so catalog
    registrations inside it check that site), with an injection checkpoint
    first: a spec counts attempts, not allocations. A
    ``torch.cuda.OutOfMemoryError`` raised inside the attempt becomes a
    retryable ``DeviceOomError``; nothing else is mapped."""
    from spark_rapids_tpu_torch.runtime import faults as F
    try:
        if site is None:
            return call()
        with F.scope(site):
            F.maybe_inject("oom", site)
            return call()
    except torch.cuda.OutOfMemoryError as e:
        raise DeviceOomError(
            f"device allocation failed at {site or '<unscoped>'}: {e}") from e


def _resolve_limits(conf, max_splits, split_floor_bytes):
    from spark_rapids_tpu_torch import config as C
    if conf is not None:
        if max_splits is None:
            max_splits = conf.get(C.RETRY_MAX_SPLITS)
        if split_floor_bytes is None:
            split_floor_bytes = conf.get(C.RETRY_SPLIT_FLOOR_BYTES)
    if max_splits is None:
        max_splits = C.RETRY_MAX_SPLITS.default
    if split_floor_bytes is None:
        split_floor_bytes = C.RETRY_SPLIT_FLOOR_BYTES.default
    return max_splits, split_floor_bytes


def with_retry(inputs, fn, *, conf=None, scope=None, splittable=True,
               max_splits=None, split_floor_bytes=None, catalog=None):
    """Generator: run ``fn`` over each input batch, recovering from
    retryable device OOMs by spill + split-and-retry. Yields fn's results:
    one an input, several where an input was split (every caller composes
    pieces to the unsplit answer).

    ``inputs``: ColumnarBatch or SpillableColumnarBatch items (a spillable
    one is acquired per attempt and closed after its last piece, so it
    stays spillable between attempts)."""
    from spark_rapids_tpu_torch.runtime.memory import SpillableColumnarBatch
    max_splits, split_floor_bytes = _resolve_limits(conf, max_splits,
                                                    split_floor_bytes)
    for item in inputs:
        pending = [(item, False)]   # (piece, already spill-retried)
        splits_used = 0
        while pending:
            cur, retried = pending.pop(0)
            spillable = isinstance(cur, SpillableColumnarBatch)
            batch = cur.get_batch() if spillable else cur
            try:
                result = _attempt(scope, lambda: fn(batch))
            except DeviceOomError as oom:
                if not getattr(oom, "retryable", False):
                    raise
                _count("oom_retries")
                _spill_for_retry(catalog)
                halves = None
                if splittable and splits_used < max_splits:
                    halves = split_batch(batch, floor_bytes=split_floor_bytes)
                if halves is not None:
                    splits_used += 1
                    _count("split_retries")
                    if spillable:
                        cur.close()
                    pending[:0] = [(h, False) for h in halves]
                    continue
                if isinstance(oom, SplitAndRetryOom) or retried:
                    raise   # the ladder is spent
                pending.insert(0, (cur, True))   # one spill-only retry
                continue
            if spillable:
                cur.close()
            yield result


def call_with_retry(thunk, *, scope=None, max_retries=2, catalog=None):
    """Run a zero-arg callable under spill-only OOM retry — the
    withRetryNoSplit analog, for work that cannot split: a block write, the
    merge of accumulated partials, a whole-batch sort."""
    attempt = 0
    while True:
        try:
            return _attempt(scope, thunk)
        except DeviceOomError as oom:
            if not getattr(oom, "retryable", False) or attempt >= max_retries:
                raise
            attempt += 1
            _count("oom_retries")
            _spill_for_retry(catalog)


def register_with_retry(batch, priority, *, conf=None, scope=None,
                        catalog=None, spill_callback=None, max_splits=None,
                        split_floor_bytes=None):
    """Register ``batch`` in the spill catalog as one or more
    SpillableColumnarBatch pieces, recovering from a strict-budget
    DeviceOomError by spilling and splitting (a failed registration rolls
    back in the catalog, so a re-attempt is clean)."""
    from spark_rapids_tpu_torch.runtime.memory import SpillableColumnarBatch

    def register(b):
        return SpillableColumnarBatch(b, priority, catalog=catalog,
                                      spill_callback=spill_callback)

    return list(with_retry([batch], register, conf=conf, scope=scope,
                           catalog=catalog, max_splits=max_splits,
                           split_floor_bytes=split_floor_bytes))
