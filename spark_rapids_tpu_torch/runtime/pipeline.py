"""Pipelined stages — counterpart of ``spark_rapids_tpu/runtime/pipeline.py``:
bounded, memory-budgeted producer/consumer stages.

The reference cuts a physical plan into segments at its pipeline breakers
(scan, exchange map/reduce, join build, sort, final collect) and runs each
segment's batch loop on its own worker thread, connected by
:class:`BoundedBatchQueue` edges whose capacity is counted in batches and
in bytes. Queued device batches are registered as spillable with the
buffer catalog, so the OOM ladder (runtime/retry.py) can spill them like
any other on-deck batch.

On the card every producer enqueues its work on the consumer's CUDA stream
(each thread's current stream is the device's default stream, and no stage
changes it), so a tensor that crosses a queue needs no event wait and no
``record_stream``: the overlap these stages give is on the host (decode,
Python operator code, the exchange's block writes), where the port spends
most of its walls. A producer on a side stream would need both for every
tensor that crosses, or the caching allocator could hand out memory that
is still being read.

Contracts (the reference's):

- **Admission control**: a thread never holds a ``DeviceSemaphore`` permit
  while it blocks on a queue (the consumer may need that permit to drain
  it); the operators re-acquire theirs per batch.
- **Failure**: a producer's error (an injected fault at the
  ``pipeline.put`` / ``pipeline.get`` sites included) stops the stage,
  drains and unregisters the queued spillable batches, and re-raises the
  original exception at the consumer's place in the stream. Closing the
  consumer early (a limit, an error downstream) releases the producer
  instead of leaving it blocked on a full queue.

The reference's queue metrics (``queueWaitTime:<edge>``,
``queueFullTime:<edge>``, ``queueDepthPeak:<edge>``), its process gauges and
its ``pipeline.stall`` events wait for runtime/metrics.py and eventlog.py;
``peak_bytes`` and ``peak_depth`` stay on each queue.
"""

from __future__ import annotations

import collections
import threading
import typing
import weakref

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.runtime import faults as F


def enabled(conf) -> bool:
    """Is the pipelined executor on (spark.rapids.tpu.pipeline.enabled)?"""
    return conf is not None and conf.get(C.PIPELINE_ENABLED)


def maybe_stage(it, edge: str, conf, spillable: bool = True):
    """``it`` on a pipelined stage of its own when the pipeline is on (the
    edge's depth and byte budget from the conf), else ``it`` itself: the one
    place every pipeline boundary of the operators asks. ``spillable``
    registers queued device batches with the catalog; an edge of host
    arrow tables passes False."""
    if not enabled(conf):
        return it
    return stage_iterator(it, edge=edge, conf=conf, spillable=spillable)


def _size_of(item) -> int:
    """Bytes one queued item accounts for: arrow tables by nbytes, device
    batches by device footprint, spillable handles by registered size."""
    nb = getattr(item, "nbytes", None)
    if isinstance(nb, int):
        return nb
    if callable(nb):
        try:
            return int(nb())
        except Exception:
            return 0
    dm = getattr(item, "device_memory_size", None)
    if callable(dm):
        try:
            return int(dm())
        except Exception:
            return 0
    size = getattr(item, "size", None)
    return size if isinstance(size, int) else 0


class BoundedBatchQueue:
    """One pipeline edge: a bounded queue counted in items and in bytes.

    One oversized item is always accepted by an empty queue, so a single
    huge batch can never deadlock the stage. ``close()`` is the consumer's
    cancel: it unblocks the producer (``put`` returns False) and drops the
    queued items through a cleanup callback, so no spillable registration
    leaks."""

    def __init__(self, edge: str, depth: int, max_bytes):
        self.edge = edge
        self.depth = max(1, int(depth))
        self.max_bytes = max_bytes  # None = unbounded bytes
        self._cond = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._bytes = 0
        self._done = False
        self._error: BaseException | None = None
        self._closed = False
        self.peak_bytes = 0
        self.peak_depth = 0

    # -- producer side -------------------------------------------------------
    def put(self, item, nbytes: int | None = None) -> bool:
        """Enqueue one item; blocks while the queue is over its depth or
        byte budget. False when the consumer closed the stage (the producer
        must stop and drop `item`)."""
        F.maybe_inject_any(f"pipeline.put.{self.edge}")
        F.maybe_inject_any("pipeline.put")
        nb = _size_of(item) if nbytes is None else nbytes
        released = False
        with self._cond:
            while not self._closed and self._items and (
                    len(self._items) >= self.depth
                    or (self.max_bytes is not None
                        and self._bytes + nb > self.max_bytes)):
                if not released:
                    released = True
                    self._release_device_permit()
                self._cond.wait(0.05)
            if self._closed:
                return False
            self._items.append((item, nb))
            self._bytes += nb
            self.peak_bytes = max(self.peak_bytes, self._bytes)
            self.peak_depth = max(self.peak_depth, len(self._items))
            self._cond.notify_all()
        return True

    def finish(self) -> None:
        with self._cond:
            self._done = True
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Producer error: the items queued before it still drain in order,
        then the consumer's next get() re-raises `exc`."""
        with self._cond:
            self._error = exc
            self._done = True
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------
    def get(self):
        """('item', x) or ('done', None); re-raises the producer's error
        once every item queued before it is consumed."""
        F.maybe_inject_any(f"pipeline.get.{self.edge}")
        F.maybe_inject_any("pipeline.get")
        released = False
        with self._cond:
            while not self._items and not self._done and not self._closed:
                if not released:
                    # a consumer blocked on an empty queue must not sit on
                    # a permit its producer needs
                    released = True
                    self._release_device_permit()
                self._cond.wait(0.05)
            if self._items:
                item, nb = self._items.popleft()
                self._bytes -= nb
                self._cond.notify_all()
                return ("item", item)
            if self._error is not None:
                err = self._error
            else:
                return ("done", None)
        raise err

    def close(self, cleanup=None) -> None:
        """Cancel the edge: producer puts start returning False and the
        queued items are dropped through `cleanup` (idempotent)."""
        with self._cond:
            self._closed = True
            items = list(self._items)
            self._items.clear()
            self._bytes = 0
            self._cond.notify_all()
        for item, _ in items:
            if cleanup is not None:
                try:
                    cleanup(item)
                except Exception:   # noqa: BLE001 — cleanup must not mask
                    pass

    @staticmethod
    def _release_device_permit() -> None:
        # never block on a queue holding a device permit: with
        # concurrentTpuTasks=N, N blocked producers would starve the very
        # consumers that must drain them
        from spark_rapids_tpu_torch.runtime.semaphore import DeviceSemaphore
        DeviceSemaphore.get().release_if_necessary()


def stage_iterator(gen, *, edge: str, conf=None, spillable: bool = False,
                   depth: int | None = None, max_bytes=None,
                   _queue_cb=None) -> typing.Iterator:
    """Run `gen` on its own worker thread behind a BoundedBatchQueue and
    return an order-preserving iterator over its items.

    - `depth` / `max_bytes` default to pipeline.queueDepth /
      pipeline.maxQueueBytes (the byte cap also shrinks to the spill
      catalog's free host headroom, runtime/memory.host_prefetch_budget).
    - `spillable=True` registers device batches with the buffer catalog
      while they are queued, under the OOM split-retry ladder (so an
      over-budget registration spills others and may split the batch).
    """
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.runtime import memory as mem
    from spark_rapids_tpu_torch.runtime.semaphore import TaskContext

    if depth is None:
        depth = (conf.get(C.PIPELINE_QUEUE_DEPTH) if conf is not None
                 else C.PIPELINE_QUEUE_DEPTH.default)
    if max_bytes is None:
        cap = (conf.get(C.PIPELINE_MAX_QUEUE_BYTES) if conf is not None
               else C.PIPELINE_MAX_QUEUE_BYTES.default)
        max_bytes = mem.host_prefetch_budget(cap)
    q = BoundedBatchQueue(edge, depth, max_bytes)
    if _queue_cb is not None:
        _queue_cb(q)
    query = mem.current_query()
    cuda_dev = (torch.cuda.current_device()
                if torch.cuda.is_available() and torch.cuda.is_initialized()
                else None)

    def produce():
        from spark_rapids_tpu_torch.runtime import retry as R
        it = iter(gen)
        try:
            if cuda_dev is not None:
                # the consumer's device, hence its default stream
                torch.cuda.set_device(cuda_dev)
            with mem.query_context(query), TaskContext():
                while True:
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    # a device batch of any column kind goes through the
                    # spill tiers; an arrow table is bounded by the queue's
                    # byte budget alone
                    if spillable and isinstance(item, ColumnarBatch):
                        ok = True
                        # queued batches are held by the queue edge, not by
                        # the operator that made them
                        with mem.alloc_site("pipeline.queue"):
                            sbs = R.register_with_retry(
                                item, mem.ACTIVE_ON_DECK_PRIORITY, conf=conf)
                        for i, sb in enumerate(sbs):
                            try:
                                if ok:
                                    ok = q.put(sb, sb.size)
                            except BaseException:
                                # a fault at the queue: what it did not
                                # take must not stay registered
                                for rest in sbs[i:]:
                                    rest.close()
                                raise
                            if not ok:
                                sb.close()
                        if not ok:
                            return
                    elif not q.put(item):
                        return
                q.finish()
        except BaseException as e:   # noqa: BLE001 — re-raised at consumer
            q.fail(e)
        finally:
            # run the source generator's finalizers on this thread even when
            # the consumer stopped mid-stream (shuffle read accounting,
            # nested stages and spillable closes live in them)
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:   # noqa: BLE001
                    pass

    t = threading.Thread(target=produce, daemon=True,
                         name=f"srt-pipe-{edge}")

    def consume():
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    return
                if isinstance(item, mem.SpillableColumnarBatch):
                    batch = item.get_batch()
                    item.close()
                    yield batch
                else:
                    yield item
        finally:
            q.close(_cleanup_item)

    out = consume()
    # a consumer that is never started skips its finally block: the GC
    # finalizer still cancels the queue, so the producer cannot idle
    # forever against a full edge
    weakref.finalize(out, q.close, _cleanup_item)
    t.start()
    return out


def _cleanup_item(item) -> None:
    close = getattr(item, "close", None)
    if close is not None:
        close()
