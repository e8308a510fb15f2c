"""Shuffle exchange — counterpart of ``ShuffleExchangeExec`` and
``AdaptiveShuffleReaderExec`` in ``spark_rapids_tpu/exec/exchange.py``
(reference GpuShuffleExchangeExecBase and GpuCustomShuffleReaderExec).

The map stage runs once, lazily, when the first reduce partition is read:
one map task per input partition, on a pool of
``spark.rapids.tpu.sql.localScheduler.numThreads`` threads. A range
exchange first samples the first batch of every input partition to pick
its bounds. Each task partitions its batches on the device
(``shuffle/partitioning.py``) under the OOM ladder
(``R.with_retry(..., scope="exchange.map")``: a split half writes the same
rows to the same reduce ids) and writes every slice under
``R.call_with_retry(scope="exchange.write")``, each under ``(map split,
piece seq)``, so a reduce partition reads back in the same order whatever
the threads or the retries did. The blocks go to a private shuffle id that
is published only when the map stage is complete.

The reduce side reads its blocks (from any spill tier, or from host frames
in the serializing shuffle), and a block lost before the partition's first
batch was emitted — ``KeyError``, ``BufferClosedError`` or a disk-tier CRC
failure (``SpillCorruptionError``) — invalidates the map outputs and
recomputes them, at most ``spark.rapids.tpu.shuffle.fetch.maxRetries``
times; a loss after that raises ``TransportError``. The reduce side
coalesces its blocks to ``spark.rapids.tpu.sql.batchSizeBytes`` batches,
and the last reduce partition read frees the shuffle's blocks. Under
``spark.rapids.tpu.pipeline.enabled`` the map side's child and the reduce
side's reader run as pipelined stages (``runtime/pipeline.py``).

Not ported: the event log, metrics, the query scheduler's cancellation
hooks (``abort_query``) and the mesh exchange.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.coalesce import TargetSize, coalesce_iterator
from spark_rapids_tpu_torch.runtime import memory as mem
from spark_rapids_tpu_torch.runtime import pipeline as P
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.semaphore import (DeviceSemaphore,
                                                      TaskContext)
from spark_rapids_tpu_torch.shuffle.manager import ShuffleBlockStore
from spark_rapids_tpu_torch.shuffle.partitioning import (Partitioner,
                                                         RangePartitioner)


class ShuffleExchangeExec(TorchExec):
    """Reference GpuShuffleExchangeExecBase."""

    def __init__(self, partitioner: Partitioner, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        if not self.conf.get(C.SHUFFLE_MANAGER_ENABLED):
            from spark_rapids_tpu_torch.shuffle import serialization as ser
            if not ser.schema_serializable(child.output):
                raise NotImplementedError(
                    "the serializing shuffle has no frame for nested "
                    f"columns ({child.output}); set "
                    f"{C.SHUFFLE_MANAGER_ENABLED.key}=true")
        self.partitioner = partitioner.bind(child.output)
        self._map_done = threading.Event()
        self._map_lock = threading.Lock()
        self._map_error = None
        self._shuffle_id = None
        self._pending_shuffle_id = None
        self._reads_left = self.partitioner.num_partitions
        self._reads_lock = threading.Lock()
        #: batches (and split pieces) the map stage partitioned, over every
        #: run of it (empty batches are skipped)
        self.map_batches = 0
        #: times the map stage ran (a recompute runs it again)
        self.map_runs = 0
        #: reduce-side fetch failures that recomputed the map outputs
        self.recomputes = 0
        #: wall seconds of the last map stage (its child's work included),
        #: on the host clock
        self.map_seconds = 0.0
        #: host seconds the map tasks spent partitioning and writing blocks
        #: (summed over tasks; each batch's count sync waits for the device)
        self.partition_seconds = 0.0
        #: bytes per reduce partition of the last map stage
        #: (``ShuffleBlockStore.partition_sizes``)
        self.partition_sizes: list = []

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return self.partitioner.num_partitions

    def _sample_bounds(self):
        """The range exchange's sample pass: the first batch of every input
        partition (reference GpuRangePartitioner.sketch over a reservoir
        sample)."""
        samples = []
        for split in range(self.child.num_partitions):
            with TaskContext():
                it = self.child.execute_partition(split)
                try:
                    for b in it:
                        samples.append(b)
                        break
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
        if samples:
            self.partitioner.set_bounds_from_sample(samples)

    def _run_map_stage(self):
        store = ShuffleBlockStore.get()
        serialized = not self.conf.get(C.SHUFFLE_MANAGER_ENABLED)
        # write to a private shuffle id, published only when every block
        # is in the store: a reader racing a recompute never sees half a
        # shuffle as complete
        sid = store.register_shuffle(serialized=serialized,
                                     device=self.device)
        self._pending_shuffle_id = sid
        self.map_runs += 1
        t0 = time.perf_counter()
        if isinstance(self.partitioner, RangePartitioner):
            self._sample_bounds()
        query = mem.current_query()
        counted = threading.Lock()

        def map_task(split):
            with mem.query_context(query), TaskContext():
                # the map segment's boundary: the child produces on the
                # stage's thread while this one partitions and writes
                child_it = P.maybe_stage(self.child.execute_partition(split),
                                         "exchange.map", self.conf)
                piece_seq = 0
                for batch in child_it:
                    if batch.num_rows == 0:
                        continue

                    def partition_one(b):
                        t1 = time.perf_counter()
                        out = self.partitioner.partition(b, split)
                        with counted:
                            self.map_batches += 1
                            self.partition_seconds += time.perf_counter() - t1
                        return out

                    # a split half writes the same rows to the same reduce
                    # ids, so recovery by pieces is invisible downstream
                    for pieces in R.with_retry([batch], partition_one,
                                               conf=self.conf,
                                               scope="exchange.map"):
                        piece_seq += 1
                        t1 = time.perf_counter()
                        for pid, piece in pieces:
                            # a failed block registration rolls back before
                            # it raises, so a retry never writes twice; seq
                            # pins the block to (map split, piece order)
                            R.call_with_retry(
                                lambda p=pid, b=piece, s=piece_seq:
                                    store.write_block(sid, p, b,
                                                      seq=(split, s)),
                                scope="exchange.write")
                        with counted:
                            self.partition_seconds += time.perf_counter() - t1

        n_maps = self.child.num_partitions
        threads = max(1, min(self.conf.get(C.NUM_LOCAL_TASKS), n_maps))
        if threads == 1:
            for split in range(n_maps):
                map_task(split)
        else:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(map_task, range(n_maps)))
        self.map_seconds = time.perf_counter() - t0
        self.partition_sizes = store.partition_sizes(
            sid, self.partitioner.num_partitions)
        self._shuffle_id = sid          # publish: the map outputs are whole
        self._pending_shuffle_id = None

    def _ensure_map_stage(self):
        if self._map_done.is_set():
            self._raise_if_failed()
            return
        with self._map_lock:
            if not self._map_done.is_set():
                try:
                    self._run_map_stage()
                except BaseException as e:
                    # neither re-run the map stage for every reduce task nor
                    # strand the blocks the failed stage wrote
                    self._map_error = e
                    pending = self._pending_shuffle_id
                    if pending is not None:
                        ShuffleBlockStore.get().unregister_shuffle(pending)
                        self._pending_shuffle_id = None
                finally:
                    self._map_done.set()
        self._raise_if_failed()

    def _raise_if_failed(self):
        err = self._map_error
        if err is not None:
            raise RuntimeError("shuffle map stage failed") from err

    def ensure_map_stage(self) -> int:
        """Run the map stage once; the shuffle id of its blocks."""
        self._ensure_map_stage()
        return self._shuffle_id

    def _invalidate_map_stage(self, observed):
        """Forget the map outputs so that the next read recomputes them
        (Spark's FetchFailed → stage retry). ``observed`` is the shuffle id
        the caller's read failed against: only that generation may be torn
        down, since a concurrent reader's recompute may already have
        published a newer one."""
        with self._map_lock:
            if observed is None or self._shuffle_id != observed:
                return
            ShuffleBlockStore.get().unregister_shuffle(self._shuffle_id)
            self._shuffle_id = None
            self._map_error = None
            self._map_done.clear()

    def _read_with_recompute(self, split):
        """Stream one reduce partition; a lost block found before any batch
        was emitted recomputes the map outputs (bounded by
        shuffle.fetch.maxRetries). After a partial emission the consumer
        has seen rows, so the loss raises TransportError."""
        from spark_rapids_tpu_torch.shuffle.transport import TransportError
        store = ShuffleBlockStore.get()
        retries = self.conf.get(C.SHUFFLE_FETCH_MAX_RETRIES)
        for attempt in range(retries + 1):
            emitted = False
            sid = self._shuffle_id
            try:
                for b in store.read_partition(sid, split):
                    emitted = True
                    yield b
                return
            except (TransportError, KeyError, mem.BufferClosedError,
                    mem.SpillCorruptionError) as e:
                if emitted or attempt == retries:
                    raise TransportError(
                        f"reduce {split} fetch failed"
                        f"{' after partial read' if emitted else ''}: {e}"
                    ) from e
                self.recomputes += 1
                self._invalidate_map_stage(sid)
                DeviceSemaphore.get().release_if_necessary()
                self._ensure_map_stage()

    def account_read_done(self):
        """One reduce partition finished (drained or never opened); the
        last one frees the shuffle's blocks."""
        with self._reads_lock:
            self._reads_left -= 1
            done = self._reads_left == 0
        if done and self._shuffle_id is not None:
            ShuffleBlockStore.get().unregister_shuffle(self._shuffle_id)

    def read_reduce(self, pid: int):
        """Stream one reduce partition's blocks with recompute; each pid is
        read (or accounted as skipped) exactly once, and the last one frees
        the shuffle."""
        try:
            yield from self._read_with_recompute(pid)
        finally:
            self.account_read_done()

    def execute_partition(self, split):
        # drop this task's permit before waiting on the map stage: holding
        # it would starve the map tasks (reference
        # RapidsShuffleIterator.scala:300)
        DeviceSemaphore.get().release_if_necessary()
        self._ensure_map_stage()
        goal = TargetSize(self.conf.get(C.BATCH_SIZE_BYTES))
        it = coalesce_iterator(self.read_reduce(split), goal,
                               conf=self.conf)
        # the reduce segment's boundary: fetch and coalesce run on the
        # stage's thread, beside the consumer's compute
        return P.maybe_stage(it, "exchange.reduce", self.conf)

    def args_string(self):
        return (f"{type(self.partitioner).__name__}"
                f"({self.partitioner.num_partitions})")


class AdaptiveShuffleReaderExec(TorchExec):
    """The AQE coalescing shuffle reader (reference GpuCustomShuffleReaderExec
    with Spark's CoalesceShufflePartitions): once the map stage has run,
    contiguous reduce partitions merge into reader partitions of about
    ``spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes``.

    ``num_partitions`` stays the exchange's, so planning never runs the map
    stage; reader splits past the merged specs come up empty. Planned only
    above an exchange with one consumer (the aggregate), because merging
    changes which rows share a split."""

    def __init__(self, exchange: ShuffleExchangeExec, conf=None):
        super().__init__(exchange, conf=conf)
        self._specs = None
        self._spec_lock = threading.Lock()

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return self.child.num_partitions

    def _ensure_specs(self) -> list:
        ex = self.child
        sid = ex.ensure_map_stage()
        with self._spec_lock:
            if self._specs is None:
                n = ex.partitioner.num_partitions
                sizes = ShuffleBlockStore.get().partition_sizes(sid, n)
                target = self.conf.get(C.ADVISORY_PARTITION_BYTES)
                specs, cur, cur_bytes = [], [], 0
                for pid in range(n):
                    if cur and cur_bytes + sizes[pid] > target:
                        specs.append(cur)
                        cur, cur_bytes = [], 0
                    cur.append(pid)
                    cur_bytes += sizes[pid]
                if cur:
                    specs.append(cur)
                self._specs = specs
            return self._specs

    def execute_partition(self, split):
        ex = self.child
        goal = TargetSize(self.conf.get(C.BATCH_SIZE_BYTES))

        def blocks():
            # the same guard as ShuffleExchangeExec.execute_partition
            DeviceSemaphore.get().release_if_necessary()
            specs = self._ensure_specs()
            pids = specs[split] if split < len(specs) else []
            opened = 0
            try:
                for pid in pids:
                    opened += 1
                    yield from ex.read_reduce(pid)   # accounts for itself
            finally:
                # a consumer that stops early leaves pids unopened: they
                # must be accounted too, or the blocks are never freed
                for _ in pids[opened:]:
                    ex.account_read_done()
        return P.maybe_stage(coalesce_iterator(blocks(), goal,
                                               conf=self.conf),
                             "exchange.reduce", self.conf)

    def args_string(self):
        specs = self._specs
        return f"coalesced={len(specs) if specs is not None else '?'}"
