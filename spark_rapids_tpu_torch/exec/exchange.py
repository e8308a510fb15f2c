"""Shuffle exchange — counterpart of ``ShuffleExchangeExec`` and
``AdaptiveShuffleReaderExec`` in ``spark_rapids_tpu/exec/exchange.py``
(reference GpuShuffleExchangeExecBase and GpuCustomShuffleReaderExec).

The map stage runs once, lazily, when the first reduce partition is read:
one map task per input partition, on a pool of
``spark.rapids.tpu.sql.localScheduler.numThreads`` threads. Each task
partitions its batches on the device (``shuffle/partitioning.py``) and
writes every slice to the block store under ``(map split, piece seq)``, so
a reduce partition reads back in the same order whatever the threads did.
The reduce side coalesces its blocks to ``spark.rapids.tpu.sql.batchSizeBytes``
batches. The last reduce partition read frees the shuffle's blocks.

Not ported: the retry ladder, the event log, metrics, the pipelined stage
iterators, fetch-failure recompute and the mesh exchange.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.coalesce import TargetSize, coalesce_iterator
from spark_rapids_tpu_torch.shuffle.manager import ShuffleBlockStore
from spark_rapids_tpu_torch.shuffle.partitioning import Partitioner


class ShuffleExchangeExec(TorchExec):
    """Reference GpuShuffleExchangeExecBase."""

    def __init__(self, partitioner: Partitioner, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        if not self.conf.get(C.SHUFFLE_MANAGER_ENABLED):
            raise NotImplementedError(
                "the serializing shuffle is not ported yet: "
                f"{C.SHUFFLE_MANAGER_ENABLED.key} must stay true")
        self.partitioner = partitioner.bind(child.output)
        self._map_lock = threading.Lock()
        self._shuffle_id = None
        self._reads_left = self.partitioner.num_partitions
        self._reads_lock = threading.Lock()
        #: batches the map stage partitioned (empty ones are skipped)
        self.map_batches = 0
        #: wall seconds of the map stage (its child's work included), on the
        #: host clock
        self.map_seconds = 0.0
        #: host seconds the map tasks spent partitioning and writing blocks
        #: (summed over tasks; each batch's count sync waits for the device)
        self.partition_seconds = 0.0

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self):
        return self.partitioner.num_partitions

    def _run_map_stage(self) -> int:
        store = ShuffleBlockStore.get()
        sid = store.register_shuffle()
        counted = threading.Lock()

        def map_task(split):
            seq = 0
            for batch in self.child.execute_partition(split):
                if batch.num_rows == 0:
                    continue
                seq += 1
                t0 = time.perf_counter()
                for pid, piece in self.partitioner.partition(batch, split):
                    store.write_block(sid, pid, piece, seq=(split, seq))
                with counted:
                    self.map_batches += 1
                    self.partition_seconds += time.perf_counter() - t0

        t0 = time.perf_counter()
        n_maps = self.child.num_partitions
        threads = max(1, min(self.conf.get(C.NUM_LOCAL_TASKS), n_maps))
        if threads == 1:
            for split in range(n_maps):
                map_task(split)
        else:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(map_task, range(n_maps)))
        self.map_seconds = time.perf_counter() - t0
        return sid

    def ensure_map_stage(self) -> int:
        """Run the map stage once; the shuffle id of its blocks."""
        with self._map_lock:
            if self._shuffle_id is None:
                self._shuffle_id = self._run_map_stage()
            return self._shuffle_id

    def read_reduce(self, pid: int):
        """Stream one reduce partition's blocks; each pid is read (or
        accounted as skipped) exactly once, and the last one frees the
        shuffle."""
        try:
            yield from ShuffleBlockStore.get().read_partition(
                self.ensure_map_stage(), pid)
        finally:
            self.account_read_done()

    def account_read_done(self):
        with self._reads_lock:
            self._reads_left -= 1
            done = self._reads_left == 0
        if done:
            ShuffleBlockStore.get().unregister_shuffle(self._shuffle_id)

    def execute_partition(self, split):
        goal = TargetSize(self.conf.get(C.BATCH_SIZE_BYTES))
        return coalesce_iterator(self.read_reduce(split), goal)

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
        return coalesce_iterator(blocks(), goal)

    def args_string(self):
        specs = self._specs
        return f"coalesced={len(specs) if specs is not None else '?'}"
