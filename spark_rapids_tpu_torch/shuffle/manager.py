"""The shuffle block store — counterpart of ``ShuffleBlockStore`` in
``spark_rapids_tpu/shuffle/manager.py``.

An in-process registry of device-resident shuffle blocks, keyed by (shuffle
id, reduce id): the map side of an exchange writes each partition's slice
here, the reduce side reads its partition back. Each block carries a
``seq`` tuple, ``(map split, piece seq)``, and a partition is read back in
that order whatever order the map threads wrote it in, so results never
depend on timing. The reference's spill catalog, serialized mode and
transport hooks are not ported: blocks stay on the device until their
shuffle is unregistered.
"""

from __future__ import annotations

import itertools
import threading

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class ShuffleBlockStore:
    """Process-wide shuffle block registry (ShuffleBufferCatalog analog)."""

    _instance = None
    _ilock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._shuffle_ids = itertools.count(0)
        # shuffle id -> reduce id -> [(seq, arrival, batch)]
        self._blocks: dict[int, dict[int, list]] = {}

    @classmethod
    def get(cls) -> "ShuffleBlockStore":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = ShuffleBlockStore()
            return cls._instance

    def register_shuffle(self) -> int:
        with self._lock:
            sid = next(self._shuffle_ids)
            self._blocks[sid] = {}
            return sid

    def write_block(self, shuffle_id: int, reduce_id: int,
                    batch: ColumnarBatch, seq: tuple):
        """Add one block; ``seq`` pins its place in the reduce partition."""
        with self._lock:
            lst = self._blocks[shuffle_id].setdefault(reduce_id, [])
            lst.append((seq, len(lst), batch))

    def read_partition(self, shuffle_id: int, reduce_id: int):
        """Yield one reduce partition's blocks in ``seq`` order."""
        with self._lock:
            entries = sorted(self._blocks[shuffle_id].get(reduce_id, ()),
                             key=lambda e: (e[0], e[1]))
        for _, _, batch in entries:
            yield batch

    def partition_sizes(self, shuffle_id: int, num_partitions: int) -> list:
        """Device bytes per reduce partition: the map-output statistics the
        AQE coalescing decision reads (Spark MapOutputStatistics)."""
        with self._lock:
            parts = self._blocks.get(shuffle_id, {})
            return [sum(b.device_memory_size() for _, _, b in parts.get(p, ()))
                    for p in range(num_partitions)]

    def unregister_shuffle(self, shuffle_id: int):
        with self._lock:
            self._blocks.pop(shuffle_id, None)
