"""The shuffle block store — counterpart of ``ShuffleBlockStore`` in
``spark_rapids_tpu/shuffle/manager.py`` (reference
RapidsShuffleInternalManagerBase:200 with its caching writer and reader,
ShuffleBufferCatalog, and GpuColumnarBatchSerializer for the serializing
path).

An in-process registry of shuffle blocks, keyed by (shuffle id, reduce
id): the map side of an exchange writes each partition's slice here, the
reduce side reads its partition back. A block is registered in the spill
catalog as a ``SpillableColumnarBatch`` at
``OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY`` (shuffle output spills first, the
reference's SpillPriorities contract) under the allocation site
"exchange.block" (or the retry scope that writes it); in serialized mode
(``spark.rapids.tpu.shuffle.enabled=false``) it is a host frame
(``shuffle/serialization.py``) and is read back to the shuffle's device.
Each block carries a ``seq`` tuple, ``(map split, piece seq)``, and a
partition is read back in that order whatever order the map threads wrote
it in. Unregistering a shuffle closes every block. The transport's
listeners (``add_unregister_listener``) wait for ``shuffle/transport.py``.
"""

from __future__ import annotations

import itertools
import threading

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.runtime import faults as F
from spark_rapids_tpu_torch.runtime import memory as mem
from spark_rapids_tpu_torch.shuffle import serialization as ser


class ShuffleBlockStore:
    """Process-wide shuffle block registry (ShuffleBufferCatalog analog)."""

    _instance = None
    _ilock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._shuffle_ids = itertools.count(0)
        # shuffle id -> reduce id -> [(seq, arrival, blob)]
        self._blocks: dict[int, dict[int, list]] = {}
        self._serialized_mode: dict[int, bool] = {}
        self._devices: dict[int, object] = {}

    @classmethod
    def get(cls) -> "ShuffleBlockStore":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = ShuffleBlockStore()
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._ilock:
            if cls._instance is not None:
                cls._instance.clear_all()
            cls._instance = None

    def register_shuffle(self, serialized: bool = False,
                         device="cpu") -> int:
        """A new shuffle id; a serialized shuffle's blocks read back to
        ``device``."""
        with self._lock:
            sid = next(self._shuffle_ids)
            self._blocks[sid] = {}
            self._serialized_mode[sid] = serialized
            self._devices[sid] = device
            return sid

    # -- write side (RapidsCachingWriter.write:90) ---------------------------
    def write_block(self, shuffle_id: int, reduce_id: int,
                    batch: ColumnarBatch, seq=None):
        """Add one block; ``seq`` (an ordered tuple, (map split, piece
        seq)) pins its place in the reduce partition whatever order the
        writes come in; None appends after every seq-tagged block."""
        if self._serialized_mode[shuffle_id]:
            blob = ser.serialize_batch(batch)
        else:
            with mem.alloc_site(F.current_scope() or "exchange.block"):
                blob = mem.SpillableColumnarBatch(
                    batch, priority=mem.OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY)
        with self._lock:
            lst = self._blocks[shuffle_id].setdefault(reduce_id, [])
            lst.append((seq, len(lst), blob))

    @staticmethod
    def _ordered(entries):
        return sorted(entries, key=lambda e: (
            (0, e[0]) if e[0] is not None else (1,), e[1]))

    # -- read side (RapidsCachingReader / RapidsShuffleIterator) -------------
    def read_partition(self, shuffle_id: int, reduce_id: int):
        """Yield one reduce partition's blocks in ``seq`` order."""
        for _, batch in self.read_partition_with_keys(shuffle_id, reduce_id):
            yield batch

    def read_partition_with_keys(self, shuffle_id: int, reduce_id: int):
        """Yield (seq, batch) in the partition's pinned order."""
        with self._lock:
            entries = self._ordered(self._blocks[shuffle_id].get(reduce_id,
                                                                 ()))
            device = self._devices.get(shuffle_id, "cpu")
        for seq, _, blob in entries:
            if isinstance(blob, bytes):
                yield seq, ser.deserialize_batch(blob, device)
            else:
                yield seq, blob.get_batch()

    def partition_keys(self, shuffle_id: int, reduce_id: int) -> list:
        """The ordered seq tags of one partition's blocks."""
        with self._lock:
            entries = self._ordered(self._blocks[shuffle_id].get(reduce_id,
                                                                 ()))
        return [seq for seq, _, _ in entries]

    @staticmethod
    def _blob_size(b) -> int:
        return len(b) if isinstance(b, bytes) else b.size

    def partition_sizes(self, shuffle_id: int, num_partitions: int) -> list:
        """Bytes per reduce partition (a frame's length, a spillable
        block's registered size): the map-output statistics the AQE
        coalescing decision reads (Spark MapOutputStatistics)."""
        with self._lock:
            parts = self._blocks.get(shuffle_id, {})
            return [sum(self._blob_size(b) for _, _, b in parts.get(p, ()))
                    for p in range(num_partitions)]

    def split_partition_sizes(self, shuffle_id: int, num_partitions: int,
                              map_split: int) -> list:
        """Bytes per reduce partition written by one map split (seq tuples
        lead with the map split)."""
        with self._lock:
            parts = self._blocks.get(shuffle_id, {})
            return [sum(self._blob_size(b) for seq, _, b in parts.get(p, ())
                        if isinstance(seq, tuple) and seq
                        and seq[0] == map_split)
                    for p in range(num_partitions)]

    def drop_map_output(self, shuffle_id: int, map_split: int) -> int:
        """Discard every block one map split wrote; the count dropped."""
        dropped = []
        with self._lock:
            parts = self._blocks.get(shuffle_id)
            if parts is None:
                return 0
            for rid, entries in parts.items():
                keep = []
                for e in entries:
                    seq = e[0]
                    if isinstance(seq, tuple) and seq and seq[0] == map_split:
                        dropped.append(e)
                    else:
                        keep.append(e)
                parts[rid] = keep
        for _, _, b in dropped:
            if not isinstance(b, bytes):
                b.close()
        return len(dropped)

    def unregister_shuffle(self, shuffle_id: int):
        with self._lock:
            parts = self._blocks.pop(shuffle_id, {})
            self._serialized_mode.pop(shuffle_id, None)
            self._devices.pop(shuffle_id, None)
        for entries in parts.values():
            for _, _, b in entries:
                if not isinstance(b, bytes):
                    b.close()

    def clear_all(self):
        for sid in list(self._blocks):
            self.unregister_shuffle(sid)

    def num_shuffles(self) -> int:
        with self._lock:
            return len(self._blocks)
