"""BroadcastExchangeExec — counterpart of ``spark_rapids_tpu/exec/broadcast.py``
(``:52-184``; reference GpuBroadcastExchangeExecBase).

The child is materialized once, every partition of it concatenated into one
device batch (``ops/concat.concat_all``), and every stream partition of a
broadcast join reads that batch; the last reader releases it. The
reference's spill catalog registration, OOM retry, build thread and
``spark.sql.broadcastTimeout`` are not ported: the build runs on the first
reader's thread and the batch stays on the device until released. Nothing
reads the relation as a stream of batches (the reference's host bridge), so
``execute_partition`` is not ported.
"""

from __future__ import annotations

import threading
import time

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.ops.concat import concat_all


class BroadcastExchangeExec(TorchExec):
    """Materialize the child once as a shared device batch."""

    def __init__(self, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        self._lock = threading.Lock()
        self._batch: ColumnarBatch | None = None
        #: host seconds of the last materialization, child included
        self.build_seconds = 0.0

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self) -> int:
        return 1

    def broadcast(self) -> ColumnarBatch:
        """The shared batch; the first caller builds it, later callers wait
        for it and share it."""
        with self._lock:
            if self._batch is None:
                t0 = time.perf_counter()
                batches = [b for split in range(self.child.num_partitions)
                           for b in self.child.execute_partition(split)]
                self._batch = concat_all(batches, self.child.output,
                                         self.device)
                self.build_seconds = time.perf_counter() - t0
            return self._batch

    def release(self) -> None:
        """Drop the shared batch (the last reader calls it); a later
        execution builds it again."""
        with self._lock:
            self._batch = None

    def args_string(self):
        return f"over {self.child.num_partitions} partitions"
