"""BroadcastExchangeExec — counterpart of ``spark_rapids_tpu/exec/broadcast.py``
(``:52-184``; reference GpuBroadcastExchangeExecBase).

The child is materialized once, every partition of it concatenated into one
device batch (``ops/concat.concat_all``), and every stream partition of a
broadcast join reads that batch; the last reader releases it. The
reference's spill catalog registration, OOM retry, build thread and
``spark.sql.broadcastTimeout`` are not ported: the build runs on the first
reader's thread. The built batch is held in the spill catalog as a
``SpillableColumnarBatch`` at ``ACTIVE_BATCHING_PRIORITY`` (registered under
spill-only OOM retry, scope "joins.build", the scope the whole build runs
in), so it can spill to the host and come back while the stream side runs;
a reader waiting for the build holds no device permit. Under
``spark.rapids.tpu.pipeline.enabled`` each child partition produces on a
pipelined stage ("join.build", the reference's build-segment boundary,
``exec/joins.py:788``). Nothing reads the relation as a stream of batches
(the reference's host bridge), so ``execute_partition`` is not ported.
"""

from __future__ import annotations

import threading
import time

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.ops.concat import concat_all
from spark_rapids_tpu_torch.runtime import faults as F
from spark_rapids_tpu_torch.runtime import memory as mem
from spark_rapids_tpu_torch.runtime import pipeline as P
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.semaphore import (DeviceSemaphore,
                                                      TaskContext)


class BroadcastExchangeExec(TorchExec):
    """Materialize the child once as a shared device batch."""

    def __init__(self, child: TorchExec, conf=None):
        super().__init__(child, conf=conf)
        self._lock = threading.Lock()
        self._batch: mem.SpillableColumnarBatch | None = None
        #: host seconds of the last materialization, child included
        self.build_seconds = 0.0

    @property
    def output(self):
        return self.child.output

    @property
    def num_partitions(self) -> int:
        return 1

    def _materialize(self) -> mem.SpillableColumnarBatch:
        with F.scope("joins.build"):
            batches = []
            for split in range(self.child.num_partitions):
                with TaskContext():
                    it = self.child.execute_partition(split)
                    batches.extend(P.maybe_stage(it, "join.build",
                                                 self.conf))
            batch = concat_all(batches, self.child.output, self.device)
            # one batch cannot split: spill-only retry
            with mem.alloc_site("joins.build"):
                return R.call_with_retry(
                    lambda: mem.SpillableColumnarBatch(
                        batch, mem.ACTIVE_BATCHING_PRIORITY),
                    scope="joins.build")

    def broadcast(self) -> ColumnarBatch:
        """The shared batch; the first caller builds it, later callers wait
        for it and share it."""
        # never wait for a build holding a permit the build may need
        DeviceSemaphore.get().release_if_necessary()
        with self._lock:
            if self._batch is None:
                t0 = time.perf_counter()
                self._batch = self._materialize()
                self.build_seconds = time.perf_counter() - t0
            sb = self._batch
        return sb.get_batch()

    def release(self) -> None:
        """Drop the shared batch (the last reader calls it); a later
        execution builds it again."""
        with self._lock:
            sb, self._batch = self._batch, None
        if sb is not None:
            sb.close()

    def args_string(self):
        return f"over {self.child.num_partitions} partitions"
