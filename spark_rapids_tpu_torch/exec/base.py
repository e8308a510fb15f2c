"""Physical operator base — counterpart of ``spark_rapids_tpu/exec/base.py``.

An exec produces, per partition, an iterator of device ColumnarBatches on an
explicit ``device``. ``execute_collect`` runs the partitions one after
another on the calling thread, each as a task of the device semaphore
(``runtime/semaphore.TaskContext``); under
``spark.rapids.tpu.pipeline.enabled`` each partition's plan produces on a
pipelined stage ("collect") while this thread converts the previous batch
to arrow. The action's catalog registrations carry its query id, and a
buffer still registered when it ends is a leak: reported and reclaimed
(``BufferCatalog.finish_query``, ``spark.rapids.tpu.memory.leak.check``), and
raised under ``spark.rapids.tpu.memory.leak.strict``. Metrics are not ported
yet.
"""

from __future__ import annotations

import itertools
import typing

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import RapidsConf

_query_ids = itertools.count(1)


class TorchExec:
    def __init__(self, *children: "TorchExec", conf: RapidsConf | None = None,
                 device=None):
        self.children = list(children)
        self.conf = conf or RapidsConf()
        if device is None:
            if not children:
                raise ValueError(f"{type(self).__name__} needs a device")
            device = children[0].device
        self.device = torch.device(device)

    @property
    def child(self) -> "TorchExec":
        return self.children[0]

    @property
    def output(self) -> T.StructType:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def execute_partition(self, split: int) -> typing.Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute_collect(self) -> pa.Table:
        """Run every partition and collect to one arrow table (Spark collect())."""
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.runtime import memory as mem
        from spark_rapids_tpu_torch.runtime import pipeline as P
        from spark_rapids_tpu_torch.runtime.semaphore import TaskContext
        query = f"q{next(_query_ids)}"
        tables = []
        with mem.query_context(query):
            for split in range(self.num_partitions):
                with TaskContext():
                    it = self.execute_partition(split)
                    it = P.maybe_stage(it, "collect", self.conf)
                    tables.extend(b.to_arrow() for b in it)
        if self.conf.get(C.MEMORY_LEAK_CHECK):
            leak = mem.DeviceManager.get().catalog.finish_query(query)
            if leak is not None and self.conf.get(C.MEMORY_LEAK_STRICT):
                raise mem.MemoryLeakError(
                    f"query {query} leaked {leak['bytes']}B in "
                    f"{leak['buffers']} buffer(s): {leak['sites']}")
        if not tables:
            return self.output.to_arrow().empty_table()
        return pa.concat_tables(tables)

    def args_string(self) -> str:
        return ""

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + f"{type(self).__name__} "
                 f"{self.args_string()}".rstrip()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return self.tree_string()
