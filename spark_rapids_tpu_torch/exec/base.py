"""Physical operator base — counterpart of ``spark_rapids_tpu/exec/base.py``.

An exec produces, per partition, an iterator of device ColumnarBatches on an
explicit ``device``. Metrics, the device semaphore and the pipelined executor
are not ported yet; partitions run one after another on the calling thread.
"""

from __future__ import annotations

import typing

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import RapidsConf


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
        tables = [b.to_arrow() for split in range(self.num_partitions)
                  for b in self.execute_partition(split)]
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
