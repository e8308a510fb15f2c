"""TorchSession + DataFrame — the user entry point.

Counterpart of ``spark_rapids_tpu/session.py`` (``TpuSession``). A DataFrame
builds a logical plan (plan/nodes.py); ``collect()`` turns it into device
execs (plan/overrides.py), runs them on the session's device and returns an
Arrow table. ``spark.rapids.tpu.*`` conf keys keep their names.

    from spark_rapids_tpu_torch.session import TorchSession
    import spark_rapids_tpu_torch.functions as F

    spark = TorchSession()                 # the CUDA card; raises without one
    df = spark.read_parquet("/data/lineitem")
    out = (df.filter(F.col("l_quantity") <= F.lit(10.0))
             .group_by("l_returnflag").agg(F.sum("l_tax").alias("t"))
             .collect())
"""

from __future__ import annotations

import pyarrow as pa
import torch

from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.plan import nodes as NN


def _to_expr(c) -> E.Expression:
    if isinstance(c, E.Expression):
        return c
    if isinstance(c, str):
        return E.col(c)
    return E.lit(c)


class DataFrame:
    def __init__(self, plan: NN.PlanNode, session: "TorchSession"):
        self._plan = plan
        self.session = session

    def select(self, *cols) -> "DataFrame":
        return DataFrame(NN.ProjectNode([_to_expr(c) for c in cols],
                                        self._plan), self.session)

    def filter(self, condition) -> "DataFrame":
        return DataFrame(NN.FilterNode(_to_expr(condition), self._plan),
                         self.session)

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData([_to_expr(k) for k in keys], self)

    def sort(self, *cols, ascending=True) -> "DataFrame":
        ascs = (ascending if isinstance(ascending, (list, tuple))
                else [ascending] * len(cols))
        # Spark default: nulls first when ascending, last when descending
        sort_exprs = [(_to_expr(c), bool(a), bool(a))
                      for c, a in zip(cols, ascs)]
        return DataFrame(NN.SortNode(sort_exprs, self._plan), self.session)

    def physical_plan(self):
        """The device exec tree ``collect()`` runs (raises on anything not
        ported)."""
        from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
        return TorchOverrides(self.session.conf,
                              self.session.device).apply(self._plan)

    def collect(self) -> pa.Table:
        return self.physical_plan().execute_collect()


class GroupedData:
    def __init__(self, keys: list, df: DataFrame):
        self.keys = keys
        self.df = df

    def agg(self, *aggs) -> DataFrame:
        named = [_to_expr(a) for a in aggs]
        for e in named:
            NN.agg_fn(e)   # raises on a non-aggregate
        return DataFrame(NN.AggregateNode(self.keys, named, self.df._plan),
                         self.df.session)


class TorchSession:
    """The SparkSession stand-in; owns the conf, the device and the read API.

    It runs on the CUDA card unless the caller passes ``device="cpu"`` (as
    the tests do). With no CUDA device it raises: it never falls back to the
    CPU on its own."""

    def __init__(self, conf: dict | RapidsConf | None = None,
                 device="cuda"):
        self.conf = (conf if isinstance(conf, RapidsConf)
                     else RapidsConf(conf or {}))
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def read_parquet(self, path, files_per_partition: int = 1) -> DataFrame:
        from spark_rapids_tpu_torch.io.filescan import FileScanNode
        return DataFrame(FileScanNode(path, "parquet",
                                      files_per_partition=files_per_partition),
                         self)
