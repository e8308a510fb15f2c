"""TorchSession + DataFrame — the user entry point.

Counterpart of ``spark_rapids_tpu/session.py`` (``TpuSession``). A DataFrame
builds a logical plan (plan/nodes.py), from the DataFrame API or from SQL
text over temp views (``sql()``); ``collect()`` narrows its scans to the
columns it uses (plan/pruning.py), turns it into device execs
(plan/overrides.py), runs them on the session's device and returns an Arrow
table. ``spark.rapids.tpu.*`` conf keys keep their names.

    from spark_rapids_tpu_torch.session import TorchSession
    import spark_rapids_tpu_torch.functions as F

    spark = TorchSession()                 # the CUDA card; raises without one
    df = spark.read_parquet("/data/lineitem")
    out = (df.filter(F.col("l_quantity") <= F.lit(10.0))
             .group_by("l_returnflag").agg(F.sum("l_tax").alias("t"))
             .collect())
    spark.create_or_replace_temp_view("lineitem", df)
    out = spark.sql("select l_returnflag, sum(l_tax) as t from lineitem "
                    "where l_quantity <= 10 group by l_returnflag").collect()
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

    def agg(self, *aggs) -> "DataFrame":
        """Aggregate the whole frame with no grouping keys: one row."""
        return GroupedData([], self).agg(*aggs)

    def sort(self, *cols, ascending=True) -> "DataFrame":
        ascs = (ascending if isinstance(ascending, (list, tuple))
                else [ascending] * len(cols))
        # Spark default: nulls first when ascending, last when descending
        sort_exprs = [(_to_expr(c), bool(a), bool(a))
                      for c, a in zip(cols, ascs)]
        return DataFrame(NN.SortNode(sort_exprs, self._plan), self.session)

    def limit(self, n: int) -> "DataFrame":
        """The first ``n`` rows of the whole result (a global limit)."""
        return DataFrame(NN.LimitNode(n, self._plan, global_limit=True),
                         self.session)

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Join on the columns named ``on`` (USING semantics, Spark's: one
        key column per name, the left one for inner and left joins, the
        right one for a right join, ``coalesce(left, right)`` for a full
        join; the right duplicate is dropped). Semi and anti joins keep the
        left columns only. ``how`` is inner, left[_outer], right[_outer],
        full[_outer]/outer, [left_]semi, [left_]anti or cross. The planner
        refuses the shapes the port has not ported."""
        jt = {"left_outer": "left", "right_outer": "right",
              "full_outer": "full", "outer": "full",
              "left_semi": "leftsemi", "semi": "leftsemi",
              "left_anti": "leftanti", "anti": "leftanti"}.get(how, how)
        if on is None:
            names, lk, rk = [], [], []
        else:
            names = [on] if isinstance(on, str) else list(on)
            lk = [E.col(n) for n in names]
            rk = [E.col(n) for n in names]
        jn = NN.JoinNode(self._plan, other._plan, lk, rk, jt, condition)
        if on is None or jt in ("leftsemi", "leftanti"):
            return DataFrame(jn, self.session)
        from spark_rapids_tpu_torch.expr.nullexprs import Coalesce
        lout, rout = self._plan.output, other._plan.output
        nl = len(lout.fields)
        proj = []
        for n in names:
            li, ri = lout.index_of(n), rout.index_of(n)
            lref = E.BoundReference(li, lout.fields[li].data_type)
            rref = E.BoundReference(nl + ri, rout.fields[ri].data_type)
            key = (rref if jt == "right"
                   else Coalesce(lref, rref) if jt == "full" else lref)
            proj.append(E.Alias(key, n))
        for i, f in enumerate(lout.fields):
            if f.name not in names:
                proj.append(E.Alias(E.BoundReference(i, f.data_type), f.name))
        for i, f in enumerate(rout.fields):
            if f.name not in names:
                proj.append(E.Alias(E.BoundReference(nl + i, f.data_type),
                                    f.name))
        return DataFrame(NN.ProjectNode(proj, jn), self.session)

    def repartition(self, n: int, *keys) -> "DataFrame":
        """``n`` partitions: hashed on ``keys`` (Spark's
        ``repartition(n, cols)``), or dealt round-robin without keys."""
        if keys:
            return DataFrame(NN.ExchangeNode(
                self._plan, "hash", n, keys=[_to_expr(k) for k in keys]),
                self.session)
        return DataFrame(NN.ExchangeNode(self._plan, "roundrobin", n),
                         self.session)

    def window(self, window_exprs: list) -> "DataFrame":
        """Append one column per ``Alias(WindowExpression)`` (all over one
        partition/order spec) to every row."""
        return DataFrame(NN.WindowNode(window_exprs, self._plan), self.session)

    def physical_plan(self):
        """The device exec tree ``collect()`` runs (raises on anything not
        ported): the plan with its scans narrowed to the columns it uses
        (``plan/pruning.py``, once at the root), then the override rules."""
        from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
        from spark_rapids_tpu_torch.plan.pruning import prune_columns
        return TorchOverrides(self.session.conf, self.session.device).apply(
            prune_columns(self._plan))

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
        self._views: dict = {}

    def create_or_replace_temp_view(self, name: str, df: DataFrame) -> None:
        """Register ``df`` under ``name`` for ``sql()`` (SparkSession's
        createOrReplaceTempView)."""
        self._views[name] = df

    def sql(self, text: str) -> DataFrame:
        """A DataFrame for SQL text over the registered temp views
        (``sql/``). What the port cannot plan raises
        ``NotImplementedError`` here, while the text is lowered."""
        from spark_rapids_tpu_torch.sql import lower_sql
        return DataFrame(lower_sql(text, self._views, self), self)

    def read_parquet(self, path, files_per_partition: int = 1) -> DataFrame:
        from spark_rapids_tpu_torch.io.filescan import FileScanNode
        return DataFrame(FileScanNode(path, "parquet",
                                      files_per_partition=files_per_partition),
                         self)
