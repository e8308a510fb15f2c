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
    df.write_orc("/data/lineitem_orc", mode="overwrite")
    back = spark.read_orc("/data/lineitem_orc")

``read_orc``/``read_csv`` scan ORC and CSV files as ``read_parquet`` scans
parquet (``io/filescan.py``); ``write_parquet``/``write_orc``/``write_csv``
run the frame's plan and write its batches through the commit protocol of
``io/writer.py``. ``spark.range(n, num_slices=8)`` makes a LONG ``id``
column on the device; ``with_column``, ``drop``, ``with_column_renamed``,
``sort_within_partitions``, ``count()``, ``to_pandas()`` and ``explain()``
are the reference's, with Spark's column order for ``with_column``.

Nested columns (arrays, maps and structs, nested to any depth) are device
columns: ``F.collect_list``/``F.collect_set``, ``F.split``, ``F.array``,
``F.struct`` and ``F.create_map`` build them, files and arrow tables bring
them, ``df.explode(col, outer, pos)`` flattens an array (of structs or of
arrays too), and ``group_by(k).pivot(p, values).agg(...)`` pivots.
``F.rand(seed)`` draws the reference's stream (``ops/random.py``).
``collect_row_buffer()`` and ``spark.create_dataframe_from_rows(...)``
move a frame through the packed row format (``columnar/rows.py``).
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
    def __init__(self, plan: NN.PlanNode, session: "TorchSession",
                 subquery_plans=()):
        self._plan = plan
        self.session = session
        #: the physical plans of the subqueries ``sql()`` ran while it
        #: lowered this frame's text (Spark runs subquery stages first)
        self.subquery_plans = list(subquery_plans)

    def select(self, *cols) -> "DataFrame":
        return DataFrame(NN.ProjectNode([_to_expr(c) for c in cols],
                                        self._plan), self.session)

    def with_column(self, name: str, expr) -> "DataFrame":
        """The frame with column ``name`` set to ``expr``: a column of that
        name is replaced where it stands, else the new one comes last
        (Spark's ``Dataset.withColumns``; the reference moves a replaced
        column to the end)."""
        out = self._plan.output
        proj = [E.Alias(_to_expr(expr), name) if f.name == name
                else E.col(f.name) for f in out]
        if name not in out.names:
            proj.append(E.Alias(_to_expr(expr), name))
        return DataFrame(NN.ProjectNode(proj, self._plan), self.session)

    def drop(self, *names) -> "DataFrame":
        """The frame without the columns named (unknown names are
        ignored, as in Spark)."""
        drop_set = set(names)
        keep = [E.col(f.name) for f in self._plan.output
                if f.name not in drop_set]
        return DataFrame(NN.ProjectNode(keep, self._plan), self.session)

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        proj = [E.Alias(E.col(f.name), new) if f.name == old
                else E.col(f.name) for f in self._plan.output]
        return DataFrame(NN.ProjectNode(proj, self._plan), self.session)

    def filter(self, condition) -> "DataFrame":
        return DataFrame(NN.FilterNode(_to_expr(condition), self._plan),
                         self.session)

    where = filter

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData([_to_expr(k) for k in keys], self)

    def rollup(self, *keys) -> "RollupData":
        """``df.rollup(a, b).agg(...)``: the subtotals of every prefix of
        the keys, through an Expand with a grouping id, as the SQL
        lowering's GROUP BY ROLLUP."""
        return RollupData([_to_expr(k) for k in keys], self)

    def agg(self, *aggs) -> "DataFrame":
        """Aggregate the whole frame with no grouping keys: one row."""
        return GroupedData([], self).agg(*aggs)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position (Spark's ``union``); the column types must
        be equal."""
        return DataFrame(NN.UnionNode(self._plan, other._plan), self.session)

    def distinct(self) -> "DataFrame":
        """The distinct rows: a group-by on every column."""
        keys = [E.BoundReference(i, f.data_type, f.nullable, f.name)
                for i, f in enumerate(self._plan.output)]
        return DataFrame(NN.AggregateNode(keys, [], self._plan), self.session)

    drop_duplicates = distinct

    @staticmethod
    def _sort_exprs(cols, ascending) -> list:
        ascs = (ascending if isinstance(ascending, (list, tuple))
                else [ascending] * len(cols))
        # Spark default: nulls first when ascending, last when descending
        return [(_to_expr(c), bool(a), bool(a)) for c, a in zip(cols, ascs)]

    def sort(self, *cols, ascending=True) -> "DataFrame":
        return DataFrame(NN.SortNode(self._sort_exprs(cols, ascending),
                                     self._plan), self.session)

    order_by = sort

    def sort_within_partitions(self, *cols, ascending=True) -> "DataFrame":
        """Each partition sorted on its own, the partitions kept (Spark's
        ``sortWithinPartitions``; no exchange)."""
        return DataFrame(NN.SortNode(self._sort_exprs(cols, ascending),
                                     self._plan, global_sort=False),
                         self.session)

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
        """Append one column per ``Alias(WindowExpression)`` to every row
        (``functions.over`` builds them); expressions over several
        partition/order specs plan one window exec a spec, chained."""
        return DataFrame(NN.WindowNode(window_exprs, self._plan), self.session)

    def explode(self, column: str, outer: bool = False,
                pos: bool = False) -> "DataFrame":
        """One row per element of the array column ``column`` (Spark's
        explode, posexplode with ``pos``, ``_outer`` with ``outer``): the
        other columns, then ``pos`` and ``col``."""
        from spark_rapids_tpu_torch import types as T
        f = self._plan.output[column]
        if not isinstance(f.data_type, T.ArrayType):
            raise TypeError(
                f"explode: column '{column}' is {f.data_type!r}, not an "
                "array")
        return DataFrame(NN.GenerateNode(
            column, self._plan, outer=outer,
            element_type=f.data_type.element_type, pos=pos), self.session)

    @property
    def schema(self):
        return self._plan.output

    @property
    def columns(self) -> list:
        return [f.name for f in self._plan.output]

    def explain(self, metrics: bool = False, stats: bool = False,
                fused: bool = False) -> str:
        """The physical exec tree ``collect()`` would run, one line an exec
        indented by its depth, with its arguments (the exchanges and
        gathers the planner inserts among them). A plan the port cannot
        run raises the ``NotImplementedError`` ``collect()`` would."""
        for flag, module in ((metrics, "runtime/metrics.py"),
                             (stats, "runtime/stats.py"),
                             (fused, "plan/stages.py")):
            if flag:
                raise NotImplementedError(
                    f"explain with metrics, stats or fused needs "
                    f"{module}, which is not ported yet")
        return self.physical_plan().tree_string()

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

    def collect_row_buffer(self):
        """The collected rows in the packed row format (the reference's
        GpuColumnarToRowExec + CudfUnsafeRow): ``(rows int64[n, words],
        schema)`` for a fixed-width schema, ``((words, row_offsets),
        schema)`` (the UnsafeRow-style variable layout) for one with
        strings; nested columns raise."""
        from spark_rapids_tpu_torch.columnar import rows as R
        schema = self._plan.output
        if R.is_fixed_width(schema):
            return R.pack_arrow(self.collect(), schema), schema
        if R.is_packable(schema):
            return R.pack_arrow_var(self.collect(), schema), schema
        raise NotImplementedError(
            f"the row format of {schema} is not ported: use collect()")

    def count(self) -> int:
        """The number of rows: a keyless ``count(*)`` (0 over no rows)."""
        from spark_rapids_tpu_torch.expr.aggregates import Count
        agg = NN.AggregateNode([], [E.Alias(Count(None), "count")],
                               self._plan)
        return DataFrame(agg, self.session).collect().column(
            "count")[0].as_py()

    def to_pandas(self):
        """``collect()`` as a pandas DataFrame (pandas is imported here)."""
        return self.collect().to_pandas()

    def write_parquet(self, path: str, partition_by=None, mode="error"):
        """Write the frame as parquet files under ``path`` (SNAPPY; the
        native writer, or the arrow writer for a partitioned write).
        ``mode`` is error, overwrite, append or ignore. Returns the
        ``WriteStats``."""
        return self._write(path, "parquet", partition_by, mode)

    def write_orc(self, path: str, partition_by=None, mode="error"):
        """Write the frame as ORC files under ``path`` (SNAPPY), as
        ``write_parquet``."""
        return self._write(path, "orc", partition_by, mode)

    def write_csv(self, path: str, mode="error"):
        """Write the frame as CSV files with a header under ``path``."""
        return self._write(path, "csv", None, mode)

    def _write(self, path, fmt, partition_by, mode):
        from spark_rapids_tpu_torch.io.writer import FileWriteNode
        return FileWriteNode(self._plan, path, fmt, partition_by, mode).run(
            self.session.conf, self.session.device)


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

    def count(self) -> DataFrame:
        """The rows of each group, as a LONG column ``count``."""
        from spark_rapids_tpu_torch.expr.aggregates import Count
        return self.agg(E.Alias(Count(None), "count"))

    def pivot(self, pivot_col, values: list) -> "PivotedGroupedData":
        """``group_by(k).pivot(p, values).agg(f(v))``, Spark's pivot,
        lowered by If-guards: one guarded aggregate a pivot value and
        aggregate, so every aggregate keeps its own device route."""
        return PivotedGroupedData(self.keys, self.df, _to_expr(pivot_col),
                                  list(values))


class PivotedGroupedData:
    """The reference's pivot: ``agg(f(x))`` becomes, for each pivot value
    ``pv``, ``f(if(pv = p, x, null))`` (``count(*)`` counts the value's
    rows; first/last ignore the guard's nulls), named ``pv`` for a single
    unnamed aggregate and ``{pv}_{name}`` otherwise (the name an alias
    gives, else the function's class name in lower case)."""

    def __init__(self, keys: list, df: DataFrame, pivot_expr, values: list):
        self.keys = keys
        self.df = df
        self.pivot_expr = pivot_expr
        self.values = values

    def agg(self, *aggs) -> DataFrame:
        from spark_rapids_tpu_torch import types as T
        from spark_rapids_tpu_torch.expr.aggregates import Count, First, Last
        from spark_rapids_tpu_torch.expr.conditional import If
        named = []
        for a in aggs:
            e = _to_expr(a)
            inner = NN.agg_fn(e)
            base_name = e.name if isinstance(e, E.Alias) else None
            for pv in self.values:
                child = inner.children[0] if inner.children else None
                if child is None:
                    guarded = Count(If(E.Literal(pv) == self.pivot_expr,
                                       E.Literal(1), E.Literal(None, T.INT)))
                else:
                    guard = If(E.Literal(pv) == self.pivot_expr, child,
                               E.Literal(None, child.dtype))
                    if isinstance(inner, (First, Last)):
                        # a guarded-out row is null; it must not win
                        guarded = type(inner)(guard, ignore_nulls=True)
                    else:
                        guarded = inner.with_children([guard])
                col_name = (f"{pv}" if len(aggs) == 1 and base_name is None
                            else f"{pv}_{base_name or type(inner).__name__.lower()}")
                named.append(E.Alias(guarded, col_name))
        return DataFrame(NN.AggregateNode(self.keys, named, self.df._plan),
                         self.df.session)


class RollupData:
    """GROUP BY ROLLUP over plain columns: an Expand with a grouping id
    (``plan/nodes.build_rollup_expand``, which the SQL lowering shares),
    then the aggregate; the grouping id is dropped from the output."""

    def __init__(self, keys: list, df: DataFrame):
        for k in keys:
            if not isinstance(k, (E.AttributeReference, E.BoundReference)):
                raise ValueError("rollup supports plain columns only")
        self.keys = [E.bind_references(k, df._plan.output) for k in keys]
        self.df = df

    def agg(self, *aggs) -> DataFrame:
        named = [_to_expr(a) for a in aggs]
        for e in named:
            NN.agg_fn(e)   # raises on a non-aggregate
        expand, group_refs, gid_ref = NN.build_rollup_expand(
            self.df._plan, self.keys)
        agg_node = NN.AggregateNode(
            [E.Alias(r, r.name) for r in group_refs]
            + [E.Alias(gid_ref, "_gid")], named, expand)
        # drop the grouping id by position (an aggregate's alias may equal
        # a key's name)
        gid_pos = len(group_refs)
        keep = [E.Alias(E.BoundReference(i, f.data_type, f.nullable, f.name),
                        f.name)
                for i, f in enumerate(agg_node.output) if i != gid_pos]
        return DataFrame(NN.ProjectNode(keep, agg_node), self.df.session)


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
        # the memory runtime of the session's device: its budget, spill
        # tiers and device semaphore (the reference's executor init,
        # GpuDeviceManager.initializeGpuAndMemory)
        from spark_rapids_tpu_torch import config as CFG
        from spark_rapids_tpu_torch.runtime.memory import DeviceManager
        from spark_rapids_tpu_torch.runtime.semaphore import DeviceSemaphore
        DeviceManager.initialize(self.conf, device)
        DeviceSemaphore.initialize(self.conf.get(CFG.CONCURRENT_TPU_TASKS))
        # fault injection is process-wide: only an explicit setting arms,
        # re-seeds or (set empty) disarms it
        if CFG.TEST_FAULTS.key in self.conf.settings:
            from spark_rapids_tpu_torch.runtime import faults
            faults.configure(self.conf.get(CFG.TEST_FAULTS),
                             self.conf.get(CFG.TEST_FAULTS_SEED))

    def create_or_replace_temp_view(self, name: str, df: DataFrame) -> None:
        """Register ``df`` under ``name`` for ``sql()`` (SparkSession's
        createOrReplaceTempView)."""
        self._views[name] = df

    def sql(self, text: str) -> DataFrame:
        """A DataFrame for SQL text over the registered temp views
        (``sql/``). What the port cannot plan raises
        ``NotImplementedError`` here, while the text is lowered; the
        uncorrelated subqueries that are not joins run here too, on the
        session's device."""
        from spark_rapids_tpu_torch.sql import lower_sql
        plan, subquery_plans = lower_sql(text, self._views, self)
        return DataFrame(plan, self, subquery_plans)

    def range(self, start: int, end: int | None = None, step: int = 1,
              num_slices: int = 1) -> DataFrame:
        """A LONG column ``id`` from ``start`` to ``end`` (exclusive) by
        ``step`` in ``num_slices`` partitions, made on the session's device
        (``range(n)`` is 0 .. n-1)."""
        if end is None:
            start, end = 0, start
        return DataFrame(NN.RangeNode(start, end, step, num_slices), self)

    def create_dataframe_from_rows(self, rows, schema,
                                   num_partitions: int = 1,
                                   offsets=None) -> DataFrame:
        """A DataFrame over a packed row buffer (the reference's
        GpuRowToColumnarExec fast path): a fixed-width ``rows`` matrix cut
        into ``num_partitions`` partitions, or the variable layout with
        ``offsets`` (or a ``(words, offsets)`` tuple in ``rows``), one
        partition as in the reference."""
        import numpy as np
        from spark_rapids_tpu_torch.columnar import rows as R
        if offsets is None and isinstance(rows, tuple) and len(rows) == 2:
            rows, offsets = rows
        if offsets is not None:
            tbl = R.unpack_rows_arrow_var(np.asarray(rows),
                                          np.asarray(offsets), schema)
            return self.create_dataframe(tbl, num_partitions)
        rows = np.asarray(rows)
        n = rows.shape[0]
        per = -(-n // max(1, num_partitions)) if n else 1
        parts = []
        for i in range(max(1, num_partitions)):
            chunk = rows[i * per:(i + 1) * per]
            if chunk.shape[0] == 0 and i > 0:
                break
            parts.append(R.unpack_rows_arrow(chunk, schema))
        return DataFrame(NN.ScanNode(parts, schema), self)

    def create_dataframe(self, data, num_partitions: int = 1) -> DataFrame:
        """A DataFrame over an in-memory arrow table (or a dict of columns),
        cut into ``num_partitions`` partitions of equal row counts."""
        if not isinstance(data, pa.Table):
            data = pa.table(data)
        per = -(-data.num_rows // max(1, num_partitions))
        parts = ([data.slice(i * per, per) for i in range(num_partitions)]
                 if num_partitions > 1 else [data])
        return DataFrame(NN.ScanNode(parts), self)

    def read_parquet(self, path, pushed_filter=None,
                     files_per_partition: int = 1) -> DataFrame:
        """A parquet scan of a directory or files; ``pushed_filter``, a
        predicate over the files' columns by name, filters the rows as they
        are read (``io/filescan.py``). The Alluxio path rewrite applies to
        ``path``."""
        from spark_rapids_tpu_torch.io.filescan import (FileScanNode,
                                                         rewrite_scan_path)
        return DataFrame(FileScanNode(rewrite_scan_path(path, self.conf),
                                      "parquet", pushed_filter=pushed_filter,
                                      files_per_partition=files_per_partition),
                         self)

    def read_orc(self, path, pushed_filter=None,
                 files_per_partition: int = 1) -> DataFrame:
        from spark_rapids_tpu_torch.io.filescan import (FileScanNode,
                                                         rewrite_scan_path)
        return DataFrame(FileScanNode(rewrite_scan_path(path, self.conf),
                                      "orc", pushed_filter=pushed_filter,
                                      files_per_partition=files_per_partition),
                         self)

    def read_csv(self, path, schema=None, header: bool = True,
                 delimiter: str = ",") -> DataFrame:
        """A CSV scan. With ``schema`` (a ``StructType``) its fields are the
        columns read, matched to the header by name (or naming the file's
        columns in order when there is no header); without one, arrow infers
        the types from the first file."""
        from spark_rapids_tpu_torch.io.filescan import (FileScanNode,
                                                         rewrite_scan_path)
        return DataFrame(FileScanNode(
            rewrite_scan_path(path, self.conf), "csv", schema=schema,
            options={"header": header, "delimiter": delimiter,
                     "schema": schema}), self)
