"""File scan: plan node + device exec with partition-values handling.

Counterpart of ``spark_rapids_tpu/io/filescan.py``. A directory is discovered
into one partition per directory (``discover_partitions``, hive directories
``a=1/b=x/`` included; ``files_per_partition`` applies only to an explicit
file list). A partition goes one of these ways:

- parquet, the device decode (``io/parquet_native.read_row_group_device``),
  one batch per row group: the native scanner reads each dictionary column
  chunk and one ``chunk_decode`` launch decodes it on the card; a chunk out
  of the decode's scope goes through arrow for that column;
- ORC, the device decode (``io/orc_native.read_stripe_device``), one batch
  per stripe: RLEv2 run headers on the host, the packed bits unpacked on
  the device; a column out of its scope goes through arrow for that stripe;
- CSV, the device parse (``io/csv_native``), one batch per file: the field
  boundaries found on the host, the digits parsed on the device;
- the arrow reader (``io/readers.py``, the PERFILE / MULTITHREADED /
  COALESCING strategies of ``spark.rapids.tpu.sql.format.parquet.reader.type``)
  wherever the reference takes it: the device decode turned off, a partition
  with hive partition values (appended as constant columns), row groups or
  stripes above the reader caps, parquet dates that footer statistics do not
  prove post-cutover (the reader applies the configured DATE rebase), an ORC
  file with a codec the ORC decode does not read, or a CSV file outside the
  device parse's scope.

The parquet device decode is taken on every device, the CPU included. The
ORC and CSV device routes are taken on a CUDA device when their conf is on,
and on the CPU only when their conf key is set explicitly (the reference's
``decode_engaged``), so the CPU tests can run them. ``orc_native.routes``
and ``csv_native.routes`` count the way each ORC column and CSV file took.

The exec reads the columns of the node's schema only: column pruning
(``plan/pruning.py``) narrows a copy of the node to the columns its plan
uses, keeping every partition column, so an unread column is never parsed,
uploaded or decoded. Every batch carries its file's provenance
(``ColumnarBatch.metadata``: the path, 0 and the file's size, as the
reference's ``_scan_meta``) for the input-file expressions; on the arrow
route only where the partition has one file, as in the reference.

A pushed filter (``read_parquet(path, pushed_filter=...)``, ``read_orc``
likewise; reference ``:195-248``) sends every partition to the arrow reader,
as in the reference. Its top-level conjuncts that ``readers.
spark_filter_to_arrow`` translates exactly, over data columns, are applied
by arrow as it reads; the rest (a float comparison among them: Spark orders
NaN above every value and holds NaN = NaN, arrow does not) is the residual,
which the reference evaluates on its host path (``plan/host_eval``, not
ported) and the port on the device, over each staged batch, with one
``compact_cols`` (one host sync a batch). ``rewrite_scan_path`` is the
Alluxio path rewrite the session applies to every scan path.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import threading

import pyarrow as pa

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.misc import scan_meta
from spark_rapids_tpu_torch.io import readers as R
from spark_rapids_tpu_torch.plan.nodes import PlanNode


def _arrow_only(dt) -> bool:
    """A column type only the arrow reader reads: a timestamp or a nested
    type."""
    return isinstance(dt, T.TimestampType) or T.is_nested(dt)


@dataclasses.dataclass(frozen=True)
class FilePartition:
    """Files + constant partition-column values (from dir names a/b=1/...)."""
    paths: tuple
    partition_values: tuple = ()   # ((name, value), ...)


def discover_partitions(root: str, fmt: str) -> list[FilePartition]:
    """Walk a (possibly hive-partitioned) directory into per-directory
    partitions, skipping '_' and '.' entries like Spark's file index."""
    exts = {"parquet": (".parquet", ".pq"), "orc": (".orc",),
            "csv": (".csv",)}
    out = []
    for dirpath, dirnames, files in os.walk(root):
        # NB: os.walk must not be wrapped in sorted() — that would drain the
        # generator before this in-place prune is seen
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(("_", ".")))
        paths = tuple(sorted(
            os.path.join(dirpath, f) for f in files
            if f.endswith(exts[fmt]) and not f.startswith(("_", "."))))
        if not paths:
            continue
        rel = os.path.relpath(dirpath, root)
        pvals = []
        if rel != ".":
            for seg in rel.split(os.sep):
                if "=" in seg:
                    k, v = seg.split("=", 1)
                    pvals.append((k, v))
        out.append(FilePartition(paths, tuple(pvals)))
    out.sort(key=lambda p: p.paths)
    return out


# proleptic-Gregorian and hybrid-Julian calendars agree on every date from the
# 1582-10-15 Gregorian cutover onward, so no datetime rebase applies there
_GREGORIAN_CUTOVER = datetime.date(1582, 10, 15)


def _dates_post_cutover(md, date_cols: list) -> bool:
    """True when every row group's footer statistics PROVE all values of the
    named date columns are on/after the Gregorian cutover — the condition
    under which the device decode (which never rebases) is exact. Missing
    stats fail closed."""
    leaf = {}
    for i in range(md.num_columns):
        p = md.schema.column(i).path
        if "." not in p:
            leaf[p] = i
    for name in date_cols:
        i = leaf.get(name)
        if i is None:
            return False
        for g in range(md.num_row_groups):
            st = md.row_group(g).column(i).statistics
            if st is None or not st.has_min_max:
                return False
            mn = st.min
            if not isinstance(mn, datetime.date) or \
                    isinstance(mn, datetime.datetime) or \
                    mn < _GREGORIAN_CUTOVER:
                return False
    return True


def rewrite_scan_path(path, conf):
    """The Alluxio path rewrite (reference ``rewrite_scan_path``,
    spark.rapids.alluxio.pathsToReplace): each ``from->to`` rule of the
    conf, separated by ``;``, rewrites a path that starts with ``from``; the
    first rule that matches applies. A rule without ``->`` raises
    ``ValueError``."""
    spec = conf.get(CFG.ALLUXIO_PATHS_REPLACE) if conf is not None else None
    if not spec or not isinstance(path, (str, list, tuple)):
        return path
    rules = []
    for rule in spec.split(";"):
        rule = rule.strip()
        if not rule:
            continue
        if "->" not in rule:
            raise ValueError(
                f"bad {CFG.ALLUXIO_PATHS_REPLACE.key} rule {rule!r}: "
                "expected 'from->to'")
        frm, to = rule.split("->", 1)
        rules.append((frm.strip(), to.strip()))

    def one(p):
        for frm, to in rules:
            if p.startswith(frm):
                return to + p[len(frm):]
        return p
    return one(path) if isinstance(path, str) else [one(p) for p in path]


def _conjuncts(e) -> list:
    from spark_rapids_tpu_torch.expr.predicates import And
    if isinstance(e, And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _infer_partition_type(values: list) -> T.DataType:
    try:
        for v in values:
            int(v)
        small = all(-2**31 <= int(v) < 2**31 for v in values)
        return T.INT if small else T.LONG
    except ValueError:
        return T.STRING


class FileScanNode(PlanNode):
    """Plan node for a file scan; the override rules turn it into
    FileSourceScanExec. The schema is the files' columns (or the one given,
    as a CSV scan's), then one column per hive partition key (INT, LONG or
    STRING, not nullable). ``options`` are the reader's: a CSV scan's
    header, delimiter and schema."""

    def __init__(self, paths_or_dir, fmt: str = "parquet",
                 schema: T.StructType | None = None,
                 pushed_filter=None, files_per_partition: int = 1,
                 options: dict | None = None):
        super().__init__()
        self.pushed_filter = pushed_filter
        self.fmt = fmt
        self.options = dict(options or {})
        self.reader = R.reader_for(fmt, **self.options)
        if isinstance(paths_or_dir, str) and os.path.isdir(paths_or_dir):
            parts = discover_partitions(paths_or_dir, fmt)
        else:
            paths = ([paths_or_dir] if isinstance(paths_or_dir, str)
                     else list(paths_or_dir))
            parts = [FilePartition(tuple(paths[i:i + files_per_partition]))
                     for i in range(0, len(paths), files_per_partition)]
        if not parts:
            raise ValueError(f"no {fmt} files under {paths_or_dir}")
        keys0 = tuple(k for k, _ in parts[0].partition_values)
        for p in parts[1:]:
            if tuple(k for k, _ in p.partition_values) != keys0:
                raise ValueError(
                    "inconsistent partition directory layout: "
                    f"{keys0} vs {tuple(k for k, _ in p.partition_values)} "
                    f"under {p.paths[0]}")
        self.partitions = parts
        if schema is None:
            file_schema = T.StructType.from_arrow(
                self.reader.schema_of(parts[0].paths[0]))
            pfields = []
            for i, (k, _) in enumerate(parts[0].partition_values):
                vals = [p.partition_values[i][1] for p in parts]
                pfields.append(T.StructField(
                    k, _infer_partition_type(vals), False))
            schema = T.StructType(list(file_schema.fields) + pfields)
        self._schema = schema
        self._n_partition_cols = len(keys0)

    @property
    def output(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self.partitions)

    def _data_columns(self) -> list:
        n = len(self._schema.fields) - self._n_partition_cols
        return [f.name for f in self._schema.fields[:n]]

    def split_filter(self, rebase_mode: str | None = None):
        """``(arrow expression or None, residual or None)`` of the pushed
        filter: the AND of its top-level conjuncts that translate exactly
        and read data columns only, and the AND of the rest, bound to this
        node's schema. Under ``datetimeRebaseModeInRead=LEGACY`` a parquet
        conjunct that reads a DATE column stays in the residual: arrow would
        compare the file's hybrid-calendar days, and the residual runs after
        the rebase (Spark rebases the pushed literal instead; the reference
        pushes it and drops matching rows)."""
        if self.pushed_filter is None:
            return None, None
        from spark_rapids_tpu_torch.expr.core import (BoundReference,
                                                      bind_references)
        from spark_rapids_tpu_torch.expr.predicates import And
        data = set(self._data_columns())
        legacy = (self.fmt == "parquet"
                  and (rebase_mode or "").upper() == "LEGACY")
        arrow, rest = None, None
        for c in _conjuncts(bind_references(self.pushed_filter,
                                            self._schema)):
            refs = c.collect(lambda x: isinstance(x, BoundReference))
            names = {r.name for r in refs}
            pushable = names <= data and not (legacy and any(
                isinstance(r.dtype, T.DateType) for r in refs))
            a = R.spark_filter_to_arrow(c) if pushable else None
            if a is None:
                rest = c if rest is None else And(rest, c)
            else:
                arrow = a if arrow is None else arrow & a
        return arrow, rest

    def _append_partition_values(self, tbl: pa.Table, part: FilePartition):
        """Constant partition columns for every row (reference
        ColumnarPartitionReaderWithPartitionValues)."""
        if not part.partition_values:
            return tbl
        n = len(self._schema.fields) - self._n_partition_cols
        for (k, v), f in zip(part.partition_values, self._schema.fields[n:]):
            at = T.to_arrow_type(f.data_type)
            val = int(v) if isinstance(f.data_type, T.IntegralType) else v
            tbl = tbl.append_column(pa.field(k, at), pa.repeat(
                pa.scalar(val, at), tbl.num_rows))
        return tbl

    def tables_for(self, split: int, batch_rows: int,
                   strategy: str = "PERFILE", num_threads: int = 4,
                   target_rows: int = 1 << 20,
                   rebase_mode: str | None = None, filt=None):
        """The arrow tables of partition ``split`` by the named strategy,
        each with its partition columns appended; ``filt``, an arrow
        expression over data columns, filters the rows as they are read."""
        reader = self.reader
        if rebase_mode is not None and self.fmt == "parquet" and \
                reader.rebase_mode != rebase_mode.upper():
            # a fresh reader per divergent call: never mutate the shared one
            reader = R.reader_for(self.fmt, rebase_mode=rebase_mode)
        part = self.partitions[split]
        cols = self._data_columns()
        if strategy == "MULTITHREADED":
            gen = R.multithreaded_tables(reader, list(part.paths), cols,
                                         batch_rows, num_threads, filt=filt)
        elif strategy == "COALESCING":
            gen = R.coalescing_tables(reader, list(part.paths), cols,
                                      batch_rows, target_rows, filt=filt)
        else:
            gen = R.perfile_tables(reader, list(part.paths), cols,
                                   batch_rows, filt=filt)
        for tbl in gen:
            yield self._append_partition_values(tbl, part)

    def args_string(self):
        return (f"{self.fmt} {len(self.partitions)} partitions"
                + (f" filter={self.pushed_filter!r}"
                   if self.pushed_filter is not None else ""))


class FileSourceScanExec(TorchExec):
    """Leaf device exec: the device decode of its format (parquet row
    groups, ORC stripes, CSV files), or the arrow reader where the device
    decode does not apply. ``stats`` counts the batches each way took and
    names the arrow reader's strategy."""

    def __init__(self, node: FileScanNode, conf=None, device=None):
        super().__init__(conf=conf, device=device)
        self.node = node
        self.stats = {"device_batches": 0, "arrow_batches": 0,
                      "strategy": None, "encoded_vectors": 0,
                      "residual_rows_in": 0, "residual_rows_out": 0,
                      "syncs": 0}
        self._lock = threading.Lock()

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    @property
    def output(self):
        return self.node.output

    @property
    def num_partitions(self):
        return self.node.num_partitions

    def _device_decode_batches(self, split, batch_rows: int,
                               batch_bytes: int):
        """Row-group-at-a-time device decode. Returns None when the partition
        is out of the device path's scope (partition values, date columns
        that statistics do not prove post-cutover, or row groups larger than
        the reader caps)."""
        import pyarrow.parquet as pq
        from spark_rapids_tpu_torch.io import parquet_native as PN
        node = self.node
        part = node.partitions[split]
        if part.partition_values:
            return None
        # a partition that outputs a timestamp or a nested column takes the
        # arrow reader whole (it owns the unit conversion, the datetime
        # rebase and the list/struct/map conversion; the reference's rule,
        # io/filescan.py:299-311)
        if any(_arrow_only(f.data_type) for f in self.output):
            return None
        date_cols = [f.name for f in self.output
                     if isinstance(f.data_type, T.DateType)]
        files = []
        for path in part.paths:
            pf = pq.ParquetFile(path)
            md = pf.metadata
            # honor BOTH reader caps: this path emits one batch per row group
            if any(md.row_group(g).num_rows > batch_rows
                   or md.row_group(g).total_byte_size > batch_bytes
                   for g in range(md.num_row_groups)):
                return None
            if date_cols and not _dates_post_cutover(md, date_cols):
                return None
            files.append((path, pf, md.num_row_groups))

        def it():
            from spark_rapids_tpu_torch.columnar.encoded import \
                EncodedColumnVector
            cols = node._data_columns()
            for path, pf, n_groups in files:
                meta = scan_meta(path)
                for rg in range(n_groups):
                    self._count("device_batches")
                    batch = PN.read_row_group_device(
                        path, rg, self.output, self.device, cols, pf=pf)
                    self._count("encoded_vectors", sum(
                        isinstance(c, EncodedColumnVector)
                        for c in batch.columns))
                    batch.metadata = meta
                    yield batch
        return it()

    def _orc_device_decode_batches(self, split, batch_rows: int,
                                   batch_bytes: int):
        """Stripe-at-a-time device ORC decode. Returns None (the arrow
        reader) when the partition has partition values, a file that
        ``orc_native.read_meta`` refuses, or a stripe above the reader
        caps; columns out of scope go through arrow inside the stripe
        read."""
        from spark_rapids_tpu_torch.io import orc_native as ON
        part = self.node.partitions[split]
        if part.partition_values or any(T.is_nested(f.data_type)
                                        for f in self.output):
            return None
        metas = []
        for path in part.paths:
            try:
                meta = ON.read_meta(path)
            except (NotImplementedError, OSError, IndexError):
                return None
            if any(si.num_rows > batch_rows or si.data_length > batch_bytes
                   for si in meta.stripes):
                return None  # the arrow reader cuts oversized stripes
            metas.append(meta)

        def it():
            import pyarrow.orc as orc
            for path, meta in zip(part.paths, metas):
                pf = orc.ORCFile(path)
                fmeta = scan_meta(path)
                for si in range(len(meta.stripes)):
                    self._count("device_batches")
                    batch = ON.read_stripe_device(path, meta, si, self.output,
                                                  self.device, pf=pf)
                    batch.metadata = fmeta
                    yield batch
        return it()

    def _csv_device_decode_batches(self, split):
        """Whole-file device CSV parse. Every scope check runs first, in one
        host pass per file: if any file is out of scope the partition takes
        the arrow reader (None), so a committed device iterator finishes."""
        from spark_rapids_tpu_torch.io import csv_native as CN
        node = self.node
        part = node.partitions[split]
        if part.partition_values or any(T.is_nested(f.data_type)
                                        for f in self.output):
            return None
        allow_f = self.conf.get(CFG.CSV_READ_FLOATS)
        rdr = node.reader
        shapes = []
        for path in part.paths:
            shape = CN.try_scan_for_device(path, self.output, rdr.delimiter,
                                           rdr.header, allow_f)
            if shape is None:
                return None
            shapes.append(shape)

        def it():
            for path, shape in zip(part.paths, shapes):
                CN.route("device_files")
                self._count("device_batches")
                batch = CN.decode_shape_device(shape, self.output,
                                               self.device)
                batch.metadata = scan_meta(path)
                yield batch
        return it()

    def _arrow_batches(self, split, batch_rows: int):
        """The arrow reader path: the configured strategy's tables, each
        staged to the card as one batch."""
        from spark_rapids_tpu_torch.columnar.arrow import table_to_device
        conf = self.conf
        strategy = conf.get(CFG.PARQUET_READER_TYPE).upper()
        self.stats["strategy"] = strategy
        fmt = self.node.fmt
        if fmt != "parquet":
            from spark_rapids_tpu_torch.io import csv_native as CN
            from spark_rapids_tpu_torch.io import orc_native as ON
            (CN if fmt == "csv" else ON).route(
                "arrow_files", len(self.node.partitions[split].paths))
        # the file of a batch is known only where the partition has one
        # file (the strategies may stitch files); else "" and -1, as in the
        # reference
        paths = self.node.partitions[split].paths
        meta = scan_meta(paths[0]) if len(paths) == 1 else None
        filt, residual = self.node.split_filter(
            conf.get(CFG.PARQUET_REBASE_MODE))
        tables = self.node.tables_for(
            split, batch_rows, strategy,
            conf.get(CFG.MULTITHREADED_READ_NUM_THREADS),
            rebase_mode=conf.get(CFG.PARQUET_REBASE_MODE), filt=filt)
        from spark_rapids_tpu_torch.runtime import pipeline as P
        # the decode edge buffers host arrow tables only, ahead of the
        # device upload below (reference filescan.py:494)
        tables = P.maybe_stage(tables, "scan.decode", conf, spillable=False)
        for tbl in tables:
            self._count("arrow_batches")
            batch = table_to_device(tbl, self.device, schema=self.output)
            if residual is not None:
                batch = self._residual(batch, residual)
            batch.metadata = meta
            yield batch

    def _residual(self, batch, residual):
        """The rows of ``batch`` the residual predicate keeps, evaluated on
        the device with Spark's semantics (one host sync, the count)."""
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        from spark_rapids_tpu_torch.expr.core import EvalContext
        from spark_rapids_tpu_torch.ops.filtering import (compact_cols,
                                                          selection_mask)
        ctx = EvalContext.from_batch(batch, self.device)
        keep = selection_mask(residual.eval(ctx), ctx.num_rows, ctx.capacity)
        cols, n = compact_cols(ctx.cols, keep)
        self._count("residual_rows_in", batch.num_rows)
        self._count("residual_rows_out", n)
        self._count("syncs")
        return ColumnarBatch([c.to_vector() for c in cols], n, self.output)

    def _engaged(self, entry) -> bool:
        """Whether a device route is taken (the reference's
        ``decode_engaged``): an explicitly set key decides; otherwise the
        conf's default, on a CUDA device only."""
        if entry.key in self.conf.settings:
            return self.conf.get(entry)
        return self.conf.get(entry) and self.device.type == "cuda"

    def execute_partition(self, split):
        conf = self.conf
        batch_rows = min(conf.get(CFG.MAX_READER_BATCH_SIZE_ROWS), 1 << 20)
        batch_bytes = conf.get(CFG.MAX_READER_BATCH_SIZE_BYTES)
        fmt = self.node.fmt
        dev_it = None
        if self.node.pushed_filter is not None:
            # a pushed filter takes the arrow reader, as in the reference
            pass
        elif fmt == "parquet" and conf.get(CFG.PARQUET_DEVICE_DECODE):
            dev_it = self._device_decode_batches(split, batch_rows,
                                                 batch_bytes)
        elif fmt == "csv" and self._engaged(CFG.CSV_DEVICE_DECODE):
            dev_it = self._csv_device_decode_batches(split)
        elif fmt == "orc" and self._engaged(CFG.ORC_DEVICE_DECODE):
            dev_it = self._orc_device_decode_batches(split, batch_rows,
                                                     batch_bytes)
        if dev_it is not None:
            # a device route's batches on their own pipelined stage
            # (reference filescan.py:426): the host parse and the upload run
            # on the stage's thread, and the queued batches wait spillable
            from spark_rapids_tpu_torch.runtime import pipeline as P
            return P.maybe_stage(dev_it, "scan.device", conf)
        return self._arrow_batches(split, batch_rows)

    def args_string(self):
        return self.node.args_string()
