"""Columnar file writers with a commit protocol and write statistics.

Counterpart of ``spark_rapids_tpu/io/writer.py`` (reference
ColumnarOutputWriter.scala, GpuFileFormatDataWriter:419, GpuFileFormatWriter:345,
BasicColumnarWriteStatsTracker:180): the GpuInsertIntoHadoopFsRelationCommand
analog. The commit protocol is Hadoop's FileOutputCommitter v2: a job
writes under ``<path>/_temporary-<job uuid>/task_<n>/``, each task renames
its files into the final directory when it commits, and the job writes
``_SUCCESS`` last. Files are named ``part-<task:05d>-<job uuid>-<n:04d>.<ext>``,
so an append never collides with an earlier job's files and a read-back
lists them in task order.

Each partition of the plan is one task; the tasks run on
``spark.rapids.tpu.sql.localScheduler.numThreads`` threads, as the
exchange's map stage does. A task writes one file per batch:

- the native writer (``io/{parquet,orc,csv}_write_native.py``) when the
  format's ``writer.type`` is NATIVE (the default) and the write is not
  partitioned: the device prepares each column, the host frames the bytes;
- the arrow writer (``pyarrow``) for a partitioned write (dynamic
  partitioning: one ``key=value`` directory per combination, rows kept in
  their order), for ``writer.type`` ARROW, and for a schema with a nested
  (array, map, struct) column, which the native encoders do not frame
  (``native_supports``, the reference's ``supports_schema``). The route
  is chosen from the schema before any file is written; a CSV write of a
  nested column is refused there (Spark's CSV source refuses it too).

``routes`` counts the files each way wrote. Unlike the reference, a native
encoder that fails raises: the task aborts, its temporary files go, and
nothing is rewritten through arrow.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import uuid

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch.plan.nodes import PlanNode

#: files written since the last reset_routes(): ``native_files`` (a native
#: encoder's) and ``arrow_files`` (pyarrow's)
routes = {"native_files": 0, "arrow_files": 0}
_ROUTES_LOCK = threading.Lock()

_EXT = {"parquet": "parquet", "orc": "orc", "csv": "csv"}
_WRITER_TYPE = {"parquet": CFG.PARQUET_WRITER_TYPE,
                "orc": CFG.ORC_WRITER_TYPE, "csv": CFG.CSV_WRITER_TYPE}
MODES = ("error", "overwrite", "append", "ignore")


def native_supports(schema) -> bool:
    """Whether the native encoders frame every column: not a nested one."""
    from spark_rapids_tpu_torch import types as T
    return not any(T.is_nested(f.data_type) for f in schema)


def reset_routes() -> None:
    with _ROUTES_LOCK:
        for k in routes:
            routes[k] = 0


def _route(name: str) -> None:
    with _ROUTES_LOCK:
        routes[name] += 1


@dataclasses.dataclass
class WriteStats:
    """Reference BasicColumnarWriteStatsTracker: files, rows, bytes and the
    partition directories written."""
    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    partitions: list = dataclasses.field(default_factory=list)

    def merge(self, other: "WriteStats"):
        self.num_files += other.num_files
        self.num_rows += other.num_rows
        self.num_bytes += other.num_bytes
        self.partitions.extend(other.partitions)


def _write_table(tbl: pa.Table, path: str, fmt: str, compression: str):
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(tbl, path, compression=compression)
    elif fmt == "orc":
        import pyarrow.orc as orc
        orc.write_table(tbl, path)
    elif fmt == "csv":
        import pyarrow.csv as pcsv
        pcsv.write_csv(tbl, path)
    else:
        raise ValueError(f"unknown format {fmt}")


def _native_module(fmt: str):
    if fmt == "parquet":
        from spark_rapids_tpu_torch.io import parquet_write_native as m
    elif fmt == "orc":
        from spark_rapids_tpu_torch.io import orc_write_native as m
    else:
        from spark_rapids_tpu_torch.io import csv_write_native as m
    return m


class _TaskWriter:
    """One task's output, one file per batch: plain or dynamic-partitioned
    (reference GpuFileFormatDataWriter SingleDirectory/DynamicPartition
    writers)."""

    def __init__(self, temp_dir: str, task_id: int, fmt: str,
                 compression: str, partition_by: list, schema,
                 job_uuid: str, native: bool = False):
        self.temp = os.path.join(temp_dir, f"task_{task_id}")
        os.makedirs(self.temp, exist_ok=True)
        self.fmt = fmt
        self.compression = compression
        self.partition_by = partition_by
        self.schema = schema
        self.stats = WriteStats()
        self._file_counter = 0
        self._task_id = task_id
        self._job_uuid = job_uuid
        self.native = native

    def _next_name(self, subdir: str = "") -> str:
        name = (f"part-{self._task_id:05d}-{self._job_uuid}"
                f"-{self._file_counter:04d}.{_EXT[self.fmt]}")
        self._file_counter += 1
        d = os.path.join(self.temp, subdir)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def write_batch(self, batch):
        """One device batch → one file: the native encoder, or the arrow
        writer for a partitioned write or the ARROW writer type."""
        if not self.native or self.partition_by:
            self.write(batch.to_arrow())
            return
        m = _native_module(self.fmt)
        path = self._next_name()
        if self.fmt == "csv":
            nbytes = m.write_batch_file(path, batch, self.schema)
        else:
            nbytes = m.write_batch_file(path, batch, self.schema,
                                        self.compression)
        _route("native_files")
        self.stats.num_files += 1
        self.stats.num_rows += batch.num_rows
        self.stats.num_bytes += nbytes

    def _write_file(self, tbl: pa.Table, subdir: str = ""):
        path = self._next_name(subdir)
        _write_table(tbl, path, self.fmt, self.compression)
        _route("arrow_files")
        self.stats.num_files += 1
        self.stats.num_rows += tbl.num_rows
        self.stats.num_bytes += os.path.getsize(path)

    def write(self, tbl: pa.Table):
        """One host table through the arrow writer; with ``partition_by``,
        one file per combination of the keys, under ``k=v`` directories
        (null as ``__HIVE_DEFAULT_PARTITION__``), in the order the
        combinations first appear, each file's rows in table order."""
        if not self.partition_by:
            self._write_file(tbl)
            return
        codes = []
        for c in self.partition_by:
            enc = tbl.column(c).combine_chunks().dictionary_encode()
            # null keys form one group of their own, after the dictionary
            codes.append(enc.indices.fill_null(len(enc.dictionary))
                         .to_numpy(zero_copy_only=False).astype(np.int64))
        if tbl.num_rows:
            _u, first, inverse = np.unique(np.stack(codes, axis=1), axis=0,
                                           return_index=True,
                                           return_inverse=True)
            inverse = inverse.reshape(-1)
        else:
            first, inverse = np.zeros(0, np.int64), np.zeros(0, np.int64)
        data_cols = [c for c in tbl.column_names
                     if c not in self.partition_by]
        keys = [tbl.column(c) for c in self.partition_by]
        for g in np.argsort(first, kind="stable"):
            rows = np.flatnonzero(inverse == g)
            r0 = int(rows[0])
            combo = [k[r0].as_py() for k in keys]
            subdir = os.path.join(*[
                f"{c}={'__HIVE_DEFAULT_PARTITION__' if v is None else v}"
                for c, v in zip(self.partition_by, combo)])
            self._write_file(tbl.select(data_cols).take(pa.array(rows)),
                             subdir)
            if subdir not in self.stats.partitions:
                self.stats.partitions.append(subdir)

    def commit(self, final_dir: str):
        """Move the task's files into the final directory (FileOutputCommitter
        v2)."""
        for dirpath, _, files in os.walk(self.temp):
            rel = os.path.relpath(dirpath, self.temp)
            dest = final_dir if rel == "." else os.path.join(final_dir, rel)
            os.makedirs(dest, exist_ok=True)
            for f in files:
                os.replace(os.path.join(dirpath, f), os.path.join(dest, f))
        shutil.rmtree(self.temp, ignore_errors=True)

    def abort(self):
        shutil.rmtree(self.temp, ignore_errors=True)


def write_columnar(exec_, path: str, fmt: str = "parquet",
                   partition_by: list | None = None,
                   compression: str = "snappy", mode: str = "error",
                   conf=None) -> WriteStats:
    """Write a device exec's output under ``path``: job setup, one task per
    partition on the local scheduler's threads, each task's commit, then
    ``_SUCCESS``. ``mode``: error (refuse a non-empty directory), overwrite
    (remove it first), append (add files beside it) or ignore (write
    nothing). A failed task aborts the job: its exception propagates and
    the job's temporary directory is removed."""
    if mode not in MODES:
        raise ValueError(f"unknown save mode {mode!r}")
    if fmt not in _EXT:
        raise ValueError(f"unknown format {fmt}")
    conf = conf if conf is not None else CFG.RapidsConf()
    if os.path.exists(path) and os.listdir(path):
        if mode == "error":
            raise FileExistsError(path)
        if mode == "ignore":
            return WriteStats()
        if mode == "overwrite":
            shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    job_uuid = uuid.uuid4().hex[:12]
    temp_dir = os.path.join(path, f"_temporary-{job_uuid}")
    os.makedirs(temp_dir, exist_ok=True)
    partition_by = list(partition_by or [])
    schema = exec_.output
    for c in partition_by:
        schema.index_of(c)            # raises KeyError on an unknown column
    native = (str(conf.get(_WRITER_TYPE[fmt])).upper() == "NATIVE"
              and native_supports(schema))
    total = WriteStats()
    lock = threading.Lock()

    from spark_rapids_tpu_torch.runtime.memory import (current_query,
                                                       query_context)
    from spark_rapids_tpu_torch.runtime.semaphore import TaskContext
    query = current_query()

    def run_split(split):
        writer = _TaskWriter(temp_dir, split, fmt, compression, partition_by,
                             schema, job_uuid, native=native)
        try:
            # one task of the device semaphore a partition
            with query_context(query), TaskContext():
                for batch in exec_.execute_partition(split):
                    writer.write_batch(batch)
            writer.commit(path)
        except BaseException:
            writer.abort()
            raise
        with lock:
            total.merge(writer.stats)

    from concurrent.futures import ThreadPoolExecutor
    n = exec_.num_partitions
    try:
        with ThreadPoolExecutor(max_workers=max(1, min(
                conf.get(CFG.NUM_LOCAL_TASKS), n))) as pool:
            list(pool.map(run_split, range(n)))
    finally:
        shutil.rmtree(temp_dir, ignore_errors=True)
    with open(os.path.join(path, "_SUCCESS"), "w"):
        pass
    return total


class FileWriteNode(PlanNode):
    """The plan of a write: its child's rows written under ``path``.
    ``run`` plans the child (pruned, then the override rules) on a
    session's conf and device and writes its output."""

    def __init__(self, child: PlanNode, path: str, fmt: str = "parquet",
                 partition_by: list | None = None, mode: str = "error"):
        super().__init__(child)
        self.path = path
        self.fmt = fmt
        self.partition_by = list(partition_by or [])
        self.mode = mode

    @property
    def output(self):
        return self.child.output

    def run(self, conf, device) -> WriteStats:
        from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
        from spark_rapids_tpu_torch.plan.pruning import prune_columns
        if self.fmt == "csv" and not native_supports(self.child.output):
            raise NotImplementedError(
                f"a CSV write of {self.child.output} is not ported: CSV has "
                "no nested types (Spark's CSV source refuses them too)")
        exec_ = TorchOverrides(conf, device).apply(prune_columns(self.child))
        return write_columnar(exec_, self.path, self.fmt,
                              partition_by=self.partition_by, mode=self.mode,
                              conf=conf)
