"""File scan: plan node + device exec.

Counterpart of ``spark_rapids_tpu/io/filescan.py``. A directory is discovered
into one partition per directory (the JAX package's ``discover_partitions``;
``files_per_partition`` applies only to an explicit file list). The exec reads
each row group through the device parquet decode
(``io/parquet_native.read_row_group_device``), one batch per row group; a
column chunk out of the decode's scope goes through arrow for that column.
Hive partition values, the arrow reader strategies and the legacy datetime
rebase are not ported yet and raise ``NotImplementedError``; pushed filters
are not ported either, so the scan takes none.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

from spark_rapids_tpu_torch import config as CFG
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.io import readers as R
from spark_rapids_tpu_torch.plan.nodes import PlanNode


@dataclasses.dataclass(frozen=True)
class FilePartition:
    """Files + constant partition-column values (from dir names a/b=1/...)."""
    paths: tuple
    partition_values: tuple = ()   # ((name, value), ...)


def discover_partitions(root: str, fmt: str) -> list[FilePartition]:
    """Walk a (possibly hive-partitioned) directory into per-directory
    partitions, skipping '_' and '.' entries like Spark's file index."""
    exts = {"parquet": (".parquet", ".pq")}
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


class FileScanNode(PlanNode):
    """Plan node for a file scan; the override rules turn it into
    FileSourceScanExec."""

    def __init__(self, paths_or_dir, fmt: str = "parquet",
                 schema: T.StructType | None = None,
                 files_per_partition: int = 1):
        super().__init__()
        self.fmt = fmt
        self.reader = R.reader_for(fmt)
        if isinstance(paths_or_dir, str) and os.path.isdir(paths_or_dir):
            parts = discover_partitions(paths_or_dir, fmt)
        else:
            paths = ([paths_or_dir] if isinstance(paths_or_dir, str)
                     else list(paths_or_dir))
            parts = [FilePartition(tuple(paths[i:i + files_per_partition]))
                     for i in range(0, len(paths), files_per_partition)]
        if not parts:
            raise ValueError(f"no {fmt} files under {paths_or_dir}")
        if any(p.partition_values for p in parts):
            raise NotImplementedError(
                "hive partition directories are not ported yet")
        self.partitions = parts
        if schema is None:
            schema = T.StructType.from_arrow(
                self.reader.schema_of(parts[0].paths[0]))
        self._schema = schema

    @property
    def output(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self.partitions)

    def _data_columns(self) -> list:
        return [f.name for f in self._schema.fields]

    def args_string(self):
        return f"{self.fmt} {len(self.partitions)} partitions"


class FileSourceScanExec(TorchExec):
    """Leaf device exec: row-group-at-a-time device decode."""

    def __init__(self, node: FileScanNode, conf=None, device=None):
        super().__init__(conf=conf, device=device)
        self.node = node

    @property
    def output(self):
        return self.node.output

    @property
    def num_partitions(self):
        return self.node.num_partitions

    def _device_decode_batches(self, split, batch_rows: int,
                               batch_bytes: int):
        """Row-group-at-a-time device decode. Returns None when the partition
        is out of the device path's scope (date columns that statistics do
        not prove post-cutover, or row groups larger than the reader caps)."""
        import pyarrow.parquet as pq
        from spark_rapids_tpu_torch.io import parquet_native as PN
        node = self.node
        part = node.partitions[split]
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
            cols = node._data_columns()
            for path, pf, n_groups in files:
                for rg in range(n_groups):
                    yield PN.read_row_group_device(
                        path, rg, self.output, self.device, cols, pf=pf)
        return it()

    def execute_partition(self, split):
        conf = self.conf
        if not conf.get(CFG.PARQUET_DEVICE_DECODE):
            raise NotImplementedError(
                "the arrow parquet reader is not ported yet: "
                f"{CFG.PARQUET_DEVICE_DECODE.key} must stay true")
        batch_rows = min(conf.get(CFG.MAX_READER_BATCH_SIZE_ROWS), 1 << 20)
        dev_it = self._device_decode_batches(
            split, batch_rows, conf.get(CFG.MAX_READER_BATCH_SIZE_BYTES))
        if dev_it is None:
            raise NotImplementedError(
                "this partition needs the arrow reader (row groups above the "
                "reader caps, or dates before the Gregorian cutover), which "
                "is not ported yet")
        return dev_it

    def args_string(self):
        return self.node.args_string()
