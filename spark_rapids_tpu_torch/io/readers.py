"""Format readers with the reference's three strategies — counterpart of
``spark_rapids_tpu/io/readers.py``.

The arrow reader path: a parquet, ORC or CSV file decodes on the host
through Arrow C++ into arrow tables, which reach the card as batches in one
copy per column (``columnar/arrow.py``). The scan takes it for the
partitions the device decode does not take (``io/filescan.py``): the device
decode turned off, hive partition directories, row groups or stripes above
the reader caps, parquet dates that footer statistics do not prove
post-cutover, and ORC or CSV files outside the device parse's scope. ORC is
read a stripe at a time (reference GpuOrcPartitionReader:375), CSV a whole
file at a time with the schema's types. The strategies (reference
GpuParquetScan.scala): PERFILE (ParquetPartitionReader:1603, one file at a
time), MULTITHREADED (MultiFileCloudParquetPartitionReader:1377, background
threads decode files ahead of the consumer) and COALESCING
(MultiFileParquetPartitionReader:958, many small files stitched into few
large tables). A pushed scan filter, translated by
``spark_filter_to_arrow``, is applied by arrow as it reads: row groups
pruned from the footers' statistics and the rows filtered exactly.
"""

from __future__ import annotations

import concurrent.futures as futures
import typing

import numpy as np
import pyarrow as pa

def spark_filter_to_arrow(expr):
    """A pyarrow dataset expression for a predicate bound to the scan's
    schema, or None when it cannot be translated exactly with Spark's
    semantics (reference ``io/readers.spark_filter_to_arrow``); the caller
    then evaluates it itself. A comparison is translated only between
    columns and literals of one integral, string, date or boolean type:
    arrow orders NaN as IEEE does, while Spark orders NaN above every value
    and holds NaN = NaN, so no float comparison is translated, and neither
    is a decimal or a timestamp one (the port's literals of those hold
    unscaled values and microseconds, which arrow would compare as
    numbers)."""
    import datetime
    import pyarrow.dataset as ds
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr import nullexprs as N
    from spark_rapids_tpu_torch.expr import predicates as P

    # a date literal holds its day number (expr/core._held_value); a
    # ``datetime.date`` is taken too
    kinds = ((T.IntegralType, int), (T.StringType, str),
             (T.DateType, (datetime.date, int)), (T.BooleanType, bool))

    def kind(e):
        for i, (cls, py) in enumerate(kinds):
            if isinstance(e.dtype, cls):
                if isinstance(e, E.Literal) and not (
                        e.value is None or isinstance(e.value, py)):
                    break
                return i
        raise NotImplementedError(f"{e.dtype} comparison")

    def operand(e):
        if isinstance(e, (E.AttributeReference, E.BoundReference)):
            return ds.field(e.name)
        if isinstance(e, E.Literal):
            return pa.scalar(e.value, T.to_arrow_type(e.dtype))
        raise NotImplementedError(type(e).__name__)

    ops = {P.EqualTo: "__eq__", P.NotEqual: "__ne__", P.LessThan: "__lt__",
           P.LessThanOrEqual: "__le__", P.GreaterThan: "__gt__",
           P.GreaterThanOrEqual: "__ge__"}

    def conv(e):
        if isinstance(e, P.And):
            return conv(e.children[0]) & conv(e.children[1])
        if isinstance(e, P.Or):
            return conv(e.children[0]) | conv(e.children[1])
        if isinstance(e, P.Not):
            return ~conv(e.children[0])
        if isinstance(e, N.IsNull):
            return operand(e.children[0]).is_null()
        if isinstance(e, N.IsNotNull):
            return ~operand(e.children[0]).is_null()
        m = ops.get(type(e))
        if m is None:
            raise NotImplementedError(type(e).__name__)
        a, b = e.children
        if kind(a) != kind(b):
            raise NotImplementedError("a comparison across types")
        return getattr(operand(a), m)(operand(b))

    try:
        out = conv(expr)
    except NotImplementedError:
        return None
    return out if isinstance(out, ds.Expression) else None


def _filtered(tbl: pa.Table, filt) -> pa.Table:
    """``tbl``'s rows that ``filt`` (an arrow expression) keeps."""
    if filt is None or not tbl.num_rows:
        return tbl
    import pyarrow.dataset as ds
    return pa.Table.from_batches(ds.dataset(tbl).to_batches(filter=filt),
                                 schema=tbl.schema)


# -- legacy (hybrid-calendar) datetime rebase --------------------------------
# Spark RebaseDateTime: files written by Spark 2.x / Hive used the hybrid
# Julian+Gregorian calendar; days before the 1582-10-15 switch must be
# reinterpreted. The port's copy of spark_rapids_tpu/shims/__init__.py's.

GREGORIAN_SWITCH_DAY = -141427  # 1582-10-15 as days since 1970-01-01


def _julian_jdn_to_ymd(jdn):
    c = jdn + 32082
    d = (4 * c + 3) // 1461
    e = c - (1461 * d) // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = d - 4800 + m // 10
    return year, month, day


def _gregorian_ymd_to_jdn(y, m, d):
    a = (14 - m) // 12
    y2 = y + 4800 - a
    m2 = m + 12 * a - 3
    return (d + (153 * m2 + 2) // 5 + 365 * y2 + y2 // 4 - y2 // 100
            + y2 // 400 - 32045)


def rebase_julian_to_gregorian_days(days: np.ndarray) -> np.ndarray:
    """Hybrid-calendar epoch days → proleptic Gregorian epoch days (read
    rebase). Identity at/after the 1582-10-15 switch."""
    days = np.asarray(days, dtype=np.int64)
    old = days < GREGORIAN_SWITCH_DAY
    if not old.any():
        return days
    jdn = days[old] + 2440588  # JDN of 1970-01-01
    y, m, d = _julian_jdn_to_ymd(jdn)
    out = days.copy()
    out[old] = _gregorian_ymd_to_jdn(y, m, d) - 2440588
    return out


class ParquetReader:
    """One parquet file → arrow tables of at most ``batch_rows`` rows,
    decoded by the Arrow dataset scanner (C++), with the DATE rebase of the
    configured mode applied to each table."""

    format_name = "parquet"
    _REBASE_MODES = ("EXCEPTION", "CORRECTED", "LEGACY")

    def __init__(self, rebase_mode: str = "EXCEPTION"):
        self.rebase_mode = rebase_mode.upper()
        if self.rebase_mode not in self._REBASE_MODES:
            raise ValueError(
                f"invalid datetimeRebaseModeInRead {rebase_mode!r}; "
                f"expected one of {self._REBASE_MODES}")

    def _rebase(self, tbl: pa.Table) -> pa.Table:
        """Datetime rebase for legacy hybrid-calendar writers (reference
        GpuParquetScan rebase checks; Spark datetimeRebaseModeInRead)."""
        if self.rebase_mode == "CORRECTED":
            return tbl
        for i, f in enumerate(tbl.schema):
            if not pa.types.is_date32(f.type):
                continue
            col = tbl.column(i).combine_chunks()
            days = col.cast(pa.int32()).to_numpy(zero_copy_only=False)
            valid = ~np.asarray(col.is_null())
            old = valid & (days < GREGORIAN_SWITCH_DAY)
            if not old.any():
                continue
            if self.rebase_mode == "EXCEPTION":
                raise ValueError(
                    f"column '{f.name}' holds dates before 1582-10-15; set "
                    "spark.rapids.tpu.sql.parquet.datetimeRebaseModeInRead "
                    "to LEGACY (hybrid-calendar writer) or CORRECTED "
                    "(proleptic writer)")
            rebased = rebase_julian_to_gregorian_days(
                days.astype("int64")).astype("int32")
            arr = pa.array(rebased, pa.int32()).cast(pa.date32())
            if not valid.all():
                import pyarrow.compute as pc
                arr = pc.if_else(pa.array(valid), arr,
                                 pa.nulls(len(arr), pa.date32()))
            tbl = tbl.set_column(i, f.name, arr)
        return tbl

    def read_file(self, path: str, columns: list | None, batch_rows: int,
                  filt=None) -> typing.Iterator[pa.Table]:
        import pyarrow.dataset as ds
        dset = ds.dataset(path, format="parquet")
        for batch in dset.to_batches(columns=columns, filter=filt,
                                     batch_size=batch_rows,
                                     use_threads=False):
            if batch.num_rows:
                yield self._rebase(pa.Table.from_batches([batch]))

    def schema_of(self, path: str) -> pa.Schema:
        import pyarrow.parquet as pq
        return pq.read_schema(path)


class OrcReader:
    """One ORC file → arrow tables, a stripe at a time, each cut to at most
    ``batch_rows`` rows."""

    format_name = "orc"

    def read_file(self, path, columns, batch_rows, filt=None):
        import pyarrow.orc as orc
        f = orc.ORCFile(path)
        for stripe in range(f.nstripes):
            tbl = f.read_stripe(stripe, columns=columns)
            if isinstance(tbl, pa.RecordBatch):
                tbl = pa.Table.from_batches([tbl])
            tbl = _filtered(tbl, filt)
            for off in range(0, tbl.num_rows, batch_rows):
                yield tbl.slice(off, batch_rows)

    def schema_of(self, path):
        import pyarrow.orc as orc
        return orc.ORCFile(path).schema


class CsvReader:
    """One CSV file → arrow tables of at most ``batch_rows`` rows, parsed
    whole by pyarrow with the schema's types. With a header, schema fields
    are matched to the file's columns by name; without one, the schema
    names the file's columns in order. Empty, ``null`` and ``NULL`` fields
    are null."""

    format_name = "csv"

    def __init__(self, header: bool = True, delimiter: str = ",",
                 schema=None, null_value: str = ""):
        self.header = header
        self.delimiter = delimiter
        self.schema = schema
        self.null_value = null_value

    def _options(self):
        import pyarrow.csv as pcsv
        from spark_rapids_tpu_torch import types as T
        read_opts = pcsv.ReadOptions(
            autogenerate_column_names=not self.header,
            column_names=(None if self.header or self.schema is None
                          else [f.name for f in self.schema]))
        parse_opts = pcsv.ParseOptions(delimiter=self.delimiter)
        conv = {}
        if self.schema is not None:
            # a timestamp parses naive and is taken as UTC (the session
            # zone): arrow refuses a zoned target for text without an offset
            conv = {f.name: (pa.timestamp("us")
                             if isinstance(f.data_type, T.TimestampType)
                             else T.to_arrow_type(f.data_type))
                    for f in self.schema}
        convert_opts = pcsv.ConvertOptions(
            column_types=conv, null_values=[self.null_value, "null", "NULL"],
            strings_can_be_null=True)
        return read_opts, parse_opts, convert_opts

    def read_file(self, path, columns, batch_rows, filt=None):
        import pyarrow.csv as pcsv
        ro, po, co = self._options()
        tbl = pcsv.read_csv(path, read_options=ro, parse_options=po,
                            convert_options=co)
        if columns is not None:
            tbl = tbl.select(columns)
        tbl = _filtered(tbl, filt)
        for off in range(0, tbl.num_rows, batch_rows):
            yield tbl.slice(off, batch_rows)

    def schema_of(self, path):
        import pyarrow.csv as pcsv
        ro, po, co = self._options()
        # the streaming reader: the schema of the first block, no full parse
        with pcsv.open_csv(path, read_options=ro, parse_options=po,
                           convert_options=co) as reader:
            return reader.schema


def reader_for(fmt: str, rebase_mode: str = "EXCEPTION", **kw):
    """The reader of a format: ``rebase_mode`` applies to parquet, ``kw``
    (header, delimiter, schema) to CSV."""
    if fmt == "parquet":
        return ParquetReader(rebase_mode=rebase_mode)
    if fmt == "orc":
        return OrcReader()
    if fmt == "csv":
        return CsvReader(**kw)
    raise ValueError(f"unknown format {fmt}")


# -- multi-file strategies ---------------------------------------------------

def perfile_tables(reader, paths, columns, batch_rows, filt=None):
    """PERFILE: sequential, lowest memory (reference ParquetPartitionReader:1603)."""
    for p in paths:
        yield from reader.read_file(p, columns, batch_rows, filt)


def multithreaded_tables(reader, paths, columns, batch_rows, num_threads,
                         prefetch: int = 4, filt=None):
    """MULTITHREADED: background futures decode files ahead of the consumer so
    host decode overlaps device compute (reference
    MultiFileCloudParquetPartitionReader:1377 + its thread pool)."""
    if not paths:
        return
    pool = futures.ThreadPoolExecutor(max_workers=max(1, num_threads))
    try:
        def read_whole(p):
            return list(reader.read_file(p, columns, batch_rows, filt))
        pending = [pool.submit(read_whole, p) for p in paths[:prefetch]]
        consumed = min(prefetch, len(paths))
        while pending:
            fut = pending.pop(0)
            if consumed < len(paths):
                pending.append(pool.submit(read_whole, paths[consumed]))
                consumed += 1
            yield from fut.result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def coalescing_tables(reader, paths, columns, batch_rows, target_rows,
                      filt=None):
    """COALESCING: stitch many files into few big tables so each device batch is
    large (reference MultiFileParquetPartitionReader:958 stitches row groups into
    one host buffer + one decode). `batch_rows` (the configured reader cap) still
    bounds every emitted table; `target_rows` is the coalesce goal."""
    cap = max(batch_rows, 1)
    acc: list[pa.Table] = []
    acc_rows = 0

    def flush():
        t = acc[0] if len(acc) == 1 else pa.concat_tables(
            acc, promote_options="permissive")
        for off in range(0, t.num_rows, cap):
            yield t.slice(off, cap)

    # sequential streaming accumulate-and-flush: peak host memory stays
    # ~target_rows regardless of file sizes. Decode/compute overlap is the
    # MULTITHREADED strategy's job (it pays whole-file buffering for it).
    for tbl in perfile_tables(reader, paths, columns, cap, filt):
        acc.append(tbl)
        acc_rows += tbl.num_rows
        if acc_rows >= target_rows:  # flush() re-slices to cap-row batches
            yield from flush()
            acc, acc_rows = [], 0
    if acc:
        yield from flush()
