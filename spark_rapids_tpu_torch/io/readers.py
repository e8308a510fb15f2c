"""Format readers — counterpart of ``spark_rapids_tpu/io/readers.py``.

Only the parquet footer/schema access the scan needs is ported; the arrow
reader strategies (PERFILE / MULTITHREADED / COALESCING) wait for a later
slice, because the device decode (``io/parquet_native.py``) reads every
in-scope row group itself.
"""

from __future__ import annotations

import pyarrow as pa


class ParquetReader:
    format_name = "parquet"

    def schema_of(self, path: str) -> pa.Schema:
        import pyarrow.parquet as pq
        return pq.read_schema(path)


def reader_for(fmt: str) -> ParquetReader:
    if fmt != "parquet":
        raise NotImplementedError(f"{fmt} scans are not ported yet")
    return ParquetReader()
