"""Shared helpers for the benchmark data generator and loader — counterpart of
``spark_rapids_tpu/benchmarks/common.py``."""

from __future__ import annotations

import os

import pyarrow as pa
import pyarrow.parquet as pq


def write_partitioned(outdir: str, name: str, table: pa.Table,
                      nfiles: int, paths: dict) -> None:
    """Write ``table`` as ``nfiles`` parquet parts under outdir/name;
    idempotent (skips a table directory that already holds parquet parts of
    the same schema)."""
    d = os.path.join(outdir, name)
    paths[name] = d
    if os.path.isdir(d):
        parts = sorted(f for f in os.listdir(d) if f.endswith(".parquet"))
        if parts:
            old = pq.read_schema(os.path.join(d, parts[0]))
            if old.equals(table.schema):
                return
            for f in parts:
                os.unlink(os.path.join(d, f))
    os.makedirs(d, exist_ok=True)
    n = table.num_rows
    per = max((n + nfiles - 1) // nfiles, 1)
    for i in range(max(nfiles, 1)):
        sl = table.slice(i * per, per)
        if sl.num_rows == 0 and i > 0:
            break
        pq.write_table(sl, os.path.join(d, f"part-{i:04d}.parquet"))


def load(spark, paths: dict, files_per_partition: int = 2) -> dict:
    """One DataFrame per table, each also registered as a temp view of its
    name, so that ``spark.sql`` can read it."""
    dfs = {name: spark.read_parquet(p,
                                    files_per_partition=files_per_partition)
           for name, p in paths.items()}
    for name, df in dfs.items():
        spark.create_or_replace_temp_view(name, df)
    return dfs


def read_np(path, columns=None):
    """Read a table dir/file into {col: np.ndarray}; date32 → epoch-day i32."""
    t = pq.read_table(path, columns=columns)
    out = {}
    for name in t.column_names:
        col = t.column(name)
        if pa.types.is_date32(col.type):
            out[name] = col.cast(pa.int32()).to_numpy()
        else:
            out[name] = col.to_numpy(zero_copy_only=False)
    return out


def load_np(paths: dict) -> dict:
    return {name: read_np(p) for name, p in paths.items()}
