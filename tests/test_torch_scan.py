"""The port's parquet scan (io/filescan.py → io/parquet_native.py) held
against the JAX package's ``FileSourceScanExec`` on the same files, both with
``parquet.deviceDecode.enabled=true`` and ``parquet.encodedUpload.enabled=false``
set explicitly (an explicit conf engages the JAX device decode on the CPU).

Cases: every lineitem column of the TPC-H tables at SF 0.002, and a small
file written with nulls, tiny data pages (multi-page chunks), several row
groups and one PLAIN-encoded column (the per-column arrow fallback).
Tolerance: exact — values, validity and string dictionaries over the whole
padded capacity of every batch.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.config import RapidsConf
from spark_rapids_tpu.exec.base import TaskContext
from spark_rapids_tpu.io.filescan import FileScanNode, FileSourceScanExec
from spark_rapids_tpu_torch.config import RapidsConf as TorchConf
from spark_rapids_tpu_torch.io.filescan import FileScanNode as TFileScanNode
from spark_rapids_tpu_torch.io.filescan import \
    FileSourceScanExec as TFileSourceScanExec

CONF = {"spark.rapids.tpu.sql.parquet.deviceDecode.enabled": "true",
        "spark.rapids.tpu.sql.parquet.encodedUpload.enabled": "false"}


def _jax_batches(path):
    ex = FileSourceScanExec(FileScanNode(path, "parquet"),
                            conf=RapidsConf(CONF))
    out = []
    with TaskContext():
        for split in range(ex.num_partitions):
            out.extend(ex.execute_partition(split))
    return out


def _torch_batches(path):
    ex = TFileSourceScanExec(TFileScanNode(path, "parquet"),
                             conf=TorchConf(CONF), device="cpu")
    return [b for split in range(ex.num_partitions)
            for b in ex.execute_partition(split)]


def _column_pairs(path) -> dict:
    """{column: [(jax vector, port vector) per batch]} of one scan each."""
    jb, tb = _jax_batches(path), _torch_batches(path)
    assert len(jb) == len(tb) and jb
    out: dict = {}
    for j, t in zip(jb, tb):
        assert j.num_rows == t.num_rows
        assert j.schema.names == t.schema.names
        for name, jc, tc in zip(t.schema.names, j.columns, t.columns):
            out.setdefault(name, []).append((jc, tc))
    return out


def _assert_column_equal(name, jc, tc):
    assert jc.dtype.sql_name == tc.dtype.sql_name, name
    jv = np.asarray(jc.data)
    tv = tc.data.numpy()
    assert jv.dtype == tv.dtype, name
    np.testing.assert_array_equal(tv, jv, err_msg=name)
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity), err_msg=name)
    if jc.is_string:
        assert tc.dictionary.equals(jc.dictionary), name


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    from spark_rapids_tpu.benchmarks import tpch
    d = tmp_path_factory.mktemp("tpch_scan")
    return _column_pairs(tpch.generate(0.002, str(d))["lineitem"])


LINEITEM_COLUMNS = ["l_orderkey", "l_suppkey", "l_quantity",
                    "l_extendedprice", "l_discount", "l_tax",
                    "l_returnflag", "l_linestatus", "l_shipdate"]


@pytest.mark.parametrize("column", LINEITEM_COLUMNS)
def test_lineitem_column_matches_jax(lineitem, column):
    pairs = lineitem[column]
    assert len(pairs) == 4   # one batch per file (4 files, one row group each)
    for jc, tc in pairs:
        _assert_column_equal(column, jc, tc)


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    """Nulls in every column, ~tiny pages (many per chunk), three row
    groups, and ``plain_d`` written without a dictionary."""
    rng = np.random.default_rng(11)
    n = 3000

    def nulls(a, frac):
        mask = rng.random(n) < frac
        return pa.array(a, mask=mask)

    t = pa.table({
        "i64": nulls(rng.integers(-10**12, 10**12, n), 0.1),
        "i32": nulls(rng.integers(0, 40, n).astype(np.int32), 0.2),
        "d": nulls(np.round(rng.uniform(0, 100, n), 1), 0.05),
        "s": nulls(np.array(["x", "yy", "zzz", "a", ""])[
            rng.integers(0, 5, n)], 0.3),
        "dt": pa.array(rng.integers(9000, 10000, n).astype(np.int32),
                       mask=rng.random(n) < 0.15).cast(pa.date32()),
        "allnull": pa.nulls(n, pa.float64()),
        "plain_d": nulls(rng.normal(size=n), 0.1),
    })
    d = tmp_path_factory.mktemp("edge")
    path = os.path.join(str(d), "edge.parquet")
    pq.write_table(t, path, row_group_size=1100, data_page_size=512,
                   write_batch_size=64,
                   use_dictionary=[c for c in t.column_names
                                   if c != "plain_d"])
    return path


@pytest.fixture(scope="module")
def edge_pairs(edge_file):
    return _column_pairs(edge_file)


def test_edge_file_is_multipage(edge_file):
    from spark_rapids_tpu_torch.io import parquet_native as PN
    md = pq.ParquetFile(edge_file).metadata
    assert md.num_row_groups == 3
    chunk = PN.read_chunk_pages(edge_file, 0, 0, md=md)
    assert len(chunk.index_segments) > 1
    with pytest.raises(NotImplementedError):
        PN.read_chunk_pages(edge_file, 0, md.num_columns - 1, md=md)


@pytest.mark.parametrize("column", ["i64", "i32", "d", "s", "dt", "allnull",
                                    "plain_d"])
def test_edge_column_matches_jax(edge_pairs, column):
    pairs = edge_pairs[column]
    assert len(pairs) == 3   # one batch per row group
    for jc, tc in pairs:
        _assert_column_equal(column, jc, tc)


def test_uncompressed_file_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    t = pa.table({"k": pa.array(np.array(["p", "q", "r"])[
        rng.integers(0, 3, 500)]), "v": rng.integers(0, 9, 500)})
    path = str(tmp_path / "u.parquet")
    pq.write_table(t, path, compression="NONE", data_page_size=256,
                   write_batch_size=32)
    for name, pairs in _column_pairs(path).items():
        for jc, tc in pairs:
            _assert_column_equal(name, jc, tc)
