"""The context expressions of the PyTorch port on the CPU, held against the
JAX package: ``spark_partition_id()``, ``monotonically_increasing_id()``
and the input-file family (``input_file_name()``,
``input_file_block_start()``, ``input_file_block_length()``).

Three files of a numpy-seeded table, one partition each (and two files in
one partition), are read through every scan route of both packages: the
parquet device decode, the arrow reader (the device decode off), the ORC
device decode and the CSV device parse (their conf set, as on the CPU the
reference takes them only then). Each projection of the context
expressions is the reference's ``collect()`` bit for bit: the file's path
as the scan was given it, 0 and the file's size; ``(partition << 33) +
row``, the row counted over the partition's batches (several a file at a
small batch size); the partition. After an exchange the input-file family
gives ``""`` and -1 in both, Spark's contract, and so does the arrow route
over a partition of two files.

``group_by(input_file_name())`` groups by file in both. Spark's answers
the reference does not give, shown beside: a filter on
``monotonically_increasing_id()`` counts the rows of every batch before
(the reference restarts each batch at 0), and a keyless aggregate reads
the partition and row ids of the scan's partitions (the reference reads
them after its gather into one). The port computes an aggregate's context
expressions in a projection below it, as Spark's PullOutNondeterministic
does.

Tolerance: none (strings and integers, exact).
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pcsv
import pyarrow.orc as porc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.session import TorchSession

ROWS = (700, 1100, 900)


def _part(i, n):
    r = np.random.default_rng(40 + i)
    return pa.table({"a": pa.array(r.integers(0, 1000, n), pa.int64()),
                     "b": pa.array(r.integers(-50, 50, n), pa.int32())})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ctx")
    out = {}
    for fmt in ("parquet", "orc", "csv"):
        d = root / fmt
        d.mkdir()
        paths = []
        for i, n in enumerate(ROWS):
            t = _part(i, n)
            p = str(d / f"part-{i}.{fmt}")
            if fmt == "parquet":
                pq.write_table(t, p, row_group_size=256)
            elif fmt == "orc":
                porc.write_table(t, p, stripe_size=4096)
            else:
                pcsv.write_csv(t, p)
            paths.append(p)
        out[fmt] = paths
    return out


ROUTES = {
    "parquet device": ("parquet", {
        "spark.rapids.tpu.sql.parquet.deviceDecode.enabled": "true"}),
    "parquet arrow": ("parquet", {
        "spark.rapids.tpu.sql.parquet.deviceDecode.enabled": "false",
        "spark.rapids.tpu.sql.format.parquet.reader.type": "PERFILE",
        "spark.rapids.tpu.sql.reader.batchSizeRows": "300"}),
    "orc device": ("orc", {
        "spark.rapids.tpu.sql.orc.deviceDecode.enabled": "true"}),
    "csv device": ("csv", {
        "spark.rapids.tpu.sql.csv.deviceDecode.enabled": "true"}),
}


def _read(spark, fmt, paths):
    if fmt == "parquet":
        return spark.read_parquet(paths)
    if fmt == "orc":
        return spark.read_orc(paths)
    return spark.read_csv(paths)


def _sessions(conf):
    return TorchSession(dict(conf), device="cpu"), TpuSession(dict(conf))


def _ctx_cols(f):
    return [f.input_file_name().alias("f"),
            f.input_file_block_start().alias("s"),
            f.input_file_block_length().alias("l"),
            f.spark_partition_id().alias("p"),
            f.monotonically_increasing_id().alias("m"), "a"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_context_columns_match_reference(files, route):
    fmt, conf = ROUTES[route]
    port, ref = _sessions(conf)
    paths = files[fmt]
    got = _read(port, fmt, paths).select(*_ctx_cols(F)).collect()
    exp = _read(ref, fmt, paths).select(*_ctx_cols(JF)).collect()
    assert got.equals(exp)
    # the values Spark gives: each file's path, 0, its size; the partition;
    # the row's position in it
    rows = got.to_pylist()
    start = 0
    for i, n in enumerate(ROWS):
        part = rows[start:start + n]
        start += n
        assert {r["f"] for r in part} == {paths[i]}
        assert {(r["s"], r["l"]) for r in part} == {
            (0, os.path.getsize(paths[i]))}
        assert [r["p"] for r in part] == [i] * n
        assert [r["m"] for r in part] == [(i << 33) + j for j in range(n)]


@pytest.mark.parametrize("route", list(ROUTES))
def test_after_an_exchange_the_file_is_unknown(files, route):
    fmt, conf = ROUTES[route]
    port, ref = _sessions(conf)
    paths = files[fmt]

    def run(spark, f):
        return _read(spark, fmt, paths).repartition(2).select(
            f.input_file_name().alias("f"),
            f.input_file_block_start().alias("s"),
            f.input_file_block_length().alias("l")).collect()
    got, exp = run(port, F), run(ref, JF)
    assert got.equals(exp)
    assert set(zip(*(got.column(c).to_pylist() for c in "fsl"))) == {
        ("", -1, -1)}
    assert got.num_rows == sum(ROWS)


def test_arrow_route_over_two_files_in_a_partition(files):
    """A partition of two files on the arrow reader: the strategies may
    stitch files, so neither package names one (Spark's contract for a
    coalescing read)."""
    conf = ROUTES["parquet arrow"][1]
    port, ref = _sessions(conf)
    paths = files["parquet"]

    def run(spark, f):
        return spark.read_parquet(paths[:2], files_per_partition=2).select(
            f.input_file_name().alias("f"), f.spark_partition_id().alias(
                "p"), f.monotonically_increasing_id().alias("m")).collect()
    got, exp = run(port, F), run(ref, JF)
    assert got.column("f").to_pylist() == exp.column("f").to_pylist() == [
        ""] * (ROWS[0] + ROWS[1])
    assert got.equals(exp)


def test_partition_id_over_range_and_union(files):
    port, ref = _sessions({})
    got = port.range(0, 40, num_slices=4).select(
        "id", F.spark_partition_id().alias("p"),
        F.monotonically_increasing_id().alias("m")).collect()
    exp = ref.range(0, 40, num_slices=4).select(
        "id", JF.spark_partition_id().alias("p"),
        JF.monotonically_increasing_id().alias("m")).collect()
    assert got.equals(exp)
    assert got.column("p").to_pylist() == [i // 10 for i in range(40)]


def test_gap_filter_on_the_row_id_counts_every_batch(files):
    """The device decode gives a batch a row group (256 rows here): Spark
    counts the partition's rows across them, the reference's filter
    restarts at 0 in every batch."""
    conf = ROUTES["parquet device"][1]
    port, ref = _sessions(conf)
    paths = files["parquet"]

    def run(spark, f):
        return spark.read_parquet(paths).filter(
            f.monotonically_increasing_id() % (1 << 33) == 300).select(
            "a", f.spark_partition_id().alias("p")).collect()
    got, exp = run(port, F), run(ref, JF)
    # the 301st row of the files of 1100 rows
    assert got.column("p").to_pylist() == [0, 1, 2]
    assert got.column("a").to_pylist() == [
        _part(i, n).column("a")[300].as_py() for i, n in enumerate(ROWS)]
    # the reference's count restarts at every 256-row batch: no row
    # reaches 300
    assert exp.num_rows == 0


def test_group_by_input_file_name(files):
    """One group a file, as in Spark and the reference (the port computes
    the key in a projection below the aggregate)."""
    conf = ROUTES["parquet device"][1]
    port, ref = _sessions(conf)
    paths = files["parquet"]
    got = port.read_parquet(paths).group_by(
        F.input_file_name().alias("f")).count().order_by("f").collect()
    assert got.to_pylist() == [{"f": p, "count": n}
                               for p, n in zip(paths, ROWS)]
    plan = port.read_parquet(paths).group_by(
        F.input_file_name().alias("f")).count().explain()
    assert "input_file_name() AS _ctx0" in plan
    exp = ref.read_parquet(paths).group_by(
        JF.input_file_name().alias("f")).count().order_by("f").collect()
    assert got.equals(exp)


def test_gap_keyless_aggregate_of_partition_ids(files):
    """A keyless aggregate gathers its partitions into one; Spark reads
    the partition ids and row ids below the gather (PullOutNondeterministic),
    the reference reads them after it."""
    conf = ROUTES["parquet device"][1]
    port, ref = _sessions(conf)
    paths = files["parquet"]
    got = port.read_parquet(paths).agg(
        F.sum(F.spark_partition_id()).alias("sp"),
        F.max(F.monotonically_increasing_id()).alias("mx")).collect()
    assert got.to_pylist() == [{"sp": ROWS[1] + 2 * ROWS[2],
                                "mx": (2 << 33) + ROWS[2] - 1}]
    exp = ref.read_parquet(paths).agg(
        JF.sum(JF.spark_partition_id()).alias("sp"),
        JF.max(JF.monotonically_increasing_id()).alias("mx")).collect()
    assert exp.to_pylist() != got.to_pylist()


def test_context_expressions_refused_outside_project_filter_aggregate(files):
    port, _ = _sessions({})
    df = port.read_parquet(files["parquet"])
    for bad in (df.sort(F.monotonically_increasing_id()),
                df.repartition(2, F.input_file_name()),
                df.window([F.alias(F.over(F.row_number(), [],
                                          [F.spark_partition_id()]), "r")])):
        with pytest.raises(NotImplementedError, match="select it"):
            bad.physical_plan()
