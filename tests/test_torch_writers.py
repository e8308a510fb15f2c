"""The port's writers (``io/writer.py``, ``io/parquet_write_native.py``,
``io/orc_write_native.py``, ``io/csv_write_native.py``) held against the
JAX package's on the same batches:

- each native writer's file for one batch of every port type with nulls (an
  all-null column and a zero-row batch too), under each codec, equals the
  reference writer's file byte for byte. The one field that differs: the
  parquet footer's ``created_by`` names the writer
  ("spark-rapids-tpu-torch native writer" against "spark-rapids-tpu native
  writer"), which also moves the footer length; the ORC and CSV files have
  no such field and are equal whole;
- pyarrow reads both files back equal to the source, and the parquet
  footer statistics (null count, min, max) are the source's;
- the job: the four modes, append without collision, the commit
  directories and ``_SUCCESS``, the file names, partitioned writes against
  the reference's, zero rows, the routes, and round trips through
  ``TorchSession``;
- failures: a failing native encoder and a missing codec raise, leave no
  file behind and write nothing through arrow.

Tolerance: exact (bytes, values, nulls and types).
"""

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.io import csv_write_native as JCW
from spark_rapids_tpu.io import orc_write_native as JOW
from spark_rapids_tpu.io import parquet_write_native as JPW

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import table_to_device
from spark_rapids_tpu_torch.io import csv_write_native as CW
from spark_rapids_tpu_torch.io import orc_write_native as OW
from spark_rapids_tpu_torch.io import parquet_write_native as PW
from spark_rapids_tpu_torch.io import writer as W
from spark_rapids_tpu_torch.session import TorchSession


def _source(n: int, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    cents = rng.integers(-10**6, 10**6, n)
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "l": pa.array(rng.integers(-2**62, 2**62, n)),
        "d": pa.array(rng.normal(0, 1e4, n), mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(["apple", "b,c", 'q"t', "zz", "ä€"], n),
                      mask=rng.random(n) < 0.1),
        "dt": pa.array(rng.integers(-5000, 30000, n).astype(np.int32),
                       mask=rng.random(n) < 0.1).cast(pa.date32()),
        "m": _dec(cents, rng.random(n) < 0.1, 7, 2),
        "w": _dec(rng.integers(-10**17, 10**17, n), rng.random(n) < 0.05,
                  18, 4),
        "z": pa.nulls(n, pa.int64()),
    })


def _dec(unscaled, nulls, p, s):
    words = np.zeros((len(unscaled), 2), np.int64)
    words[:, 0] = unscaled
    words[:, 1] = np.asarray(unscaled) >> 63
    mask = np.packbits(~nulls, bitorder="little")
    return pa.Array.from_buffers(pa.decimal128(p, s), len(unscaled),
                                 [pa.py_buffer(mask.tobytes()),
                                  pa.py_buffer(words.tobytes())])


def _batches(t: pa.Table):
    schema = T.StructType.from_arrow(t.schema)
    jschema = JT.StructType.from_arrow(t.schema)
    return (table_to_device(t, "cpu", schema=schema), schema,
            JBatch.from_arrow(t), jschema)


_REF_BY = b"spark-rapids-tpu native writer"


def _parquet_as_port(ref: bytes) -> bytes:
    """The reference's parquet file with the port's ``created_by``: the
    field's length byte and text, and the footer length that moves with
    them."""
    old = bytes([len(_REF_BY)]) + _REF_BY
    new = bytes([len(PW.CREATED_BY)]) + PW.CREATED_BY
    assert ref.count(old) == 1
    out = bytearray(ref.replace(old, new))
    flen = int.from_bytes(out[-8:-4], "little") + len(new) - len(old)
    out[-8:-4] = flen.to_bytes(4, "little")
    return bytes(out)


CASES = [(1000, 0), (1, 1), (0, 2), (3000, 3)]


@pytest.mark.parametrize("n,seed", CASES)
@pytest.mark.parametrize("codec", ["uncompressed", "gzip", "snappy"])
def test_parquet_file_matches_reference(tmp_path, n, seed, codec):
    t = _source(n, seed)
    b, schema, jb, jschema = _batches(t)
    p, jp = str(tmp_path / "p.parquet"), str(tmp_path / "j.parquet")
    nbytes = PW.write_batch_file(p, b, schema, codec)
    JPW.write_batch_file(jp, jb, jschema, codec)
    got, want = open(p, "rb").read(), open(jp, "rb").read()
    assert nbytes == len(got)
    assert got == _parquet_as_port(want)
    back = pq.read_table(p)
    assert back.equals(t) and pq.read_table(jp).equals(t)
    md, jmd = pq.ParquetFile(p).metadata, pq.ParquetFile(jp).metadata
    assert md.created_by == PW.CREATED_BY.decode()
    for ci in range(md.num_columns):
        st = md.row_group(0).column(ci).statistics
        jst = jmd.row_group(0).column(ci).statistics
        assert st.null_count == jst.null_count == t.column(ci).null_count
        assert st.has_min_max == jst.has_min_max
        col = t.column(ci)
        if st.has_min_max:
            assert st.min == jst.min and st.max == jst.max
            if not pa.types.is_boolean(col.type):
                mm = pc.min_max(col)
                assert st.min == mm["min"].as_py()
                assert st.max == mm["max"].as_py()


@pytest.mark.parametrize("n,seed", CASES)
@pytest.mark.parametrize("codec", ["none", "zlib", "snappy"])
def test_orc_file_matches_reference(tmp_path, n, seed, codec):
    t = _source(n, seed)
    b, schema, jb, jschema = _batches(t)
    p, jp = str(tmp_path / "o.orc"), str(tmp_path / "j.orc")
    nbytes = OW.write_batch_file(p, b, schema, codec)
    JOW.write_batch_file(jp, jb, jschema, codec)
    got = open(p, "rb").read()
    assert nbytes == len(got) and got == open(jp, "rb").read()
    assert orc.read_table(p).equals(t)


@pytest.mark.parametrize("n,seed", CASES)
def test_csv_file_matches_reference(tmp_path, n, seed):
    t = _source(n, seed)
    b, schema, jb, jschema = _batches(t)
    p, jp = str(tmp_path / "c.csv"), str(tmp_path / "j.csv")
    nbytes = CW.write_batch_file(p, b, schema)
    JCW.write_batch_file(jp, jb, jschema)
    got = open(p, "rb").read()
    assert nbytes == len(got) and got == open(jp, "rb").read()
    import pyarrow.csv as pcsv
    back = pcsv.read_csv(p, convert_options=pcsv.ConvertOptions(
        column_types=t.schema, strings_can_be_null=True,
        quoted_strings_can_be_null=False))
    # pyarrow reads an empty string field as null, as the writer wrote null
    assert back.equals(t) if n else back.num_rows == 0


def test_vectorized_decimal_varints_match_the_loop():
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.integers(-2**63, 2**63 - 1, 5000,
                                        dtype=np.int64),
                           [0, -1, 1, 63, 64, -64, -65, 2**63 - 1, -2**63]])
    want = b"".join(OW._pvarint((int(x) << 1) ^ (int(x) >> 63))
                    for x in vals.tolist())
    assert OW.zigzag_varints(vals) == want


@pytest.mark.parametrize("signed", [True, False])
def test_rlev2_packing_matches_the_shift_loop(signed):
    """``_pack_msb`` (big-endian images) and ``rlev2_direct`` against the
    reference's shift-and-mask packing, at every encodable width."""
    rng = np.random.default_rng(6)
    for w in OW._WIDTHS:
        for n in (1, 5, 300, 512):
            v = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
            if w < 64:
                v &= np.uint64((1 << w) - 1)
            assert OW._pack_msb(v, w) == JOW._pack_msb(v, w)
    for vals in (rng.integers(-2**63, 2**63 - 1, 3000, dtype=np.int64),
                 rng.integers(0, 100, 1300), np.zeros(0, np.int64)):
        if not signed:
            vals = np.abs(vals)
        assert OW.rlev2_direct(vals, signed) == JOW.rlev2_direct(vals, signed)


def _files(d):
    return sorted(f for f in os.listdir(d) if not f.startswith("_"))


@pytest.fixture
def src_dir(tmp_path):
    d = tmp_path / "src"
    d.mkdir()
    t = _source(600, 7)
    for i in range(3):
        pq.write_table(t.slice(200 * i, 200), str(d / f"part-{i}.parquet"))
    return str(d), t


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_session_round_trip(tmp_path, src_dir, fmt):
    d, t = src_dir
    spark = TorchSession(device="cpu")
    df = spark.read_parquet(sorted(os.path.join(d, f) for f in os.listdir(d)))
    out = str(tmp_path / "out")
    W.reset_routes()
    st = getattr(df, f"write_{fmt}")(out)
    assert W.routes == {"native_files": 3, "arrow_files": 0}
    assert (st.num_files, st.num_rows) == (3, 600)
    assert st.num_bytes == sum(os.path.getsize(os.path.join(out, f))
                               for f in _files(out))
    names = _files(out)
    assert os.listdir(out).count("_SUCCESS") == 1
    assert all(re.fullmatch(rf"part-0000{k}-[0-9a-f]{{12}}-0000\.{fmt}", f)
               for k, f in enumerate(names))
    # a read-back lists the files in task order: the source's rows in order
    if fmt == "parquet":
        back = spark.read_parquet(out).collect()
    elif fmt == "orc":
        back = spark.read_orc(out).collect()
    else:
        back = spark.read_csv(out, schema=T.StructType.from_arrow(
            t.schema)).collect()
    assert back.equals(t)


def test_modes_and_append(tmp_path, src_dir):
    d, t = src_dir
    spark = TorchSession(device="cpu")
    df = spark.read_parquet(d)          # one partition: one task
    out = str(tmp_path / "out")
    df.write_parquet(out)
    first = _files(out)
    with pytest.raises(FileExistsError):
        df.write_parquet(out)
    assert df.write_parquet(out, mode="ignore").num_files == 0
    assert _files(out) == first
    df.write_parquet(out, mode="append")
    assert len(_files(out)) == 2 * len(first) and set(first) < set(
        _files(out))
    assert spark.read_parquet(out).collect().num_rows == 2 * t.num_rows
    st = df.write_parquet(out, mode="overwrite")
    assert len(_files(out)) == st.num_files == len(first)
    assert set(_files(out)).isdisjoint(first)
    with pytest.raises(ValueError, match="save mode"):
        df.write_parquet(out, mode="overwrit")
    # no job leaves its temporary directory behind
    assert not [f for f in os.listdir(out) if f.startswith("_temporary")]


def test_commit_directories(tmp_path, src_dir, monkeypatch):
    """Tasks write under _temporary-<job>/task_<n>/ and rename on commit."""
    d, _t = src_dir
    spark = TorchSession(device="cpu")
    seen = []
    real = W._TaskWriter.commit

    def commit(self, final_dir):
        seen.append((os.path.relpath(self.temp, final_dir),
                     sorted(os.listdir(self.temp))))
        return real(self, final_dir)
    monkeypatch.setattr(W._TaskWriter, "commit", commit)
    out = str(tmp_path / "out")
    spark.read_parquet(sorted(os.path.join(d, f) for f in os.listdir(d))
                       ).write_orc(out)
    assert len(seen) == 3
    for rel, files in seen:
        assert re.fullmatch(r"_temporary-[0-9a-f]{12}/task_[0-2]", rel)
        assert len(files) == 1 and files[0].endswith(".orc")


def test_partitioned_write_matches_reference(tmp_path):
    """Dynamic partitioning through the arrow writer, against the
    reference's write_columnar on the same rows."""
    from spark_rapids_tpu.config import RapidsConf as JConf
    from spark_rapids_tpu.exec.basic import ArrowScanExec
    from spark_rapids_tpu.io.writer import write_columnar as jwrite
    t = pa.table({"k": pa.array([1, 2, 1, None, 2, 3], pa.int64()),
                  "s": pa.array(["x", "y", "x", "y", None, "x"]),
                  "v": pa.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0])})
    src = tmp_path / "src.parquet"
    pq.write_table(t, str(src))
    spark = TorchSession(device="cpu")
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    W.reset_routes()
    st = spark.read_parquet(str(src)).write_parquet(out,
                                                    partition_by=["k", "s"])
    jst = jwrite(ArrowScanExec([t], conf=JConf()), jout, "parquet",
                 partition_by=["k", "s"])
    assert st.partitions == jst.partitions == [
        "k=1/s=x", "k=2/s=y", "k=__HIVE_DEFAULT_PARTITION__/s=y",
        "k=2/s=__HIVE_DEFAULT_PARTITION__", "k=3/s=x"]
    assert W.routes == {"native_files": 0, "arrow_files": 5}
    assert (st.num_files, st.num_rows) == (jst.num_files, jst.num_rows)
    for part in st.partitions:
        [f] = _files(os.path.join(out, part))
        [jf] = _files(os.path.join(jout, part))
        assert pq.read_table(os.path.join(out, part, f)).equals(
            pq.read_table(os.path.join(jout, part, jf)))
    # read back through hive discovery (k=... directories with v)
    t2 = pa.table({"k": pa.array([3, 1, 3, 2], pa.int64()),
                   "v": pa.array([1.0, 2.0, 3.0, 4.0])})
    pq.write_table(t2, str(src))
    out2 = str(tmp_path / "out2")
    spark.read_parquet(str(src)).write_parquet(out2, partition_by=["k"])
    back = spark.read_parquet(out2).collect()
    assert sorted(zip(back["k"].to_pylist(), back["v"].to_pylist())) == \
        [(1, 2.0), (2, 4.0), (3, 1.0), (3, 3.0)]


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_zero_rows(tmp_path, fmt):
    t = _source(0)
    src = tmp_path / "src.parquet"
    pq.write_table(t, str(src))
    spark = TorchSession(device="cpu")
    out = str(tmp_path / "out")
    st = getattr(spark.read_parquet(str(src)), f"write_{fmt}")(out)
    assert os.path.exists(os.path.join(out, "_SUCCESS"))
    assert st.num_rows == 0
    for f in _files(out):
        p = os.path.join(out, f)
        n = (pq.read_table(p).num_rows if fmt == "parquet" else
             orc.read_table(p).num_rows if fmt == "orc" else
             len(open(p).read().splitlines()) - 1)
        assert n == 0


@pytest.mark.parametrize("writer_type", ["NATIVE", "ARROW"])
def test_writer_type_conf(tmp_path, src_dir, writer_type):
    d, t = src_dir
    spark = TorchSession({"spark.rapids.tpu.sql.format.orc.writer.type":
                          writer_type}, device="cpu")
    out = str(tmp_path / "out")
    W.reset_routes()
    spark.read_parquet(d).write_orc(out)
    key = "native_files" if writer_type == "NATIVE" else "arrow_files"
    assert W.routes[key] == 3 and sum(W.routes.values()) == 3
    assert orc.read_table([os.path.join(out, f) for f in _files(out)][0]) \
        .num_rows == 200


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_failing_encoder_raises(tmp_path, src_dir, monkeypatch, fmt):
    """A native encoder that fails aborts the job: no arrow rewrite, no
    file, no temporary directory; the error propagates."""
    d, _t = src_dir
    mod = {"parquet": PW, "orc": OW, "csv": CW}[fmt]
    name = "_format_column" if fmt == "csv" else "_encode_column"

    def broken(*a, **k):
        raise ValueError("encoder defect")
    monkeypatch.setattr(mod, name, broken)
    spark = TorchSession(device="cpu")
    out = str(tmp_path / "out")
    W.reset_routes()
    with pytest.raises(ValueError, match="encoder defect"):
        getattr(spark.read_parquet(d), f"write_{fmt}")(out)
    assert W.routes == {"native_files": 0, "arrow_files": 0}
    assert os.listdir(out) == []


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_missing_codec_raises(tmp_path, src_dir, monkeypatch, fmt):
    d, _t = src_dir
    monkeypatch.setattr(PW, "codec_available", lambda name: name != "snappy")
    spark = TorchSession(device="cpu")
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="snappy"):
        getattr(spark.read_parquet(d), f"write_{fmt}")(out)
    assert os.listdir(out) == []
