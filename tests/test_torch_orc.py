"""The port's ORC scan (``io/orc_native.py``, ``ops/orc_decode.py``, the ORC
half of ``io/filescan.py``) held against the JAX package on the same files:

- ``read_meta`` (stripes, kinds, names, codec) on uncompressed, ZLIB and
  SNAPPY files, and its refusal of ZSTD;
- ``scan_rlev2`` over all four RLEv2 sub-encodings, run for run, with the
  reference's PATCHED_BASE goldens; ``decode_boolean_rle``;
  ``unpack_msb_device``/``zigzag_decode``/``decode_intv2_device``;
- ``read_stripe_device`` column for column (values and validity over the
  whole padded capacity, and the sorted dictionary) against the
  reference's, over integer, double and both string encodings, with nulls;
- ``TorchSession.read_orc`` against ``TpuSession.read_orc`` on compressed,
  multi-stripe files, with the device decode on and off, and the routes.

Tolerance: exact everywhere (integer bits, raw double bits, validity and
dictionaries).
"""

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.io import orc_native as JON
from spark_rapids_tpu.ops import orc_decode as JOD
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io import orc_native as ON
from spark_rapids_tpu_torch.ops import orc_decode as OD
from spark_rapids_tpu_torch.session import TorchSession

DEV = "spark.rapids.tpu.sql.orc.deviceDecode.enabled"


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(np.arange(n, dtype=np.int64)),              # delta
        "b": pa.array(rng.integers(-1 << 40, 1 << 40, n)),        # direct
        "c": pa.array(rng.integers(0, 1000, n), mask=rng.random(n) < 0.15),
        "d": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "e": pa.array(np.full(n, 42, dtype=np.int64)),            # repeat
        "i32": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "w": pa.array(rng.integers(-2**62, 2**62, n)),            # > 56 bits
        "s": pa.array([f"g{i % 9}" for i in range(n)],
                      mask=rng.random(n) < 0.1),
        "dt": pa.array(rng.integers(0, 20000, n).astype(np.int32))
        .cast(pa.date32()),                                       # arrow
    })


_SCHEMA = [("a", "LONG"), ("b", "LONG"), ("c", "LONG"), ("d", "DOUBLE"),
           ("e", "LONG"), ("i32", "INT"), ("w", "LONG"), ("s", "STRING"),
           ("dt", "DATE")]


def _schemas():
    return (T.StructType([T.StructField(n, getattr(T, t))
                          for n, t in _SCHEMA]),
            JT.StructType([JT.StructField(n, getattr(JT, t))
                           for n, t in _SCHEMA]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Uncompressed, ZLIB and SNAPPY files, several stripes each, direct
    and dictionary strings."""
    d = tmp_path_factory.mktemp("torch_orc")
    out = {}
    for i, (codec, dict_thr) in enumerate((("uncompressed", 0.0),
                                           ("zlib", 1.0),
                                           ("snappy", 1.0),
                                           ("snappy", 0.0))):
        t = _table(9000, i)
        p = str(d / f"t{i}_{codec}.orc")
        orc.write_table(t, p, compression=codec, stripe_size=64 * 1024,
                        dictionary_key_size_threshold=dict_thr)
        out[(codec, dict_thr)] = (p, t)
    return out


def test_read_meta_matches_reference(files):
    for p, t in files.values():
        m, jm = ON.read_meta(p), JON.read_meta(p)
        assert len(m.stripes) > 1
        assert m.compression == jm.compression
        assert m.column_kinds == jm.column_kinds
        assert m.column_names == jm.column_names == t.column_names
        assert [(s.offset, s.index_length, s.data_length, s.footer_length,
                 s.num_rows) for s in m.stripes] == \
            [(s.offset, s.index_length, s.data_length, s.footer_length,
              s.num_rows) for s in jm.stripes]


def test_read_meta_refuses_zstd(tmp_path):
    p = str(tmp_path / "z.orc")
    orc.write_table(_table(100, 0), p, compression="zstd")
    for mod in (ON, JON):
        with pytest.raises(NotImplementedError):
            mod.read_meta(p)


def _runs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[1] == y[1]
        if x[0] == "direct":
            assert x[2:] == y[2:]
        else:
            np.testing.assert_array_equal(x[2], y[2])


def test_rlev2_goldens_and_sub_encodings():
    # the ORC spec's PATCHED_BASE example (the reference's golden)
    buf = bytes([0x8e, 0x09, 0x2b, 0x21, 0x07, 0xd0, 0x1e, 0x00, 0x14,
                 0x70, 0x28, 0x32, 0x3c, 0x46, 0x50, 0x5a, 0xfc, 0xe8])
    runs = ON.scan_rlev2(buf, 0, len(buf), 10, True)
    assert [int(v) for v in runs[0][2]] == \
        [2030, 2000, 2020, 1000000, 2040, 2050, 2060, 2070, 2080, 2090]
    _runs_equal(runs, JON.scan_rlev2(buf, 0, len(buf), 10, True))
    # the reference's non-aligned patch width golden: 3 + 22 bits read at 26
    w, cnt, pw, pgw = 4, 6, 22, 3

    def pack(values, width):
        bits = "".join(format(v, f"0{width}b") for v in values)
        bits += "0" * (-len(bits) % 8)
        return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    patch = 0x2ABCDE
    buf = (bytes([0x80 | (3 << 1), cnt - 1, 21, ((pgw - 1) << 5) | 1, 100])
           + pack([1, 2, 3, 4, 5, 6], w)
           + pack([(3 << pw) | patch], ON._closest_fixed_bits(pgw + pw)))
    runs = ON.scan_rlev2(buf, 0, len(buf), cnt, True)
    assert [int(v) for v in runs[0][2]] == \
        [101, 102, 103, 100 + (4 | (patch << w)), 105, 106]
    _runs_equal(runs, JON.scan_rlev2(buf, 0, len(buf), cnt, True))
    # SHORT_REPEAT, DELTA (fixed and packed), DIRECT at 8 and 64 bits
    sr = bytes([0b00000001, 10])
    _runs_equal(ON.scan_rlev2(sr, 0, 2, 4, True),
                JON.scan_rlev2(sr, 0, 2, 4, True))
    assert list(ON.scan_rlev2(sr, 0, 2, 4, True)[0][2]) == [5, 5, 5, 5]
    delta_fixed = bytes([0xC0, 9, 2, 2])          # 10 values 1, 2, ...
    delta_packed = bytes([0xC2, 4, 4, 2, 0b01100101, 0b10000000])
    direct8 = bytes([0x4E, 3, 2, 4, 6, 8])
    direct64 = bytes([0x7E, 1]) + (2**64 - 3).to_bytes(8, "big") \
        + (5).to_bytes(8, "big")
    for buf, n in ((delta_fixed, 10), (delta_packed, 5), (direct8, 4),
                   (direct64, 2)):
        for signed in (True, False):
            _runs_equal(ON.scan_rlev2(buf, 0, len(buf), n, signed),
                        JON.scan_rlev2(buf, 0, len(buf), n, signed))
    assert [int(v) for v in ON.scan_rlev2(
        delta_fixed, 0, 4, 10, False)[0][2]] == list(range(2, 12))


def test_boolean_rle_matches_reference():
    rng = np.random.default_rng(7)
    assert list(ON.decode_boolean_rle(bytes([254, 0b10100000, 0b11000000]),
                                      12)) == [1, 0, 1, 0, 0, 0, 0, 0, 1, 1,
                                               0, 0]
    for n in (1, 7, 8, 100, 5000):
        # literal and repeat runs mixed
        body = bytearray()
        while len(body) < 40:
            if rng.random() < 0.5:
                body += bytes([int(rng.integers(0, 20)),
                               int(rng.integers(0, 256))])
            else:
                k = int(rng.integers(1, 9))
                body += bytes([256 - k]) + bytes(
                    rng.integers(0, 256, k).astype(np.uint8))
        np.testing.assert_array_equal(ON.decode_boolean_rle(bytes(body), n),
                                      JON.decode_boolean_rle(bytes(body), n))


@pytest.mark.parametrize("signed", [True, False])
def test_intv2_decode_ops_match_reference(signed):
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    cap = 4096
    packed = rng.integers(0, 256, 40000).astype(np.uint8)
    widths = rng.choice([0, 1, 3, 8, 13, 24, 32, 40, 48, 56], cap)
    offsets = np.cumsum(np.concatenate([[0], widths[:-1]])).astype(np.int64)
    const_mask = rng.random(cap) < 0.2
    const_vals = rng.integers(-2**62, 2**62, cap)
    got = OD.decode_intv2_device(
        torch.from_numpy(packed), torch.from_numpy(offsets),
        torch.from_numpy(widths.astype(np.int64)),
        torch.from_numpy(const_mask), torch.from_numpy(const_vals), signed,
        cap).numpy()
    want = np.asarray(JOD.decode_intv2_device(
        jnp.asarray(packed), jnp.asarray(offsets),
        jnp.asarray(widths.astype(np.int64)), jnp.asarray(const_mask),
        jnp.asarray(const_vals), signed, cap))
    np.testing.assert_array_equal(got, want)
    raw = rng.integers(-2**63, 2**63, cap, dtype=np.int64)
    np.testing.assert_array_equal(
        OD.zigzag_decode(torch.from_numpy(raw)).numpy(),
        np.asarray(JOD.zigzag_decode(jnp.asarray(raw))))


def _assert_batch_equal(got, want):
    assert got.num_rows == want.num_rows
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
        gd, wd = g.data.numpy(), np.asarray(w.data)
        if gd.dtype == np.float64:
            gd, wd = gd.view(np.int64), wd.view(np.int64)
        np.testing.assert_array_equal(gd, wd)
        if g.dictionary is not None or w.dictionary is not None:
            assert g.dictionary.to_pylist() == w.dictionary.to_pylist()


def test_read_stripe_device_matches_reference(files):
    schema, jschema = _schemas()
    ON.reset_routes()
    stripes = 0
    for p, _t in files.values():
        m, jm = ON.read_meta(p), JON.read_meta(p)
        for si in range(len(m.stripes)):
            got = ON.read_stripe_device(p, m, si, schema, "cpu")
            want = JON.read_stripe_device(p, jm, si, jschema)
            _assert_batch_equal(got, want)
            stripes += 1
    # DATE is outside the device scope: one arrow column a stripe
    assert ON.routes == {"device_columns": 8 * stripes,
                         "arrow_columns": stripes, "arrow_files": 0}


def test_string_encodings_on_the_device(files):
    """Both string encodings reach the device decoders (not the per-column
    arrow route): dictionary strings when pyarrow's threshold allows them,
    direct strings otherwise."""
    for (codec, thr), (p, _t) in files.items():
        m = ON.read_meta(p)
        si = m.stripes[0]
        with open(p, "rb") as f:
            f.seek(si.offset)
            raw = f.read(si.index_length + si.data_length + si.footer_length)
        rel = ON.StripeInfo()
        rel.index_length, rel.data_length = si.index_length, si.data_length
        rel.footer_length = si.footer_length
        _streams, encodings = ON._read_stripe_footer(raw, rel, m.compression)
        enc = encodings[m.column_names.index("s") + 1][0]
        assert enc == (ON.E_DICTIONARY_V2 if thr else ON.E_DIRECT_V2)


@pytest.mark.parametrize("key", [("zlib", 1.0), ("snappy", 0.0),
                                 ("uncompressed", 0.0)])
@pytest.mark.parametrize("decode", ["true", "false"])
def test_session_read_orc_matches_reference(files, key, decode):
    p, t = files[key]
    got = TorchSession({DEV: decode}, device="cpu").read_orc(p)
    want = TpuSession({DEV: decode}).read_orc(p)
    ON.reset_routes()
    g = got.collect()
    assert g.equals(want.collect())
    assert g.equals(t)
    n_stripes = len(ON.read_meta(p).stripes)
    if decode == "true":
        assert ON.routes == {"device_columns": 8 * n_stripes,
                             "arrow_columns": n_stripes, "arrow_files": 0}
    else:
        assert ON.routes == {"device_columns": 0, "arrow_columns": 0,
                             "arrow_files": 1}


def test_read_orc_zstd_and_pruned(tmp_path, files):
    """A ZSTD file goes through the arrow reader whole; a pruned scan reads
    only its query's columns, on both routes."""
    import spark_rapids_tpu_torch.functions as F
    t = _table(3000, 5)
    p = str(tmp_path / "z.orc")
    orc.write_table(t, p, compression="zstd")
    ON.reset_routes()
    spark = TorchSession({DEV: "true"}, device="cpu")
    assert spark.read_orc(p).collect().equals(t)
    assert ON.routes["arrow_files"] == 1 and ON.routes["device_columns"] == 0
    p2, t2 = files[("zlib", 1.0)]
    df = spark.read_orc(p2).filter(F.col("c") > F.lit(500)).select("s", "b")
    plan = df.physical_plan()
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    scan = plan
    while not isinstance(scan, FileSourceScanExec):
        scan = scan.children[0]
    assert scan.output.names == ["b", "c", "s"]
    got = df.collect()
    mask = np.asarray(t2["c"].fill_null(-1).to_numpy() > 500)
    assert got.column("s").to_pylist() == \
        [v for v, k in zip(t2["s"].to_pylist(), mask) if k]
