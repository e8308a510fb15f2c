"""The port's native parquet chunk scanner (``spark_rapids_tpu_torch/native``)
held against the JAX package's page parser and the port's plain versions, on
files written from the same numpy-seeded table in UNCOMPRESSED, SNAPPY, GZIP
and ZSTD, with v1 and v2 data pages of 20,000 and 4,096 bytes, two row
groups each. The table has nulls, a one-entry dictionary, a sorted
low-cardinality column, a column of short repeats (RLE runs between
bit-packed runs), a long-string dictionary, an all-null column and one
column written without a dictionary (out of the scanner's scope on both
sides). pyarrow writes a one-entry dictionary at bit width 1, so pages at
bit width 0 (an RLE run with no value bytes, a bit-packed run with no
bytes) are written by hand.

- ``read_chunk_pages`` equals the reference's
  ``spark_rapids_tpu.io.parquet_native.read_chunk_pages`` page for page (def
  levels, bit widths, runs, values offsets, page bytes, dictionary). The
  reference is run through its Python parser (its native call is made to
  refuse), which is the reference's specification of its own scanner and
  which builds nothing inside the JAX package;
- ``pack_chunk``'s buffer equals ``pack_chunk_plain`` over the port's
  Python parse bit for bit, and ``decode_hybrid`` equals the reference's
  ``decode_rle_host`` at every bit width;
- a malformed chunk raises and is never parsed in Python; a failed build or
  a missing compiler raises; four threads scanning one chunk at once agree;
  two processes building at once leave one whole library.

Tolerance: exact everywhere.
"""

import concurrent.futures as futures
import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.native as JN
from spark_rapids_tpu.io import parquet_native as JPN
from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch.io import parquet_native as PN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ["NONE", "SNAPPY", "GZIP", "ZSTD"]
VERSIONS = ["1.0", "2.0"]
PAGE_BYTES = [20_000, 4_096]
CASES = [(c, v, p) for c in CODECS for v in VERSIONS for p in PAGE_BYTES]
CASE_IDS = [f"{c}-v{v[0]}-{p}" for c, v, p in CASES]
ROWS = 30_000


def _table() -> pa.Table:
    rng = np.random.default_rng(20261017)
    n = ROWS

    def nulls(a, frac):
        return pa.array(a, mask=rng.random(n) < frac)
    k = n // 8
    bursts = np.repeat(rng.integers(0, 50, k), rng.integers(1, 20, k))[:n]
    pool = np.array(["".join(chr(97 + c) for c in rng.integers(0, 26, ln))
                     for ln in rng.integers(100, 300, 200)])
    return pa.table({
        "i32": nulls(rng.integers(0, 300, n).astype(np.int32), 0.1),
        "i64": nulls(rng.integers(-10**12, 10**12, 700)[
            rng.integers(0, 700, n)], 0.02),
        "one": pa.array(np.full(n, 7, np.int64)),
        "sorted": pa.array(np.sort(rng.integers(0, 12, n)).astype(np.int32)),
        "bursts": nulls(np.resize(bursts, n).astype(np.int64), 0.05),
        "d": nulls(np.round(rng.uniform(0, 100, n), 1), 0.05),
        "s": nulls(np.array(["x", "yy", "zzz", "a", ""])[
            rng.integers(0, 5, n)], 0.3),
        "long_s": pa.array(pool[rng.integers(0, 200, n)]),
        "allnull": pa.nulls(n, pa.float64()),
        "plain": rng.normal(size=n),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    t = _table()
    d = tmp_path_factory.mktemp("native_scan")
    out = {}
    for codec, version, page in CASES:
        path = os.path.join(str(d), f"{codec}-{version}-{page}.parquet")
        pq.write_table(t, path, compression=codec, data_page_version=version,
                       data_page_size=page, row_group_size=ROWS // 2,
                       use_dictionary=[c for c in t.column_names
                                       if c != "plain"])
        out[(codec, version, page)] = path
    return out


def _chunks(path):
    md = pq.ParquetFile(path).metadata
    return md, [(rg, ci) for rg in range(md.num_row_groups)
                for ci in range(md.num_columns)]


@pytest.fixture
def reference_python_parser(monkeypatch):
    """The reference's read_chunk_pages through its Python parser."""
    def refuse(*a, **k):
        raise JN.NativeBuildError("the reference's Python parser")
    monkeypatch.setattr(JN, "scan_chunk_native", refuse)


def _assert_same_pages(got, want, where):
    assert got.physical_type == want.physical_type, where
    assert got.num_values == want.num_values, where
    if isinstance(want.dict_values, list):
        assert got.dict_values == want.dict_values, where
    else:
        assert got.dict_values.dtype == want.dict_values.dtype, where
        np.testing.assert_array_equal(got.dict_values, want.dict_values,
                                      err_msg=where)
    assert len(got.index_segments) == len(want.index_segments), where
    for i, (g, w) in enumerate(zip(got.index_segments, want.index_segments)):
        nv, dl, bw, page_bytes, values_off, segs = g
        assert (nv, bw, values_off) == (w[0], w[2], w[4]), (where, i)
        assert bytes(page_bytes) == bytes(w[3]), (where, i)
        np.testing.assert_array_equal(dl, w[1], err_msg=f"{where} page {i}")
        assert [tuple(s) for s in segs] == [tuple(s) for s in w[5]], \
            (where, i)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scanner_matches_reference_page_for_page(files, case,
                                                 reference_python_parser):
    path = files[case]
    md, chunks = _chunks(path)
    refused = 0
    PN.reset_routes()
    for rg, ci in chunks:
        where = f"{case} rg {rg} column {md.schema.column(ci).path}"
        try:
            want = JPN.read_chunk_pages(path, rg, ci, md=md)
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                PN.read_chunk_pages(path, rg, ci, md=md)
            refused += 1
            continue
        _assert_same_pages(PN.read_chunk_pages(path, rg, ci, md=md), want,
                           where)
    # the column written without a dictionary, in each row group
    assert refused == 2
    scanned = len(chunks) - refused
    native = "native_chunk" if case[:2] == ("NONE", "1.0") else "native_pages"
    assert PN.routes == {"native_chunk": 0, "native_pages": 0, "arrow": 0,
                         "python": 0, native: scanned}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_pack_chunk_equals_the_python_route(files, case):
    """pack_chunk over the native scan, bit for bit pack_chunk_plain over the
    Python parse (decode_rle_host for the pages with RLE runs), at a
    capacity past the rows; the fixture's pages hold both kinds."""
    path = files[case]
    md, chunks = _chunks(path)
    kinds = set()
    for rg, ci in chunks:
        try:
            plain = PN.read_chunk_pages_plain(path, rg, ci, md=md)
        except NotImplementedError:
            continue
        got = PN.read_chunk_pages(path, rg, ci, md=md)
        _assert_same_pages(got, plain, f"{case} {rg} {ci}")
        _st, _want, _d, dictionary, _sd = PN.chunk_column(got, None)
        cap = 1 << 15
        a = PN.pack_chunk(got, dictionary, cap)
        b = PN.pack_chunk_plain(plain, dictionary, cap)
        assert a[1:] == b[1:]
        assert torch.equal(a.buf, b.buf), (case, rg, ci)
        kinds |= {int(r[4]) for r in a.buf[:8 * a.num_pages].view(-1, 8)}
    assert 32 in kinds and len(kinds) > 2     # decoded pages and packed ones


@pytest.mark.parametrize("bw", list(range(1, 33)))
def test_decode_hybrid_equals_decode_rle_host(bw):
    """Random hybrid streams (RLE runs and bit-packed groups, a last group
    cut short) at every bit width, against the reference's decode_rle_host;
    values past the stream's end are zero."""
    rng = np.random.default_rng(bw)
    out, total = bytearray(b"\x00\x00\x00"), 0
    for _ in range(60):
        if rng.random() < 0.5:
            run = int(rng.integers(1, 40))
            v = int(rng.integers(0, 1 << min(bw, 31)))
            out += _varint(run << 1) + v.to_bytes((bw + 7) // 8, "little")
            total += run
        else:
            groups = int(rng.integers(1, 9))
            vals = rng.integers(0, 1 << min(bw, 31), 8 * groups).astype(
                np.uint64)
            bits = (vals[:, None] >> np.arange(bw, dtype=np.uint64)) & 1
            out += _varint((groups << 1) | 1) + np.packbits(
                bits.astype(np.uint8).reshape(-1), bitorder="little").tobytes()
            total += 8 * groups
    page = bytes(out)
    want = JPN.decode_rle_host(page, 3, len(page), bw, total - 5)
    np.testing.assert_array_equal(N.decode_hybrid(page, 3, bw, total - 5),
                                  want)
    got = N.decode_hybrid(page, 3, bw, total + 100)
    np.testing.assert_array_equal(got[:total], JPN.decode_rle_host(
        page, 3, len(page), bw, total))
    assert not got[total:].any()


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b, x = x & 0x7F, x >> 7
        out.append(b | 0x80 if x else b)
        if not x:
            return bytes(out)


def _v1_page(def_levels: np.ndarray, bw: int, runs: list) -> bytes:
    """A v1 data page body: def levels (bit width 1, behind their 4-byte
    length) as bit-packed groups, the bit-width byte, then the runs: ("rle",
    count, value) or ("packed", groups, values)."""
    dl = np.zeros(-(-len(def_levels) // 8) * 8, np.uint8)
    dl[:len(def_levels)] = def_levels
    levels = _varint((len(dl) // 8 << 1) | 1) + np.packbits(
        dl, bitorder="little").tobytes()
    out = bytearray(len(levels).to_bytes(4, "little") + levels + bytes([bw]))
    for kind, count, value in runs:
        if kind == "rle":
            out += _varint(count << 1) + int(value).to_bytes((bw + 7) // 8,
                                                             "little")
        else:
            bits = (np.asarray(value, np.uint64)[:, None]
                    >> np.arange(bw, dtype=np.uint64)) & 1
            out += _varint((count << 1) | 1) + np.packbits(
                bits.astype(np.uint8).reshape(-1), bitorder="little").tobytes()
    return bytes(out)


def test_one_entry_dictionary_at_bit_width_0():
    """Pages of a one-entry dictionary at bit width 0 (an RLE run, and a
    bit-packed run with no bytes) beside a page at bit width 5 with nulls:
    the native page scan equals the reference's Python parse of the same
    bodies, and pack_chunk equals pack_chunk_plain (every index 0)."""
    rng = np.random.default_rng(0)
    pages = []
    for bw, dl, runs in (
            (0, np.ones(40, np.int32), [("rle", 40, 0)]),
            (0, (rng.random(64) < 0.7).astype(np.int32), [("packed", 8, [])]),
            (5, (rng.random(50) < 0.8).astype(np.int32),
             [("rle", 9, 3), ("packed", 5, rng.integers(0, 32, 40)),
              ("rle", 1, 30)])):
        pages.append((_v1_page(dl, bw, runs), dl))
    body = b"".join(p for p, _dl in pages)
    descs, at = [], 0
    for page, dl in pages:
        descs.append((1, len(dl), at, len(page), 0, 0))
        at += len(page)
    n = sum(len(dl) for _p, dl in pages)
    scanned = PN.ScannedPages(np.frombuffer(body, np.uint8), *N.scan_pages(
        np.frombuffer(body, np.uint8), np.asarray(descs), 1, n))
    want = []
    for page, dl in pages:
        (dl_len,) = np.frombuffer(page[:4], "<u4")
        levels = JPN.decode_rle_host(page, 4, 4 + int(dl_len), 1, len(dl))
        np.testing.assert_array_equal(levels, dl)
        p = 4 + int(dl_len)
        want.append((len(dl), levels, page[p], page, p, JPN.parse_rle_hybrid(
            page, p + 1, len(page), page[p], int(levels.sum()))))
    assert [w[2] for w in want] == [0, 0, 5]
    got = PN.ChunkPages("INT64", np.array([42], "<i8"), scanned, n)
    _assert_same_pages(got, JPN.ChunkPages("INT64", np.array([42], "<i8"),
                                           want, n), "bit width 0")
    dictionary = torch.tensor([42], dtype=torch.int64)
    a = PN.pack_chunk(got, dictionary, 256)
    b = PN.pack_chunk_plain(PN.ChunkPages("INT64", np.array([42], "<i8"),
                                          list(scanned), n), dictionary, 256)
    assert a[1:] == b[1:] and torch.equal(a.buf, b.buf)
    words, table, defs, dic = PN.chunk_views(a.buf, a, torch.int64)
    assert table[:2, 4].tolist() == [32, 32]
    assert not words[:int(table[1, 2] + table[1, 3])].any()


def _corrupt_first_header(src: str, dst: str, column: int) -> None:
    """Copy ``src`` with the first page header of ``column``'s first chunk
    overwritten by 0xFF bytes (a thrift field of an unknown type)."""
    col = pq.ParquetFile(src).metadata.row_group(0).column(column)
    start = col.dictionary_page_offset or col.data_page_offset
    raw = bytearray(open(src, "rb").read())
    raw[start:start + 4] = b"\xff" * 4
    with open(dst, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("codec", ["NONE", "SNAPPY"])
def test_malformed_chunk_raises_and_is_never_parsed_in_python(
        files, tmp_path, monkeypatch, codec):
    bad = str(tmp_path / "bad.parquet")
    _corrupt_first_header(files[(codec, "1.0", 4096)], bad, 0)

    def no_python(*a, **k):
        raise AssertionError("the Python parser ran")
    monkeypatch.setattr(PN, "parse_page_header", no_python)
    monkeypatch.setattr(PN, "parse_rle_hybrid", no_python)
    monkeypatch.setattr(PN, "decode_rle_host", no_python)
    PN.reset_routes()
    with pytest.raises(ValueError, match="malformed"):
        PN.read_chunk_pages(bad, 0, 0)
    # the scan fails with it: no arrow fallback for a malformed chunk
    with pytest.raises(ValueError, match="malformed"):
        PN.read_row_group_device(bad, 0, None, "cpu", ["i32"])
    assert PN.routes == {"native_chunk": 0, "native_pages": 0, "arrow": 0,
                         "python": 0}


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(N, "_LIBS", {})
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))


def test_failed_build_raises(files, tmp_path, monkeypatch):
    broken = tmp_path / "parquet_host.cpp"
    broken.write_text("extern \"C\" int sr_scan_chunk( { not c++ }\n")
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(N, "SOURCE", str(broken))
    path = files[("SNAPPY", "1.0", 4096)]
    with pytest.raises(N.NativeBuildError, match="error"):
        PN.read_chunk_pages(path, 0, 0)
    with pytest.raises(N.NativeBuildError):
        PN.read_row_group_device(path, 0, None, "cpu", ["i32"])
    assert not os.listdir(tmp_path / "build")      # no partial library


def test_missing_compiler_raises(files, tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(N, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(N.NativeBuildError, match="no-such-compiler"):
        PN.read_chunk_pages(files[("NONE", "1.0", 4096)], 0, 0)


def test_four_threads_scan_one_chunk_alike(files):
    path = files[("ZSTD", "2.0", 4096)]
    md = pq.ParquetFile(path).metadata
    ci = [md.schema.column(i).path for i in range(md.num_columns)].index(
        "bursts")

    def scan(_):
        chunk = PN.read_chunk_pages(path, 1, ci, md=md)
        _st, _w, _d, dictionary, _sd = PN.chunk_column(chunk, None)
        return PN.pack_chunk(chunk, dictionary, 1 << 14).buf
    want = scan(0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(scan, range(64), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 64 and all(torch.equal(g, want) for g in got)


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    build = str(tmp_path / "build")
    code = textwrap.dedent(f"""
        from spark_rapids_tpu_torch import native as N
        print(N.build_library(N.SOURCE, {build!r}))
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert os.listdir(build) == [os.path.basename(outs[0][0].strip())]
    assert outs[0][0] == outs[1][0]
    lib = ctypes.CDLL(outs[0][0].strip())
    lib.sr_decode_hybrid.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p]
    lib.sr_decode_hybrid.restype = ctypes.c_int64
    got = np.zeros(4, np.int32)
    # one RLE run of 3 values of 5 at bit width 3
    assert lib.sr_decode_hybrid(b"\x06\x05", 2, 0, 3, 4,
                                got.ctypes.data) == 3
    assert got.tolist() == [5, 5, 5, 0]
