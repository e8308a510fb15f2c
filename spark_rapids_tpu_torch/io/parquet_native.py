"""Native parquet page access: the host scan of a column chunk, and its
bulk index decode on the device.

Counterpart of ``spark_rapids_tpu/io/parquet_native.py``. The native scanner
(``native/parquet_host.cpp``, one C call per chunk, built with g++ at first
use) walks the thrift page headers, decodes the def levels and splits every
page's RLE/bit-packed hybrid stream into runs: an UNCOMPRESSED chunk of v1
pages in one ``sr_scan_chunk`` call, as the reference does; a SNAPPY / GZIP /
ZSTD chunk, or one of v2 data pages, through the native header walk, arrow's
codec per page body and one native page scan. ``pack_chunk`` then lays the
chunk out in one buffer (the native scanner writes its page table and index
words), which crosses to the card in one copy, where one ``chunk_decode``
launch (``ops/cuda_kernels.py``) unpacks the indices, gathers the dictionary
values and spreads them over the null layout. The parquet dictionary page
maps 1:1 onto the engine's sorted string dictionary, so a string column never
materializes per-row bytes. ``routes`` counts the chunks each route took.

The reference's Python page parser stays here as the plain version
(``read_chunk_pages_plain``, ``pack_chunk_plain``), which the tests hold the
scanner against; no path of the package calls it, and nothing falls back to
it: a scanner that cannot be built fails the scan.

Scope: RLE_DICTIONARY-encoded data pages (v1 and v2), flat schemas, physical
types INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY. Anything else (for example a
dictionary that overflowed to PLAIN pages, or an unported codec) falls back
to the arrow decode per column chunk. Every chunk is decoded at the scan;
uploading pages encoded is not ported yet.
"""

from __future__ import annotations

import struct
import threading
import typing

import numpy as np
import torch


# -- thrift compact protocol (just enough for PageHeader) --------------------

class _CompactReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def skip_binary(self):
        # NB: two statements — `self.pos += self.varint()` would load the
        # pre-varint pos before the call mutates it
        n = self.varint()
        self.pos += n

    def read_struct(self) -> dict:
        """Generic struct → {field_id: value}; nested structs recurse, lists
        and binaries are skipped (we never need them in page headers)."""
        out = {}
        fid = 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            delta = head >> 4
            ftype = head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            if ftype in (1, 2):            # BOOLEAN_TRUE / BOOLEAN_FALSE
                out[fid] = ftype == 1
            elif ftype == 3:               # byte
                out[fid] = self.byte()
            elif ftype in (4, 5, 6):       # i16/i32/i64
                out[fid] = self.zigzag()
            elif ftype == 7:               # double
                out[fid] = struct.unpack_from("<d", self.buf, self.pos)[0]
                self.pos += 8
            elif ftype == 8:               # binary/string
                self.skip_binary()
            elif ftype == 12:              # struct
                out[fid] = self.read_struct()
            elif ftype in (9, 10):         # list/set: skip elements
                sz_type = self.byte()
                n = sz_type >> 4
                if n == 15:
                    n = self.varint()
                et = sz_type & 0x0F
                for _ in range(n):
                    if et in (4, 5, 6):
                        self.zigzag()
                    elif et == 8:
                        self.skip_binary()
                    elif et == 12:
                        self.read_struct()
                    elif et == 3:
                        self.byte()
                    elif et == 7:
                        self.pos += 8
                    else:
                        raise NotImplementedError(f"thrift list elem {et}")
            else:
                raise NotImplementedError(f"thrift compact type {ftype}")


class PageHeader(typing.NamedTuple):
    page_type: int            # 0=data, 2=dictionary, 3=data v2
    uncompressed_size: int
    compressed_size: int
    num_values: int
    encoding: int             # 8=RLE_DICTIONARY(PLAIN_DICT=2), 0=PLAIN
    header_len: int
    # v2 only: level-section byte lengths (levels are NEVER compressed) and
    # whether the values section is compressed
    def_len: int = 0
    rep_len: int = 0
    v2_compressed: bool = True


def parse_page_header(buf: bytes, pos: int) -> PageHeader:
    r = _CompactReader(buf, pos)
    d = r.read_struct()
    ptype = d[1]
    dl = rl = 0
    v2c = True
    if ptype == 0:      # DataPageHeader (field 5)
        dph = d.get(5, {})
        nv, enc = dph.get(1, 0), dph.get(2, 0)
    elif ptype == 2:    # DictionaryPageHeader (field 7)
        dph = d.get(7, {})
        nv, enc = dph.get(1, 0), dph.get(2, 0)
    elif ptype == 3:    # DataPageHeaderV2 (field 8)
        dph = d.get(8, {})
        nv, enc = dph.get(1, 0), dph.get(4, 0)
        dl, rl = dph.get(5, 0), dph.get(6, 0)
        v2c = bool(dph.get(7, 1))
    else:
        nv, enc = 0, 0
    return PageHeader(ptype, d[2], d[3], nv, enc, r.pos - pos, dl, rl, v2c)


# -- RLE / bit-packed hybrid structure ---------------------------------------

class RleSegment(typing.NamedTuple):
    kind: str          # "rle" | "packed"
    count: int         # decoded value count
    value: int         # rle: the repeated value
    byte_off: int      # packed: offset of packed bytes in the stream
    byte_len: int


def parse_rle_hybrid(buf: bytes, pos: int, end: int, bit_width: int,
                     total: int) -> list[RleSegment]:
    """Split an RLE/bit-packed hybrid stream into segments. Headers are
    varints (metadata); packed payload bytes are NOT touched here — the
    device unpacks them."""
    r = _CompactReader(buf, pos)
    segs: list[RleSegment] = []
    got = 0
    vbytes = (bit_width + 7) // 8
    while got < total and r.pos < end:
        h = r.varint()
        if h & 1:
            groups = h >> 1
            n = groups * 8
            blen = groups * bit_width  # bytes: 8 values * bw bits / 8
            segs.append(RleSegment("packed", min(n, total - got), 0,
                                   r.pos, blen))
            r.pos += blen
        else:
            run = h >> 1
            v = int.from_bytes(buf[r.pos:r.pos + vbytes], "little") \
                if vbytes else 0
            r.pos += vbytes
            segs.append(RleSegment("rle", min(run, total - got), v, 0, 0))
        got += segs[-1].count
    return segs


def decode_rle_host(buf: bytes, pos: int, end: int, bit_width: int,
                    total: int) -> np.ndarray:
    """Host (numpy-vectorized) hybrid decode — def levels and fallback path."""
    out = np.empty(total, dtype=np.int32)
    at = 0
    for seg in parse_rle_hybrid(buf, pos, end, bit_width, total):
        if seg.kind == "rle":
            out[at:at + seg.count] = seg.value
        else:
            bits = np.unpackbits(
                np.frombuffer(buf, np.uint8, seg.byte_len, seg.byte_off),
                bitorder="little")
            vals = bits.reshape(-1, bit_width)[:seg.count]
            out[at:at + seg.count] = (
                vals.astype(np.int32) * (1 << np.arange(bit_width,
                                                        dtype=np.int32))
            ).sum(axis=1)
        at += seg.count
    return out


# -- column chunk reading -----------------------------------------------------

class ChunkPages(typing.NamedTuple):
    physical_type: str
    dict_values: np.ndarray | list      # decoded PLAIN dictionary (host)
    index_segments: typing.Any          # the data pages: ScannedPages (the
                                        #   native scan), or a list of
                                        #   (num_values, def_levels, bit_width,
                                        #   page bytes, values_off, segments)
    num_values: int


class ScannedPages:
    """The data pages of one column chunk as the native scanner returns
    them: ``body`` (uint8) holds every page's bytes, ``pages`` one
    ``native.PAGE_FIELDS`` row a page (offsets into ``body``), ``segs`` one
    ``native.SEG_FIELDS`` row a run (offsets relative to its page), and
    ``def_levels`` (int32) the chunk's def levels in page order. Indexing
    and iteration give the reference's per-page tuples ``(num_values, def
    levels, bit width, page bytes, values_off, [RleSegment])``, built on
    demand (the tests and the per-page route read them; the scan packs the
    arrays)."""

    __slots__ = ("body", "pages", "segs", "def_levels")

    def __init__(self, body, pages, segs, def_levels):
        self.body = body
        self.pages = pages
        self.segs = segs
        self.def_levels = def_levels

    def __len__(self) -> int:
        return int(self.pages.shape[0])

    def __getitem__(self, i: int):
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        (nv, def_off, _n_present, bw, body_off, body_len, values_off,
         seg_off, seg_count) = (int(v) for v in self.pages[i])
        segs = [RleSegment("packed" if k == 1 else "rle", int(c), int(v),
                           int(bo), int(bl))
                for k, c, v, bo, bl in self.segs[seg_off:seg_off + seg_count]]
        return (nv, self.def_levels[def_off:def_off + nv], bw,
                bytes(self.body[body_off:body_off + body_len]), values_off,
                segs)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @classmethod
    def from_list(cls, index_segments) -> "ScannedPages":
        """The arrays of a per-page tuple list (a chunk that the Python
        parser or a test built)."""
        from spark_rapids_tpu_torch import native as N
        pages = np.zeros((len(index_segments), N.PAGE_FIELDS), np.int64)
        segs, levels, bodies = [], [], []
        body_at = def_at = 0
        for i, (nv, dl, bw, page_bytes, values_off, ps) in enumerate(
                index_segments):
            pages[i] = (nv, def_at, int(np.asarray(dl).sum()), bw, body_at,
                        len(page_bytes), values_off, len(segs), len(ps))
            segs += [(int(s.kind == "packed"), s.count, s.value, s.byte_off,
                      s.byte_len) for s in ps]
            levels.append(np.asarray(dl, np.int32))
            bodies.append(bytes(page_bytes))
            body_at += len(page_bytes)
            def_at += nv
        return cls(np.frombuffer(b"".join(bodies), np.uint8).copy(), pages,
                   np.asarray(segs, np.int64).reshape(-1, N.SEG_FIELDS),
                   np.concatenate(levels) if levels
                   else np.zeros(0, np.int32))


#: column chunks per scan route since the last reset_routes():
#: ``native_chunk`` (an UNCOMPRESSED chunk in one sr_scan_chunk call),
#: ``native_pages`` (a compressed chunk, or one of v2 pages: the native
#: header walk, the arrow codec per page body, one native page scan),
#: ``arrow`` (a chunk the device decode refuses, read through arrow by
#: read_row_group_device) and ``python`` (read_chunk_pages_plain, which no
#: path of the package calls)
routes = {"native_chunk": 0, "native_pages": 0, "arrow": 0, "python": 0}
_ROUTES_LOCK = threading.Lock()


def reset_routes() -> None:
    with _ROUTES_LOCK:
        for k in routes:
            routes[k] = 0


def _route(name: str) -> None:
    with _ROUTES_LOCK:
        routes[name] += 1


_FIXED = {"INT32": ("<i4", 4), "INT64": ("<i8", 8),
          "FLOAT": ("<f4", 4), "DOUBLE": ("<f8", 8)}


def _decode_plain_dictionary(physical_type: str, raw: bytes, n: int):
    if physical_type in _FIXED:
        dt, _ = _FIXED[physical_type]
        return np.frombuffer(raw, dtype=dt, count=n).copy()
    if physical_type == "BYTE_ARRAY":
        out, pos = [], 0
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            out.append(raw[pos:pos + ln].decode("utf-8"))
            pos += ln
        return out
    raise NotImplementedError(physical_type)


def _open_chunk(path: str, row_group: int, column: int, md):
    """The scope checks of a column chunk and its bytes: ``(column chunk
    metadata, max def level, arrow codec or None, chunk buffer)``. Raises
    NotImplementedError when the chunk is out of the device decode's scope
    (the caller reads it through arrow)."""
    if md is None:
        import pyarrow.parquet as pq
        md = pq.ParquetFile(path).metadata
    col = md.row_group(row_group).column(column)
    dec = None
    if col.compression != "UNCOMPRESSED":
        import pyarrow as pa
        if col.compression not in ("SNAPPY", "GZIP", "ZSTD"):
            raise NotImplementedError(f"codec {col.compression}")
        try:
            dec = pa.Codec(col.compression.lower())
        except (ValueError, NotImplementedError, pa.ArrowException) as e:
            raise NotImplementedError(f"codec {col.compression}: {e}")
    if "RLE_DICTIONARY" not in col.encodings and \
            "PLAIN_DICTIONARY" not in col.encodings:
        raise NotImplementedError(f"encodings {col.encodings}")
    if col.physical_type not in _FIXED and \
            col.physical_type != "BYTE_ARRAY":
        raise NotImplementedError(f"type {col.physical_type}")

    max_def = md.schema.column(column).max_definition_level
    if md.schema.column(column).max_repetition_level:
        raise NotImplementedError("nested (repeated) columns")

    with open(path, "rb") as f:
        start = col.dictionary_page_offset or col.data_page_offset
        f.seek(start)
        buf = f.read(col.total_compressed_size)
    return col, max_def, dec, buf


def read_chunk_pages(path: str, row_group: int, column: int,
                     md=None) -> ChunkPages:
    """Scan one dictionary-encoded column chunk with the native scanner
    (``native/parquet_host.cpp``) into its raw device-ready pieces: an
    UNCOMPRESSED chunk of v1 pages in one ``sr_scan_chunk`` call; any other
    (SNAPPY/GZIP/ZSTD, or v2 data pages) through the native header walk, the
    arrow codec per page body and one native page scan. Raises
    NotImplementedError when out of scope (the caller falls back to the
    arrow decode), ValueError on a malformed chunk and
    ``native.NativeBuildError`` when the scanner cannot be built: nothing
    falls back to the Python parser. ``md`` avoids re-parsing the footer per
    chunk."""
    from spark_rapids_tpu_torch import native as N
    col, max_def, dec, buf = _open_chunk(path, row_group, column, md)
    if dec is None:
        try:
            pages, segs, defs, (d_off, d_len, d_n) = N.scan_chunk(
                buf, col.num_values, max_def)
        except N.ScopeRefused as e:
            if e.code != N.PAGE_TYPE:       # v2 pages take the page route
                raise
        else:
            _route("native_chunk")
            dict_vals = _decode_plain_dictionary(
                col.physical_type, buf[d_off:d_off + d_len], d_n)
            return ChunkPages(col.physical_type, dict_vals, ScannedPages(
                np.frombuffer(buf, np.uint8), pages, segs, defs),
                col.num_values)

    view = memoryview(buf)
    dict_vals = None
    descs, parts = [], []
    at = 0
    for (page_type, body_off, csize, usize, nv, def_len,
         v2_compressed) in N.page_headers(buf, col.num_values).tolist():
        raw = view[body_off:body_off + csize]
        if page_type == 2:                          # dictionary page
            body = raw if dec is None else dec.decompress(raw, usize)
            dict_vals = _decode_plain_dictionary(col.physical_type,
                                                 bytes(body), nv)
        elif page_type == 0:                        # data page v1
            data = raw if dec is None else dec.decompress(raw, usize)
            descs.append((1, nv, at, len(data), 0, 0))
            parts.append(data)
            at += len(data)
        else:                                       # data page v2
            # levels ride UNCOMPRESSED ahead of the (optionally
            # compressed) values section; no repetition levels (the walk
            # refuses them)
            data = raw[def_len:]
            if dec is not None and v2_compressed:
                data = dec.decompress(data, usize - def_len)
            descs.append((2, nv, at + def_len, len(data), at, def_len))
            parts += [raw[:def_len], data]
            at += def_len + len(data)
    body = np.empty(at, np.uint8)
    at = 0
    for part in parts:
        n = len(part)
        body[at:at + n] = np.frombuffer(part, np.uint8)
        at += n
    pages, segs, defs = N.scan_pages(
        body, np.asarray(descs, np.int64).reshape(-1, N.DESC_FIELDS),
        max_def, col.num_values)
    _route("native_pages")
    return ChunkPages(col.physical_type, dict_vals,
                      ScannedPages(body, pages, segs, defs), col.num_values)


def read_chunk_pages_plain(path: str, row_group: int, column: int,
                           md=None) -> ChunkPages:
    """The plain version of ``read_chunk_pages``: the reference's Python
    page parser, page by page. The tests hold the native scanner against it;
    no path of the package calls it."""
    col, max_def, dec, buf = _open_chunk(path, row_group, column, md)
    pos = 0
    dict_vals = None
    pages = []
    values_seen = 0
    while pos < len(buf) and values_seen < col.num_values:
        ph = parse_page_header(buf, pos)
        body = pos + ph.header_len
        raw_body = buf[body:body + ph.compressed_size]
        if ph.page_type == 2:                       # dictionary page
            page_body = (raw_body if dec is None else
                         bytes(dec.decompress(raw_body,
                                              ph.uncompressed_size)))
            dict_vals = _decode_plain_dictionary(
                col.physical_type, page_body, ph.num_values)
        elif ph.page_type == 0:                     # data page v1
            if ph.encoding not in (8, 2):           # RLE_DICT / PLAIN_DICT
                raise NotImplementedError(f"page encoding {ph.encoding}")
            page_bytes = (raw_body if dec is None else
                          bytes(dec.decompress(raw_body,
                                               ph.uncompressed_size)))
            p = 0
            if max_def:
                # optional-field def levels: RLE with 4-byte length prefix
                (dl_len,) = struct.unpack_from("<I", page_bytes, p)
                p += 4
                def_levels = decode_rle_host(page_bytes, p, p + dl_len, 1,
                                             ph.num_values)
                p += dl_len
            else:
                def_levels = np.ones(ph.num_values, dtype=np.int32)
            bw = page_bytes[p]
            p += 1
            n_present = int(def_levels.sum())
            segs = parse_rle_hybrid(page_bytes, p, len(page_bytes), bw,
                                    n_present)
            pages.append((ph.num_values, def_levels, bw, page_bytes,
                          p - 1, segs))
            values_seen += ph.num_values
        elif ph.page_type == 3:                     # data page v2
            if ph.encoding not in (8, 2):
                raise NotImplementedError(f"page encoding {ph.encoding}")
            if ph.rep_len:
                raise NotImplementedError("repeated (nested) v2 page")
            # levels ride UNCOMPRESSED ahead of the (optionally compressed)
            # values section; def levels have NO length prefix in v2
            levels = raw_body[:ph.def_len]
            data = raw_body[ph.def_len:]
            if dec is not None and ph.v2_compressed:
                data = bytes(dec.decompress(
                    data, ph.uncompressed_size - ph.def_len - ph.rep_len))
            if max_def and ph.def_len:
                def_levels = decode_rle_host(levels, 0, ph.def_len, 1,
                                             ph.num_values)
            else:
                def_levels = np.ones(ph.num_values, dtype=np.int32)
            bw = data[0]
            n_present = int(def_levels.sum())
            segs = parse_rle_hybrid(data, 1, len(data), bw, n_present)
            pages.append((ph.num_values, def_levels, bw, data, 0, segs))
            values_seen += ph.num_values
        else:
            raise NotImplementedError(f"page type {ph.page_type}")
        pos = body + ph.compressed_size
    if dict_vals is None:
        raise NotImplementedError("no dictionary page")
    _route("python")
    return ChunkPages(col.physical_type, dict_vals, pages, col.num_values)


# -- chunk → engine vector ----------------------------------------------------

def _spark_type_of(physical_type: str, spark_type):
    from spark_rapids_tpu_torch import types as T
    if physical_type == "BYTE_ARRAY":
        return T.STRING
    if isinstance(spark_type, T.TimestampType):
        # a timestamp's unit and rebase belong to the arrow reader
        raise NotImplementedError("timestamp chunks take the arrow reader")
    if spark_type is not None:
        # an INT32 chunk annotated INT(8)/INT(16) decodes to int8/int16:
        # its dictionary is converted to the column's dtype on the host
        return spark_type
    np_to_spark = {"INT32": T.INT, "INT64": T.LONG, "FLOAT": T.FLOAT,
                   "DOUBLE": T.DOUBLE}
    if physical_type not in np_to_spark:
        raise NotImplementedError(f"parquet {physical_type} is not ported yet")
    return np_to_spark[physical_type]


def _all_packed(segs) -> bool:
    return bool(segs) and all(s.kind == "packed" for s in segs)


def _packed_bytes(page_bytes: bytes, segs) -> bytes:
    # segments each hold whole 8-value groups at byte boundaries:
    # concatenating their BYTES preserves bit alignment
    return b"".join(page_bytes[s.byte_off:s.byte_off + s.byte_len]
                    for s in segs)


class PackedChunk(typing.NamedTuple):
    """One column chunk packed for ``cuda_kernels.chunk_decode``: one int32
    buffer that crosses to the card in one copy, holding at 16-byte
    boundaries the page table (``PAGE_FIELDS``), every page's index words,
    the chunk's def levels (one byte a row, only when some page has nulls)
    and the dictionary in the column's type; the gaps between sections are
    zero. The tuples say where each section lies, in int32 words."""
    buf: torch.Tensor            # (n,) int32 on the host
    num_pages: int
    words: tuple                 # (offset, words)
    defs: tuple | None           # (offset, rows)
    dictionary: tuple            # (offset, entries)
    n_rows: int


def _words_of(n_bytes: int) -> int:
    """int32 words holding n_bytes, rounded up to a 16-byte boundary."""
    return -(-n_bytes // 16) * 4


def _pack(table: np.ndarray, n_words: int, write_words, def_levels,
          dictionary: torch.Tensor, num_values: int, capacity: int,
          pin: bool) -> PackedChunk:
    """Lay out a packed chunk from its ``(P, 8)`` int32 page table, its
    index word count and a ``write_words(dst)`` that fills the words
    section."""
    n_rows = min(int(table[:, 1].astype(np.int64).sum()), num_values,
                 capacity)
    has_nulls = bool(table[:, 7].any())
    raw_dict = np.ascontiguousarray(dictionary.numpy()).view(np.uint8)
    n_table = table.size
    at_words = _words_of(4 * n_table)
    at_defs = at_words + _words_of(4 * n_words)
    at_dict = at_defs + (_words_of(n_rows) if has_nulls else 0)
    buf = torch.empty((at_dict + _words_of(raw_dict.size),),
                      dtype=torch.int32, pin_memory=pin)
    host = buf.numpy()
    host[:n_table] = table.reshape(-1)
    host[n_table:at_words] = 0
    write_words(host[at_words:at_words + n_words])
    host[at_words + n_words:at_defs] = 0
    if has_nulls:
        defs = host[at_defs:at_dict].view(np.uint8)
        defs[:n_rows] = def_levels[:n_rows] != 0
        defs[n_rows:] = 0
    tail = host[at_dict:].view(np.uint8)
    tail[:raw_dict.size] = raw_dict
    tail[raw_dict.size:] = 0
    return PackedChunk(buf, table.shape[0], (at_words, n_words),
                       (at_defs, n_rows) if has_nulls else None,
                       (at_dict, dictionary.numel()), n_rows)


def pack_chunk(pages: ChunkPages, dictionary: torch.Tensor, capacity: int,
               pin: bool = False) -> PackedChunk:
    """Host prep of one chunk in one buffer: the page table and every
    page's index words from the native scanner (``sr_pack_table``,
    ``sr_pack_words``: a page's bit-packed runs as they are; a page with RLE
    runs decodes its indices natively and carries them at bit width 32,
    which unpacks as the identity), the def levels and the (converted)
    dictionary. ``pin`` takes the buffer from torch's caching pinned-memory
    allocator, so that the copy to the card can run asynchronously; every
    call has its own buffer, so concurrent scans share none."""
    from spark_rapids_tpu_torch import native as N
    sp = pages.index_segments
    if not isinstance(sp, ScannedPages):
        sp = ScannedPages.from_list(sp)
    table, n_words = N.pack_table(sp.pages, sp.segs)
    return _pack(table, n_words,
                 lambda dst: N.pack_words(sp.body, sp.pages, sp.segs, table,
                                          dst),
                 sp.def_levels, dictionary, pages.num_values, capacity, pin)


def pack_chunk_plain(pages: ChunkPages, dictionary: torch.Tensor,
                     capacity: int) -> PackedChunk:
    """The plain version of ``pack_chunk``, page by page in Python with
    ``decode_rle_host``; the tests hold ``pack_chunk`` against it."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    table, streams, levels = [], [], []
    row_off = word_off = present_before = 0
    for (num_values, def_levels, bw, page_bytes, values_off, segs) in \
            pages.index_segments:
        n_present = int(def_levels.sum())
        if _all_packed(segs) and bw > 0:
            words = CK.bytes_to_words_u32(
                np.frombuffer(_packed_bytes(page_bytes, segs), np.uint8))
        else:
            if not segs:
                idx = np.zeros(0, np.int32)
            elif bw == 0:               # one-entry dictionary: every index 0
                idx = np.zeros(n_present, np.int32)
            else:
                idx = decode_rle_host(page_bytes, values_off + 1,
                                      len(page_bytes), bw, n_present)
            words, bw = idx.astype(np.int32), 32
        table.append((row_off, num_values, word_off, len(words), bw,
                      n_present, present_before,
                      int(n_present != num_values)))
        streams.append(words)
        levels.append(def_levels)
        row_off += num_values
        word_off += len(words)
        present_before += n_present

    def write(dst):
        if word_off:
            dst[:] = np.concatenate(streams)
    return _pack(np.asarray(table, np.int32).reshape(-1, 8), word_off, write,
                 np.concatenate(levels) if levels else np.zeros(0, np.int32),
                 dictionary, pages.num_values, capacity, False)


def chunk_views(buf: torch.Tensor, packed: PackedChunk, want: torch.dtype):
    """``(words, page table, defs or None, dictionary)``: views of a packed
    chunk's buffer (on the host or on the card) for ``chunk_decode``."""
    n_table = packed.num_pages * 8
    table = buf[:n_table].view(packed.num_pages, 8)
    at_words, n_words = packed.words
    words = buf[at_words:at_words + n_words]
    defs = None
    if packed.defs is not None:
        at_defs, rows = packed.defs
        defs = buf[at_defs:].view(torch.uint8)[:rows]
    at_dict, nd = packed.dictionary
    size = torch.empty((), dtype=want).element_size()
    dictionary = buf[at_dict:].view(torch.uint8)[:nd * size].view(want)
    return words, table, defs, dictionary


def chunk_column(pages: ChunkPages, spark_type):
    """``(spark type, dtype, default, host dictionary in that dtype, sorted
    string dictionary or None)`` of a parsed chunk. A string chunk's
    dictionary is the rank array mapping each parquet index to its code in
    the engine's sorted dictionary (parquet's dictionary is that dictionary,
    reordered), and its invalid slots hold code 0 (the canonical-null
    invariant: group-by compares raw codes)."""
    from spark_rapids_tpu_torch import types as T
    if pages.physical_type == "BYTE_ARRAY":
        from spark_rapids_tpu_torch.ops.strings import sorted_dict_and_rank
        sorted_dict, rank = sorted_dict_and_rank(pages.dict_values)
        return T.STRING, torch.int32, 0, torch.from_numpy(rank), sorted_dict
    st = _spark_type_of(pages.physical_type, spark_type)
    dictionary = torch.from_numpy(
        np.asarray(pages.dict_values)).to(st.torch_dtype)
    return st, st.torch_dtype, st.default_value(), dictionary, None


def chunk_to_device(pages: ChunkPages, spark_type, capacity: int, device):
    """A parsed chunk as an ``EncodedColumnVector`` on the device: the packed
    chunk crosses in one asynchronous copy from pinned memory, and one
    ``chunk_decode`` launch (the kernel for a CUDA device) at the column's
    first read unpacks, gathers from the dictionary and spreads over the
    null layout at the output capacity. Bit for bit the reference's
    page-by-page decode."""
    from spark_rapids_tpu_torch.columnar import encoded as EN

    device = torch.device(device)
    st, want, default, dictionary, sorted_dict = chunk_column(pages,
                                                              spark_type)
    packed = pack_chunk(pages, dictionary, capacity,
                        pin=device.type == "cuda")
    buf = packed.buf.to(device, non_blocking=True)
    words, table, defs, dict_d = chunk_views(buf, packed, want)
    return EN.EncodedColumnVector(st, EN.EncodedChunk(
        buf, words, table, defs, dict_d, packed.n_rows, capacity, want,
        default), sorted_dict)


def read_row_group_device(path: str, row_group: int, schema, device,
                          columns: list[str] | None = None, pf=None):
    """Read one row group through the device decode; out-of-scope column
    chunks (non-dictionary, nested, unported codec) fall back to arrow PER
    COLUMN. Pass ``pf`` to reuse one parsed footer across row groups. The
    dictionary chunks stay encoded on the device until their first read
    (``columnar/encoded.py``); the others are dense."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity

    if pf is None:
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(path)
    md = pf.metadata
    # leaf paths: a flat column's path IS its name; nested leaves look like
    # "l.list.element" and must never match a top-level name
    leaf_of = {}
    for i in range(md.num_columns):
        path_in_schema = md.schema.column(i).path
        if "." not in path_in_schema:
            leaf_of[path_in_schema] = i
    want = (columns if columns is not None else
            [f.name for f in (schema.fields if schema is not None else [])]
            or list(leaf_of))
    n_rows = md.row_group(row_group).num_rows
    cap = bucket_capacity(max(n_rows, 1))
    cols, fields = [], []
    for name in want:
        sf = schema[name] if schema is not None else None
        try:
            if name not in leaf_of:
                raise NotImplementedError(f"nested column {name}")
            pages = read_chunk_pages(path, row_group, leaf_of[name], md=md)
            cv = chunk_to_device(pages, sf.data_type if sf else None, cap,
                                 device)
        except NotImplementedError:
            _route("arrow")
            arr = pf.read_row_group(row_group, columns=[name]).column(0)
            cv = array_to_device(arr, sf.data_type if sf else None, cap,
                                 device)
        cols.append(cv)
        fields.append(sf or T.StructField(name, cols[-1].dtype, True))
    return ColumnarBatch(cols, n_rows, T.StructType(fields))
