"""Native parquet page access: thrift metadata and page splitting on the host,
bulk index decode on the device.

Counterpart of ``spark_rapids_tpu/io/parquet_native.py``. The thrift page
headers and RLE run structure are metadata (bytes to kilobytes) parsed on the
host in Python; the bulk bytes, the bit-packed dictionary indices of every
page of a column chunk, go to the device in one copy, where one
``chunk_decode`` launch (``ops/cuda_kernels.py``) unpacks them, gathers the
dictionary values and spreads them over the null layout. The parquet
dictionary page maps 1:1 onto the engine's sorted string dictionary, so a
string column never materializes per-row bytes.

Scope: UNCOMPRESSED / SNAPPY / GZIP / ZSTD chunks (compressed page bodies
decompress on the host through arrow's codecs), RLE_DICTIONARY-encoded data
pages (v1 and v2), flat schemas, physical types INT32/INT64/FLOAT/DOUBLE/
BYTE_ARRAY. Anything else (for example a dictionary that overflowed to PLAIN
pages) falls back to the arrow decode per column chunk. Every chunk is decoded
at the scan; uploading pages encoded is not ported yet.
"""

from __future__ import annotations

import struct
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
    index_segments: list                # per data page: (num_values,
                                        #   def_levels np | None,
                                        #   bit_width, packed bytes | np idx)
    num_values: int


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


def read_chunk_pages(path: str, row_group: int, column: int,
                     md=None) -> ChunkPages:
    """Parse one dictionary-encoded column chunk (UNCOMPRESSED, or
    SNAPPY/GZIP/ZSTD with page bodies decompressed on the host) into its raw
    device-ready pieces. Raises NotImplementedError when out of scope (the
    caller falls back to the arrow decode). ``md`` avoids re-parsing the
    footer per chunk."""
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
    return ChunkPages(col.physical_type, dict_vals, pages, col.num_values)


# -- chunk → engine vector ----------------------------------------------------

def _spark_type_of(physical_type: str, spark_type):
    from spark_rapids_tpu_torch import types as T
    if physical_type == "BYTE_ARRAY":
        return T.STRING
    if spark_type is not None:
        return spark_type
    np_to_spark = {"INT32": T.INT, "INT64": T.LONG, "DOUBLE": T.DOUBLE}
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
    and the dictionary in the column's type. The tuples say where each
    section lies, in int32 words."""
    buf: torch.Tensor            # (n,) int32 on the host
    num_pages: int
    words: tuple                 # (offset, words)
    defs: tuple | None           # (offset, rows)
    dictionary: tuple            # (offset, entries)
    n_rows: int


def _words_of(n_bytes: int) -> int:
    """int32 words holding n_bytes, rounded up to a 16-byte boundary."""
    return -(-n_bytes // 16) * 4


def pack_chunk(pages: ChunkPages, dictionary: torch.Tensor, capacity: int,
               pin: bool = False) -> PackedChunk:
    """Host prep of one chunk: each page's index words (its bit-packed
    segments as they are; pages with RLE runs decode their indices on the
    host and carry them at bit width 32, which unpacks as the identity), its
    row of the page table, the def levels and the (converted) dictionary, in
    one buffer. ``pin`` takes the buffer from torch's caching pinned-memory
    allocator, so that the copy to the card can run asynchronously; every
    call has its own buffer, so concurrent scans share none."""
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
    n_rows = min(row_off, pages.num_values, capacity)
    has_nulls = any(t[-1] for t in table)
    raw_dict = np.ascontiguousarray(dictionary.numpy()).view(np.uint8)
    n_table = len(table) * len(CK.PAGE_FIELDS)
    at_words = _words_of(4 * n_table)
    at_defs = at_words + _words_of(4 * word_off)
    at_dict = at_defs + (_words_of(n_rows) if has_nulls else 0)
    buf = torch.empty((at_dict + _words_of(raw_dict.size),),
                      dtype=torch.int32, pin_memory=pin)
    host = buf.numpy()
    host[:n_table] = np.asarray(table, np.int32).reshape(-1)
    if word_off:
        host[at_words:at_words + word_off] = np.concatenate(streams)
    if has_nulls:
        host[at_defs:at_dict].view(np.uint8)[:n_rows] = \
            np.concatenate(levels)[:n_rows] != 0
    host[at_dict:].view(np.uint8)[:raw_dict.size] = raw_dict
    return PackedChunk(buf, len(table), (at_words, word_off),
                       (at_defs, n_rows) if has_nulls else None,
                       (at_dict, dictionary.numel()), n_rows)


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
    """Decode a parsed chunk into a device column in one ``chunk_decode``
    launch (the kernel for a CUDA device): the packed chunk crosses in one
    asynchronous copy from pinned memory, and the kernel unpacks, gathers
    from the dictionary and spreads over the null layout at the output
    capacity. Bit for bit the reference's page-by-page decode."""
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK

    device = torch.device(device)
    st, want, default, dictionary, sorted_dict = chunk_column(pages,
                                                              spark_type)
    packed = pack_chunk(pages, dictionary, capacity,
                        pin=device.type == "cuda")
    buf = packed.buf.to(device, non_blocking=True)
    words, table, defs, dict_d = chunk_views(buf, packed, want)
    v, m = CK.chunk_decode(words, table, defs, dict_d, packed.n_rows,
                           capacity, want, default)
    return TorchColumnVector(st, v, m, sorted_dict)


def read_row_group_device(path: str, row_group: int, schema, device,
                          columns: list[str] | None = None, pf=None):
    """Read one row group through the device decode; out-of-scope column
    chunks (non-dictionary, nested, unported codec) fall back to arrow PER
    COLUMN. Pass ``pf`` to reuse one parsed footer across row groups."""
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
            arr = pf.read_row_group(row_group, columns=[name]).column(0)
            cv = array_to_device(arr, sf.data_type if sf else None, cap,
                                 device)
        cols.append(cv)
        fields.append(sf or T.StructField(name, cols[-1].dtype, True))
    return ColumnarBatch(cols, n_rows, T.StructType(fields))
