"""Native Parquet encode: the device prepares each column, the host frames.

Counterpart of ``spark_rapids_tpu/io/parquet_write_native.py`` (reference
ColumnarOutputWriter.scala / GpuParquetFileFormat.scala:348 write Parquet
straight from device buffers). The split is the scan's, reversed:

- the device (torch ops on the column's own device, ``prep_column``):
  null compaction of the values (PLAIN stores only non-null values), the
  null count, and min/max over the live values; the compacted values and
  their min and max then cross to the host in one copy. A string column's
  int32 codes ARE the dictionary-page indices: the engine's sorted
  dictionary maps 1:1 onto a Parquet dictionary page, so a string's min/max
  is its code min/max;
- the host: definition levels (RLE/bit-packed hybrid), thrift compact
  metadata (PageHeader / ColumnMetaData / FileMetaData, the mirror image of
  ``parquet_native``'s reader), page compression and file assembly.

Each batch is one row group: an optional dictionary page and one v1 data
page per column. Codecs: UNCOMPRESSED, GZIP (zlib) and SNAPPY (pyarrow's
codec). A codec pyarrow lacks raises: the port frames no uncompressed
stand-in. Types: every port type (BOOLEAN, INT, LONG, DOUBLE, STRING, DATE
and DECIMAL up to 18 digits as INT64). The file names its writer in
``created_by``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

MAGIC = b"PAR1"
CREATED_BY = b"spark-rapids-tpu-torch native writer"

# --- thrift compact protocol writer ----------------------------------------

_CT_BOOL_TRUE, _CT_BOOL_FALSE = 1, 2
_CT_I32, _CT_I64 = 5, 6
_CT_BINARY, _CT_LIST, _CT_STRUCT = 8, 9, 12


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> bytes:
    return _varint((v << 1) ^ (v >> 63))


class _CompactWriter:
    """Emit one thrift-compact struct. Fields are written in ascending
    field-id order (the compact protocol encodes the id as a delta)."""

    def __init__(self):
        self.buf = bytearray()
        self._last_fid = [0]

    def _field_header(self, fid: int, ftype: int):
        delta = fid - self._last_fid[-1]
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ftype)
        else:
            self.buf.append(ftype)
            self.buf += _zigzag(fid)
        self._last_fid[-1] = fid

    def field_bool(self, fid: int, v: bool):
        self._field_header(fid, _CT_BOOL_TRUE if v else _CT_BOOL_FALSE)

    def field_i32(self, fid: int, v: int, *, wide: int = _CT_I32):
        self._field_header(fid, wide)
        self.buf += _zigzag(v)

    def field_i64(self, fid: int, v: int):
        self.field_i32(fid, v, wide=_CT_I64)

    def field_binary(self, fid: int, v: bytes):
        self._field_header(fid, _CT_BINARY)
        self.buf += _varint(len(v))
        self.buf += v

    def begin_struct(self, fid: int):
        self._field_header(fid, _CT_STRUCT)
        self._last_fid.append(0)

    def end_struct(self):
        self.buf.append(0)
        self._last_fid.pop()

    def begin_list(self, fid: int, elem_type: int, size: int):
        self._field_header(fid, _CT_LIST)
        if size < 15:
            self.buf.append((size << 4) | elem_type)
        else:
            self.buf.append(0xF0 | elem_type)
            self.buf += _varint(size)

    def list_i32(self, v: int):
        self.buf += _zigzag(v)

    def list_binary(self, v: bytes):
        self.buf += _varint(len(v))
        self.buf += v

    def end_top(self) -> bytes:
        self.buf.append(0)
        return bytes(self.buf)


# --- physical-type mapping -------------------------------------------------

# parquet Type enum
_PT_BOOLEAN, _PT_INT32, _PT_INT64 = 0, 1, 2
_PT_FLOAT, _PT_DOUBLE, _PT_BYTE_ARRAY = 4, 5, 6
# ConvertedType enum values used
_CV_UTF8, _CV_DECIMAL, _CV_DATE, _CV_TS_MICROS = 0, 5, 6, 10
_CV_INT8, _CV_INT16 = 15, 16
# CompressionCodec enum
CODECS = {"uncompressed": 0, "none": 0, "snappy": 1, "gzip": 2}
# Encoding enum
_ENC_PLAIN, _ENC_PLAIN_DICTIONARY, _ENC_RLE = 0, 2, 3


def _physical(dt: T.DataType):
    """(parquet Type, converted_type or None, numpy dtype of the PLAIN byte
    image). Raises TypeError for a type the writer cannot frame."""
    if isinstance(dt, T.BooleanType):
        return _PT_BOOLEAN, None, np.bool_
    if isinstance(dt, T.ByteType):
        return _PT_INT32, _CV_INT8, np.int32
    if isinstance(dt, T.ShortType):
        return _PT_INT32, _CV_INT16, np.int32
    if isinstance(dt, T.IntegerType):
        return _PT_INT32, None, np.int32
    if isinstance(dt, T.LongType):
        return _PT_INT64, None, np.int64
    if isinstance(dt, T.FloatType):
        return _PT_FLOAT, None, np.float32
    if isinstance(dt, T.DoubleType):
        return _PT_DOUBLE, None, np.float64
    if isinstance(dt, T.StringType):
        return _PT_BYTE_ARRAY, _CV_UTF8, np.int32
    if isinstance(dt, T.DateType):
        return _PT_INT32, _CV_DATE, np.int32
    if isinstance(dt, T.TimestampType):
        return _PT_INT64, _CV_TS_MICROS, np.int64
    if isinstance(dt, T.DecimalType):
        return _PT_INT64, _CV_DECIMAL, np.int64
    raise TypeError(f"native parquet writer: unsupported type {dt}")


# --- device prep: compaction and statistics --------------------------------

def _prep_device(data: torch.Tensor, validity: torch.Tensor, num_rows: int):
    """On the column's device: (the live non-null values followed by their
    min and max, the null count, the live validity). The null count is one
    scalar read; everything else stays on the device until the caller's one
    copy. An all-null column's min and max are zeros, never read."""
    vl = validity[:num_rows]
    nulls = num_rows - int(vl.sum())
    vals = data[:num_rows]
    comp = vals[vl] if nulls else vals
    if comp.numel() == 0:
        ext = torch.zeros(2, dtype=data.dtype, device=data.device)
    elif data.dtype == torch.bool:
        ext = torch.stack([comp.all(), comp.any()])
    else:
        # min and max propagate a NaN, as the reference's reductions do
        ext = torch.stack([comp.min(), comp.max()])
    return torch.cat([comp, ext]), nulls, vl


def prep_column(col, num_rows: int):
    """The device prep of one column, brought to the host: ``(values of the
    non-null rows, n_valid, null_count, vmin, vmax, validity of the rows or
    None when none is null)``."""
    buf, nulls, vl = _prep_device(col.data, col.validity, num_rows)
    host = buf.cpu().numpy()
    valid = vl.cpu().numpy() if nulls else None
    return (host[:-2], num_rows - nulls, nulls, host[-2], host[-1], valid)


# --- host framing ----------------------------------------------------------

def _rle_bitpacked(values: np.ndarray, bit_width: int) -> bytes:
    """RLE/bit-packed hybrid, the bit-packed branch only (groups of 8
    values, LSB-first within each byte)."""
    n = len(values)
    if n == 0:
        return b""
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, dtype=np.uint32)
    padded[:n] = values.astype(np.uint32)
    bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.uint32)) & 1)
    packed = np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")
    return _varint((groups << 1) | 1) + packed.tobytes()


def _def_levels_v1(valid: np.ndarray) -> bytes:
    """Definition levels of one optional flat column, v1 framing: a 4-byte
    LE length, then the RLE/bit-packed hybrid of 1-bit levels."""
    n = len(valid)
    if n and valid.all():
        body = _varint(n << 1) + b"\x01"      # one RLE run of 1s
    elif n and not valid.any():
        body = _varint(n << 1) + b"\x00"
    else:
        body = _rle_bitpacked(valid.astype(np.uint8), 1)
    return struct.pack("<I", len(body)) + body


def codec_available(name: str) -> bool:
    import pyarrow as pa
    return pa.Codec.is_available(name)


def snappy_codec():
    """pyarrow's snappy codec, which the parquet and ORC writers compress
    with. A pyarrow without it raises: no writer frames an uncompressed
    stand-in."""
    import pyarrow as pa
    if not codec_available("snappy"):
        raise ValueError("native writer: pyarrow has no snappy codec")
    return pa.Codec("snappy")


def _snappy(raw: bytes) -> bytes:
    """A whole page body as one raw snappy block."""
    return bytes(snappy_codec().compress(raw))


def _compress(raw: bytes, codec: str) -> bytes:
    if codec in ("uncompressed", "none"):
        return raw
    if codec == "gzip":
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        return co.compress(raw) + co.flush()
    if codec == "snappy":
        return _snappy(raw)
    raise ValueError(f"native parquet writer: codec {codec}")


def _plain_stat_bytes(dt: T.DataType, v, dictionary=None) -> bytes | None:
    """The PLAIN byte image of one statistics value; None leaves it out."""
    if isinstance(dt, T.StringType):
        if dictionary is None or len(dictionary) == 0:
            return None
        return dictionary[int(v)].as_py().encode("utf-8")
    pt, _, np_dt = _physical(dt)
    if pt == _PT_BOOLEAN:
        return b"\x01" if bool(v) else b"\x00"
    a = np.asarray(v).astype(np_dt)
    if np.issubdtype(a.dtype, np.floating) and np.isnan(a):
        return None
    return a.tobytes()


def _page_header(page_type: int, unc: int, comp: int, body_writer) -> bytes:
    w = _CompactWriter()
    w.field_i32(1, page_type)
    w.field_i32(2, unc)
    w.field_i32(3, comp)
    body_writer(w)
    return w.end_top()


def _stats_struct(w: _CompactWriter, fid: int, null_count: int,
                  min_b: bytes | None, max_b: bytes | None):
    w.begin_struct(fid)
    w.field_i64(3, null_count)
    if max_b is not None:
        w.field_binary(5, max_b)
    if min_b is not None:
        w.field_binary(6, min_b)
    w.end_struct()


def _encode_column(col, dt: T.DataType, num_rows: int, codec: str):
    """One column chunk: (pages, ColumnMetaData fields, dictionary page
    length). An optional dictionary page, then one v1 data page."""
    vals, n_valid, null_count, vmin, vmax, valid = prep_column(col, num_rows)
    if valid is None:
        valid = np.ones(num_rows, dtype=bool)

    pt, _, np_dt = _physical(dt)
    is_string = isinstance(dt, T.StringType)
    pages = []
    dict_page_len = 0
    raw_bytes = 0   # total_uncompressed_size: headers + RAW page bodies
    encodings = [_ENC_RLE, _ENC_PLAIN]

    if is_string:
        # the dictionary page: PLAIN byte arrays of the sorted dictionary
        entries = ([] if col.dictionary is None
                   else [s.encode("utf-8") for s in
                         col.dictionary.to_pylist()])
        raw = b"".join(struct.pack("<I", len(e)) + e for e in entries)
        comp = _compress(raw, codec)
        hdr = _page_header(2, len(raw), len(comp), lambda w: (
            w.begin_struct(7),
            w.field_i32(1, len(entries)),
            w.field_i32(2, _ENC_PLAIN_DICTIONARY),
            w.end_struct()))
        pages.append(hdr + comp)
        dict_page_len = len(hdr) + len(comp)
        raw_bytes += len(hdr) + len(raw)
        # the data page: a bit-width byte, then the bit-packed codes
        bw = max(1, (max(1, len(entries)) - 1).bit_length())
        payload = bytes([bw]) + _rle_bitpacked(vals.astype(np.uint32), bw)
        encodings = [_ENC_RLE, _ENC_PLAIN_DICTIONARY]
    elif pt == _PT_BOOLEAN:
        payload = np.packbits(vals.astype(np.uint8),
                              bitorder="little").tobytes()
    else:
        payload = vals.astype(np_dt).tobytes()

    raw_page = _def_levels_v1(valid) + payload
    comp_page = _compress(raw_page, codec)
    min_b = _plain_stat_bytes(dt, vmin, col.dictionary) if n_valid else None
    max_b = _plain_stat_bytes(dt, vmax, col.dictionary) if n_valid else None
    enc = _ENC_PLAIN_DICTIONARY if is_string else _ENC_PLAIN
    hdr = _page_header(0, len(raw_page), len(comp_page), lambda w: (
        w.begin_struct(5),
        w.field_i32(1, num_rows),
        w.field_i32(2, enc),
        w.field_i32(3, _ENC_RLE),
        w.field_i32(4, _ENC_RLE),
        _stats_struct(w, 5, null_count, min_b, max_b),
        w.end_struct()))
    pages.append(hdr + comp_page)
    raw_bytes += len(hdr) + len(raw_page)

    meta = {
        "type": pt,
        "encodings": encodings,
        "codec": CODECS[codec],
        "num_values": num_rows,
        "total_uncompressed_size": raw_bytes,
        "null_count": null_count,
        "min_b": min_b,
        "max_b": max_b,
    }
    return pages, meta, dict_page_len


def _schema_elements(w: _CompactWriter, schema: T.StructType):
    w.begin_list(2, _CT_STRUCT, len(schema.fields) + 1)
    r = _CompactWriter()                       # the root
    r.field_binary(4, b"schema")
    r.field_i32(5, len(schema.fields))
    w.buf += r.end_top()
    for f in schema.fields:
        pt, cv, _ = _physical(f.data_type)
        e = _CompactWriter()
        e.field_i32(1, pt)
        e.field_i32(3, 1)                      # OPTIONAL
        e.field_binary(4, f.name.encode("utf-8"))
        if cv is not None:
            e.field_i32(6, cv)
        if isinstance(f.data_type, T.DecimalType):
            e.field_i32(7, f.data_type.scale)
            e.field_i32(8, f.data_type.precision)
        if isinstance(f.data_type, T.TimestampType):
            # LogicalType TIMESTAMP(isAdjustedToUTC=true, MICROS): readers
            # rebuild timestamp[us, UTC] (the converted type alone is naive)
            e.begin_struct(10)
            e.begin_struct(8)
            e.field_bool(1, True)
            e.begin_struct(2)
            e.begin_struct(2)                  # TimeUnit.MICROS (empty)
            e.end_struct()
            e.end_struct()
            e.end_struct()
            e.end_struct()
        w.buf += e.end_top()


class NativeParquetFile:
    """A streaming writer: one row group per ``append_batch()``, as the task
    writer's open → append* → close lifecycle (ColumnarOutputWriter)."""

    def __init__(self, path: str, schema: T.StructType,
                 compression: str = "snappy"):
        codec = compression.lower()
        if codec not in CODECS:
            raise ValueError(f"native parquet writer: codec {compression}")
        for f in schema.fields:
            _physical(f.data_type)      # raises on a type it cannot frame
        self.path = path
        self.schema = schema
        self.codec = codec
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offset = len(MAGIC)
        self._row_groups = []   # (columns meta, num_rows, total bytes)
        self._num_rows = 0

    def append_batch(self, batch) -> int:
        """Encode one ColumnarBatch as a row group; returns bytes written."""
        n = batch.num_rows
        cols_meta = []
        group_bytes = 0
        for field, col in zip(self.schema.fields, batch.columns):
            pages, meta, dict_page_len = _encode_column(
                col, field.data_type, n, self.codec)
            first_off = self._offset
            for p in pages:
                self._f.write(p)
                self._offset += len(p)
            m = dict(meta)
            m["path"] = field.name
            if dict_page_len:
                m["dictionary_page_offset"] = first_off
                m["data_page_offset"] = first_off + dict_page_len
            else:
                m["data_page_offset"] = first_off
            m["file_offset"] = first_off
            m["total_compressed_size"] = self._offset - first_off
            cols_meta.append(m)
            group_bytes += m["total_uncompressed_size"]
        self._row_groups.append((cols_meta, n, group_bytes))
        self._num_rows += n
        return sum(m["total_compressed_size"] for m in cols_meta)

    def close(self):
        if self._f is None:
            return
        w = _CompactWriter()
        w.field_i32(1, 1)                       # version
        _schema_elements(w, self.schema)
        w.field_i64(3, self._num_rows)
        w.begin_list(4, _CT_STRUCT, len(self._row_groups))
        for cols_meta, n, group_bytes in self._row_groups:
            g = _CompactWriter()
            g.begin_list(1, _CT_STRUCT, len(cols_meta))
            for m in cols_meta:
                c = _CompactWriter()
                c.field_i64(2, m["file_offset"])
                c.begin_struct(3)               # ColumnMetaData
                c.field_i32(1, m["type"])
                c.begin_list(2, _CT_I32, len(m["encodings"]))
                for e in m["encodings"]:
                    c.list_i32(e)
                c.begin_list(3, _CT_BINARY, 1)
                c.list_binary(m["path"].encode("utf-8"))
                c.field_i32(4, m["codec"])
                c.field_i64(5, m["num_values"])
                c.field_i64(6, m["total_uncompressed_size"])
                c.field_i64(7, m["total_compressed_size"])
                c.field_i64(9, m["data_page_offset"])
                if "dictionary_page_offset" in m:
                    c.field_i64(11, m["dictionary_page_offset"])
                _stats_struct(c, 12, m["null_count"], m["min_b"], m["max_b"])
                c.end_struct()
                g.buf += c.end_top()
            g.field_i64(2, group_bytes)
            g.field_i64(3, n)
            w.buf += g.end_top()
        w.field_binary(6, CREATED_BY)
        # ColumnOrder TYPE_ORDER per column: without it readers treat the
        # min/max statistics as of undefined order
        w.begin_list(7, _CT_STRUCT, len(self.schema.fields))
        for _ in self.schema.fields:
            o = _CompactWriter()
            o.begin_struct(1)      # TypeDefinedOrder (an empty struct)
            o.end_struct()
            w.buf += o.end_top()
        footer = w.end_top()
        self._f.write(footer)
        self._f.write(struct.pack("<I", len(footer)))
        self._f.write(MAGIC)
        self._f.close()
        self._f = None

    def abort(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def write_batch_file(path: str, batch, schema: T.StructType,
                     compression: str = "snappy") -> int:
    """One batch → one file of one row group (the task writer's shape).
    Returns the bytes written; a failure removes the partial file and
    raises."""
    f = NativeParquetFile(path, schema, compression)
    try:
        f.append_batch(batch)
        f.close()
    except BaseException:
        f.abort()
        if os.path.exists(path):
            os.unlink(path)
        raise
    return os.path.getsize(path)
