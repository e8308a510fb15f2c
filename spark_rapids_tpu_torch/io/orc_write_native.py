"""Native ORC encode: the device prepares each column, the host frames.

Counterpart of ``spark_rapids_tpu/io/orc_write_native.py`` (reference
GpuOrcFileFormat.scala / ColumnarOutputWriter.scala:182). The device prep is
the parquet writer's (``parquet_write_native.prep_column``: null compaction,
null count, min/max, one copy a column); the host frames the streams, the
mirror image of ``io/orc_native.py``'s reader:

- PRESENT: bits MSB-first, then byte-RLE;
- SHORT/INT/LONG/DATE: RLEv2 DIRECT runs (zigzag, MSB-first bit
  packing); BYTE: byte-RLE;
- FLOAT/DOUBLE: raw little-endian IEEE;
- TIMESTAMP: seconds from 2015-01-01 UTC (RLEv2, signed) in DATA and the
  nanoseconds (always >= 0, no trailing-zero compression) in SECONDARY;
- STRING: DICTIONARY_V2, the engine's sorted dictionary as ORC's (codes in
  DATA, lengths in LENGTH, UTF-8 in DICTIONARY_DATA); row bytes never
  materialize on the device;
- BOOLEAN: bits and byte-RLE; DECIMAL (up to 18 digits): zigzag varints of
  the unscaled values and a SECONDARY stream of the scale;
- the protobuf StripeFooter / Footer / PostScript.

Compression: NONE, ZLIB (raw DEFLATE) and SNAPPY (pyarrow's codec), chunked
with the spec's 3-byte ``(len << 1) | isOriginal`` headers; streams, stripe
footers and the file footer all ride the codec. A codec pyarrow lacks
raises. Each batch is one stripe. The varints of a decimal column are built
in one vectorized pass, byte for byte the reference's per-value loop.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io import parquet_write_native as PW

MAGIC = b"ORC"

# Type.Kind
K_BOOLEAN, K_BYTE, K_SHORT, K_INT, K_LONG = 0, 1, 2, 3, 4
K_FLOAT, K_DOUBLE, K_STRING, K_TIMESTAMP = 5, 6, 7, 9
K_STRUCT, K_DECIMAL, K_DATE = 12, 14, 15
# Stream.Kind
S_PRESENT, S_DATA, S_LENGTH, S_DICT_DATA, S_SECONDARY = 0, 1, 2, 3, 5
# ColumnEncoding.Kind
E_DIRECT, E_DIRECT_V2, E_DICTIONARY_V2 = 0, 2, 3

# CompressionKind and the writer's codec names
C_NONE, C_ZLIB, C_SNAPPY = 0, 1, 2
CODECS = {"none": C_NONE, "uncompressed": C_NONE, "zlib": C_ZLIB,
          "gzip": C_ZLIB, "snappy": C_SNAPPY}
_BLOCK = 262144

_TS_BASE_MICROS = 1420070400 * 1000000      # 2015-01-01 00:00:00 UTC


def _compress_chunked(blob: bytes, codec: int) -> bytes:
    """One ORC compression stream: 3-byte little-endian ``(chunkLength << 1)
    | isOriginal`` headers; a chunk that does not shrink is stored original
    (isOriginal=1)."""
    if codec == C_NONE or not blob:
        return blob
    if codec == C_SNAPPY:
        snappy = PW.snappy_codec()
    out = bytearray()
    for s in range(0, len(blob), _BLOCK):
        chunk = blob[s:s + _BLOCK]
        if codec == C_ZLIB:
            c = zlib.compressobj(wbits=-15)
            body = c.compress(chunk) + c.flush()
        else:
            body = bytes(snappy.compress(chunk))
        orig = 1 if len(body) >= len(chunk) else 0
        if orig:
            body = chunk
        hdr = (len(body) << 1) | orig
        out += bytes([hdr & 0xFF, (hdr >> 8) & 0xFF, (hdr >> 16) & 0xFF])
        out += body
    return bytes(out)


def _kind_of(dt: T.DataType) -> int:
    if isinstance(dt, T.BooleanType):
        return K_BOOLEAN
    if isinstance(dt, T.ByteType):
        return K_BYTE
    if isinstance(dt, T.ShortType):
        return K_SHORT
    if isinstance(dt, T.IntegerType):
        return K_INT
    if isinstance(dt, T.LongType):
        return K_LONG
    if isinstance(dt, T.FloatType):
        return K_FLOAT
    if isinstance(dt, T.DoubleType):
        return K_DOUBLE
    if isinstance(dt, T.TimestampType):
        return K_TIMESTAMP
    if isinstance(dt, T.StringType):
        return K_STRING
    if isinstance(dt, T.DateType):
        return K_DATE
    if isinstance(dt, T.DecimalType):
        return K_DECIMAL
    raise TypeError(f"native orc writer: unsupported type {dt}")


# --- protobuf writer (the inverse of orc_native._ProtoReader) ---------------

def _pvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Proto:
    def __init__(self):
        self.buf = bytearray()

    def uint(self, fid: int, v: int):
        self.buf += _pvarint(fid << 3)
        self.buf += _pvarint(v)

    def bytes_(self, fid: int, v: bytes):
        self.buf += _pvarint((fid << 3) | 2)
        self.buf += _pvarint(len(v))
        self.buf += v

    def packed(self, fid: int, vals):
        self.bytes_(fid, b"".join(_pvarint(v) for v in vals))

    def done(self) -> bytes:
        return bytes(self.buf)


# --- byte-RLE and boolean-RLE (the inverse of decode_boolean_rle) -----------

def byte_rle(data: bytes) -> bytes:
    """ORC byte-RLE: [0..127, b] is a run of n+3 copies of b; [256-n,
    b0..b{n-1}] is n literal bytes (1 <= n <= 128)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 130 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(run - 3)
            out.append(data[i])
            i += run
            continue
        lit_start = i
        while i < n and i - lit_start < 128:
            if (i + 2 < n and data[i + 1] == data[i]
                    and data[i + 2] == data[i]):
                break               # a run of 3 or more starts here
            i += 1
        cnt = i - lit_start         # 1..128 by the loop bound
        out.append(256 - cnt)
        out += data[lit_start:i]
    return bytes(out)


def bool_rle(bits: np.ndarray) -> bytes:
    """A boolean stream: bits MSB-first into bytes, then byte-RLE."""
    return byte_rle(np.packbits(bits.astype(np.uint8)).tobytes())


# --- RLEv2 DIRECT writer ----------------------------------------------------

# the encodable direct widths and their 5-bit codes
_WIDTHS = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]
_WIDTH_CODE = {w: (w - 1 if w <= 24 else 24 + [26, 28, 30, 32, 40, 48, 56,
                                              64].index(w)) for w in _WIDTHS}


def _fit_width(maxbits: int) -> int:
    for w in _WIDTHS:
        if w >= maxbits:
            return w
    return 64


def _pack_msb(vals: np.ndarray, width: int) -> bytes:
    """Bit-pack uint64 values MSB-first at ``width`` bits: the last
    ``width`` bits of each value's big-endian image, whole bytes when the
    width is a multiple of 8."""
    be = vals.astype(">u8").view(np.uint8).reshape(-1, 8)
    if width % 8 == 0:
        return be[:, 8 - width // 8:].tobytes()
    bits = np.unpackbits(be, axis=1)[:, 64 - width:]
    return np.packbits(bits.ravel()).tobytes()


def rlev2_direct(vals: np.ndarray, signed: bool) -> bytes:
    """Values as a sequence of RLEv2 DIRECT runs of at most 512 values.
    DIRECT is valid for any data, and the reader decodes all four
    sub-encodings, so the writer needs only this one."""
    v = vals.astype(np.int64)
    if signed:
        u = ((v << 1) ^ (v >> 63)).astype(np.uint64)     # zigzag
    else:
        u = v.astype(np.uint64)
    out = bytearray()
    for s in range(0, len(u), 512):
        chunk = u[s:s + 512]
        m = int(chunk.max()) if len(chunk) else 0
        width = _fit_width(max(m.bit_length(), 1))
        code = _WIDTH_CODE[width]
        ln = len(chunk) - 1
        out.append(0x40 | (code << 1) | (ln >> 8))
        out.append(ln & 0xFF)
        out += _pack_msb(chunk, width)
    return bytes(out)


def zigzag_varints(vals: np.ndarray) -> bytes:
    """Unbounded base-128 varints of the zigzagged int64 values (ORC's
    DECIMAL DATA stream), vectorized: each value's 7-bit groups, low first,
    the high bit set on every group but its last."""
    v = vals.astype(np.int64)
    u = ((v << 1) ^ (v >> 63)).astype(np.uint64)
    groups = (u[:, None] >> (np.arange(10, dtype=np.uint64) * 7)[None, :]) \
        & np.uint64(0x7F)
    # a value takes one group, and one more for each 7 bits past the first 7
    ngroups = np.ones(len(u), np.int64)
    for j in range(1, 10):
        ngroups += u >= np.uint64(1 << (7 * j))
    k = np.arange(10)[None, :]
    cont = (k < (ngroups[:, None] - 1)).astype(np.uint64) << np.uint64(7)
    body = (groups | cont).astype(np.uint8)
    return body[k < ngroups[:, None]].tobytes()


# --- column encoders --------------------------------------------------------

def _encode_column(streams: list, col_id: int, col, dt: T.DataType,
                   num_rows: int):
    """Append one column's stripe streams ``(kind, column, bytes)`` to
    ``streams``; returns (encoding kind, dictionary size, n_valid,
    has_null)."""
    kind = _kind_of(dt)
    vals, n_valid, null_count, _vmin, _vmax, valid = PW.prep_column(
        col, num_rows)
    if null_count:
        streams.append((S_PRESENT, col_id, bool_rle(valid)))

    if kind == K_STRING:
        entries = ([] if col.dictionary is None
                   else [s.encode("utf-8") for s in
                         col.dictionary.to_pylist()])
        streams.append((S_DATA, col_id, rlev2_direct(vals, signed=False)))
        streams.append((S_DICT_DATA, col_id, b"".join(entries)))
        streams.append((S_LENGTH, col_id, rlev2_direct(
            np.array([len(e) for e in entries], np.int64), signed=False)))
        return E_DICTIONARY_V2, len(entries), n_valid, bool(null_count)
    if kind in (K_SHORT, K_INT, K_LONG, K_DATE):
        streams.append((S_DATA, col_id, rlev2_direct(vals, signed=True)))
        return E_DIRECT_V2, 0, n_valid, bool(null_count)
    if kind in (K_FLOAT, K_DOUBLE):
        streams.append((S_DATA, col_id, vals.astype(
            "<f4" if kind == K_FLOAT else "<f8").tobytes()))
        return E_DIRECT, 0, n_valid, bool(null_count)
    if kind == K_BYTE:
        streams.append((S_DATA, col_id,
                        byte_rle(vals.astype(np.int8).tobytes())))
        return E_DIRECT, 0, n_valid, bool(null_count)
    if kind == K_TIMESTAMP:
        rel = vals.astype(np.int64) - _TS_BASE_MICROS
        secs = np.floor_divide(rel, 1_000_000)
        nanos = (rel - secs * 1_000_000) * 1000
        streams.append((S_DATA, col_id, rlev2_direct(secs, signed=True)))
        streams.append((S_SECONDARY, col_id,
                        rlev2_direct(nanos << 3, signed=False)))
        return E_DIRECT_V2, 0, n_valid, bool(null_count)
    if kind == K_BOOLEAN:
        streams.append((S_DATA, col_id, bool_rle(vals.astype(np.uint8))))
        return E_DIRECT, 0, n_valid, bool(null_count)
    # K_DECIMAL
    streams.append((S_DATA, col_id, zigzag_varints(vals)))
    streams.append((S_SECONDARY, col_id, rlev2_direct(
        np.full(n_valid, dt.scale, np.int64), signed=True)))
    return E_DIRECT_V2, 0, n_valid, bool(null_count)


# --- the file writer --------------------------------------------------------

class NativeOrcFile:
    """A streaming writer: one stripe per ``append_batch()``, as the task
    writer's open → append* → close lifecycle (ColumnarOutputWriter)."""

    def __init__(self, path: str, schema: T.StructType,
                 compression: str = "zlib"):
        for f in schema.fields:
            _kind_of(f.data_type)       # raises on a type it cannot frame
        codec = compression.lower()
        if codec not in CODECS:
            raise ValueError(f"native orc writer: codec {compression}")
        self.codec = CODECS[codec]
        self.path = path
        self.schema = schema
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offset = len(MAGIC)
        self._stripes = []       # StripeInformation fields
        self._num_rows = 0
        # the footer's statistics per column (the root included):
        # [n_values, has_null]
        self._stats = [[0, False] for _ in range(len(schema.fields) + 1)]

    def append_batch(self, batch) -> int:
        n = batch.num_rows
        streams = []
        encodings = [(E_DIRECT, 0)]             # the root struct
        for i, (field, col) in enumerate(zip(self.schema.fields,
                                             batch.columns)):
            enc, dsize, n_valid, has_null = _encode_column(
                streams, i + 1, col, field.data_type, n)
            encodings.append((enc, dsize))
            self._stats[i + 1][0] += n_valid
            self._stats[i + 1][1] |= has_null
        self._stats[0][0] += n

        comp = [(kind, col, _compress_chunked(blob, self.codec))
                for kind, col, blob in streams]
        data = b"".join(blob for _, _, blob in comp)
        sf = _Proto()
        for kind, col, blob in comp:
            s = _Proto()
            s.uint(1, kind)
            s.uint(2, col)
            s.uint(3, len(blob))
            sf.bytes_(1, s.done())
        for enc, dsize in encodings:
            e = _Proto()
            e.uint(1, enc)
            if dsize:
                e.uint(2, dsize)
            sf.bytes_(2, e.done())
        footer = _compress_chunked(sf.done(), self.codec)

        start = self._offset
        self._f.write(data)
        self._f.write(footer)
        self._offset += len(data) + len(footer)
        self._stripes.append((start, 0, len(data), len(footer), n))
        self._num_rows += n
        return len(data) + len(footer)

    def close(self):
        if self._f is None:
            return
        ft = _Proto()
        ft.uint(1, len(MAGIC))                  # headerLength
        ft.uint(2, self._offset)                # contentLength
        for (off, ilen, dlen, flen, rows) in self._stripes:
            s = _Proto()
            s.uint(1, off)
            s.uint(2, ilen)
            s.uint(3, dlen)
            s.uint(4, flen)
            s.uint(5, rows)
            ft.bytes_(3, s.done())
        root = _Proto()
        root.uint(1, K_STRUCT)
        root.packed(2, range(1, len(self.schema.fields) + 1))
        for f in self.schema.fields:
            root.bytes_(3, f.name.encode("utf-8"))
        ft.bytes_(4, root.done())
        for f in self.schema.fields:
            t = _Proto()
            t.uint(1, _kind_of(f.data_type))
            if isinstance(f.data_type, T.DecimalType):
                t.uint(5, f.data_type.precision)
                t.uint(6, f.data_type.scale)
            ft.bytes_(4, t.done())
        ft.uint(6, self._num_rows)
        for n_values, has_null in self._stats:
            st = _Proto()
            st.uint(1, n_values)
            st.uint(10, 1 if has_null else 0)
            ft.bytes_(7, st.done())
        footer = _compress_chunked(ft.done(), self.codec)
        self._f.write(footer)

        ps = _Proto()
        ps.uint(1, len(footer))
        ps.uint(2, self.codec)                  # CompressionKind
        if self.codec != C_NONE:
            ps.uint(3, _BLOCK)                  # compressionBlockSize
        ps.packed(4, [0, 12])                   # file version 0.12
        ps.uint(5, 0)                           # no metadata section
        ps.uint(6, 1)                           # writerVersion
        ps.bytes_(8000, MAGIC)
        psb = ps.done()
        self._f.write(psb)
        self._f.write(struct.pack("B", len(psb)))
        self._f.close()
        self._f = None

    def abort(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def write_batch_file(path: str, batch, schema: T.StructType,
                     compression: str = "zlib") -> int:
    """One batch → one single-stripe file (the task writer's shape).
    Returns the bytes written; a failure removes the partial file and
    raises."""
    f = NativeOrcFile(path, schema, compression)
    try:
        f.append_batch(batch)
        f.close()
    except BaseException:
        f.abort()
        if os.path.exists(path):
            os.unlink(path)
        raise
    return os.path.getsize(path)
