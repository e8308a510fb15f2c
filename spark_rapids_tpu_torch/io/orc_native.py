"""Native ORC stripe access: protobuf metadata and the RLEv2 run scan on the
host, the bulk bit-unpack on the device.

Counterpart of ``spark_rapids_tpu/io/orc_native.py`` (reference
GpuOrcScan.scala:375 copies stripe bytes to the GPU where libcudf decodes).
The same split as ``io/parquet_native.py``: the protobuf footers and the
RLEv2 run headers are metadata, parsed here with a minimal proto-wire
reader, while the packed payload bits go to the device
(``ops/orc_decode.py``: MSB-first bit-unpack and zigzag, torch ops).

Scope: flat schemas; UNCOMPRESSED, ZLIB or SNAPPY files (``read_meta``
refuses every other codec, and the scan reads such a file through arrow
whole); INT/LONG (and SHORT read as INT) columns in DIRECT_V2 (all four
RLEv2 sub-encodings), DOUBLE as raw IEEE, strings in DICTIONARY_V2 (the ORC
dictionary maps onto the engine's sorted dictionary; row bytes never
materialize) or DIRECT_V2, and PRESENT null streams. Any other column
(DATE, DECIMAL, BOOLEAN, another encoding) is read through pyarrow for that
column of that stripe: ``routes`` counts both ways.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

MAGIC = b"ORC"

# ORC "closest fixed bit width" table: 5-bit code → bit width
_WIDTH_TABLE = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]

#: ORC reads since the last reset_routes(): ``device_columns`` (a column of
#: a stripe decoded by read_stripe_device), ``arrow_columns`` (a column of a
#: stripe it hands to pyarrow) and ``arrow_files`` (a file the scan reads
#: through the arrow reader whole: a codec read_meta refuses, or a stripe
#: above the reader caps)
routes = {"device_columns": 0, "arrow_columns": 0, "arrow_files": 0}
_ROUTES_LOCK = threading.Lock()


def reset_routes() -> None:
    with _ROUTES_LOCK:
        for k in routes:
            routes[k] = 0


def route(name: str, n: int = 1) -> None:
    with _ROUTES_LOCK:
        routes[name] += n


def _closest_fixed_bits(n: int) -> int:
    """ORC getClosestFixedBits: the smallest encodable width ≥ n."""
    for w in _WIDTH_TABLE:
        if w >= n:
            return w
    return 64


class _ProtoReader:
    """Just enough protobuf wire format for ORC footers."""

    def __init__(self, buf: bytes, pos: int = 0, end: int | None = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def fields(self):
        """Yield (field_number, wire_type, value_or_bytes)."""
        while self.pos < self.end:
            tag = self.varint()
            fnum, wt = tag >> 3, tag & 7
            if wt == 0:
                yield fnum, wt, self.varint()
            elif wt == 2:
                ln = self.varint()
                data = self.buf[self.pos:self.pos + ln]
                self.pos += ln
                yield fnum, wt, data
            elif wt == 5:
                data = self.buf[self.pos:self.pos + 4]
                self.pos += 4
                yield fnum, wt, data
            elif wt == 1:
                data = self.buf[self.pos:self.pos + 8]
                self.pos += 8
                yield fnum, wt, data
            else:
                raise NotImplementedError(f"proto wire type {wt}")


class StripeInfo:
    __slots__ = ("offset", "index_length", "data_length", "footer_length",
                 "num_rows")

    def __init__(self):
        self.offset = self.index_length = self.data_length = 0
        self.footer_length = self.num_rows = 0


class OrcMeta:
    __slots__ = ("stripes", "column_kinds", "column_names", "compression")

    def __init__(self):
        self.stripes: list[StripeInfo] = []
        self.column_kinds: list[int] = []   # leaf type kind per column
        self.column_names: list[str] = []
        self.compression = 0


# CompressionKind
C_NONE, C_ZLIB, C_SNAPPY, C_LZO, C_LZ4, C_ZSTD = 0, 1, 2, 3, 4, 5


def _decompress_chunked(buf: bytes, codec: int) -> bytes:
    """Decompress one ORC stream: a sequence of chunks, each with a 3-byte
    little-endian header ``(chunkLength << 1) | isOriginal`` (ORC spec
    'Compression'). ZLIB is raw DEFLATE; SNAPPY's uncompressed length rides
    as the snappy block's leading varint."""
    import zlib
    out = []
    pos = 0
    n = len(buf)
    while pos + 3 <= n:
        hdr = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16)
        pos += 3
        length = hdr >> 1
        chunk = buf[pos:pos + length]
        pos += length
        if hdr & 1:                       # isOriginal: stored uncompressed
            out.append(chunk)
        elif codec == C_ZLIB:
            out.append(zlib.decompressobj(wbits=-15).decompress(chunk))
        elif codec == C_SNAPPY:
            import pyarrow as pa
            size = shift = 0
            i = 0
            while True:
                b = chunk[i]
                size |= (b & 0x7F) << shift
                i += 1
                if not b & 0x80:
                    break
                shift += 7
            dec = pa.Codec("snappy").decompress(chunk, size)
            out.append(dec.to_pybytes() if hasattr(dec, "to_pybytes")
                       else bytes(dec))
        else:
            raise NotImplementedError(f"ORC compression codec {codec}")
    return b"".join(out)


K_SHORT, K_INT, K_LONG = 2, 3, 4
K_FLOAT, K_DOUBLE = 5, 6
K_STRING = 7
# stream kinds
S_PRESENT, S_DATA = 0, 1
S_LENGTH, S_DICT_DATA = 2, 3
# column encodings
E_DIRECT, E_DICTIONARY, E_DIRECT_V2, E_DICTIONARY_V2 = 0, 1, 2, 3


def read_meta(path: str) -> OrcMeta:
    """The file's stripes, its flat columns' kinds and names, and its codec.
    Raises NotImplementedError for a file out of the device scope (not
    ORC, a codec other than NONE/ZLIB/SNAPPY, nested columns)."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        tail_len = min(size, 16 * 1024)
        f.seek(size - tail_len)
        tail = f.read(tail_len)
        # layout: ...stripes | metadata | footer | postscript | psLen(1).
        # The "ORC" magic rides at the end of the postscript, so the last 4
        # bytes are b"ORC" + psLen.
        if tail[-4:-1] != MAGIC:
            raise NotImplementedError("not an ORC file")
        ps_len = tail[-1]
        meta = OrcMeta()
        footer_len = 0
        for fnum, wt, val in _ProtoReader(tail[-1 - ps_len:-1]).fields():
            if fnum == 1:
                footer_len = val
            elif fnum == 2:
                meta.compression = val
        if meta.compression not in (C_NONE, C_ZLIB, C_SNAPPY):
            raise NotImplementedError(
                f"ORC compression codec {meta.compression}: host path")
        need = 1 + ps_len + footer_len
        if need > tail_len:            # a large footer: read exactly enough
            f.seek(size - need)
            tail = f.read(need)
    footer = tail[-1 - ps_len - footer_len:-1 - ps_len]
    if meta.compression != C_NONE:
        footer = _decompress_chunked(footer, meta.compression)
    types: list[tuple[int, list, list]] = []   # (kind, subtypes, names)
    for fnum, wt, val in _ProtoReader(footer).fields():
        if fnum == 3:          # StripeInformation
            si = StripeInfo()
            for f2, _w, v in _ProtoReader(val).fields():
                if f2 == 1:
                    si.offset = v
                elif f2 == 2:
                    si.index_length = v
                elif f2 == 3:
                    si.data_length = v
                elif f2 == 4:
                    si.footer_length = v
                elif f2 == 5:
                    si.num_rows = v
            meta.stripes.append(si)
        elif fnum == 4:        # Type
            kind, subtypes, names = 0, [], []
            for f2, w2, v in _ProtoReader(val).fields():
                if f2 == 1:
                    kind = v
                elif f2 == 2:
                    if w2 == 0:
                        subtypes.append(v)
                    else:           # packed repeated uint32
                        pr = _ProtoReader(v)
                        while pr.pos < pr.end:
                            subtypes.append(pr.varint())
                elif f2 == 3:
                    names.append(v.decode("utf-8"))
            types.append((kind, subtypes, names))
    if not types or types[0][0] != 12:          # the root must be a struct
        raise NotImplementedError("non-struct root type")
    _root_kind, subtypes, names = types[0]
    for tid, name in zip(subtypes, names):
        kind, sub, _n = types[tid]
        if sub:
            raise NotImplementedError(f"nested column {name}")
        meta.column_kinds.append(kind)
        meta.column_names.append(name)
    return meta


def _read_stripe_footer(raw: bytes, si: StripeInfo, compression: int = 0):
    """(streams [(kind, column, length)], encodings [(kind, dict size)])."""
    foot_off = si.offset + si.index_length + si.data_length
    footer = raw[foot_off:foot_off + si.footer_length]
    if compression != C_NONE:
        footer = _decompress_chunked(footer, compression)
    streams, encodings = [], []
    for fnum, _w, val in _ProtoReader(footer).fields():
        if fnum == 1:
            kind = col = length = 0
            for f2, _w2, v in _ProtoReader(val).fields():
                if f2 == 1:
                    kind = v
                elif f2 == 2:
                    col = v
                elif f2 == 3:
                    length = v
            streams.append((kind, col, length))
        elif fnum == 2:
            enc = dict_size = 0
            for f2, _w2, v in _ProtoReader(val).fields():
                if f2 == 1:
                    enc = v
                elif f2 == 2:
                    dict_size = v
            encodings.append((enc, dict_size))
    return streams, encodings


def decode_boolean_rle(buf: bytes, n_bits: int) -> np.ndarray:
    """PRESENT stream: byte-RLE over bit bytes, bits MSB-first."""
    out_bytes = bytearray()
    pos = 0
    need = (n_bits + 7) // 8
    while len(out_bytes) < need and pos < len(buf):
        h = buf[pos]
        pos += 1
        if h < 128:                      # a run of h+3 copies of the next byte
            out_bytes.extend(buf[pos:pos + 1] * (h + 3))
            pos += 1
        else:                            # 256-h literal bytes
            lit = 256 - h
            out_bytes.extend(buf[pos:pos + lit])
            pos += lit
    bits = np.unpackbits(np.frombuffer(bytes(out_bytes[:need]), np.uint8),
                         bitorder="big")
    return bits[:n_bits].astype(np.int32)


def _zz(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


class _ByteReader:
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


def _unpack_msb_host(buf: bytes, byte_off: int, width: int,
                     count: int) -> np.ndarray:
    """Host MSB-first unpack of a small run (delta payloads, patch lists).
    Runs start byte-aligned, so only the run's own bytes expand."""
    if width == 0 or count == 0:
        return np.zeros(count, np.int64)
    nbytes = (width * count + 7) // 8
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, byte_off),
                         bitorder="big")[:width * count]
    mat = bits.reshape(count, width).astype(np.int64)
    pw = (1 << np.arange(width - 1, -1, -1, dtype=np.int64))
    return (mat * pw).sum(axis=1)


def scan_rlev2(buf: bytes, start: int, end: int, n_values: int,
               signed: bool):
    """Split an RLEv2 stream into runs: ``('direct', count, width,
    payload_bit_offset)`` (unpacked on the device) and ``('const', count,
    ndarray)`` (decoded here: SHORT_REPEAT, DELTA, PATCHED_BASE and DIRECT
    runs wider than 56 bits). A PATCHED_BASE run wider than 56 bits raises
    NotImplementedError, and the column goes through arrow."""
    r = _ByteReader(buf, start)
    runs = []
    got = 0
    while got < n_values and r.pos < end:
        h = r.byte()
        enc = h >> 6
        if enc == 0:                    # SHORT_REPEAT
            nbytes = ((h >> 3) & 7) + 1
            cnt = (h & 7) + 3
            v = int.from_bytes(buf[r.pos:r.pos + nbytes], "big")
            r.pos += nbytes
            if signed:
                v = _zz(v)
            runs.append(("const", cnt, np.full(cnt, v, np.int64)))
            got += cnt
        elif enc == 1:                  # DIRECT
            w = _WIDTH_TABLE[(h >> 1) & 31]
            cnt = (((h & 1) << 8) | r.byte()) + 1
            if w > 56:
                # full-width values overflow the int64 device window:
                # decode here in uint64 (it wraps mod 2^64, which is the
                # two's-complement int64)
                nbytes = (w * cnt + 7) // 8
                bits = np.unpackbits(
                    np.frombuffer(buf, np.uint8, nbytes, r.pos),
                    bitorder="big")[:w * cnt]
                mat = bits.reshape(cnt, w).astype(np.uint64)
                pw = (np.uint64(1)
                      << np.arange(w - 1, -1, -1, dtype=np.uint64))
                u = (mat * pw).sum(axis=1, dtype=np.uint64)
                if signed:
                    vals = ((u >> np.uint64(1)).astype(np.int64)
                            ^ -((u & np.uint64(1)).astype(np.int64)))
                else:
                    vals = u.astype(np.int64)
                r.pos += nbytes
                runs.append(("const", cnt, vals))
                got += cnt
                continue
            runs.append(("direct", cnt, w, r.pos * 8))
            r.pos += (cnt * w + 7) // 8
            got += cnt
        elif enc == 3:                  # DELTA
            wcode = (h >> 1) & 31
            w = 0 if wcode == 0 else _WIDTH_TABLE[wcode]
            cnt = (((h & 1) << 8) | r.byte()) + 1
            base = r.varint()
            base = _zz(base) if signed else base
            delta0 = _zz(r.varint())
            vals = np.zeros(cnt, np.int64)
            vals[0] = base
            if cnt > 1:
                vals[1] = base + delta0
            if cnt > 2:
                if w == 0:              # a fixed-delta run
                    deltas = np.full(cnt - 2, abs(delta0), np.int64)
                else:
                    deltas = _unpack_msb_host(buf, r.pos, w, cnt - 2)
                    r.pos += (w * (cnt - 2) + 7) // 8
                sign = 1 if delta0 >= 0 else -1
                vals[2:] = vals[1] + sign * np.cumsum(deltas)
            runs.append(("const", cnt, vals))
            got += cnt
        else:                           # PATCHED_BASE, decoded here
            w = _WIDTH_TABLE[(h >> 1) & 31]
            cnt = (((h & 1) << 8) | r.byte()) + 1
            b3 = r.byte()
            bw = ((b3 >> 5) & 7) + 1          # base width, bytes
            pw = _WIDTH_TABLE[b3 & 31]        # patch width, bits
            b4 = r.byte()
            pgw = ((b4 >> 5) & 7) + 1         # patch gap width, bits
            pll = b4 & 31                     # patch list length
            if w > 56 or _closest_fixed_bits(pgw + pw) > 56:
                raise NotImplementedError("patched-base width > 56")
            base = int.from_bytes(buf[r.pos:r.pos + bw], "big")
            r.pos += bw
            sign_bit = 1 << (bw * 8 - 1)      # a sign-magnitude base
            if base & sign_bit:
                base = -(base & (sign_bit - 1))
            vals = _unpack_msb_host(buf, r.pos, w, cnt)
            r.pos += (w * cnt + 7) // 8
            # writers pack patch entries at getClosestFixedBits(pgw + pw);
            # the gap sits in bits [pw, pw + pgw) (the top padding is zero)
            cw = _closest_fixed_bits(pgw + pw)
            entries = _unpack_msb_host(buf, r.pos, cw, pll)
            r.pos += (cw * pll + 7) // 8
            at = 0
            for e in entries:
                at += int(e) >> pw
                patch = int(e) & ((1 << pw) - 1)
                vals[at] |= patch << w
            runs.append(("const", cnt, base + vals))
            got += cnt
    if got < n_values:
        raise NotImplementedError("short RLEv2 stream")
    return runs


def _present_tensor(present: np.ndarray, n_rows: int, capacity: int,
                    device) -> torch.Tensor:
    pres = torch.zeros((capacity,), dtype=torch.bool)
    pres[:n_rows] = torch.from_numpy(present.astype(bool))
    return pres.to(device)


def _spread(present_vals: torch.Tensor, pcap: int, present, n_rows: int,
            capacity: int, dtype, device):
    """Present values (the first ``pcap`` slots) over the row layout:
    ``(values, validity)`` at ``capacity``."""
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    padded = torch.zeros((capacity,), dtype=dtype, device=device)
    k = min(pcap, capacity, present_vals.shape[0])
    padded[:k] = present_vals[:k]
    if present is None:
        valid = torch.arange(capacity, device=device) < n_rows
        return padded, valid
    return PD.expand_present_to_rows(
        padded, _present_tensor(present, n_rows, capacity, device), capacity)


def intv2_column_to_device(raw: bytes, data_off: int, data_len: int,
                           present: np.ndarray | None, n_rows: int,
                           spark_type, capacity: int, raw_dev: torch.Tensor,
                           signed: bool = True, return_raw: bool = False):
    """One INT/LONG DIRECT_V2 column of a stripe → device column: run
    headers on the host, DIRECT payload bits unpacked on the device,
    constant runs merged. ``raw_dev`` is the stripe's bytes on the device
    (uploaded once a stripe by read_stripe_device, shared by its columns),
    and the column lands on its device."""
    from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                        bucket_capacity)
    from spark_rapids_tpu_torch.ops import orc_decode as OD

    n_present = n_rows if present is None else int(present.sum())
    runs = scan_rlev2(raw, data_off, data_off + data_len, n_present, signed)
    pcap = max(bucket_capacity(max(n_present, 1)), 8)
    bit_offsets = np.zeros(pcap, np.int64)
    widths = np.zeros(pcap, np.int64)
    const_mask = np.zeros(pcap, bool)
    const_vals = np.zeros(pcap, np.int64)
    at = 0
    for run in runs:
        if run[0] == "direct":
            _k, cnt, w, bit0 = run
            bit_offsets[at:at + cnt] = bit0 + w * np.arange(cnt)
            widths[at:at + cnt] = w
        else:
            _k, cnt, vals = run
            const_mask[at:at + cnt] = True
            const_vals[at:at + cnt] = vals
        at += cnt
    device = raw_dev.device
    present_vals = OD.decode_intv2_device(
        raw_dev, *(torch.from_numpy(a).to(device) for a in
                   (bit_offsets, widths, const_mask, const_vals)),
        signed, pcap)
    if return_raw:
        return present_vals, n_present, pcap
    vals, valid = _spread(present_vals, pcap, present, n_rows, capacity,
                          torch.int64, device)
    out = vals.to(spark_type.torch_dtype)
    out = torch.where(valid, out, torch.zeros_like(out))
    return TorchColumnVector(spark_type, out, valid)


def float_column_to_device(raw: bytes, data_off: int, data_len: int,
                           present: np.ndarray | None, n_rows: int,
                           spark_type, capacity: int, device):
    """FLOAT/DOUBLE: the DATA stream is raw little-endian IEEE (4 or 8
    bytes); one host view and one copy, then the null spread on the
    device."""
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    n_present = n_rows if present is None else int(present.sum())
    np_dt = np.float32 if isinstance(spark_type, T.FloatType) else np.float64
    vals_np = np.frombuffer(raw, np.dtype(np_dt).newbyteorder("<"),
                            n_present, data_off).astype(np_dt)
    padded = np.zeros(capacity, np_dt)
    padded[:n_present] = vals_np
    vals, valid = _spread(torch.from_numpy(padded).to(device), capacity,
                          present, n_rows, capacity, spark_type.torch_dtype,
                          device)
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    return TorchColumnVector(spark_type, vals, valid)


# SHORT reads as smallint, as Spark reads it; the reference maps it to INT
# here (orc_native.py:504), which never matches the smallint its schema
# gives the column, so it reads every SHORT column through arrow. BYTE
# (byte RLE) and TIMESTAMP columns take the arrow reader, as there.
_KIND_TO_TYPE = {K_SHORT: T.SHORT, K_INT: T.INT, K_LONG: T.LONG,
                 K_FLOAT: T.FLOAT, K_DOUBLE: T.DOUBLE, K_STRING: T.STRING}


def read_stripe_device(path: str, meta: OrcMeta, stripe_idx: int, schema,
                       device, pf=None):
    """Read one stripe through the device decode; a column out of its scope
    is read through pyarrow for this stripe. Returns a ColumnarBatch and
    counts each column's way in ``routes``."""
    from spark_rapids_tpu_torch.columnar.arrow import array_to_device
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity

    device = torch.device(device)
    si = meta.stripes[stripe_idx]
    with open(path, "rb") as f:
        f.seek(si.offset)
        raw = f.read(si.index_length + si.data_length + si.footer_length)
    # offsets relative to the stripe: the footer's stream lengths are laid
    # out from the stripe start (index region first, then data)
    si_rel = StripeInfo()
    si_rel.index_length = si.index_length
    si_rel.data_length = si.data_length
    si_rel.footer_length = si.footer_length
    streams, encodings = _read_stripe_footer(raw, si_rel, meta.compression)
    n_rows = si.num_rows
    cap = bucket_capacity(max(n_rows, 1))

    # each stream's offset within `raw`, in file order. A compressed
    # stripe's streams decompress on the host and `raw` becomes their
    # concatenation, so the offsets, the upload and every decoder below work
    # unchanged
    offsets = {}
    if meta.compression == C_NONE:
        off = 0
        for kind, col, length in streams:
            offsets[(kind, col)] = (off, length)
            off += length
    else:
        pieces = []
        src_off = new_off = 0
        for kind, col, length in streams:
            blob = _decompress_chunked(raw[src_off:src_off + length],
                                       meta.compression)
            src_off += length
            pieces.append(blob)
            offsets[(kind, col)] = (new_off, len(blob))
            new_off += len(blob)
        raw = b"".join(pieces)

    name_to_col = {n: i for i, n in enumerate(meta.column_names)}
    raw_dev = None  # uploaded at first need, once, shared by the columns

    def stripe_bytes():
        nonlocal raw_dev
        if raw_dev is None:
            host = torch.frombuffer(bytearray(raw), dtype=torch.uint8) \
                if raw else torch.zeros(1, dtype=torch.uint8)
            raw_dev = host.to(device)
        return raw_dev

    cols, fields = [], []
    for f_ in schema.fields:
        sf_type = f_.data_type
        try:
            ci = name_to_col.get(f_.name)
            if ci is None:
                raise NotImplementedError(f"unknown column {f_.name}")
            col_id = ci + 1                     # the root struct is column 0
            kind = meta.column_kinds[ci]
            want = _KIND_TO_TYPE.get(kind)
            if want is None or type(want) is not type(sf_type):
                raise NotImplementedError(f"kind {kind} vs {sf_type}")
            enc, dict_size = (encodings[col_id]
                              if col_id < len(encodings) else (0, 0))
            present = None
            if (S_PRESENT, col_id) in offsets:
                poff, plen = offsets[(S_PRESENT, col_id)]
                present = decode_boolean_rle(raw[poff:poff + plen], n_rows)
            doff, dlen = offsets[(S_DATA, col_id)]
            if kind in (K_SHORT, K_INT, K_LONG):
                if enc != E_DIRECT_V2:
                    raise NotImplementedError(f"int encoding {enc}")
                cv = intv2_column_to_device(
                    raw, doff, dlen, present, n_rows, sf_type, cap,
                    stripe_bytes())
            elif kind == K_STRING:
                if enc == E_DICTIONARY_V2:
                    cv = string_column_to_device(
                        raw, offsets, col_id, present, n_rows, cap,
                        stripe_bytes(), dict_size)
                elif enc == E_DIRECT_V2:
                    cv = direct_string_column_to_device(
                        raw, offsets, col_id, present, n_rows, cap, device)
                else:
                    raise NotImplementedError(f"string encoding {enc}")
            else:
                cv = float_column_to_device(
                    raw, doff, dlen, present, n_rows, sf_type, cap, device)
            route("device_columns")
        except NotImplementedError:
            import pyarrow.orc as orc
            route("arrow_columns")
            pfile = pf if pf is not None else orc.ORCFile(path)
            tbl = pfile.read_stripe(stripe_idx, columns=[f_.name])
            arr = tbl.column(0) if hasattr(tbl, "column") else tbl[0]
            cv = array_to_device(arr, sf_type, cap, device)
        cols.append(cv)
        fields.append(f_)
    return ColumnarBatch(cols, n_rows, T.StructType(fields))


def rlev2_decode_host(raw: bytes, off: int, length: int, n: int,
                      signed: bool) -> np.ndarray:
    """A whole RLEv2 stream decoded on the host (small streams: LENGTH)."""
    out = np.zeros(n, np.int64)
    at = 0
    for run in scan_rlev2(raw, off, off + length, n, signed):
        if run[0] == "direct":
            _k, cnt, w, bit0 = run
            vals = _unpack_msb_host(raw, bit0 // 8, w, cnt)
            if bit0 % 8:
                raise NotImplementedError("unaligned direct run")
            if signed:
                vals = (vals >> 1) ^ -(vals & 1)
            out[at:at + cnt] = vals
        else:
            out[at:at + run[1]] = run[2]
        at += run[1]
    return out


def string_column_to_device(raw: bytes, offsets: dict, col_id: int,
                            present: np.ndarray | None, n_rows: int,
                            capacity: int, raw_dev: torch.Tensor,
                            n_dict: int):
    """DICTIONARY_V2 string column → engine string column. The ORC
    dictionary (DICTIONARY_DATA and LENGTH streams, its size from the stripe
    footer) maps onto the engine's sorted dictionary through one rank
    array; the row indices (DATA, unsigned RLEv2) decode on the device and
    are gathered through it, so row bytes never materialize."""
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu_torch.ops.strings import sorted_dict_and_rank

    if (S_DICT_DATA, col_id) not in offsets or \
            (S_LENGTH, col_id) not in offsets or n_dict <= 0:
        raise NotImplementedError("direct-encoded strings: host path")
    ddoff, ddlen = offsets[(S_DICT_DATA, col_id)]
    loff, llen = offsets[(S_LENGTH, col_id)]
    doff, dlen = offsets[(S_DATA, col_id)]
    lens = rlev2_decode_host(raw, loff, llen, n_dict, signed=False)
    ends = np.cumsum(lens)
    starts = ends - lens
    blob = raw[ddoff:ddoff + ddlen]
    entries = [blob[s:e].decode("utf-8") for s, e in zip(starts, ends)]
    sorted_dict, rank = sorted_dict_and_rank(entries)

    device = raw_dev.device
    idx, _n_present, pcap = intv2_column_to_device(
        raw, doff, dlen, present, n_rows, T.LONG, capacity, raw_dev,
        signed=False, return_raw=True)
    safe = idx.to(torch.int32).clamp(0, max(n_dict - 1, 0)).long()
    codes_present = torch.from_numpy(rank).to(device)[safe]
    codes, valid = _spread(codes_present, pcap, present, n_rows, capacity,
                           torch.int32, device)
    codes = torch.where(valid, codes, torch.zeros_like(codes))  # null = 0
    return TorchColumnVector(T.STRING, codes, valid, sorted_dict)


def direct_string_column_to_device(raw: bytes, offsets: dict, col_id: int,
                                   present: np.ndarray | None, n_rows: int,
                                   capacity: int, device):
    """DIRECT_V2 string column (no dictionary): DATA is the concatenated
    UTF-8 bytes, LENGTH the per-present-row byte lengths (unsigned RLEv2).
    An arrow StringArray over (offsets, bytes) goes through the engine's
    dictionary encoding."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar import arrow as ai
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector

    doff, dlen = offsets[(S_DATA, col_id)]
    loff, llen = offsets[(S_LENGTH, col_id)]
    n_present = n_rows if present is None else int(present.sum())
    if n_present == 0:
        z = torch.zeros((capacity,), dtype=torch.int32, device=device)
        return TorchColumnVector(T.STRING, z, z.to(torch.bool),
                                 pa.array([], pa.string()))
    lens = rlev2_decode_host(raw, loff, llen, n_present, signed=False)
    off_arr = np.zeros(n_present + 1, np.int32)
    np.cumsum(lens, out=off_arr[1:])
    blob = raw[doff:doff + dlen]
    arr = pa.StringArray.from_buffers(
        n_present, pa.py_buffer(off_arr.tobytes()), pa.py_buffer(blob))
    cv = ai.string_array_to_device(arr, device)
    codes, valid = _spread(cv.data, cv.capacity, present, n_rows, capacity,
                           torch.int32, device)
    codes = torch.where(valid, codes, torch.zeros_like(codes))
    return TorchColumnVector(T.STRING, codes, valid, cv.dictionary)
