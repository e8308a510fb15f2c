"""Columnar batch (de)serialization — counterpart of
``spark_rapids_tpu/shuffle/serialization.py``, the serializing shuffle's
wire format (reference GpuColumnarBatchSerializer.scala:50 over cudf
JCudfSerialization). The frame is the reference's, byte for byte::

  magic 'TPUB' | version u32 | num_rows u32 | num_cols u32 | schema len u32 |
  schema json |
  per column: dtype code u32 | has_dict u8 | data nbytes u64 | data |
              validity bitpacked | [dict len u64 | dict arrow-IPC stream]

Fixed-width payloads are raw little-endian numpy bytes cut to num_rows
(the padded capacity is not shipped; a reader pads to its own bucket),
validity is bit-packed 8:1 little-endian, and a string dictionary travels
as an Arrow IPC stream. So a blob written by either package reads back in
the other. Nested columns have no frame in the reference, and the port
refuses them at planning (``exec/exchange.ShuffleExchangeExec``).
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                    bucket_capacity)

_MAGIC = b"TPUB"
_VERSION = 1

# -- the reference's compact type codes and schema json (types.py:359-393) ----
_CODE_TO_TYPE = {
    1: T.BOOLEAN, 2: T.BYTE, 3: T.SHORT, 4: T.INT, 5: T.LONG, 6: T.FLOAT,
    7: T.DOUBLE, 8: T.STRING, 9: T.DATE, 10: T.TIMESTAMP, 11: T.NULL,
}
_TYPE_TO_CODE = {type(v): k for k, v in _CODE_TO_TYPE.items()}
_DECIMAL_CODE = 12


def type_code(dt: T.DataType) -> int:
    if isinstance(dt, T.DecimalType):
        # precision and scale <= 38 each fit a byte above the code space
        return _DECIMAL_CODE + (dt.precision << 8) + (dt.scale << 16)
    try:
        return _TYPE_TO_CODE[type(dt)]
    except KeyError:
        raise NotImplementedError(
            f"the serializing shuffle has no frame for {dt!r}") from None


def type_from_code(code: int) -> T.DataType:
    if code & 0xFF == _DECIMAL_CODE:
        return T.DecimalType((code >> 8) & 0xFF, (code >> 16) & 0xFF)
    return _CODE_TO_TYPE[code]


def schema_serializable(schema: T.StructType) -> bool:
    """Has every column of ``schema`` a frame?"""
    return all(isinstance(f.data_type, T.DecimalType)
               or type(f.data_type) in _TYPE_TO_CODE for f in schema)


def _type_to_json(dt: T.DataType):
    if isinstance(dt, T.DecimalType):
        return {"decimal": [dt.precision, dt.scale]}
    return dt.sql_name


def _type_from_json(obj) -> T.DataType:
    if isinstance(obj, dict):
        p, s = obj["decimal"]
        return T.DecimalType(p, s)
    for t in _CODE_TO_TYPE.values():
        if t.sql_name == obj:
            return t
    raise ValueError(f"unknown type json {obj!r}")


def schema_to_json(schema: T.StructType):
    return [{"name": f.name, "type": _type_to_json(f.data_type),
             "nullable": f.nullable} for f in schema]


def schema_from_json(obj) -> T.StructType:
    return T.StructType([T.StructField(f["name"], _type_from_json(f["type"]),
                                       f["nullable"]) for f in obj])


def _write_dict(buf: io.BytesIO, arr: pa.Array):
    sink = pa.BufferOutputStream()
    t = pa.table({"d": arr})
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    payload = sink.getvalue().to_pybytes()
    buf.write(struct.pack("<Q", len(payload)))
    buf.write(payload)


def _read_dict(view: memoryview, off: int):
    (n,) = struct.unpack_from("<Q", view, off)
    off += 8
    t = pa.ipc.open_stream(pa.BufferReader(view[off:off + n])).read_all()
    return t["d"].combine_chunks(), off + n


def serialize_batch(batch: ColumnarBatch) -> bytes:
    n = batch.num_rows
    buf = io.BytesIO()
    schema_json = json.dumps(schema_to_json(batch.schema)
                             if batch.schema is not None else None)
    sj = schema_json.encode()
    buf.write(_MAGIC)
    buf.write(struct.pack("<IIII", _VERSION, n, batch.num_cols, len(sj)))
    buf.write(sj)
    for c in batch.columns:
        code = type_code(c.dtype)
        vals, valid = c.to_host(n)
        has_dict = 1 if c.dictionary is not None else 0
        data = np.ascontiguousarray(vals).tobytes()
        buf.write(struct.pack("<IBQ", code, has_dict, len(data)))
        buf.write(data)
        buf.write(np.packbits(valid, bitorder="little").tobytes())
        if has_dict:
            _write_dict(buf, c.dictionary)
    return buf.getvalue()


def deserialize_batch(data: bytes, device="cpu") -> ColumnarBatch:
    """The batch of a frame, on ``device``: each column padded to the
    row count's capacity bucket, invalid and padding slots at the type's
    default."""
    view = memoryview(data)
    if bytes(view[:4]) != _MAGIC:
        raise ValueError("bad shuffle frame magic")
    version, n, ncols, sjlen = struct.unpack_from("<IIII", view, 4)
    if version != _VERSION:
        raise ValueError(f"shuffle frame version {version}, want {_VERSION}")
    off = 20
    schema_json = json.loads(bytes(view[off:off + sjlen]).decode())
    schema = (schema_from_json(schema_json) if schema_json is not None
              else None)
    off += sjlen
    cap = bucket_capacity(n)
    cols = []
    for _ in range(ncols):
        code, has_dict, nbytes = struct.unpack_from("<IBQ", view, off)
        off += struct.calcsize("<IBQ")
        dtype = type_from_code(code)
        np_dt = T.to_numpy_dtype(dtype)
        vals = np.frombuffer(view[off:off + nbytes], dtype=np_dt)
        off += nbytes
        vbytes = (n + 7) // 8
        valid = np.unpackbits(np.frombuffer(view[off:off + vbytes],
                                            dtype=np.uint8),
                              bitorder="little")[:n].astype(bool)
        off += vbytes
        dictionary = None
        if has_dict:
            dictionary, off = _read_dict(view, off)
        dvals = np.zeros(cap, dtype=np_dt)
        dvals[:n] = vals
        dvalid = np.zeros(cap, dtype=bool)
        dvalid[:n] = valid
        dvals[~dvalid] = dtype.default_value()
        cols.append(TorchColumnVector(
            dtype, torch.from_numpy(dvals).to(device),
            torch.from_numpy(dvalid).to(device), dictionary))
    return ColumnarBatch(cols, n, schema)
