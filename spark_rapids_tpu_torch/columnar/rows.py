"""Packed binary rows — the port's own copy of
``spark_rapids_tpu/columnar/rows.py`` (the CudfUnsafeRow / row↔columnar
codegen analog), host numpy code that ``DataFrame.collect_row_buffer`` and
``TorchSession.create_dataframe_from_rows`` use. The layouts are the
reference's, word for word; a decimal column is read from and written to
its decimal128 buffers directly (the reference goes through Python
``Decimal`` objects; the words are the same).

Reference: GpuRowToColumnarExec.scala:788 + GeneratedUnsafeRowToCudfRowIterator
(:635) generate Janino code that copies UnsafeRow fixed-width fields into
packed device rows, and CudfUnsafeRow (java, 399 LoC) defines the packed
layout; GpuColumnarToRowExec:341 goes the other way. The point of the
codegen is to avoid per-row/per-field interpretation for FIXED-WIDTH
schemas. Here "generate code per schema" is "compute a strided layout per
schema and execute it as whole-column numpy ops": zero per-row Python, one
pass per column.

Layout (UnsafeRow-flavored): each row is 8-byte words —
  [null bitset words][one 8-byte slot per field]
bools/ints zero-extended into their slot, floats/doubles bit-cast,
dates/timestamps as their integer representation. Variable-width columns
(strings) take the UnsafeRow-style variable layout (``pack_arrow_var``).
"""

from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import types as T

_FIXED = (T.BooleanType, T.IntegerType, T.LongType, T.FloatType,
          T.DoubleType, T.DateType, T.TimestampType, T.DecimalType)


def is_fixed_width(schema) -> bool:
    return all(isinstance(f.data_type, _FIXED) for f in schema.fields)


def row_layout(schema):
    """(null_words, total_words): the per-schema 'generated code'."""
    nf = len(schema.fields)
    if nf > 64 * 8:
        raise NotImplementedError("more than 512 fields")
    null_words = max(1, -(-nf // 64))
    return null_words, null_words + nf


def _col_bits(dtype, data: np.ndarray) -> np.ndarray:
    """Column values → int64 slot bit patterns (vectorized)."""
    if isinstance(dtype, (T.FloatType,)):
        return np.ascontiguousarray(data.astype(np.float32)).view(
            np.int32).astype(np.int64) & 0xFFFFFFFF
    if isinstance(dtype, T.DoubleType):
        return np.ascontiguousarray(data.astype(np.float64)).view(np.int64)
    return data.astype(np.int64)


def _bits_to_col(dtype, words: np.ndarray):
    if isinstance(dtype, T.FloatType):
        return words.astype(np.int64).astype(np.uint64).astype(
            np.uint32).view(np.float32)
    if isinstance(dtype, T.DoubleType):
        return words.view(np.float64)
    if isinstance(dtype, T.BooleanType):
        return words.astype(bool)
    if isinstance(dtype, T.IntegerType) or isinstance(dtype, T.DateType):
        return words.astype(np.int32)
    return words.copy()


def _decimal_words(arr) -> np.ndarray:
    """A decimal128 array's scaled int64 values (0 where null)."""
    from spark_rapids_tpu_torch.columnar.arrow import _decimal_unscaled_int64
    import pyarrow.compute as pc
    data = _decimal_unscaled_int64(arr)
    return np.where(pc.is_valid(arr).to_numpy(zero_copy_only=False), data, 0)


def _decimal_array(data: np.ndarray, valid: np.ndarray, dt):
    """Scaled int64 values → a decimal128 arrow array (low word and its
    sign extension)."""
    import pyarrow as pa
    n = len(data)
    words = np.zeros((n, 2), dtype=np.int64)
    words[:, 0] = np.where(valid, data, 0)
    words[:, 1] = words[:, 0] >> 63
    mask = np.packbits(valid, bitorder="little")
    return pa.Array.from_buffers(T.to_arrow_type(dt), n,
                                 [pa.py_buffer(mask.tobytes()),
                                  pa.py_buffer(words.tobytes())])


def pack_rows(batch) -> np.ndarray:
    """ColumnarBatch (fixed-width schema) → (n, total_words) int64 row
    buffer. One vectorized store per column; null bits packed per word."""
    schema = batch.schema
    if not is_fixed_width(schema):
        raise NotImplementedError("variable-width schema: use arrow")
    null_words, total = row_layout(schema)
    n = batch.num_rows
    out = np.zeros((n, total), np.int64)
    for j, f in enumerate(schema.fields):
        col = batch.column(j)
        data, valid = col.to_host(n)
        out[:, null_words + j] = np.where(valid, _col_bits(f.data_type, data),
                                          0)
        w, bit = j // 64, j % 64
        out[:, w] |= np.where(valid, np.int64(0),
                              np.int64(1) << np.int64(bit))
    return out


def unpack_rows(rows: np.ndarray, schema, device):
    """(n, total_words) int64 row buffer → ColumnarBatch on ``device``."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                        bucket_capacity)

    null_words, total = row_layout(schema)
    if rows.ndim != 2 or rows.shape[1] != total:
        raise ValueError(f"row buffer shape {rows.shape} != (*, {total})")
    n = rows.shape[0]
    cap = bucket_capacity(max(n, 1))
    cols = []
    for j, f in enumerate(schema.fields):
        w, bit = j // 64, j % 64
        null = (rows[:, w] >> np.int64(bit)) & 1
        valid_np = (null == 0)
        data_np = _bits_to_col(f.data_type, rows[:, null_words + j])
        cols.append(TorchColumnVector.from_numpy(
            f.data_type, data_np.astype(T.to_numpy_dtype(f.data_type)),
            valid_np, cap, device))
    return ColumnarBatch(cols, n, schema)


def pack_arrow(tbl, schema) -> np.ndarray:
    """Arrow table (fixed-width schema) → row buffer, host-only — no device
    round-trip (the session collect() result is already host arrow)."""
    import pyarrow as pa
    if not is_fixed_width(schema):
        raise NotImplementedError("variable-width schema: use arrow")
    null_words, total = row_layout(schema)
    n = tbl.num_rows
    out = np.zeros((n, total), np.int64)
    for j, f in enumerate(schema.fields):
        arr = tbl.column(j).combine_chunks()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.chunk(0) if arr.num_chunks else pa.nulls(0, arr.type)
        valid = np.asarray(pa.compute.is_valid(arr))
        dt = f.data_type
        if isinstance(dt, T.DateType):
            arr = arr.cast(pa.int32())
        elif isinstance(dt, T.TimestampType):
            arr = arr.cast(pa.int64())
        if isinstance(dt, T.DecimalType):
            # the device's scaled int64 (DECIMAL64): the low words of the
            # decimal128 storage
            data = _decimal_words(arr)
        else:
            # fill nulls BEFORE to_numpy: a nullable int column would
            # otherwise come back as float64 and corrupt values > 2^53;
            # valid NaN floats must survive (fill_null only touches nulls)
            fill = (False if isinstance(dt, T.BooleanType)
                    else 0.0 if isinstance(dt, (T.FloatType, T.DoubleType))
                    else 0)
            filled = pa.compute.fill_null(arr, fill)
            data = filled.to_numpy(zero_copy_only=False)
            if isinstance(dt, T.BooleanType):
                data = data.astype(np.int64)
        out[:, null_words + j] = np.where(valid, _col_bits(dt, data), 0)
        w, bit = j // 64, j % 64
        out[:, w] |= np.where(valid, np.int64(0),
                              np.int64(1) << np.int64(bit))
    return out


def unpack_rows_arrow(rows: np.ndarray, schema):
    """Row buffer → arrow table, host-only (scan execution does the one
    real H2D upload later)."""
    import pyarrow as pa
    null_words, total = row_layout(schema)
    if rows.ndim != 2 or rows.shape[1] != total:
        raise ValueError(f"row buffer shape {rows.shape} != (*, {total})")
    cols, names = [], []
    for j, f in enumerate(schema.fields):
        w, bit = j // 64, j % 64
        valid = ((rows[:, w] >> np.int64(bit)) & 1) == 0
        data = _bits_to_col(f.data_type, rows[:, null_words + j])
        if isinstance(f.data_type, T.DecimalType):
            cols.append(_decimal_array(data, valid, f.data_type))
        else:
            cols.append(pa.array(data, T.to_arrow_type(f.data_type),
                                 mask=~valid))
        names.append(f.name)
    return pa.table(dict(zip(names, cols)))


# -- variable-width rows ------------------------------------------------------
# Reference: full UnsafeRow/CudfUnsafeRow semantics — a string field's 8-byte
# slot holds (offset << 32) | byteLength with offset relative to the row
# base, and the UTF-8 bytes live in the row's variable region after the
# fixed slots; rows stay 8-byte aligned. Because rows vary in length the
# buffer is (flat int64 words, int64 row offsets in words) instead of a 2-D
# matrix. Packing stays fully vectorized: one ragged byte-scatter built from
# arrow's own offsets buffers — zero per-row Python (the "codegen" stance of
# the fixed-width path, extended to strings; reference
# GpuRowToColumnarExec.scala:635 generated converter).

_VAR = (T.StringType,)


def is_packable(schema) -> bool:
    """Fixed-width or string columns — the full UnsafeRow surface."""
    return all(isinstance(f.data_type, _FIXED + _VAR) for f in schema.fields)


def _string_parts(arr):
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    arr = arr.cast(pa.string())
    valid = np.asarray(pa.compute.is_valid(arr))
    # offsets/data straight from the arrow buffers (int32 offsets)
    bufs = arr.buffers()
    off = np.frombuffer(bufs[1], np.int32)[arr.offset:arr.offset + len(arr) + 1]
    data = np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None else \
        np.zeros(0, np.uint8)
    lens = (off[1:] - off[:-1]).astype(np.int64)
    lens[~valid] = 0
    return valid, off[:-1].astype(np.int64), lens, data


def pack_arrow_var(tbl, schema):
    """Arrow table (fixed-width + string schema) → (words int64[total],
    row_offsets int64[n+1] in WORDS)."""
    import pyarrow as pa
    if not is_packable(schema):
        raise NotImplementedError(f"unsupported types in {schema}")
    null_words, base = row_layout(schema)
    n = tbl.num_rows
    var_cols = {}
    var_bytes = np.zeros(n, np.int64)
    for j, f in enumerate(schema.fields):
        if isinstance(f.data_type, T.StringType):
            parts = _string_parts(tbl.column(j))
            var_cols[j] = parts
            var_bytes += parts[2]
    row_words = base + ((var_bytes + 7) >> 3)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(row_words, out=offsets[1:])
    words = np.zeros(int(offsets[-1]), np.int64)
    rows0 = offsets[:-1]

    # fixed slots + null bits (strided scatters, same as the 2-D path)
    for j, f in enumerate(schema.fields):
        w, bit = j // 64, j % 64
        if j in var_cols:
            continue
        arr = tbl.column(j).combine_chunks()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.chunk(0) if arr.num_chunks else pa.nulls(0, arr.type)
        valid = np.asarray(pa.compute.is_valid(arr))
        dt = f.data_type
        if isinstance(dt, T.DateType):
            arr = arr.cast(pa.int32())
        elif isinstance(dt, T.TimestampType):
            arr = arr.cast(pa.int64())
        if isinstance(dt, T.DecimalType):
            data = _decimal_words(arr)
        else:
            fill = (False if isinstance(dt, T.BooleanType)
                    else 0.0 if isinstance(dt, (T.FloatType, T.DoubleType))
                    else 0)
            data = pa.compute.fill_null(arr, fill).to_numpy(
                zero_copy_only=False)
            if isinstance(dt, T.BooleanType):
                data = data.astype(np.int64)
        words[rows0 + null_words + j] = np.where(
            valid, _col_bits(dt, data), 0)
        words[rows0 + w] |= np.where(valid, np.int64(0),
                                     np.int64(1) << np.int64(bit))

    # variable region: per-row running byte cursor across string columns
    bytes_view = words.view(np.uint8)   # little-endian words
    cursor = np.full(n, base * 8, np.int64)   # byte offset from row base
    for j, f in enumerate(schema.fields):
        if j not in var_cols:
            continue
        w, bit = j // 64, j % 64
        valid, src_off, lens, data = var_cols[j]
        slot = np.where(valid, (cursor << 32) | lens, 0)
        words[rows0 + null_words + j] = slot
        words[rows0 + w] |= np.where(valid, np.int64(0),
                                     np.int64(1) << np.int64(bit))
        total = int(lens.sum())
        if total:
            dst0 = rows0 * 8 + cursor            # absolute byte start per row
            starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            within = np.arange(total, dtype=np.int64) - np.repeat(starts,
                                                                  lens)
            bytes_view[np.repeat(dst0, lens) + within] = \
                data[np.repeat(src_off, lens) + within]
        cursor += lens
    return words, offsets


def unpack_rows_arrow_var(words: np.ndarray, offsets: np.ndarray, schema):
    """(words, row_offsets) → arrow table (inverse of pack_arrow_var)."""
    import pyarrow as pa
    null_words, base = row_layout(schema)
    n = len(offsets) - 1
    rows0 = offsets[:-1]
    bytes_view = np.ascontiguousarray(words).view(np.uint8)
    cols, names = [], []
    for j, f in enumerate(schema.fields):
        w, bit = j // 64, j % 64
        valid = ((words[rows0 + w] >> np.int64(bit)) & 1) == 0
        slot = words[rows0 + null_words + j]
        if isinstance(f.data_type, T.StringType):
            lens = np.where(valid, slot & 0xFFFFFFFF, 0)
            rel = np.where(valid, slot >> 32, 0)
            src0 = rows0 * 8 + rel
            total = int(lens.sum())
            out_bytes = np.zeros(total, np.uint8)
            if total:
                starts = np.zeros(n, np.int64)
                np.cumsum(lens[:-1], out=starts[1:])
                within = np.arange(total, dtype=np.int64) - np.repeat(
                    starts, lens)
                out_bytes = bytes_view[np.repeat(src0, lens) + within]
            out_off = np.zeros(n + 1, np.int64)
            out_off[1:] = np.cumsum(lens)
            arr = pa.StringArray.from_buffers(
                n, pa.py_buffer(out_off.astype(np.int32).tobytes()),
                pa.py_buffer(out_bytes.tobytes()),
                pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()))
            cols.append(arr)
        elif isinstance(f.data_type, T.DecimalType):
            cols.append(_decimal_array(slot, valid, f.data_type))
        else:
            data = _bits_to_col(f.data_type, slot)
            cols.append(pa.array(data, T.to_arrow_type(f.data_type),
                                 mask=~valid))
        names.append(f.name)
    return pa.table(dict(zip(names, cols)))
