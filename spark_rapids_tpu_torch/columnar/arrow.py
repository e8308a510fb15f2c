"""Arrow → device conversion — counterpart of ``spark_rapids_tpu/columnar/arrow.py``.

Fixed-width buffers go to the device as padded tensors; strings are
dictionary-encoded with an order-preserving (sorted) dictionary so code
comparisons equal string comparisons; decimals (p <= 18) travel as the low
64 bits of their decimal128 storage, the scaled int64. A list, map or
struct column becomes a ``ListVector``, ``MapVector`` or ``StructVector``
(``list_array_to_device``, the JAX package's layout); their elements,
values and fields convert through ``array_to_device`` again, so a nested
type of any depth crosses level by level, each list level's buffers 1:1
the JAX package's ``ListVector``.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ListVector, MapVector,
                                                    StructVector,
                                                    TorchColumnVector,
                                                    bucket_capacity)


def _validity_of(arr: pa.Array) -> np.ndarray:
    return pc.is_valid(arr).to_numpy(zero_copy_only=False)


def _decimal_unscaled_int64(arr: pa.Array) -> np.ndarray:
    """Low 64 bits of the two's-complement decimal128 storage; exact for
    p <= 18."""
    if len(arr) == 0:
        return np.zeros(0, dtype=np.int64)
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    off = arr.offset
    return words[off * 2:(off + len(arr)) * 2:2].copy()


def string_array_to_device(arr, device, capacity: int | None = None):
    """Dictionary-encode a string array with a sorted dictionary, codes to device."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        dict_vals, codes_arr = arr.dictionary, arr.indices
    else:
        enc = pc.dictionary_encode(arr.cast(pa.string()))
        dict_vals, codes_arr = enc.dictionary, enc.indices
    dict_vals = dict_vals.cast(pa.string())
    validity = _validity_of(arr)
    codes = codes_arr.fill_null(0).to_numpy(
        zero_copy_only=False).astype(np.int32)
    if len(dict_vals):
        order = pc.array_sort_indices(dict_vals)
        sorted_dict = dict_vals.take(order)
        rank = np.empty(len(dict_vals), dtype=np.int32)
        rank[order.to_numpy(zero_copy_only=False)] = np.arange(
            len(dict_vals), dtype=np.int32)
        codes = rank[codes]
    else:
        sorted_dict = dict_vals
    codes[~validity] = 0
    return TorchColumnVector.from_numpy(T.STRING, codes, validity, capacity,
                                        device, dictionary=sorted_dict)


def list_array_to_device(arr: pa.Array, dtype, capacity: int | None,
                         device) -> ListVector:
    """A list (or map) column → ``ListVector`` (``MapVector``): the
    elements of the non-null lists, in row order, into one padded flat
    column; the row lengths and validity to the device; the offsets kept
    on the host (the JAX package's ``list_array_to_device``)."""
    n = len(arr)
    cap = capacity or bucket_capacity(n)
    validity = _validity_of(arr)
    raw = arr.offsets.to_numpy(zero_copy_only=False).astype(np.int64)
    lengths = np.where(validity, np.diff(raw), 0)
    offsets = np.zeros(cap + 1, dtype=np.int64)
    offsets[1:n + 1] = np.cumsum(lengths)
    offsets[n + 1:] = offsets[n]
    total = int(offsets[n])
    rows = TorchColumnVector.from_numpy(T.INT, lengths.astype(np.int32),
                                        validity, cap, device)
    # the elements of the non-null rows (a null row may point at some)
    take = pa.array(np.repeat(raw[:-1] - offsets[:n], lengths)
                    + np.arange(total, dtype=np.int64), type=pa.int64())
    fcap = bucket_capacity(total)
    if isinstance(dtype, T.MapType):
        keys = array_to_device(arr.keys.take(take), dtype.key_type, fcap,
                               device)
        values = array_to_device(arr.items.take(take), dtype.value_type,
                                 fcap, device)
        return MapVector(dtype, rows.data, rows.validity, keys, values,
                         total, offsets)
    elems = array_to_device(arr.values.take(take), dtype.element_type, fcap,
                            device)
    return ListVector(dtype, rows.data, rows.validity, elems, total, offsets)


def struct_array_to_device(arr: pa.Array, dtype: T.StructDataType,
                           capacity: int | None, device) -> StructVector:
    """A struct column → ``StructVector``: one device column a field, a
    null row's fields null."""
    cap = capacity or bucket_capacity(len(arr))
    validity = _validity_of(arr)
    rows = TorchColumnVector.from_numpy(T.BOOLEAN, validity, validity, cap,
                                        device)
    fields = [array_to_device(f, t, cap, device)
              for f, t in zip(arr.flatten(), dtype.types)]
    return StructVector(dtype, fields, rows.validity)


def array_to_device(arr, dtype: T.DataType | None, capacity: int | None,
                    device) -> TorchColumnVector:
    """One arrow column → device column (the per-column scan fallback)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = (arr.combine_chunks() if arr.num_chunks != 1
               else arr.chunk(0))
    dtype = dtype or T.from_arrow_type(arr.type)
    if isinstance(dtype, (T.ArrayType, T.MapType)):
        return list_array_to_device(arr, dtype, capacity, device)
    if isinstance(dtype, T.StructDataType):
        return struct_array_to_device(arr, dtype, capacity, device)
    if isinstance(dtype, T.StringType):
        return string_array_to_device(arr, device, capacity)
    validity = _validity_of(arr)
    if isinstance(dtype, T.DecimalType):
        vals = _decimal_unscaled_int64(arr)
    elif isinstance(dtype, T.DateType):
        vals = arr.cast(pa.int32()).fill_null(0).to_numpy(zero_copy_only=False)
    elif isinstance(dtype, T.TimestampType):
        # any source unit (s/ms/us/ns) to Spark's micros before the int64
        # view (nanoseconds truncated, as Spark reads them); a naive
        # timestamp is taken as UTC
        us = pa.timestamp("us", tz=getattr(arr.type, "tz", None))
        vals = arr.cast(us, safe=False).cast(pa.int64()).fill_null(
            0).to_numpy(zero_copy_only=False)
    elif isinstance(dtype, T.NullType):
        vals = np.zeros(len(arr), dtype=np.int8)
        validity = np.zeros(len(arr), dtype=bool)
    else:
        vals = arr.fill_null(dtype.default_value()).to_numpy(
            zero_copy_only=False).astype(T.to_numpy_dtype(dtype), copy=False)
    return TorchColumnVector.from_numpy(dtype, vals, validity, capacity,
                                        device)


def table_to_device(table, device, schema: T.StructType | None = None,
                    capacity: int | None = None) -> ColumnarBatch:
    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    if schema is None:
        schema = T.StructType.from_arrow(table.schema)
    n = table.num_rows
    cap = capacity or bucket_capacity(n)
    cols = [array_to_device(table.column(i), schema[i].data_type, cap, device)
            for i in range(table.num_columns)]
    return ColumnarBatch(cols, n, schema)
