"""Arrow → device conversion — counterpart of ``spark_rapids_tpu/columnar/arrow.py``.

Fixed-width buffers go to the device as padded tensors; strings are
dictionary-encoded with an order-preserving (sorted) dictionary so code
comparisons equal string comparisons; decimals (p <= 18) travel as the low
64 bits of their decimal128 storage, the scaled int64.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
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


def array_to_device(arr, dtype: T.DataType | None, capacity: int | None,
                    device) -> TorchColumnVector:
    """One arrow column → device column (the per-column scan fallback)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    dtype = dtype or T.from_arrow_type(arr.type)
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
