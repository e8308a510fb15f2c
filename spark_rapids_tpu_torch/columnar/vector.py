"""Device column vectors — counterpart of ``spark_rapids_tpu/columnar/vector.py``.

A column is:

- ``data``: a padded 1-D torch tensor on the device. Capacities are bucketed to
  powers of two (min 8), the JAX package's layout, so buffers compare 1:1.
- ``validity``: a padded bool tensor; padding slots are always invalid. Invalid
  slots hold the type's canonical default value so padding never perturbs
  sums, sorts or group codes.
- strings: ``data`` holds int32 codes into a host-side sorted pyarrow
  dictionary, so code order is string order.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from spark_rapids_tpu_torch import types as T

_MIN_CAPACITY = 8


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (>= 8)."""
    cap = _MIN_CAPACITY
    while cap < n:
        cap <<= 1
    return cap


class TorchColumnVector:
    """One device column (values, validity, optional sorted dictionary)."""

    __slots__ = ("dtype", "data", "validity", "dictionary")

    def __init__(self, dtype: T.DataType, data: torch.Tensor,
                 validity: torch.Tensor, dictionary: pa.Array | None = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.dictionary = dictionary

    @staticmethod
    def from_numpy(dtype: T.DataType, values: np.ndarray,
                   validity: np.ndarray | None, capacity: int | None,
                   device, dictionary: pa.Array | None = None):
        n = len(values)
        cap = capacity or bucket_capacity(n)
        data = np.zeros(cap, dtype=T.to_numpy_dtype(dtype))
        data[:n] = values
        valid = np.zeros(cap, dtype=bool)
        if validity is None:
            valid[:n] = True
        else:
            valid[:n] = validity
            data[~valid] = dtype.default_value()
        return TorchColumnVector(dtype, torch.from_numpy(data).to(device),
                                 torch.from_numpy(valid).to(device),
                                 dictionary)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)

    def to_host(self, num_rows: int):
        """Copy the first num_rows to host numpy (values, validity)."""
        return (self.data[:num_rows].cpu().numpy(),
                self.validity[:num_rows].cpu().numpy())

    def to_arrow(self, num_rows: int) -> pa.Array:
        vals, valid = self.to_host(num_rows)
        if self.is_string:
            codes = pa.array(vals.astype(np.int32), type=pa.int32())
            has_dict = self.dictionary is not None and len(self.dictionary)
            taken = (self.dictionary.take(codes) if has_dict
                     else pa.nulls(num_rows, pa.string()))
            return pc.if_else(pa.array(valid), taken,
                              pa.nulls(num_rows, pa.string()))
        if isinstance(self.dtype, T.DateType):
            arr = pa.array(vals.astype("int32")).cast(pa.date32())
        else:
            arr = pa.array(vals, type=T.to_arrow_type(self.dtype))
        if not valid.all():
            arr = pc.if_else(pa.array(valid), arr, pa.nulls(num_rows, arr.type))
        return arr

    def __repr__(self):
        d = (f", dict={len(self.dictionary)}" if self.dictionary is not None
             else "")
        return f"TorchColumnVector({self.dtype}, cap={self.capacity}{d})"
