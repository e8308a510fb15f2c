"""Device column vectors — counterpart of ``spark_rapids_tpu/columnar/vector.py``.

A column is:

- ``data``: a padded 1-D torch tensor on the device. Capacities are bucketed to
  powers of two (min 8), the JAX package's layout, so buffers compare 1:1.
- ``validity``: a padded bool tensor; padding slots are always invalid. Invalid
  slots hold the type's canonical default value so padding never perturbs
  sums, sorts or group codes.
- strings: ``data`` holds int32 codes into a host-side sorted pyarrow
  dictionary, so code order is string order. ``dictionary_words()`` packs
  that dictionary's UTF-8 bytes onto the device once, for byte-level
  kernels such as the murmur3 string hash.
- nested columns (``ListVector``, ``MapVector``, ``StructVector``) keep the
  JAX package's list layout: per-row lengths as ``data`` (int32 on the
  device, 0 for a null row and for padding), row validity, a flat padded
  element column (the elements of the non-null lists in row order, with
  its own dictionary for strings) and the row offsets on the host. The
  device ops over them are in ``ops/nested.py``. A flat element column, a
  map's values and a struct's fields may themselves be nested vectors, to
  any depth; ``device_memory_size`` and ``to_arrow`` recurse, and an inner
  list's offsets are read back from its lengths only when ``to_arrow``
  needs them.
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

    __slots__ = ("dtype", "data", "validity", "dictionary", "_dict_device")

    def __init__(self, dtype: T.DataType, data: torch.Tensor,
                 validity: torch.Tensor, dictionary: pa.Array | None = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.dictionary = dictionary
        self._dict_device = None

    @staticmethod
    def from_numpy(dtype: T.DataType, values: np.ndarray,
                   validity: np.ndarray | None, capacity: int | None,
                   device, dictionary: pa.Array | None = None):
        """A column of ``capacity`` slots from host values and validity.
        For a CUDA device the values and the validity are laid out in one
        buffer from torch's caching pinned-memory allocator and cross in one
        asynchronous copy; the column's two tensors are views of it."""
        n = len(values)
        cap = capacity or bucket_capacity(n)
        np_dtype = T.to_numpy_dtype(dtype)
        device = torch.device(device)
        stage = None
        if device.type == "cuda":
            size = np_dtype.itemsize * cap    # a multiple of 8: cap >= 8
            stage = torch.empty((size + cap,), dtype=torch.uint8,
                                pin_memory=True)
            host = stage.numpy()
            host[:] = 0
            data, valid = host[:size].view(np_dtype), host[size:].view(bool)
        else:
            data = np.zeros(cap, dtype=np_dtype)
            valid = np.zeros(cap, dtype=bool)
        data[:n] = values
        if validity is None:
            valid[:n] = True
        else:
            valid[:n] = validity
            data[~valid] = dtype.default_value()
        if stage is None:
            return TorchColumnVector(dtype, torch.from_numpy(data),
                                     torch.from_numpy(valid), dictionary)
        on = stage.to(device, non_blocking=True)
        return TorchColumnVector(dtype, on[:size].view(dtype.torch_dtype),
                                 on[size:].view(torch.bool), dictionary)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)

    def device_memory_size(self) -> int:
        sz = (self.data.numel() * self.data.element_size()
              + self.validity.numel() * self.validity.element_size())
        if self._dict_device is not None:
            sz += sum(t.numel() * t.element_size() for t in self._dict_device)
        return sz

    def dictionary_words(self):
        """The dictionary's UTF-8 bytes on the column's device as (words
        (D, W) int32 little-endian, lengths (D,) int32), packed once per
        vector. Rows reach them by gathering with their codes; an empty
        dictionary packs as one empty string, so code 0 stays a legal
        index."""
        if self._dict_device is None:
            from spark_rapids_tpu_torch.ops.hashing import pack_utf8_words
            if self.dictionary is None:
                raise ValueError("dictionary_words: the column has no "
                                 "dictionary")
            words, lens = pack_utf8_words(self.dictionary.to_pylist())
            if words.shape[0] == 0:
                words = np.zeros((1, 1), dtype=np.int32)
                lens = np.zeros(1, dtype=np.int32)
            dev = self.data.device
            self._dict_device = (torch.from_numpy(words).to(dev),
                                 torch.from_numpy(lens).to(dev))
        return self._dict_device

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
        if isinstance(self.dtype, T.DecimalType):
            # decimal128 from the scaled int64: the low word and its sign
            # extension
            words = np.zeros((num_rows, 2), dtype=np.int64)
            words[:, 0] = vals
            words[:, 1] = vals >> 63
            mask = np.packbits(valid, bitorder="little")
            return pa.Array.from_buffers(
                T.to_arrow_type(self.dtype), num_rows,
                [pa.py_buffer(mask.tobytes()), pa.py_buffer(words.tobytes())])
        if isinstance(self.dtype, T.NullType):
            return pa.nulls(num_rows)
        if isinstance(self.dtype, T.DateType):
            arr = pa.array(vals.astype("int32")).cast(pa.date32())
        elif isinstance(self.dtype, T.TimestampType):
            arr = pa.array(vals.astype("int64")).cast(
                pa.timestamp("us", tz="UTC"))
        else:
            arr = pa.array(vals, type=T.to_arrow_type(self.dtype))
        if not valid.all():
            arr = pc.if_else(pa.array(valid), arr, pa.nulls(num_rows, arr.type))
        return arr

    def __repr__(self):
        d = (f", dict={len(self.dictionary)}" if self.dictionary is not None
             else "")
        return f"TorchColumnVector({self.dtype}, cap={self.capacity}{d})"


class ListVector(TorchColumnVector):
    """An ``array<e>`` column: ``data`` holds the int32 row lengths, ``flat``
    the elements. ``total`` is the element count (a host int). The host
    offsets (``offsets``, ``capacity + 1`` entries, the JAX package's
    ``ListVector.offsets`` in their first ``num_rows + 1``) are given by
    the arrow bridge, or read back from the lengths on first use."""

    __slots__ = ("flat", "total", "_offsets")

    def __init__(self, dtype: T.DataType, lengths: torch.Tensor,
                 validity: torch.Tensor, flat: TorchColumnVector,
                 total: int, offsets: np.ndarray | None = None):
        super().__init__(dtype, lengths, validity)
        self.flat = flat
        self.total = int(total)
        self._offsets = offsets

    @property
    def element_dtype(self) -> T.DataType:
        return self.dtype.element_type

    @property
    def offsets(self) -> np.ndarray:
        if self._offsets is None:
            lengths = self.data.cpu().numpy().astype(np.int64)
            self._offsets = np.concatenate([[0], np.cumsum(lengths)])
        return self._offsets

    def device_memory_size(self) -> int:
        return super().device_memory_size() + self.flat.device_memory_size()

    def _list_offsets(self, num_rows: int) -> pa.Array:
        """The arrow offsets of the first ``num_rows`` rows: a null slot
        marks a null list (pyarrow's convention)."""
        off = self.offsets[:num_rows + 1].astype(np.int32)
        valid = self.validity[:num_rows].cpu().numpy()
        mask = np.concatenate([~valid, [False]])
        return pa.array(off, type=pa.int32(), mask=mask)

    def to_arrow(self, num_rows: int) -> pa.Array:
        flat = self.flat.to_arrow(int(self.offsets[num_rows]))
        return pa.ListArray.from_arrays(self._list_offsets(num_rows), flat)

    def __repr__(self):
        return (f"ListVector({self.dtype!r}, cap={self.capacity}, "
                f"elems={self.total})")


class MapVector(ListVector):
    """A ``map<k, v>`` column: the keys are ``flat``, the values
    ``values``, two flat columns over one set of offsets."""

    __slots__ = ("values",)

    def __init__(self, dtype: T.DataType, lengths: torch.Tensor,
                 validity: torch.Tensor, keys: TorchColumnVector,
                 values: TorchColumnVector, total: int,
                 offsets: np.ndarray | None = None):
        super().__init__(dtype, lengths, validity, keys, total, offsets)
        self.values = values

    def device_memory_size(self) -> int:
        return super().device_memory_size() + self.values.device_memory_size()

    def to_arrow(self, num_rows: int) -> pa.Array:
        n = int(self.offsets[num_rows])
        return pa.MapArray.from_arrays(self._list_offsets(num_rows),
                                       self.flat.to_arrow(n),
                                       self.values.to_arrow(n))

    def __repr__(self):
        return (f"MapVector({self.dtype!r}, cap={self.capacity}, "
                f"entries={self.total})")


class StructVector(TorchColumnVector):
    """A ``struct<...>`` column: one column a field (each of the struct's
    capacity) and the row validity; ``data`` is the validity too, so the
    column has a capacity like any other. A null row's fields are null."""

    __slots__ = ("fields",)

    def __init__(self, dtype: T.DataType, fields: list,
                 validity: torch.Tensor):
        super().__init__(dtype, validity, validity)
        self.fields = list(fields)

    def device_memory_size(self) -> int:
        return (self.validity.numel()
                + sum(f.device_memory_size() for f in self.fields))

    def to_arrow(self, num_rows: int) -> pa.Array:
        valid = self.validity[:num_rows].cpu().numpy()
        children = [f.to_arrow(num_rows) for f in self.fields]
        return pa.StructArray.from_arrays(
            children, fields=list(T.to_arrow_type(self.dtype)),
            mask=pa.array(~valid))

    def __repr__(self):
        return f"StructVector({self.dtype!r}, cap={self.capacity})"
