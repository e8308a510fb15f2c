"""Encoded column vectors — counterpart of
``spark_rapids_tpu/columnar/encoded.py``.

The parquet device decode hands each dictionary chunk to the device as the
one buffer that ``io/parquet_native.pack_chunk`` packs (the page table, the
index words, the def levels and the dictionary) and yields an
``EncodedColumnVector`` over it: the first read of its ``data`` or
``validity``, by whichever consumer reads it first (the aggregate's update,
a filter, a sort, a join, an exchange, a broadcast, a concat or a writer),
launches ``cuda_kernels.chunk_decode`` once and caches the dense column.

The reference fuses the decode into its consumer's XLA program, so that the
bus carries encoded bytes in place of dense columns, and its
``parquet.encodedUpload.enabled`` and ``stageFusion.scan.enabled`` choose
between that and a decode at the scan. The port's chunk already crosses
packed and decodes in one launch wherever it decodes, so both confs are
accepted and select nothing: this is the port's only device decode route.
It saves no transfer and no launch over a decode at the scan.
"""

from __future__ import annotations

import threading
import typing

import torch

from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector

#: vectors made encoded and vectors decoded since ``reset_counts``; the
#: tests hold one decode per vector on the CPU, where the kernel's plain
#: version counts no launch
counts = {"made": 0, "decoded": 0}
_lock = threading.Lock()


def reset_counts() -> None:
    with _lock:
        for k in counts:
            counts[k] = 0


class EncodedChunk(typing.NamedTuple):
    """The ``chunk_decode`` arguments of one packed chunk on the device."""
    buf: torch.Tensor            # the packed int32 buffer, on the device
    words: torch.Tensor
    table: torch.Tensor
    defs: torch.Tensor | None
    dictionary: torch.Tensor
    n_rows: int
    capacity: int
    want: torch.dtype
    default: typing.Any


class EncodedColumnVector(TorchColumnVector):
    """A ``TorchColumnVector`` whose dense arrays are made by one
    ``chunk_decode`` launch at the first read of ``data`` or ``validity``.
    ``capacity`` and ``device_memory_size`` answer without decoding."""

    __slots__ = ("_enc", "_mat", "_lk")

    def __init__(self, dtype, enc: EncodedChunk, dictionary=None):
        # the parent's __init__ would assign through data/validity
        self.dtype = dtype
        self.dictionary = dictionary
        self._dict_device = None
        self._enc = enc
        self._mat = None
        # two readers of a shared batch (a broadcast build) decode it once
        self._lk = threading.Lock()
        with _lock:
            counts["made"] += 1

    def decode(self) -> bool:
        """Decode the chunk if it is still encoded; True when this call
        launched the decode."""
        with self._lk:
            if self._mat is not None:
                return False
            from spark_rapids_tpu_torch.ops import cuda_kernels as CK
            e = self._enc
            self._mat = CK.chunk_decode(e.words, e.table, e.defs,
                                        e.dictionary, e.n_rows, e.capacity,
                                        e.want, e.default)
            # the dense column replaces the packed buffer
            self._enc = e._replace(buf=None, words=None, table=None,
                                   defs=None, dictionary=None)
        with _lock:
            counts["decoded"] += 1
        return True

    @property
    def data(self) -> torch.Tensor:
        if self._mat is None:
            self.decode()
        return self._mat[0]

    @property
    def validity(self) -> torch.Tensor:
        if self._mat is None:
            self.decode()
        return self._mat[1]

    @property
    def capacity(self) -> int:
        return self._enc.capacity

    def device_memory_size(self) -> int:
        """The packed buffer while encoded, the dense arrays after."""
        if self._mat is None:
            b = self._enc.buf
            sz = b.numel() * b.element_size()
        else:
            sz = sum(t.numel() * t.element_size() for t in self._mat)
        if self._dict_device is not None:
            sz += sum(t.numel() * t.element_size() for t in self._dict_device)
        return sz

    def __repr__(self):
        state = "encoded" if self._mat is None else "decoded"
        return f"EncodedColumnVector({self.dtype}, cap={self.capacity}, " \
               f"{state})"

