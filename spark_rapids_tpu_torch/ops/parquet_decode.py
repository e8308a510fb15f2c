"""Device parquet page decode: bit-unpack, dictionary gather, null spread.

Counterpart of ``spark_rapids_tpu/ops/parquet_decode.py``. The bulk bytes of a
dictionary-encoded column are bit-packed indices; the ``bitunpack128`` kernel
(``ops/cuda_kernels.py``) unpacks them, the dictionary values are gathered,
and present values are spread over the null layout by a rank gather. Buffers
keep the JAX package's power-of-two capacity buckets.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from spark_rapids_tpu_torch.ops import cuda_kernels as CK


class EncodedPageSpec(typing.NamedTuple):
    """Shape/type facts of one encoded data page — everything the single
    decode body (``decode_page_cols``) needs besides the device buffers."""
    bit_width: int
    pcap: int          # present-value capacity bucket
    capacity: int      # output row capacity bucket
    want: torch.dtype  # decoded value dtype (int32 codes for strings)
    is_string: bool
    default: object    # canonical fill for invalid slots
    n_present: int     # present (non-null) value count


def unpack_bits_device(packed: torch.Tensor, bit_width: int, n: int,
                       capacity: int) -> torch.Tensor:
    """(bytes,) uint8 → (capacity,) int32 of ``n`` bit-packed values, in plain
    tensor ops. Value i occupies bits [i*bw, (i+1)*bw): gather the (up to) 5
    covering bytes into an int64 window, shift and mask. Kept as the byte-wise
    oracle of the kernel's word-wise unpack."""
    dev = packed.device
    idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    bit0 = idx * bit_width
    byte0 = bit0 >> 3
    shift = bit0 & 7
    nbytes = packed.shape[0]
    window = torch.zeros((capacity,), dtype=torch.int64, device=dev)
    # a bw-bit value starting at any bit offset 0..7 spans ceil((bw+7)/8)
    # bytes — at most 5 for bw <= 32
    for k in range((bit_width + 14) // 8):
        b = packed[(byte0 + k).clamp(0, nbytes - 1)].to(torch.int64)
        window = window | (b << (8 * k))
    vals = (window >> shift) & ((1 << bit_width) - 1)
    vals = torch.where(idx < n, vals, torch.zeros_like(vals))
    vals = torch.where(vals >= (1 << 31), vals - (1 << 32), vals)
    return vals.to(torch.int32)


def expand_present_to_rows(present_vals: torch.Tensor,
                           def_levels: torch.Tensor, capacity: int):
    """Parquet stores values only for non-null slots; spread them over the
    row layout: row j takes present value rank(j), the prefix count of set
    definition levels (a gather, not a scatter)."""
    ranks = torch.cumsum(def_levels.to(torch.int32), 0, dtype=torch.int32) - 1
    safe = ranks.clamp(0, capacity - 1).long()
    vals = present_vals[safe]
    valid = def_levels.to(torch.bool)
    return vals, valid


def decode_page_cols(spec: EncodedPageSpec, words_d: torch.Tensor,
                     dict_d: torch.Tensor, dl_d: torch.Tensor, n: int):
    """The single-page decode body: bit-unpack → dictionary gather →
    definition-level spread → canonical nulls, returning (values, validity)
    at ``spec.capacity``. Device args: the packed page as int32 words, the
    device dictionary, and the definition levels as bool (capacity,); ``n``
    is the live row count."""
    idx = CK.bitunpack128(words_d, spec.bit_width, spec.n_present, spec.pcap)
    nd = dict_d.shape[0]
    # an all-null page may carry an EMPTY dictionary: nothing to gather
    present = (dict_d[idx.clamp(0, max(nd - 1, 0)).long()] if nd
               else torch.zeros((spec.pcap,), dtype=dict_d.dtype,
                                device=dict_d.device))
    cap = spec.capacity
    present_padded = torch.zeros((cap,), dtype=present.dtype,
                                 device=present.device)
    k = min(spec.pcap, cap)
    present_padded[:k] = present[:k]
    vals, valid = expand_present_to_rows(present_padded, dl_d, cap)
    live = torch.arange(cap, device=dl_d.device) < n
    m = valid & live
    default = torch.tensor(spec.default, dtype=spec.want, device=dl_d.device)
    v = torch.where(m, vals.to(spec.want), default)
    return v, m


def decode_dictionary_page(packed_bytes: np.ndarray, bit_width: int,
                           n_present: int, def_levels: np.ndarray,
                           dict_values: torch.Tensor, capacity: int):
    """One data page of a multi-page chunk → (values, validity) padded to
    capacity. The packed index bytes go to the dictionary's device as words;
    run structure was already validated on the host (every hybrid segment
    bit-packed — parse_rle_hybrid)."""
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    dev = dict_values.device
    pcap = max(bucket_capacity(n_present), 8)
    words = CK.bytes_to_words_u32(np.asarray(packed_bytes, np.uint8))
    idx = CK.bitunpack128(torch.from_numpy(words).to(dev), bit_width,
                          n_present, pcap)
    nd = dict_values.shape[0]
    present = dict_values[idx.clamp(0, max(nd - 1, 0)).long()]
    dl = torch.zeros((capacity,), dtype=torch.bool)
    dl[:len(def_levels)] = torch.from_numpy(def_levels.astype(bool))
    dl = dl.to(dev)
    # pad present values out to capacity before the rank gather (pcap <=
    # capacity: n_present <= num_values and capacity is the row bucket)
    present_padded = torch.zeros((capacity,), dtype=present.dtype, device=dev)
    present_padded[:pcap] = present
    return expand_present_to_rows(present_padded, dl, capacity)
