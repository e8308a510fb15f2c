"""Spark-exact Murmur3_x86_32 over torch tensors — counterpart of
``spark_rapids_tpu/ops/hashing.py``.

The hash partitioner relies on these matching Spark's ``Murmur3Hash(exprs,
42)`` bit for bit, so that rows land in the same partitions as on CPU Spark
and in the JAX package. Columns chain: ``h = 42; for col: if not null: h =
hash_col(value, h)``.

Column rules (Spark Murmur3Hash): bool/int/date → hashInt; long → hashLong;
float → hashInt(floatToIntBits) with -0.0 → 0.0; double →
hashLong(doubleToLongBits); string → hashUnsafeBytes over the UTF-8 bytes as
little-endian 4-byte words, then one mix round per tail byte taken as a
signed Java byte.

torch's ``>>`` on int32 is arithmetic and an int32 multiply that overflows
is not defined to wrap, so the plain arithmetic here runs in int64 holding
the 32 unsigned bits, with each 32-bit multiply split in two halves that
cannot overflow int64. The string hash, the partitioner's hot loop, is the
``murmur3_words`` CUDA kernel for a CUDA tensor (``ops/cuda_kernels.py``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_C1 = 0xcc9e2d51
_C2 = 0x1b873593
_M5 = 0xe6546b64
_FX1 = 0x85ebca6b
_FX2 = 0xc2b2ae35


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The 32 bits of an integer tensor, unsigned, in int64."""
    return x.to(torch.int64) & _MASK


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """Reinterpret unsigned 32-bit values held in int64 as int32."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32): two 16-bit halves of c keep
    every product below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return (_mul32(_rotl(h1 ^ k1, 13), 5) + _M5) & _MASK


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ (length & _MASK)
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, _FX1)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, _FX2)
    return h1 ^ (h1 >> 16)


def _seed_u32(seed, like: torch.Tensor) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return _u32(seed).expand(like.shape[0])
    return torch.full((like.shape[0],), int(seed) & _MASK, dtype=torch.int64,
                      device=like.device)


def hash_int(value_i32: torch.Tensor, seed) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashInt, per element → int32."""
    h1 = _mix_h1(_seed_u32(seed, value_i32), _mix_k1(_u32(value_i32)))
    return _to_i32(_fmix(h1, 4))


def hash_long(value_i64: torch.Tensor, seed) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashLong: low word, then high word."""
    v = value_i64.to(torch.int64)
    low = v & _MASK
    high = (v >> 32) & _MASK
    h1 = _mix_h1(_seed_u32(seed, v), _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _to_i32(_fmix(h1, 8))


def hash_float(value_f32: torch.Tensor, seed) -> torch.Tensor:
    """Spark hashes floatToIntBits (canonical NaN 0x7fc00000, -0.0 as 0.0).
    Subnormals hash as 0.0, as in the JAX package, whose XLA flushes them
    (documented there as a divergence from CPU Spark)."""
    v = value_f32.to(torch.float32)
    v = torch.where(v.abs() < torch.finfo(torch.float32).tiny,
                    torch.zeros_like(v), v)
    bits = v.view(torch.int32)
    bits = torch.where(torch.isnan(v),
                       torch.full_like(bits, 0x7fc00000), bits)
    return hash_int(bits, seed)


def double_to_long_bits(v: torch.Tensor) -> torch.Tensor:
    """Java Double.doubleToLongBits (canonical NaN 0x7ff8000000000000)."""
    v = v.to(torch.float64)
    bits = v.view(torch.int64)
    return torch.where(torch.isnan(v),
                       torch.full_like(bits, 0x7ff8000000000000), bits)


def hash_double(value_f64: torch.Tensor, seed) -> torch.Tensor:
    """Spark hashes doubleToLongBits (canonical NaN, -0.0 as 0.0).
    Subnormals hash as 0.0, as in the JAX package (see ``hash_float``)."""
    v = value_f64.to(torch.float64)
    v = torch.where(v.abs() < torch.finfo(torch.float64).tiny,
                    torch.zeros_like(v), v)
    return hash_long(double_to_long_bits(v), seed)


def hash_string_words(words: torch.Tensor, lengths: torch.Tensor, seed):
    """hashUnsafeBytes over rows of 4-byte little-endian words.

    words: (n, W) int32, UTF-8 bytes packed little-endian and zero-padded;
    lengths: (n,) int32 byte lengths; seed: an int or an (n,) int32 running
    hash. The ``murmur3_words`` kernel for a CUDA tensor, its plain version
    for a CPU one."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    return CK.murmur3_words(words, lengths, seed)


def pmod(hash_i32: torch.Tensor, divisor: int) -> torch.Tensor:
    """Spark Pmod(hash, n): the non-negative remainder."""
    return torch.remainder(hash_i32, divisor).to(torch.int32)


# ---------------------------------------------------------------------------
# host-side reference (dictionary packing and tests)
# ---------------------------------------------------------------------------

def _hm_mix_k1(k1):
    k1 = (k1 * _C1) & _MASK
    k1 = ((k1 << 15) | (k1 >> 17)) & _MASK
    return (k1 * _C2) & _MASK


def _hm_mix_h1(h1, k1):
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & _MASK
    return (h1 * 5 + _M5) & _MASK


def _hm_fmix(h1, length):
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * _FX1) & _MASK
    h1 ^= h1 >> 13
    h1 = (h1 * _FX2) & _MASK
    h1 ^= h1 >> 16
    return h1


def _to_signed(u):
    return u - 0x100000000 if u >= 0x80000000 else u


def murmur3_bytes_host(data: bytes, seed: int) -> int:
    """Spark Murmur3_x86_32.hashUnsafeBytes on the host (signed int32)."""
    h1 = seed & _MASK
    n = len(data)
    aligned = n - n % 4
    for i in range(0, aligned, 4):
        (k1,) = struct.unpack_from("<i", data, i)
        h1 = _hm_mix_h1(h1, _hm_mix_k1(k1 & _MASK))
    for i in range(aligned, n):
        b = data[i]
        sb = b - 256 if b >= 128 else b
        h1 = _hm_mix_h1(h1, _hm_mix_k1(sb & _MASK))
    return _to_signed(_hm_fmix(h1, n))


def pack_utf8_words(strings, max_bytes: int | None = None):
    """Pack strings into (words int32 (n, W), lengths int32 (n,)) numpy
    arrays for ``hash_string_words``; None packs as the empty string. Used
    once per string dictionary."""
    bs = [s.encode("utf-8") if s is not None else b"" for s in strings]
    max_b = max([len(b) for b in bs], default=0)
    if max_bytes is not None:
        max_b = max(max_b, max_bytes)
    W = max(1, (max_b + 3) // 4)
    raw = np.zeros((len(bs), W * 4), dtype=np.uint8)
    lens = np.fromiter((len(b) for b in bs), dtype=np.int32, count=len(bs))
    # every byte at (its string, its place in the string), in one scatter
    flat = np.frombuffer(b"".join(bs), dtype=np.uint8)
    rows = np.repeat(np.arange(len(bs)), lens)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    raw[rows, np.arange(flat.size) - starts] = flat
    words = raw.view("<i4").astype(np.int32)
    return words, lens
