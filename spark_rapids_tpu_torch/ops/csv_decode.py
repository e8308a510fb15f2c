"""Device CSV field parsing: digit bytes to numbers in plain torch ops.

Counterpart of ``spark_rapids_tpu/ops/csv_decode.py``. The host finds the
field boundaries (``io/csv_native.py``); the device gathers each field's
bytes into a (rows, K) byte matrix and runs a Horner scan over its K
columns. The reference leaves this to XLA (no Pallas kernel), so the port
runs it as torch ops on the file's device.

Malformed fields parse to null, as in the reference. A double is the
integer of its digits divided by a power of ten, one correctly rounded
division: that can differ from strtod by 1 ulp on long fractions, hence the
off-by-default ``spark.rapids.tpu.sql.csv.read.float.enabled``. Each step is
its own torch op (no fused multiply-add), as in the reference, so the two
agree bit for bit.
"""

from __future__ import annotations

import torch

MAX_INT_CHARS = 20    # -9223372036854775808
MAX_DBL_CHARS = 26

_LONG_MIN = -(1 << 63)
# MIN // 10, rounded toward zero
_LIM = -922337203685477580


def _gather_chars(data: torch.Tensor, starts: torch.Tensor, K: int):
    """(n,) starts → (n, K) byte matrix, a clamped gather."""
    idx = starts.long()[:, None] + torch.arange(K, device=data.device)[None, :]
    return data[idx.clamp(0, data.shape[0] - 1)]


def parse_int64(data: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, capacity: int):
    """Parse int64 fields: ``(values, validity)``. Empty, malformed or
    overflowing fields are null. data: (bytes,) uint8 on the device;
    starts/lens: (capacity,) int32 (padding rows have len < 0)."""
    dev = data.device
    chars = _gather_chars(data, starts, MAX_INT_CHARS)
    j = torch.arange(MAX_INT_CHARS, dtype=torch.int32, device=dev)[None, :]
    lens = lens.to(torch.int32)
    in_field = j < lens[:, None]
    neg = chars[:, 0] == ord("-")
    signed = neg | (chars[:, 0] == ord("+"))
    digit_pos = in_field & (j >= signed[:, None].to(torch.int32))
    d = chars.to(torch.int32) - ord("0")
    is_digit = (d >= 0) & (d <= 9)
    ok = torch.all(~digit_pos | is_digit, dim=1)
    # at least one digit; a sign alone is malformed; an over-long field is
    # null (a valid long is at most a sign and 19 digits)
    ndigits = digit_pos.sum(dim=1)
    ok = ok & (ndigits > 0) & (lens >= 1) & (lens <= MAX_INT_CHARS)
    # accumulate NEGATIVE, to hold Long.MIN, and catch the wrap as
    # Long.parseLong does: val*10 - d < MIN means overflow
    val = torch.zeros(chars.shape[0], dtype=torch.int64, device=dev)
    overflow = torch.zeros(chars.shape[0], dtype=torch.bool, device=dev)
    for col in range(MAX_INT_CHARS):
        take = digit_pos[:, col]
        dj = d[:, col].to(torch.int64)
        overflow = overflow | (take & ((val < _LIM)
                                       | ((val == _LIM) & (dj > 8))))
        val = torch.where(take, val * 10 - dj, val)
    # the positive Long.MAX + 1 case: -val wraps back to MIN
    overflow = overflow | (~neg & (val == _LONG_MIN))
    val = torch.where(neg, val, -val)
    valid = ok & ~overflow & (lens >= 0)
    valid = valid & ~(lens == 0)          # Spark: an empty field is null
    return torch.where(valid, val, torch.zeros_like(val)), valid


def parse_float64(data: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, capacity: int):
    """Parse plain-decimal doubles (no exponent, inf or nan: the host scan
    keeps such files off the device): ``(values, validity)``."""
    dev = data.device
    chars = _gather_chars(data, starts, MAX_DBL_CHARS)
    j = torch.arange(MAX_DBL_CHARS, dtype=torch.int32, device=dev)[None, :]
    lens = lens.to(torch.int32)
    in_field = j < lens[:, None]
    neg = chars[:, 0] == ord("-")
    signed = neg | (chars[:, 0] == ord("+"))
    d = chars.to(torch.int32) - ord("0")
    is_digit = (d >= 0) & (d <= 9)
    is_dot = chars == ord(".")
    body = in_field & (j >= signed[:, None].to(torch.int32))
    ok = torch.all(~body | is_digit | is_dot, dim=1)
    ok = ok & ((body & is_dot).sum(dim=1) <= 1)
    ok = ok & ((body & is_digit).sum(dim=1) > 0)
    ok = ok & (lens <= MAX_DBL_CHARS)   # no silent truncation: null instead
    n = chars.shape[0]
    mant = torch.zeros(n, dtype=torch.float64, device=dev)
    frac_digits = torch.zeros(n, dtype=torch.int32, device=dev)
    seen_dot = torch.zeros(n, dtype=torch.bool, device=dev)
    df = d.to(torch.float64)
    for col in range(MAX_DBL_CHARS):
        active = body[:, col]
        dig = active & is_digit[:, col]
        mant = torch.where(dig, mant * 10.0 + df[:, col], mant)
        frac_digits = torch.where(dig & seen_dot, frac_digits + 1,
                                  frac_digits)
        seen_dot = seen_dot | (active & is_dot[:, col])
    # the powers of ten as a table: 10**k is exact for k <= 22, and each
    # entry is the correctly rounded double above that
    pow10 = torch.tensor([10.0 ** k for k in range(MAX_DBL_CHARS + 1)],
                         dtype=torch.float64, device=dev)
    val = mant / pow10[frac_digits.long()]
    val = torch.where(neg, -val, val)
    valid = ok & (lens > 0)
    return torch.where(valid, val, torch.zeros_like(val)), valid


def parse_narrow_int(data, starts, lens, capacity, dtype: torch.dtype):
    """Parse int8/int16/int32 fields: the int64 parse, and null where the
    value is outside the type (Spark's CSV reader)."""
    v, m = parse_int64(data, starts, lens, capacity)
    info = torch.iinfo(dtype)
    in_range = (v >= info.min) & (v <= info.max)
    return v.to(dtype), m & in_range


def parse_int32(data, starts, lens, capacity):
    return parse_narrow_int(data, starts, lens, capacity, torch.int32)
