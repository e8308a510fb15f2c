"""Multi-key sort with Spark ordering semantics — counterpart of
``spark_rapids_tpu/ops/sorting.py`` (``sort_permutation`` over
``_key_bits``, ``_packed_key``, ``_wide_single_key`` and ``_key_arrays``,
and the exchange's ``partition_permutation``).

Spark ordering rules: per-key ASC/DESC with NULLS FIRST/LAST; floats: NaN is
greater than every value and equal to itself, -0.0 == 0.0; strings sort by
dictionary code (the dictionary is sorted). Padding rows carry a leading
pad-rank key so they always sink to the end. A nested key (an array) sorts
by its rank under Spark's interpreted ordering (``ops/nested.order_ranks``),
an int32 column with its null rank beside it.

``sort_permutation`` takes the first of the reference's three tiers that
fits the keys (``sort_tier`` names it):

- packed: the pad rank, each key's null rank and order-preserving unsigned
  image, and the row index in the low bits, all in one int64, when the
  static widths fit 63 bits (dictionary strings, booleans, integers of 32
  bits or fewer, dates, a nested key's rank); a single 64-bit integer or
  timestamp key packs too when a caller's ``range_hint=(vmin, fits)`` says
  its range fits beside the ranks (it packs as ``value - vmin``). One
  ``torch.sort`` of one operand: the row index makes every key unique, so
  an unstable sort is exact;
- wide: a single 64-bit integer or timestamp key that does not pack, as two
  int64 operands (the order image with null and padding rows forced to the
  extremes, then the rank and the row index). The reference sorts both in
  one ``lax.sort``; torch has no multi-operand sort, so the port takes two
  passes: the unique second operand first, then the first operand stably;
- multi: everything else (floats, decimals, keys too wide to pack), one
  stable pass per key operand from the least significant to the most.

Every tier ends in the row order, so all three give one permutation, bit
for bit the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col


@dataclasses.dataclass(frozen=True)
class SortOrder:
    ascending: bool = True
    nulls_first: bool = None  # default: first when asc, last when desc (Spark)

    @property
    def resolved_nulls_first(self):
        return self.ascending if self.nulls_first is None else self.nulls_first


def _key_arrays(c: Col, order: SortOrder):
    """Key operands for one sort column, in significance order."""
    if c.nested is not None:
        c = rank_key(c)
    keys = []
    nf = order.resolved_nulls_first
    one = torch.ones_like(c.validity, dtype=torch.int8)
    zero = torch.zeros_like(one)
    keys.append(torch.where(c.validity, one if nf else zero,
                            zero if nf else one))
    vals = c.values
    if isinstance(c.dtype, T.FractionalType):
        nan = torch.isnan(vals)
        # NaN largest: rank 1 after all finite for asc; first for desc
        nan_rank = nan.to(torch.int8)
        if not order.ascending:
            nan_rank = 1 - nan_rank
        keys.append(nan_rank)
        vals = torch.where(nan, torch.zeros_like(vals), vals)
        vals = torch.where(vals == 0, torch.zeros_like(vals), vals)  # -0.0
        if not order.ascending:
            vals = -vals
    elif isinstance(c.dtype, T.BooleanType):
        v8 = vals.to(torch.int8)
        vals = v8 if order.ascending else (1 - v8)
    else:
        if not order.ascending:
            vals = ~vals  # order-reversing, overflow-free for ints
    keys.append(vals)
    return keys


def rank_key(c: Col) -> Col:
    """A nested key as the int32 column of its ranks under Spark's
    interpreted ordering (null rows rank 0, below every value; the ranks
    are dense, so they fit 32 bits at any capacity), with its validity."""
    from spark_rapids_tpu_torch.ops.nested import order_ranks
    return Col(order_ranks(c).to(torch.int32), c.validity, T.INT)


def _key_bits(c: Col) -> int | None:
    """Static bit width of one key column's order-preserving unsigned image,
    or None when it cannot be packed (64-bit integers, floats, decimals)."""
    if c.is_string and c.dictionary is not None:
        d = max(len(c.dictionary), 1)
        return max(d - 1, 1).bit_length()
    if isinstance(c.dtype, T.BooleanType):
        return 1
    if isinstance(c.dtype, (T.IntegralType, T.DateType)):
        w = torch.iinfo(c.values.dtype).bits
        return w + 1 if w <= 32 else None   # +1: bias to unsigned
    return None


def _wide_int(c: Col) -> bool:
    """A 64-bit integer or timestamp key: the range hint's and the wide
    tier's domain."""
    return (isinstance(c.dtype, (T.IntegralType, T.DateType, T.TimestampType))
            and _key_bits(c) is None)


def _iota_bits(capacity: int) -> int:
    return max((capacity - 1).bit_length(), 1)


def _null_rank(c: Col, order: SortOrder):
    nf = order.resolved_nulls_first
    one = torch.ones_like(c.validity, dtype=torch.int64)
    zero = torch.zeros_like(one)
    # nulls first: nulls rank 0, before the valid rows; else after
    return torch.where(c.validity, one if nf else zero, zero if nf else one)


def _pad_rank(num_rows, capacity: int, dev):
    return (torch.arange(capacity, device=dev) >= num_rows).to(torch.int64)


def _packed_key(key_cols, orders, num_rows, capacity: int, range_hint=None):
    """``(key, iota_bits)``: the pad rank, each key's null rank and value
    image, and the row index in the low ``iota_bits`` bits, as ONE int64
    sort operand, for keys ``sort_tier`` calls ``packed``.
    ``range_hint=(vmin, fits)`` (a single 64-bit integer or timestamp key)
    packs the key as ``value - vmin`` in the bits left beside the ranks,
    which the caller read off the batch's range."""
    dev = key_cols[0].values.device
    iota_bits = _iota_bits(capacity)
    iota = torch.arange(capacity, dtype=torch.int64, device=dev)
    if _hinted(key_cols, range_hint):
        vmin, _ = range_hint
        c, o = key_cols[0], orders[0]
        w = 62 - iota_bits - 1      # value bits left beside the ranks
        acc = (_pad_rank(num_rows, capacity, dev) << 1) | _null_rank(c, o)
        u = (c.values.to(torch.int64) - vmin).clamp(0, (1 << w) - 1)
        u = torch.where(c.validity, u, torch.zeros_like(u))
        if not o.ascending:
            u = ((1 << w) - 1) - u
        acc = (acc << w) | u
        return (acc << iota_bits) | iota, iota_bits
    acc = _pad_rank(num_rows, capacity, dev)
    for c, o in zip(key_cols, orders):
        w = _key_bits(c)
        acc = (acc << 1) | _null_rank(c, o)
        u = c.values.to(torch.int64)
        if not (c.is_string or isinstance(c.dtype, T.BooleanType)):
            u = u + (1 << (w - 1))
        u = u.clamp(0, (1 << w) - 1)
        u = torch.where(c.validity, u, torch.zeros_like(u))
        if not o.ascending:
            u = ((1 << w) - 1) - u
        acc = (acc << w) | u
    return (acc << iota_bits) | iota, iota_bits


def _wide_single_key(key_cols, orders, num_rows, capacity: int):
    """The permutation of a single 64-bit integer or timestamp key that does
    not pack, from TWO int64 operands: the order image with null and
    padding rows forced to the extremes, and (rank, row index), whose rank
    (valid 1; null 0 first or 2 last; padding 3) resolves the ties between
    a real extreme value, a null and padding. The reference sorts the pair
    in one ``lax.sort``; here the unique second operand is sorted first and
    the first operand stably after it."""
    c, o = key_cols[0], orders[0]
    dev = c.values.device
    big = torch.iinfo(torch.int64).max
    small = torch.iinfo(torch.int64).min
    v = c.values.to(torch.int64)
    if not o.ascending:
        v = ~v        # order-reversing, overflow-free
    nf = o.resolved_nulls_first
    v = torch.where(c.validity, v, torch.full_like(v, small if nf else big))
    live = torch.arange(capacity, device=dev) < num_rows
    v = torch.where(live, v, torch.full_like(v, big))
    rank = torch.where(c.validity, torch.ones_like(v),
                       torch.full_like(v, 0 if nf else 2))
    rank = torch.where(live, rank, torch.full_like(v, 3))
    iota_bits = _iota_bits(capacity)
    op2 = (rank << iota_bits) | torch.arange(capacity, dtype=torch.int64,
                                             device=dev)
    perm = torch.sort(op2).indices
    step = torch.sort(v[perm], stable=True).indices
    return perm[step]


def _hinted(key_cols, range_hint) -> bool:
    """A single 64-bit integer or timestamp key whose range the caller
    found to fit the packed key."""
    return (range_hint is not None and range_hint[1] and len(key_cols) == 1
            and _wide_int(key_cols[0]))


def sort_tier(key_cols, capacity: int, range_hint=None) -> str:
    """The tier ``sort_permutation`` takes for these keys: ``packed``,
    ``wide`` or ``multi``, decided from the types, the dictionaries, the
    capacity and the hint alone, so it costs nothing (the reference's
    order: the packed key when it fits, then the wide pair, then the
    operands)."""
    if not key_cols:
        return "multi"
    if _hinted(key_cols, range_hint):
        return "packed"
    # a nested key sorts as its int32 rank column: 33 bits
    widths = [33 if c.nested is not None else _key_bits(c) for c in key_cols]
    if None not in widths and (1 + _iota_bits(capacity)
                               + sum(1 + w for w in widths)) <= 63:
        return "packed"
    if len(key_cols) == 1 and _wide_int(key_cols[0]):
        return "wide"
    return "multi"


def sort_permutation(key_cols, orders, num_rows, capacity: int,
                     range_hint=None):
    """Stable permutation (int64) sorting live rows by keys; padding sinks
    to the end. ``num_rows`` may be a host int or a 0-d device tensor."""
    key_cols = [rank_key(c) if c.nested is not None else c for c in key_cols]
    tier = sort_tier(key_cols, capacity, range_hint)
    if tier == "packed":
        key, iota_bits = _packed_key(key_cols, orders, num_rows, capacity,
                                     range_hint=range_hint)
        return torch.sort(key).values & ((1 << iota_bits) - 1)
    if tier == "wide":
        return _wide_single_key(key_cols, orders, num_rows, capacity)
    return multi_permutation(key_cols, orders, num_rows, capacity)


def multi_permutation(key_cols, orders, num_rows, capacity: int):
    """The multi-operand tier: the pad rank and each key's operands
    (``_key_arrays``), one stable sort each from the least significant to
    the most. It takes every key type, so it is also the permutation the
    other tiers are held to."""
    dev = key_cols[0].values.device if key_cols else None
    operands = [_pad_rank(num_rows, capacity, dev).to(torch.int8)]
    for c, o in zip(key_cols, orders):
        operands.extend(_key_arrays(c, o))
    perm = torch.arange(capacity, dtype=torch.int64, device=dev)
    for op in reversed(operands):
        step = torch.sort(op[perm], stable=True).indices
        perm = perm[step]
    return perm


def partition_permutation(part_ids, num_partitions: int, num_rows: int,
                          capacity: int):
    """Stable permutation (int64) grouping live rows by partition id, with
    padding sunk to the end: the exchange's partition step. Padding rows
    take the sentinel id ``num_partitions``, which has a lane of its own.
    The ids are a tiny dense domain, so the radix kernels compute the
    permutation (``cuda_kernels.radix_partition_permutation``) whenever the
    domain with its sentinel fits their lanes; a wider one takes the stable
    argsort, as in the reference."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    dev = part_ids.device
    live = torch.arange(capacity, device=dev) < num_rows
    ids = torch.where(live, part_ids.to(torch.int32),
                      torch.full((capacity,), num_partitions,
                                 dtype=torch.int32, device=dev))
    if num_partitions + 1 <= CK.RADIX_MAX_PARTS:
        return CK.radix_partition_permutation(ids, num_partitions + 1)
    return torch.argsort(ids, stable=True)
