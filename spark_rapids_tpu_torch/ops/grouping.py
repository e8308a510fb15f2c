"""Small-domain group-by reductions — counterpart of the dense part of
``spark_rapids_tpu/ops/grouping.py``.

Keys whose domains are statically known (dictionary strings, booleans) fuse
into one int32 code per row; sum-shaped aggregates then reduce straight into
D per-group buckets with no sort. A batch's count-like reductions go
through the count kernel together (``cuda_kernels.onehot_sums_f32``, one
launch), where the JAX package sends each to its ``onehot_sum_f32`` kernel
on a TPU. A batch's float sums at small domains stack into masked matvecs,
one per bucket; the rest is a D-bucket scatter-add. The sort-based segment
group-by is not ported yet.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import cuda_kernels as CK


def compact_key_codes(key_cols, max_domain: int = 1 << 20):
    """(codes int32, strides) for keys whose domains are STATICALLY known
    (dictionary-coded strings, booleans); nulls get each key's top code
    (Spark groups nulls together). None when unknown or overflowing."""
    if not key_cols:
        return None
    strides = []
    K = 1
    for c in key_cols:
        if c.is_string and c.dictionary is not None:
            d = len(c.dictionary) + 1
        elif isinstance(c.dtype, T.BooleanType):
            d = 3
        else:
            return None
        strides.append(d)
        K *= d
        if K > max_domain:
            return None
    combined = None
    for c, d in zip(key_cols, strides):
        code = torch.where(c.validity, c.values.to(torch.int32),
                           torch.full_like(c.values, d - 1, dtype=torch.int32))
        combined = code if combined is None else combined * d + code
    return combined, strides


def dense_group_sum(vals, mask, codes, n_domain: int):
    """(n_domain,) per-group totals of ``vals`` over unsorted small-domain
    codes, as a D-bucket scatter-add (the JAX package's non-TPU branch).
    Codes at or above n_domain land in a dropped overflow bucket (the codes
    of ``compact_key_codes`` are never negative)."""
    v = torch.where(mask, vals, torch.zeros_like(vals))
    out = torch.zeros((n_domain + 1,), dtype=v.dtype, device=v.device)
    out.index_add_(0, codes.clamp(0, n_domain).long(), v)
    return out[:n_domain]


_STACK_MAX_DOMAIN = 64   # per-domain masked matvecs unroll D times


def resolve_dense_group_sums(reqs, codes, n_domain: int, live):
    """One batch's bucket sums (``reqs`` = [(vals, mask, acc_dtype,
    count_like), ...]) → results in request order; equal requests (the same
    tensors, as aggregates sharing a child pass) reduce once. A request's
    ``vals`` and ``mask`` may both be None for a count of every row (the
    rows per group).

    The codes must already drop the rows that are not live (the aggregate
    gives them the code ``n_domain``): the count route reads no liveness.
    Count-like requests (0/1 values) below 2^24 rows, the f32 exactness
    bound, take one ``onehot_sums_f32`` call for the whole batch, which
    reads the codes once and each request's values in their own type. A
    request whose values are its mask (a validity counted as 0/1) is read
    once, and a count of every row reads only the codes. At small domains,
    two or more float sums stack into one (A, cap) f64 matrix reduced by D
    masked matvecs (``V @ (codes == d)``): on an H100 the per-column
    scatter-add of a q1 SF1 run took 32.7 ms of device time (global atomics
    on D + 1 addresses; PERF.md), far more than the matvecs. Integer sums,
    and count-likes at 2^24 rows or more, go through ``dense_group_sum``."""
    outs: list = [None] * len(reqs)
    counts = [i for i, (_v, _m, _acc, cl) in enumerate(reqs)
              if cl and codes.shape[0] < (1 << 24)]
    if counts:
        slot_of: dict = {}
        fused = []
        for i in counts:
            v, m, _, _ = reqs[i]
            kk = (id(v), id(m))
            if kk not in slot_of:
                slot_of[kk] = len(fused)
                fused.append((v, None if v is m else m))
        sums = CK.onehot_sums_f32(codes, fused, n_domain)
        by_acc: dict = {}
        for i in counts:
            v, m, acc, _ = reqs[i]
            if acc not in by_acc:
                by_acc[acc] = sums.to(acc)
            outs[i] = by_acc[acc][slot_of[(id(v), id(m))]]
    stack = [i for i, (v, m, acc, cl) in enumerate(reqs)
             if not cl and acc.is_floating_point]
    if len(stack) >= 2 and n_domain <= _STACK_MAX_DOMAIN:
        row_of: dict = {}
        rows = []
        for i in stack:
            v, m, _, _ = reqs[i]
            kk = (id(v), id(m))
            if kk not in row_of:
                row_of[kk] = len(rows)
                rows.append(torch.where(m & live, v.to(torch.float64),
                                        torch.zeros((), dtype=torch.float64,
                                                    device=v.device)))
        V = torch.stack(rows)
        sums = torch.stack(
            [V @ (codes == d).to(torch.float64) for d in range(n_domain)],
            dim=1)   # (A, D)
        for i in stack:
            v, m, acc, _ = reqs[i]
            outs[i] = sums[row_of[(id(v), id(m))]].to(acc)
    done: dict = {}
    for i, (v, m, acc, cl) in enumerate(reqs):
        if outs[i] is None:
            kk = (id(v), id(m), acc)
            if kk not in done:
                if v is None:   # a count of every row
                    v = torch.ones(codes.shape, dtype=acc,
                                   device=codes.device)
                done[kk] = dense_group_sum(
                    v.to(acc), live if m is None else m & live, codes,
                    n_domain)
            outs[i] = done[kk]
    return outs
