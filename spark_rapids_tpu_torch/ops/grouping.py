"""Small-domain group-by reductions — counterpart of the dense part of
``spark_rapids_tpu/ops/grouping.py``.

Keys whose domains are statically known (dictionary strings, booleans) fuse
into one int32 code per row; sum-shaped aggregates then reduce straight into
D per-group buckets with no sort. Count-like reductions go through the
``onehot_sum_f32`` kernel, as the JAX package sends them on a TPU. A batch's
float sums at small domains stack into masked matvecs, one per bucket; the
rest is a D-bucket scatter-add. The sort-based segment group-by is not
ported yet.
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


def dense_group_sum(vals, mask, codes, n_domain: int,
                    count_like: bool = False):
    """(n_domain,) per-group totals of ``vals`` over unsorted small-domain
    codes. Codes at or above n_domain land in a dropped overflow bucket
    (the codes of ``compact_key_codes`` are never negative).

    ``count_like`` marks 0/1-valued inputs (rows per group, per-batch count
    updates, the non-null counts of sum and avg): those are exact in f32
    below 2^24 rows, so they go through the ``onehot_sum_f32`` kernel, as
    the JAX package's TPU branch sends them. Everything else is a D-bucket
    scatter-add, its non-TPU branch."""
    v = torch.where(mask, vals, torch.zeros_like(vals))
    if count_like and v.shape[0] < (1 << 24):
        # the f32 2^24 exactness bound: a larger batch could put more ones
        # than that in one bucket, so it takes the exact scatter instead
        return CK.onehot_sum_f32(v.to(torch.float32), codes,
                                 n_domain).to(vals.dtype)
    out = torch.zeros((n_domain + 1,), dtype=v.dtype, device=v.device)
    out.index_add_(0, codes.clamp(0, n_domain).long(), v)
    return out[:n_domain]


_STACK_MAX_DOMAIN = 64   # per-domain masked matvecs unroll D times


def resolve_dense_group_sums(reqs, codes, n_domain: int, live):
    """One batch's bucket sums (``reqs`` = [(vals, mask, acc_dtype,
    count_like), ...]) → results in request order; equal requests (the same
    tensors, as aggregates sharing a child pass) reduce once.

    At small domains, two or more float sums stack into one (A, cap) f64
    matrix reduced by D masked matvecs (``V @ (codes == d)``): on an H100
    the per-column scatter-add of a q1 SF1 run took 32.7 ms of device time
    (global atomics on D + 1 addresses; PERF.md), far more than the
    matvecs. Count-likes and integer sums go through ``dense_group_sum``."""
    outs: list = [None] * len(reqs)
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
            kk = (id(v), id(m), acc, cl)
            if kk not in done:
                done[kk] = dense_group_sum(v.to(acc), m & live, codes,
                                           n_domain, count_like=cl)
            outs[i] = done[kk]
    return outs
