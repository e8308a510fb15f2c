"""Group-by reductions — counterpart of ``spark_rapids_tpu/ops/grouping.py``.

The dense path: keys whose domains are statically known (dictionary strings, booleans) fuse
into one int32 code per row; sum-shaped aggregates then reduce straight into
D per-group buckets with no sort. A batch's count-like reductions go
through the count kernel together (``cuda_kernels.onehot_sums_f32``, one
launch), where the JAX package sends each to its ``onehot_sum_f32`` kernel
on a TPU. A batch's float sums at small domains stack into masked matvecs,
one per bucket; the rest is a D-bucket scatter-add.

The segment path, for every other key: sort the rows by key
(``group_segments``), flag group boundaries, segment-reduce the values, and
the aggregate exec compacts one row per group to the front. Results are
PER-ROW (row i holds the aggregate of row i's whole segment). Reductions are
scan- and sort-based, never scatter-based, as in the reference, so that the
results match it bit for bit: integer sums and counts difference one global
cumsum at the segment edges (exact, even across wrap); float sums add
aligned blocks of a pairwise tree in the reference's order of adds (a float
scatter-add on CUDA adds in whatever order its atomics land); min, max,
first and last re-sort ``(segment, value)`` stably. Like the reference,
which computes them with XLA ops, these are plain torch ops
(``torch.sort(stable=True)``, ``cumsum``, ``index_select``).
"""

from __future__ import annotations

import typing

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.ops import windowing as W
from spark_rapids_tpu_torch.ops.filtering import gather_cols
from spark_rapids_tpu_torch.ops.sorting import SortOrder, sort_permutation


class SegCtx(typing.NamedTuple):
    """Shared segment structure for one sorted group-by batch."""
    seg_ids: torch.Tensor    # group index per sorted row (pad -> capacity-1)
    boundary: torch.Tensor   # True at the first row of each segment
    seg_start: torch.Tensor  # index of the first row of the row's segment
    seg_end: torch.Tensor    # index of the last row of the row's segment
    capacity: int


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


def combine_compact_keys(key_cols):
    """Fuse two or more group keys with statically known small domains
    (dictionary strings, booleans) into one int32 code column, so that the
    sort and the boundary checks touch one operand. Nulls get their own
    code. None for a single key, or when a domain is unknown or the product
    overflows."""
    if len(key_cols) < 2:
        return None
    ks = compact_key_codes(key_cols)
    if ks is None:
        return None
    combined, _ = ks
    return Col(combined, torch.ones_like(combined, dtype=torch.bool), T.INT)


def group_segments(key_cols, num_rows, capacity: int,
                   presorted: bool = False, range_hint=None):
    """Sort by keys and flag the groups: ``(perm, seg_ids, boundary, live)``.
    ``perm`` sorts the rows; ``seg_ids[i]`` is the group of sorted row i,
    and padding rows go to segment ``capacity - 1``; ``boundary`` marks the
    first row of each group. NaN groups with NaN, -0.0 with 0.0, and nulls
    form their own group. ``presorted=True`` asserts that the caller proved
    the live rows arrive key-sorted with no null (the aggregate exec's
    per-batch probe): the sort and the key gather are skipped.
    ``range_hint`` forwards the probe's key range to the packed sort
    (``ops/sorting._packed_key``) of a single 64-bit key. ``num_rows`` may
    be a 0-d device tensor."""
    dev = key_cols[0].values.device
    live = torch.arange(capacity, dtype=torch.int32, device=dev) < num_rows
    if presorted:
        perm = torch.arange(capacity, dtype=torch.int64, device=dev)
        sorted_keys = [Col(c.values, c.validity & live, c.dtype, c.dictionary)
                       for c in key_cols]
    else:
        perm = sort_permutation(key_cols, [SortOrder() for _ in key_cols],
                                num_rows, capacity, range_hint=range_hint)
        sorted_keys = gather_cols(key_cols, perm, live)

    neq = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    for c in sorted_keys:
        prev_vals = torch.roll(c.values, 1)
        prev_valid = torch.roll(c.validity, 1)
        if isinstance(c.dtype, T.FractionalType):
            a, b = c.values, prev_vals
            both_nan = torch.isnan(a) & torch.isnan(b)
            differs = ~both_nan & ~(a == b)
        else:
            differs = c.values != prev_vals
        neq = neq | differs | (c.validity != prev_valid)
    first_live = torch.arange(capacity, device=dev) == 0
    boundary = (first_live | neq) & live
    seg_ids = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_ids = torch.where(live, seg_ids,
                          torch.full_like(seg_ids, capacity - 1))
    seg_ids = seg_ids.clamp(0, capacity - 1)
    return perm, seg_ids, boundary, live


def segment_structure(seg_ids, capacity: int) -> SegCtx:
    """Per-row segment start and end from sorted seg_ids, shared by every
    aggregate of the batch."""
    idx = torch.arange(capacity, dtype=torch.int32, device=seg_ids.device)
    prev = torch.roll(seg_ids, 1)
    boundary = (idx == 0) | (seg_ids != prev)
    return SegCtx(seg_ids, boundary, W.seg_starts(boundary),
                  W.seg_ends(boundary), capacity)


def _take(x, idx):
    return x.index_select(0, idx)


def _edge_sum(data, ctx: SegCtx):
    """Per-row segment total of integer ``data`` by one global cumsum
    differenced at the row's segment edges: exact, even across wrap. The
    sum keeps the type of ``data``; booleans count in int64, as
    ``jnp.cumsum`` promotes them."""
    acc = torch.int64 if data.dtype == torch.bool else data.dtype
    cs = torch.cumsum(data, 0, dtype=acc)
    csz = torch.cat([torch.zeros((1,), dtype=cs.dtype, device=cs.device), cs])
    return _take(csz, ctx.seg_end + 1) - _take(csz, ctx.seg_start)


def _seg_sum_tree(data, ctx: SegCtx):
    """Per-segment float total by a range-sum tree: level k holds the sums
    of aligned 2^k-blocks (pairwise halving), and each row's
    ``[seg_start, seg_end]`` is covered by at most 2*log2(cap) disjoint
    aligned blocks, added front and back level by level in the reference's
    order. No prefix is subtracted, so a total never cancels against the
    prefixes of other segments."""
    levels = [data]
    while levels[-1].shape[0] > 1:
        x = levels[-1]
        if x.shape[0] % 2:    # non-power-of-two capacity: zero-pad the level
            x = torch.cat([x, torch.zeros((1,), dtype=x.dtype,
                                          device=x.device)])
        levels.append(x[0::2] + x[1::2])

    lo = ctx.seg_start
    hi = ctx.seg_end + 1
    out = torch.zeros_like(data)
    zero = torch.zeros_like(data)
    for k, level in enumerate(levels):
        blk = 1 << k
        top = level.shape[0] - 1
        # a 2^k block at the front when lo has bit k set
        take_lo = ((lo & blk) != 0) & (lo + blk <= hi)
        contrib = _take(level, (lo >> k).clamp(0, top))
        out = out + torch.where(take_lo, contrib, zero)
        lo = torch.where(take_lo, lo + blk, lo)
        # and one at the back when hi has bit k set
        take_hi = ((hi & blk) != 0) & (hi - blk >= lo)
        contrib = _take(level, ((hi - blk) >> k).clamp(0, top))
        out = out + torch.where(take_hi, contrib, zero)
        hi = torch.where(take_hi, hi - blk, hi)
    return out


def _seg_extreme(data, ctx: SegCtx, largest: bool):
    """Per-segment min or max by re-sorting ``(seg_id, value)`` pairs: the
    seg_ids are already sorted, so the sort only reorders within segments
    and the extreme lands on the segment's first or last row. The sort is
    stable and ties -0.0 with 0.0, as the reference's ``jax.lax.sort``
    does, so a segment's extreme has the reference's bits."""
    key = data
    if data.is_floating_point():
        key = torch.where(data == 0, torch.zeros_like(data), data)
    perm = torch.sort(key, stable=True).indices
    perm = _take(perm, torch.sort(_take(ctx.seg_ids, perm),
                                  stable=True).indices)
    pos = ctx.seg_end if largest else ctx.seg_start
    return _take(_take(data, perm), pos)


def segment_count(validity, ctx: SegCtx):
    """Per-row count of valid rows in the row's segment."""
    return _edge_sum(validity.to(torch.int64), ctx)


def segment_sum(values, validity, ctx: SegCtx):
    data = torch.where(validity, values, torch.zeros_like(values))
    if data.is_floating_point():
        s = _take(_seg_sum_tree(data, ctx), ctx.seg_end)
    else:
        s = _edge_sum(data, ctx)
    return s, segment_count(validity, ctx)


def segment_min(values, validity, ctx: SegCtx, dtype: T.DataType):
    if isinstance(dtype, T.FractionalType):
        nan = torch.isnan(values)
        data = torch.where(validity & ~nan, values,
                           torch.full_like(values, float("inf")))
        m = _seg_extreme(data, ctx, largest=False)
        # all-NaN group: NaN (Spark: NaN is largest, so min skips it if it
        # can)
        has_non_nan = _edge_sum((validity & ~nan).to(torch.int32), ctx)
        has_nan = _edge_sum((validity & nan).to(torch.int32), ctx)
        return torch.where((has_non_nan == 0) & (has_nan > 0),
                           torch.full_like(m, float("nan")), m)
    if values.dtype == torch.bool:
        data = torch.where(validity, values, True).to(torch.int8)
        return _seg_extreme(data, ctx, largest=False).to(torch.bool)
    data = torch.where(validity, values,
                       torch.full_like(values, torch.iinfo(values.dtype).max))
    return _seg_extreme(data, ctx, largest=False)


def segment_max(values, validity, ctx: SegCtx, dtype: T.DataType):
    if isinstance(dtype, T.FractionalType):
        nan = torch.isnan(values)
        data = torch.where(validity & ~nan, values,
                           torch.full_like(values, float("-inf")))
        m = _seg_extreme(data, ctx, largest=True)
        # any NaN in the group: NaN (NaN is largest)
        has_nan = _edge_sum((validity & nan).to(torch.int32), ctx)
        return torch.where(has_nan > 0, torch.full_like(m, float("nan")), m)
    if values.dtype == torch.bool:
        data = torch.where(validity, values, False).to(torch.int8)
        return _seg_extreme(data, ctx, largest=True).to(torch.bool)
    data = torch.where(validity, values,
                       torch.full_like(values, torch.iinfo(values.dtype).min))
    return _seg_extreme(data, ctx, largest=True)


def segment_first_index(validity, ctx: SegCtx, ignore_nulls: bool):
    """(the row of each group's first value in sorted order, clamped into
    the batch; whether the group has one); Spark First(ignoreNulls)."""
    idx = torch.arange(ctx.capacity, dtype=torch.int32, device=validity.device)
    eligible = validity if ignore_nulls else torch.ones_like(validity)
    cand = torch.where(eligible, idx, torch.full_like(idx, ctx.capacity))
    pos = _seg_extreme(cand, ctx, largest=False)
    return pos.clamp(0, ctx.capacity - 1), pos < ctx.capacity


def segment_last_index(validity, ctx: SegCtx, ignore_nulls: bool):
    """As ``segment_first_index``, for the group's last value (Last)."""
    idx = torch.arange(ctx.capacity, dtype=torch.int32, device=validity.device)
    eligible = validity if ignore_nulls else torch.ones_like(validity)
    cand = torch.where(eligible, idx, torch.full_like(idx, -1))
    pos = _seg_extreme(cand, ctx, largest=True)
    return pos.clamp(0, ctx.capacity - 1), pos > -1


def segment_arg_extreme(ranks, validity, ctx: SegCtx, largest: bool):
    """(the row of each group's greatest or least rank among its valid rows,
    the first such row in sorted order, clamped into the batch; whether the
    group has a valid row): Min and Max of a nested value, whose ranks
    (``ops/nested.order_ranks``) lie in ``[0, capacity]``."""
    cap = ctx.capacity
    idx = torch.arange(cap, dtype=torch.int64, device=validity.device)
    r = ranks.to(torch.int64)
    if largest:
        key = torch.where(validity, r * cap + (cap - 1 - idx),
                          torch.full_like(idx, -1))
        pos = (cap - 1) - _seg_extreme(key, ctx, largest=True) % cap
    else:
        key = torch.where(validity, r * cap + idx,
                          torch.full_like(idx, (cap + 1) * cap))
        pos = _seg_extreme(key, ctx, largest=False) % cap
    return pos.clamp(0, cap - 1), segment_count(validity, ctx) > 0


def segment_first(values, validity, ctx: SegCtx, ignore_nulls: bool):
    """First value of each group in sorted order; Spark First(ignoreNulls)."""
    pos, found = segment_first_index(validity, ctx, ignore_nulls)
    return _take(values, pos), found & _take(validity, pos)


def segment_last(values, validity, ctx: SegCtx, ignore_nulls: bool):
    """Last value of each group in sorted order; Spark Last(ignoreNulls)."""
    pos, found = segment_last_index(validity, ctx, ignore_nulls)
    return _take(values, pos), found & _take(validity, pos)
