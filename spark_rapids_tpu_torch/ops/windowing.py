"""Window kernels: segment boundaries and segmented scans over sorted
partitions — counterpart of ``spark_rapids_tpu/ops/windowing.py``.

The reference sorts once and answers every frame with segmented scans
(cudf's rolling window in the original, reference GpuWindowExpression
``windowAggregation``:847); its module has no Pallas kernel, and these are
plain torch ops:

- ``seg_starts`` / ``seg_ends``: each row's segment start and end. The
  reference takes one global cummax (cummin) of the marked row indices. On
  CUDA, ``torch.cummax``/``cummin`` of one long row runs as a scan with
  indices that took 2.6 ms a call on TPC-H q18's batches of 2^20 and 2^21
  rows on an H100 (PERF.md), so the port finds the same indices with a
  cumsum, one scatter of each boundary's row into its rank and one gather:
  the k-th boundary's row is ``pos[k]``, and a row with c boundaries at or
  before it starts at ``pos[c - 1]`` and ends before ``pos[c]``. The
  segment reductions of ``ops/grouping.py`` call them too.
- ``tie_group_ends``, ``rank`` and the exec's partition ends: the
  reference takes them from its log-step doubling scan (``seg_cummax``,
  log2(capacity) rolls and selects); the port reads the same indices off
  ``seg_ends``/``seg_starts``, with no scan.
- ``seg_cumsum``, ``row_number``, ``dense_rank``, ``rank`` and
  ``shift_within_partition`` (lead/lag): positions against segment starts
  and one global cumsum rebased per segment.
- ``sparse_table`` / ``range_query``: min/max over per-row ``[lo, hi]``
  windows from log2(capacity) levels of power-of-two spans.
- ``searchsorted_lex`` / ``range_frame_bounds``: the bounds of a bounded
  RANGE frame, by a branchless binary search on ``(segment, rank, value)``
  triples, log2(capacity) rounds of gathers.

Every result is the reference's, integer for integer (``tests/
test_torch_window.py``).
"""

from __future__ import annotations

import torch


def _boundary_rows(boundary):
    """(c, pos): ``c[i]`` counts the boundaries at or before row i;
    ``pos[k]`` is the row of the k-th boundary (0-based), and ``cap`` for
    every k from the number of boundaries on."""
    cap = boundary.shape[0]
    dev = boundary.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    c = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32)
    pos = torch.full((cap + 2,), cap, dtype=torch.int32, device=dev)
    # every boundary has a rank of its own; the other rows land in the
    # unread slot cap + 1
    pos.scatter_(0, torch.where(boundary, c - 1, cap + 1).long(), idx)
    return c, pos


def seg_starts(boundary):
    """Index of the segment start for every row: the most recent boundary at
    or before the row, 0 before the first boundary."""
    c, pos = _boundary_rows(boundary)
    start = pos.index_select(0, (c - 1).clamp(min=0))
    return torch.where(c > 0, start, torch.zeros_like(start))


def seg_ends(boundary):
    """Index of the segment end for every row: the next boundary after the
    row minus one, the last row when none follows."""
    c, pos = _boundary_rows(boundary)
    return pos.index_select(0, c) - 1


def seg_cumsum(values, boundary):
    """Segmented cumulative sum: one global cumsum rebased per segment."""
    cs = torch.cumsum(values, 0)
    start = seg_starts(boundary)
    base = torch.where(start > 0, cs[(start - 1).clamp(min=0).long()],
                       torch.zeros_like(cs))
    return cs - base


def tie_group_ends(order_boundary, part_boundary):
    """For RANGE frames: the last index of each row's order-key tie group
    within its partition (rows with equal order keys share the frame end:
    Spark's RANGE CURRENT ROW includes ties). A tie group ends before the
    next order boundary: ``seg_ends`` of the order boundaries is the
    reference's reversed segmented cummax, index for index (the exec's
    order boundaries include its partition boundaries)."""
    return seg_ends(order_boundary)


def row_number(part_boundary, capacity):
    idx = torch.arange(capacity, dtype=torch.int32,
                       device=part_boundary.device)
    return idx - seg_starts(part_boundary) + 1


def dense_rank(order_boundary, part_boundary):
    newgrp = order_boundary & ~part_boundary
    return seg_cumsum(newgrp.to(torch.int32), part_boundary) + 1


def rank(order_boundary, part_boundary, capacity):
    """1 + the distance from the partition start to the row's tie group
    start: the latest order boundary at or after the partition start (0
    when there is none, as the reference's segmented cummax of the marked
    indices)."""
    start = seg_starts(part_boundary)
    tie = seg_starts(order_boundary)
    tie_start = torch.where(tie >= start, tie, torch.zeros_like(tie))
    return tie_start - start + 1


def shift_within_partition(values, validity, seg_ids, offset: int,
                           capacity: int, fill_value, fill_valid: bool):
    """lead (offset > 0) / lag (offset < 0), masked to the row's partition."""
    dev = values.device
    idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    src = idx + offset
    in_range = (src >= 0) & (src < capacity)
    src_c = src.clamp(0, capacity - 1)
    same_part = in_range & (seg_ids[src_c] == seg_ids)
    fill = torch.full_like(values, fill_value)
    vals = torch.where(same_part, values[src_c], fill)
    valid = torch.where(same_part, validity[src_c],
                        torch.full_like(validity, fill_valid))
    return vals, valid


# -- variable-bound frames: [lo, hi] per row ----------------------------------
#
# Sliding min/max and bounded RANGE frames reduce every frame shape to an
# inclusive per-row index window [lo, hi]. min/max answer range queries with
# a sparse table (log-levels of power-of-2 span extremes); sums and counts
# difference one global cumsum.

def sparse_table(values, combine, sentinel):
    """(L, n) table: t[k][i] = combine over values[i : i+2^k] (clamped).
    Entries whose span crosses n are padded with ``sentinel``; the queries
    of ``range_query`` never read a padded slot for in-bounds [lo, hi]."""
    n = values.shape[0]
    levels = [values]
    k = 0
    while (1 << (k + 1)) <= n:
        prev = levels[-1]
        s = 1 << k
        shifted = torch.cat([prev[s:], torch.full((s,), sentinel,
                                                  dtype=prev.dtype,
                                                  device=prev.device)])
        levels.append(combine(prev, shifted))
        k += 1
    return torch.stack(levels)


def range_query(table, combine, lo, hi):
    """combine over [lo, hi] inclusive per row (needs hi >= lo; callers mask
    empty frames themselves): two overlapping power-of-two spans."""
    L = table.shape[0]
    w = hi - lo + 1
    k = torch.zeros_like(w)
    for j in range(1, L):
        k = k + (w >= (1 << j)).to(k.dtype)
    span = torch.ones_like(k) << k
    a = table[k.long(), lo.long()]
    b = table[k.long(), (hi - span + 1).long()]
    return combine(a, b)


def searchsorted_lex(seg, rank, val, q_seg, q_rank, q_val, side: str):
    """Per query row, the first index j with (seg[j], rank[j], val[j]) >=
    (or > for side='right') the query triple, by a branchless binary search:
    log2(n) rounds of gathers. The arrays must be lexicographically sorted
    (they are: rows sort by partition, then null rank, then order value)."""
    n = seg.shape[0]
    dev = seg.device
    lo = torch.zeros(q_seg.shape, dtype=torch.int32, device=dev)
    hi = torch.full(q_seg.shape, n, dtype=torch.int32, device=dev)
    n_t = torch.full_like(lo, n)
    for _ in range(max(1, n.bit_length())):
        mid = (lo + hi) >> 1
        m = mid.clamp(0, n - 1).long()
        sj, rj, vj = seg[m], rank[m], val[m]
        vcmp = (vj >= q_val) if side == "left" else (vj > q_val)
        ge = (sj > q_seg) | ((sj == q_seg)
                             & ((rj > q_rank) | ((rj == q_rank) & vcmp)))
        ge = ge & (mid < n)
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, torch.minimum(mid + 1, n_t))
    return lo


def range_frame_bounds(order_col_values, order_validity, seg_ids, ascending,
                       preceding, following, pstart, pend):
    """Per-row [lo, hi] for a bounded RANGE frame over ONE numeric order key.

    Sort-space transform: descending negates (bitwise NOT for integers, so
    the minimum is safe), so the search is always ascending. Within a
    partition rows sort as the null-first group < values < the NaN group <
    the null-last group, encoded in a rank lane so that a null or NaN
    current row resolves to its PEER GROUP on a bounded side (Spark's
    RangeBoundOrdering: null ± offset is null, equal only to nulls; NaN is
    its own largest peer class)."""
    v = order_col_values
    dev = v.device
    i64 = torch.iinfo(torch.int64)
    if v.is_floating_point():
        nan_rank_pos = torch.isnan(v)
        s = torch.where(nan_rank_pos, torch.zeros_like(v, dtype=torch.float64),
                        v.to(torch.float64))
        s = s if ascending else -s
        q_lo_sent, q_hi_sent = float("-inf"), float("inf")
        pre = None if preceding is None else float(preceding)
        fol = None if following is None else float(following)
    else:
        s = v.to(torch.int64)
        s = s if ascending else ~s
        nan_rank_pos = torch.zeros(v.shape, dtype=torch.bool, device=dev)
        q_lo_sent, q_hi_sent = i64.min, i64.max
        pre = None if preceding is None else int(preceding)
        fol = None if following is None else int(following)

    # rank within the partition: nulls keep their sorted side, and NaN is
    # the largest value class ascending (the negation puts it first
    # descending, where the sort also put it)
    nan_rank = 2 if ascending else -1
    i32 = torch.int32
    rank = torch.where(order_validity,
                       torch.where(nan_rank_pos, torch.tensor(nan_rank, dtype=i32,
                                                              device=dev),
                                   torch.tensor(1, dtype=i32, device=dev)),
                       torch.tensor(0, dtype=i32, device=dev))
    # null rows sort first or last by nulls_first: read it off the layout
    # (a null row at pstart means nulls first); either way one block
    null_first_here = ~order_validity[pstart.long()]
    rank = torch.where(order_validity, rank,
                       torch.where(null_first_here,
                                   torch.tensor(-2, dtype=i32, device=dev),
                                   torch.tensor(3, dtype=i32, device=dev)))

    # peers are told apart by the rank lane alone
    s = torch.where(order_validity & ~nan_rank_pos, s, torch.zeros_like(s))
    peer_only = ~order_validity | nan_rank_pos

    if pre is None:
        lo = pstart
    else:
        q_val = torch.where(peer_only, torch.full_like(s, q_lo_sent), s - pre)
        lo = searchsorted_lex(seg_ids, rank, s, seg_ids, rank, q_val,
                              side="left")
    if fol is None:
        hi = pend
    else:
        q_val = torch.where(peer_only, torch.full_like(s, q_hi_sent), s + fol)
        hi = searchsorted_lex(seg_ids, rank, s, seg_ids, rank, q_val,
                              side="right") - 1
    return (torch.maximum(lo, pstart).to(torch.int32),
            torch.minimum(hi, pend).to(torch.int32))
