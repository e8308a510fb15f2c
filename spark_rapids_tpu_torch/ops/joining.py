"""Equi-join gather maps — counterpart of ``spark_rapids_tpu/ops/joining.py``:
the join type names, the multi-key rank path (``join_ranks``, ``probe``),
``pair_counts``, ``expand_pairs`` and ``total_pairs``.

The rank path serves every join the single fixed-point key probe of
``exec/joins.py`` does not: several keys, or one string or float key. The
build's and the stream batch's key rows are concatenated and sorted once
through ``ops/grouping.group_segments``; equal key tuples get equal dense
ranks, with Spark's semantics (NaN equals NaN, -0.0 equals 0.0, and a null
key never matches: null-keyed rows take a sentinel rank of their side).
Rank equality is key-tuple equality, without hash collisions. The build's
ranks are then sorted once, and each stream row finds its matches as a
contiguous range ``[lo, hi)`` by two ``searchsorted``.

Either probe gives each stream row a range of positions in the build's
order, so the gather map is implicit. Pair ``j`` of the join belongs to
stream row ``i = searchsorted(cumsum(counts), j)`` and to build position
``lo[i] + (j - start[i])``, and the pairs are expanded in chunks of a fixed
capacity (the JoinGatherer analog). Pairs come out in stream order.

Join-type semantics (Spark): LeftOuter emits an unmatched stream row once,
null-extended; LeftSemi emits a matching stream row once; LeftAnti the
stream rows without a match. A right or full outer join streams its
preserved side, so its stream rows count as LeftOuter's; a full outer join
also needs the build rows no stream row matched (``matched_build``).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.ops.grouping import group_segments

INNER = "inner"
LEFT_OUTER = "leftouter"
RIGHT_OUTER = "rightouter"
FULL_OUTER = "fullouter"
LEFT_SEMI = "leftsemi"
LEFT_ANTI = "leftanti"
CROSS = "cross"

_BUILD_NULL_RANK = -2
_STREAM_NULL_RANK = -1
_PAD_RANK = 2**31 - 1


def _concat_key_cols(build_keys, stream_keys):
    """Build rows then stream rows, one Col per key. Integer keys of two
    widths meet in the wider type (the reference's ``jnp.concatenate``
    promotes the same way)."""
    out = []
    for b, s in zip(build_keys, stream_keys):
        common = torch.promote_types(b.values.dtype, s.values.dtype)
        vals = torch.cat([b.values.to(common), s.values.to(common)])
        valid = torch.cat([b.validity, s.validity])
        dtype = b.dtype if b.values.dtype == common else s.dtype
        out.append(Col(vals, valid, dtype, b.dictionary))
    return out


def join_ranks(build_keys, n_build: int, build_cap: int, stream_keys,
               n_stream: int, stream_cap: int):
    """Dense int32 ranks for both sides such that rank equality is key-tuple
    equality. Null-keyed rows get their side's sentinel rank, so they never
    match, and padding the largest rank. String keys must already share one
    dictionary. Returns ``(build_ranks, stream_ranks)``."""
    total_cap = build_cap + stream_cap
    both = _concat_key_cols(build_keys, stream_keys)
    dev = both[0].values.device
    idx = torch.arange(total_cap, dtype=torch.int32, device=dev)
    # live rows: build [0, n_build), stream [build_cap, build_cap + n_stream)
    is_build = idx < build_cap
    live = torch.where(is_build, idx < n_build, (idx - build_cap) < n_stream)
    # every row takes part in the sort; liveness and nulls are applied by
    # the sentinels afterwards
    perm, seg_ids, _, _ = group_segments(both, total_cap, total_cap)
    # perm is a permutation: each slot is written exactly once
    ranks = torch.empty((total_cap,), dtype=torch.int32, device=dev)
    ranks[perm] = seg_ids
    any_null = torch.zeros((total_cap,), dtype=torch.bool, device=dev)
    for c in both:
        any_null = any_null | ~c.validity
    null_rank = torch.where(is_build, _BUILD_NULL_RANK, _STREAM_NULL_RANK)
    ranks = torch.where(any_null, null_rank.to(torch.int32), ranks)
    ranks = torch.where(live, ranks, _PAD_RANK)
    return ranks[:build_cap], ranks[build_cap:]


def probe(build_ranks, stream_ranks):
    """Sorted-build probe: ``(build_perm, lo, hi)``, with ``[lo, hi)`` the
    positions in build order of each stream row's matches."""
    build_perm = torch.argsort(build_ranks, stable=True)
    sorted_build = build_ranks[build_perm].contiguous()
    sr = stream_ranks.contiguous()
    lo = torch.searchsorted(sorted_build, sr)
    hi = torch.searchsorted(sorted_build, sr, right=True)
    # the stream's sentinels never match (they differ from the build's,
    # and padding is guarded here as well)
    bad = (stream_ranks == _STREAM_NULL_RANK) | (stream_ranks == _PAD_RANK)
    hi = torch.where(bad, lo, hi)
    return build_perm, lo, hi


def pair_counts(lo, hi, n_stream: int, stream_cap: int, join_type: str):
    """Per-stream-row emitted pair count (int64) for the join type; 0 on
    padding rows."""
    live = torch.arange(stream_cap, device=lo.device) < n_stream
    matches = (hi - lo).long()
    if join_type == INNER:
        counts = matches
    elif join_type in (LEFT_OUTER, FULL_OUTER):
        counts = torch.clamp(matches, min=1)
    elif join_type == LEFT_SEMI:
        counts = torch.clamp(matches, max=1)
    elif join_type == LEFT_ANTI:
        counts = (matches == 0).long()
    else:
        raise ValueError(f"unsupported join type for pair_counts: {join_type}")
    return torch.where(live, counts, torch.zeros_like(counts))


def expand_pairs(build_perm, lo, hi, counts, start_pair: int, out_cap: int):
    """Pairs ``[start_pair, start_pair + out_cap)`` as ``(stream_idx,
    build_idx, build_matched, pair_live)``; ``build_matched`` is False on the
    null-extension slot of an outer join and past the last pair."""
    dev = counts.device
    offsets = torch.cumsum(counts, 0)  # inclusive
    total = offsets[-1]
    j = torch.arange(out_cap, dtype=torch.int64, device=dev) + start_pair
    stream_idx = torch.searchsorted(offsets, j, right=True)
    stream_idx = torch.clamp(stream_idx, 0, counts.shape[0] - 1)
    starts = offsets - counts
    within = j - starts[stream_idx]
    n_matches = (hi - lo).long()[stream_idx]
    build_matched = within < n_matches
    b_pos = torch.clamp(lo.long()[stream_idx]
                        + torch.minimum(within, n_matches - 1),
                        0, build_perm.shape[0] - 1)
    build_idx = build_perm[b_pos]
    pair_live = j < total
    return stream_idx, build_idx, build_matched & pair_live, pair_live


def matched_build(build_perm, lo, hi, build_cap: int):
    """Which build rows one stream batch matched, from the probe's ranges:
    a bool per build row. Every stream row marks the build positions
    ``[lo, hi)`` (positions in ``build_perm``'s order) through a difference
    array and one cumsum, so the work is linear in both sides whatever the
    pair count. A stream row that matched nothing (a null or padding row
    among them) has ``hi == lo`` and marks nothing."""
    dev = lo.device
    has = hi > lo
    delta = torch.zeros((build_cap + 1,), dtype=torch.int32, device=dev)
    delta.index_add_(0, lo.long(), has.to(torch.int32))
    delta.index_add_(0, hi.long(), -has.to(torch.int32))
    covered = torch.cumsum(delta[:build_cap], 0) > 0
    out = torch.zeros((build_cap,), dtype=torch.bool, device=dev)
    out[build_perm.long()] = covered
    return out


def total_pairs(counts):
    """The number of pairs, as a 0-dim tensor on the device (the caller
    syncs it once per stream batch)."""
    return counts.sum()
