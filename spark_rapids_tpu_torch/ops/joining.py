"""Equi-join gather maps — counterpart of the parts of
``spark_rapids_tpu/ops/joining.py`` that the single-key probe uses: the join
type names, ``pair_counts``, ``expand_pairs`` and ``total_pairs``.

A probe gives each stream row a contiguous range ``[lo, hi)`` of positions
in the build's order (``exec/joins.py``); the gather map is implicit. Pair
``j`` of the join belongs to stream row ``i = searchsorted(cumsum(counts),
j)`` and to build position ``lo[i] + (j - start[i])``, and the pairs are
expanded in chunks of a fixed capacity (the JoinGatherer analog). Pairs come
out in stream order.

Join-type semantics (Spark): null keys never match; LeftOuter emits an
unmatched stream row once, null-extended; LeftSemi emits a matching stream
row once; LeftAnti the stream rows without a match. The multi-key rank path
(``join_ranks``/``probe``) is not ported.
"""

from __future__ import annotations

import torch

INNER = "inner"
LEFT_OUTER = "leftouter"
RIGHT_OUTER = "rightouter"
FULL_OUTER = "fullouter"
LEFT_SEMI = "leftsemi"
LEFT_ANTI = "leftanti"
CROSS = "cross"


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


def total_pairs(counts):
    """The number of pairs, as a 0-dim tensor on the device (the caller
    syncs it once per stream batch)."""
    return counts.sum()
