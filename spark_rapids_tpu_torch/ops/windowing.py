"""Segment boundaries — counterpart of ``seg_starts`` and ``seg_ends`` in
``spark_rapids_tpu/ops/windowing.py`` (``:44-64``), the two pieces the
segment reductions of ``ops/grouping.py`` call. Window functions are not
ported yet.

The reference takes one global cummax (cummin) of the marked row indices.
On CUDA, ``torch.cummax``/``cummin`` of one long row runs as a scan with
indices that took 2.6 ms a call on TPC-H q18's batches of 2^20 and 2^21
rows on an H100 (PERF.md), so the port finds the same indices with a
cumsum, one scatter of each boundary's row into its rank and one gather:
the k-th boundary's row is ``pos[k]``, and a row with c boundaries at or
before it starts at ``pos[c - 1]`` and ends before ``pos[c]``. The results
are the reference's, integer for integer.
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
