"""Row selection and compaction — counterpart of
``spark_rapids_tpu/ops/filtering.py``.

On a GPU scatters are cheap (``runtime/hw.scatters_cheap`` is true off the
TPU), so compaction takes the JAX package's scatter branch: one scatter
builds the front-compaction permutation, then every column rides gathers.
``maybe_host_resize`` and ``slice_to_capacity`` are the stage-boundary
right-sizing: a front-compacted result moves on at the capacity bucket of
its row count.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.expr.core import Col


def selection_mask(pred: Col, num_rows: int, capacity: int):
    """Rows kept by a filter: predicate true AND valid AND a live row."""
    live = torch.arange(capacity, device=pred.values.device) < num_rows
    return pred.values & pred.validity & live


def compact_cols(cols, keep_mask, sync: bool = True):
    """Stable-move surviving rows to the front. Returns (new_cols, count)
    with ``count`` a host int, or with ``sync`` false a 0-d device tensor
    (no host sync; a nested column still syncs in its gather)."""
    capacity = keep_mask.shape[0]
    dev = keep_mask.device
    running = torch.cumsum(keep_mask.to(torch.int32), 0, dtype=torch.int32)
    if not sync:
        count = running[-1]
    else:
        count = int(running[-1]) if capacity else 0
    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    dest = torch.where(keep_mask, running.long() - 1,
                       torch.full_like(j, capacity))
    perm = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    perm.scatter_(0, dest, j)
    perm = perm[:capacity]
    live = j < count
    return gather_cols(cols, perm, live), count


def gather_cols(cols, indices, valid_out):
    """Gather rows by index; ``valid_out`` masks output slots, which then
    hold the canonical default. A nested column goes to
    ``ops/nested.gather``."""
    out = []
    for c in cols:
        if c.nested is not None:
            from spark_rapids_tpu_torch.ops import nested as N
            out.append(Col.from_vector(N.gather(c.nested, indices,
                                                valid_out)))
            continue
        vals = c.values[indices]
        validity = c.validity[indices] & valid_out
        default = torch.tensor(c.dtype.default_value(), dtype=vals.dtype,
                               device=vals.device)
        out.append(Col(torch.where(validity, vals, default), validity,
                       c.dtype, c.dictionary))
    return out


def slice_to_capacity(cols, count: int, capacity: int):
    """Front-compacted columns (``count`` live rows first, the rest padding)
    at ``capacity`` slots (a nested column through ``ops/nested.take_rows``)."""
    out = []
    for c in cols:
        if c.nested is not None:
            from spark_rapids_tpu_torch.ops import nested as N
            out.append(Col.from_vector(N.take_rows(c.nested, 0, count,
                                                   capacity)))
            continue
        n = c.values.shape[0]
        if capacity <= n:
            vals, validity = c.values[:capacity], c.validity[:capacity]
        else:
            vals = torch.full((capacity,), c.dtype.default_value(),
                              dtype=c.values.dtype, device=c.values.device)
            validity = torch.zeros((capacity,), dtype=torch.bool,
                                   device=c.values.device)
            vals[:n], validity[:n] = c.values, c.validity
        out.append(Col(vals, validity, c.dtype, c.dictionary))
    return out


def maybe_host_resize(cols, count: int, min_shrink: int = 4,
                      min_capacity: int = 1 << 16):
    """Front-compacted columns (the ``compact_cols`` contract) re-landed at
    ``bucket_capacity(count)``: ``(cols, count)``, or None when the input
    capacity is below ``min_capacity`` or the shrink is under
    ``min_shrink`` (reference ``ops/filtering.maybe_host_resize``). A high-
    reduction stage then stops dragging its input capacity into the
    operators downstream. ``count`` is already a host int, so this syncs
    nothing."""
    capacity = int(cols[0].values.shape[0]) if cols else 0
    if capacity < min_capacity:
        return None
    out_cap = bucket_capacity(count)
    if out_cap * min_shrink > capacity:
        return None
    return slice_to_capacity(cols, count, out_cap), count
