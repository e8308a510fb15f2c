"""Row selection and compaction — counterpart of
``spark_rapids_tpu/ops/filtering.py``.

On a GPU scatters are cheap (``runtime/hw.scatters_cheap`` is true off the
TPU), so compaction takes the JAX package's scatter branch: one scatter
builds the front-compaction permutation, then every column rides gathers.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.expr.core import Col


def selection_mask(pred: Col, num_rows: int, capacity: int):
    """Rows kept by a filter: predicate true AND valid AND a live row."""
    live = torch.arange(capacity, device=pred.values.device) < num_rows
    return pred.values & pred.validity & live


def compact_cols(cols, keep_mask):
    """Stable-move surviving rows to the front. Returns (new_cols, count)
    with ``count`` a host int."""
    capacity = keep_mask.shape[0]
    dev = keep_mask.device
    running = torch.cumsum(keep_mask.to(torch.int32), 0, dtype=torch.int32)
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
    hold the canonical default."""
    out = []
    for c in cols:
        vals = c.values[indices]
        validity = c.validity[indices] & valid_out
        default = torch.tensor(c.dtype.default_value(), dtype=vals.dtype,
                               device=vals.device)
        out.append(Col(torch.where(validity, vals, default), validity,
                       c.dtype, c.dictionary))
    return out
