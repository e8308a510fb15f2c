"""Multi-key sort with Spark ordering semantics — counterpart of
``spark_rapids_tpu/ops/sorting.py`` (``sort_permutation`` over
``_key_arrays``).

Spark ordering rules: per-key ASC/DESC with NULLS FIRST/LAST; floats: NaN is
greater than every value and equal to itself, -0.0 == 0.0; strings sort by
dictionary code (the dictionary is sorted). Padding rows carry a leading
pad-rank key so they always sink to the end.

torch has no multi-operand sort, so the lexicographic order comes from stable
sorts applied from the least significant operand to the most significant one.
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


def sort_permutation(key_cols, orders, num_rows: int, capacity: int):
    """Stable permutation (int64) sorting live rows by keys; padding sinks
    to the end."""
    dev = key_cols[0].values.device if key_cols else None
    pad_rank = (torch.arange(capacity, device=dev) >= num_rows).to(torch.int8)
    operands = [pad_rank]
    for c, o in zip(key_cols, orders):
        operands.extend(_key_arrays(c, o))
    perm = torch.arange(capacity, dtype=torch.int64, device=dev)
    for op in reversed(operands):
        step = torch.sort(op[perm], stable=True).indices
        perm = perm[step]
    return perm
