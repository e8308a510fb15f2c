"""Batch coalescing — counterpart of ``coalesce_iterator`` and
``TargetSize`` in ``spark_rapids_tpu/exec/coalesce.py`` (reference
GpuCoalesceBatches): collect a stream's batches until the target size is
reached, then concatenate them on the device (``ops/concat.py``, which
remaps string columns onto one dictionary). The reference's spill catalog
registration is not ported: pending batches stay on the device.
"""

from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch.ops.concat import concat_batches


@dataclasses.dataclass(frozen=True)
class TargetSize:
    """Flush once the pending batches reach this many device bytes."""
    target_size_bytes: int


def coalesce_iterator(it, goal: TargetSize):
    """Re-batch ``it`` into batches of about ``goal.target_size_bytes``;
    empty batches are dropped."""
    pending: list = []
    pending_bytes = 0
    for batch in it:
        if batch.num_rows == 0:
            continue
        size = batch.device_memory_size()
        if pending and pending_bytes + size > goal.target_size_bytes:
            yield concat_batches(pending)
            pending, pending_bytes = [], 0
        pending.append(batch)
        pending_bytes += size
        if pending_bytes >= goal.target_size_bytes:
            yield concat_batches(pending)
            pending, pending_bytes = [], 0
    if pending:
        yield concat_batches(pending)
