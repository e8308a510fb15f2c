"""Batch coalescing — counterpart of ``coalesce_iterator`` and
``TargetSize`` in ``spark_rapids_tpu/exec/coalesce.py`` (reference
GpuCoalesceBatches): collect a stream's batches until the target size is
reached, then concatenate them on the device (``ops/concat.py``, which
remaps string columns onto one dictionary). The batches waiting for the
concat are registered in the spill catalog at ``ACTIVE_BATCHING_PRIORITY``
under the OOM ladder (``R.register_with_retry``, allocation site
"coalesce.batch"), so a large coalesce spills instead of running the card
out of memory; an over-budget batch splits in half, and the halves concat
back to the same rows.
"""

from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.runtime import memory as mem
from spark_rapids_tpu_torch.runtime import retry as R


@dataclasses.dataclass(frozen=True)
class TargetSize:
    """Flush once the pending batches reach this many device bytes."""
    target_size_bytes: int


def coalesce_iterator(it, goal: TargetSize, conf=None):
    """Re-batch ``it`` into batches of about ``goal.target_size_bytes``;
    empty batches are dropped."""
    pending: list = []
    pending_bytes = 0

    def flush():
        nonlocal pending, pending_bytes
        out = concat_batches([p.get_batch() for p in pending])
        for p in pending:
            p.close()
        pending, pending_bytes = [], 0
        return out

    try:
        for batch in it:
            if batch.num_rows == 0:
                continue
            size = batch.device_memory_size()
            if pending and pending_bytes + size > goal.target_size_bytes:
                yield flush()
            with mem.alloc_site("coalesce.batch"):
                sbs = R.register_with_retry(
                    batch, mem.ACTIVE_BATCHING_PRIORITY, conf=conf)
            for sb in sbs:
                pending.append(sb)
                pending_bytes += sb.size
            if pending_bytes >= goal.target_size_bytes:
                yield flush()
        if pending:
            yield flush()
    finally:
        # a consumer that stops early (a limit) releases what is pending
        for p in pending:
            p.close()
        pending = []


def concat_all_spillable(it, conf=None):
    """Drain ``it`` into one batch (the reference's ``concat_all`` over
    RequireSingleBatch), holding the batches in the spill catalog while
    they accumulate; None when no batch has a row."""
    out = list(coalesce_iterator(it, TargetSize(1 << 62), conf=conf))
    return out[0] if out else None
