"""Static row-count estimates — the port's copy of ``estimate_rows`` from
``spark_rapids_tpu/plan/cbo.py`` (``:26-95``), the one piece of the cost
model the ported planner reads: an inner join builds the side with the
smaller estimate. The estimate must be the reference's, so that the same
side builds in both packages and rows come out in the same order.

A parquet scan counts the rows in its footers (cached on the node, keyed on
the files' mtimes), a range its rows; a filter halves its child, an aggregate divides it by
10, a join takes the larger side, a limit the smaller of its ``n`` and its
child, and any other node its largest child.
"""

from __future__ import annotations

import os

from spark_rapids_tpu_torch.plan import nodes as NN


def estimate_rows(node, _memo: dict | None = None) -> int:
    """Static cardinality estimate, memoized per call tree."""
    if _memo is None:
        _memo = {}
    key = id(node)
    if key not in _memo:
        _memo[key] = _estimate_rows(node, _memo)
    return _memo[key]


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def _scan_rows(node) -> int:
    fp = tuple((p, _mtime(p)) for part in node.partitions for p in part.paths)
    if (getattr(node, "_est_rows", None) is not None
            and getattr(node, "_est_rows_fp", None) == fp):
        return node._est_rows
    total = 0
    for part in node.partitions:
        for p in part.paths:
            try:
                if node.fmt == "parquet":
                    import pyarrow.parquet as pq
                    total += pq.ParquetFile(p).metadata.num_rows
                else:
                    total += max(1, os.path.getsize(p) // 64)
            except Exception:  # noqa: BLE001 — unknown size: assume big
                total += 1 << 20
    node._est_rows, node._est_rows_fp = total, fp
    return total


def _estimate_rows(node, memo) -> int:
    from spark_rapids_tpu_torch.io.filescan import FileScanNode

    def est(n):
        return estimate_rows(n, memo)

    if isinstance(node, FileScanNode):
        return _scan_rows(node)
    if isinstance(node, NN.ScanNode):
        return max(1, sum(t.num_rows for t in node.partitions))
    if isinstance(node, NN.RangeNode):
        return max(0, -(-(node.end - node.start) // node.step))
    if isinstance(node, NN.FilterNode):
        return max(1, est(node.child) // 2)   # selectivity 0.5
    if isinstance(node, NN.AggregateNode):
        return max(1, est(node.child) // 10)  # grouping factor
    if isinstance(node, NN.JoinNode):
        return max(est(node.left), est(node.right))
    if isinstance(node, NN.LimitNode):
        return min(node.n, est(node.child))
    if node.children:
        return max(est(c) for c in node.children)
    return 1 << 20
