"""The shuffle transport — counterpart of
``spark_rapids_tpu/shuffle/transport.py``. Only its error type is ported:
the exchange's recompute ladder (``exec/exchange.py``) raises it when a
reduce partition's blocks are lost after rows were emitted, or when the
ladder is spent. The TCP transport itself, its client and server, the
block-frame checksums and the fetch ladder wait for the cluster slice
(with ``shuffle/fetch.py``, ``heartbeat.py`` and ``compression.py``)."""

from __future__ import annotations


class TransportError(RuntimeError):
    """A shuffle fetch failed (reference RapidsShuffleFetchFailedException
    analog): the reduce side's blocks could not be read. ``retryable``
    marks a resubmission safe: the recompute ladder already ran."""

    retryable = True
