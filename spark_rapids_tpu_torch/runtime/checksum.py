"""Block checksums for spill files — counterpart of
``spark_rapids_tpu/runtime/checksum.py``.

Spark stamps shuffle blocks with checksums (SPARK-35275) so that a
corrupted block is a fetch failure (recompute), not a decode crash deep in
an operator. The buffer catalog stamps disk-tier spill payloads and
verifies them on unspill (runtime/memory.py); a mismatch takes the
exchange's fetch-failure → recompute ladder (exec/exchange.py).

CRC32C (Castagnoli) through the ``crc32c`` package when it is installed,
else zlib's CRC32: either detects corruption within one process, and the
algorithm's name travels in ``CHECKSUM_ALGO``.
"""

from __future__ import annotations

import zlib

try:
    import crc32c as _crc32c_mod
    CHECKSUM_ALGO = "crc32c"

    def block_checksum(data, value: int = 0) -> int:
        """CRC of `data` (bytes-like), optionally chained from `value`."""
        return _crc32c_mod.crc32c(data, value)
except ImportError:                      # no crc32c wheel in the image
    CHECKSUM_ALGO = "crc32"

    def block_checksum(data, value: int = 0) -> int:
        """CRC of `data` (bytes-like), optionally chained from `value`."""
        return zlib.crc32(data, value) & 0xFFFFFFFF
