"""Typed configuration registry — the RapidsConf analog.

Counterpart of ``spark_rapids_tpu/config.py``: the same ``conf(key)`` builder
DSL and the same ``spark.rapids.tpu.*`` key names, with only the entries the
ported path reads. A key the JAX package knows but the port does not read yet
raises ``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import re
import typing

_REGISTERED: "dict[str, ConfEntry]" = {}

_BYTE_SUFFIXES = {
    "b": 1, "k": 1 << 10, "kb": 1 << 10, "m": 1 << 20, "mb": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30, "t": 1 << 40, "tb": 1 << 40,
}


def parse_bytes(v) -> int:
    """Parse '512m', '4g', plain ints — Spark byte-unit strings."""
    if isinstance(v, (int, float)):
        return int(v)
    m = re.fullmatch(r"\s*(\d+)\s*([a-zA-Z]*)\s*", str(v))
    if not m:
        raise ValueError(f"cannot parse byte value {v!r}")
    n, suf = int(m.group(1)), m.group(2).lower()
    if suf and suf not in _BYTE_SUFFIXES:
        raise ValueError(f"unknown byte suffix {suf!r} in {v!r}")
    return n * _BYTE_SUFFIXES.get(suf, 1)


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes")


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    doc: str
    default: typing.Any
    conv: typing.Callable

    def get(self, settings: dict):
        if self.key in settings:
            return self.conv(settings[self.key])
        return self.default


class ConfBuilder:
    """``conf("spark.rapids.tpu.x").doc(...).boolean_conf(default)`` DSL."""

    def __init__(self, key: str):
        self._key = key
        self._doc = ""

    def doc(self, d: str) -> "ConfBuilder":
        self._doc = d
        return self

    def _register(self, default, conv) -> ConfEntry:
        e = ConfEntry(self._key, self._doc, default, conv)
        if e.key in _REGISTERED:
            raise ValueError(f"duplicate conf key {e.key}")
        _REGISTERED[e.key] = e
        return e

    def boolean_conf(self, default: bool) -> ConfEntry:
        return self._register(default, _parse_bool)

    def integer_conf(self, default: int) -> ConfEntry:
        return self._register(default, int)

    def bytes_conf(self, default) -> ConfEntry:
        return self._register(parse_bytes(default), parse_bytes)


def conf(key: str) -> ConfBuilder:
    return ConfBuilder(key)


MAX_READER_BATCH_SIZE_ROWS = conf("spark.rapids.tpu.sql.reader.batchSizeRows").doc(
    "Soft cap on rows per reader batch (reference reader.batchSizeRows)"
).integer_conf(2147483647)

MAX_READER_BATCH_SIZE_BYTES = conf("spark.rapids.tpu.sql.reader.batchSizeBytes").doc(
    "Soft cap on bytes per reader batch (reference reader.batchSizeBytes)"
).bytes_conf("512m")

PARQUET_DEVICE_DECODE = conf(
    "spark.rapids.tpu.sql.parquet.deviceDecode.enabled").doc(
    "Decode dictionary-encoded parquet chunks on the device (bit-unpack "
    "kernel + dictionary gather, ops/parquet_decode.py); out-of-scope chunks "
    "fall back to arrow per column. True on every device, the CPU included, "
    "so the CPU tests walk the same scan path with the kernel's plain "
    "version").boolean_conf(True)

PARQUET_ENCODED_UPLOAD = conf(
    "spark.rapids.tpu.sql.parquet.encodedUpload.enabled").doc(
    "Upload parquet pages encoded and expand them inside the consuming "
    "kernel. Not ported yet: setting it to true raises "
    "NotImplementedError").boolean_conf(False)


class RapidsConf:
    """Resolved view over user settings."""

    def __init__(self, settings: dict | None = None):
        self.settings = dict(settings or {})
        unknown = [k for k in self.settings
                   if k.startswith("spark.rapids.tpu.") and k not in _REGISTERED]
        if unknown:
            raise NotImplementedError(
                f"spark.rapids.tpu confs not ported yet: {unknown}")
        if self.get(PARQUET_ENCODED_UPLOAD):
            raise NotImplementedError(
                f"{PARQUET_ENCODED_UPLOAD.key}=true is not ported yet")

    def get(self, entry: ConfEntry):
        return entry.get(self.settings)
