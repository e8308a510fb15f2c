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

    def double_conf(self, default: float) -> ConfEntry:
        return self._register(default, float)

    def bytes_conf(self, default) -> ConfEntry:
        return self._register(parse_bytes(default), parse_bytes)

    def string_conf(self, default) -> ConfEntry:
        return self._register(default, lambda v: v if v is None else str(v))


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
    "version. False sends every partition through the arrow reader "
    "(io/readers.py)").boolean_conf(True)

PARQUET_READER_TYPE = conf("spark.rapids.tpu.sql.format.parquet.reader.type").doc(
    "PERFILE | MULTITHREADED | COALESCING: the arrow reader's strategy for "
    "the partitions the device decode does not take (reference "
    "GpuParquetScan.scala:317,426 reader strategies)").string_conf(
    "MULTITHREADED")

MULTITHREADED_READ_NUM_THREADS = conf(
    "spark.rapids.tpu.sql.format.parquet.multiThreadedRead.numThreads").doc(
    "Thread pool size for the multithreaded reader (reference "
    "multiThreadedRead.numThreads)").integer_conf(20)

PARQUET_REBASE_MODE = conf(
    "spark.rapids.tpu.sql.parquet.datetimeRebaseModeInRead").doc(
    "EXCEPTION | CORRECTED | LEGACY for dates before 1582-10-15 in parquet "
    "files read by the arrow reader (Spark "
    "spark.sql.parquet.datetimeRebaseModeInRead; LEGACY applies the "
    "Julian->proleptic-Gregorian rebase, "
    "io/readers.rebase_julian_to_gregorian_days)").string_conf("EXCEPTION")

ALLUXIO_PATHS_REPLACE = conf(
    "spark.rapids.tpu.alluxio.pathsToReplace").doc(
    "Path-prefix rewrites of every file scan, 'from->to' rules separated "
    "by ';', the first matching prefix rewritten (reference "
    "spark.rapids.alluxio.pathsToReplace, io/filescan.rewrite_scan_path). "
    "A rule without '->' raises ValueError").string_conf(None)

PARQUET_ENCODED_UPLOAD = conf(
    "spark.rapids.tpu.sql.parquet.encodedUpload.enabled").doc(
    "Upload parquet dictionary chunks encoded and decode them on the "
    "device at their first consumer. Accepted for the reference's "
    "configurations and satisfied either way: the port's device decode "
    "always uploads a chunk packed and decodes it with one chunk_decode "
    "launch at its first read (columnar/encoded.py), so true and false take "
    "the same route").boolean_conf(True)

BATCH_SIZE_BYTES = conf("spark.rapids.tpu.sql.batchSizeBytes").doc(
    "Target size of output batches from coalescing, such as the batches a "
    "shuffle reader assembles (reference spark.rapids.sql.batchSizeBytes)"
).bytes_conf("512m")

SHUFFLE_MANAGER_ENABLED = conf("spark.rapids.tpu.shuffle.enabled").doc(
    "Keep shuffle blocks on the device as spillable catalog buffers "
    "(shuffle/manager.py). False takes the serializing shuffle: each block "
    "is written to the host as a serialized frame "
    "(shuffle/serialization.py) and read back to the device").boolean_conf(
    True)

SHUFFLE_FETCH_MAX_RETRIES = conf("spark.rapids.tpu.shuffle.fetch.maxRetries").doc(
    "Fetch failures tolerated per reduce partition before the query fails; "
    "each failure invalidates the map outputs and recomputes them (reference "
    "TransferError -> FetchFailedException -> stage retry, "
    "RapidsShuffleIterator.scala:82)").integer_conf(2)

CONCURRENT_TPU_TASKS = conf("spark.rapids.tpu.sql.concurrentTpuTasks").doc(
    "Tasks admitted to the device concurrently via the semaphore "
    "(reference spark.rapids.sql.concurrentGpuTasks, RapidsConf.scala:398)"
).integer_conf(2)

DEVICE_MEMORY_FRACTION = conf("spark.rapids.tpu.memory.hbm.allocFraction").doc(
    "Fraction of device memory the pool budget may use "
    "(reference spark.rapids.memory.gpu.allocFraction)").double_conf(0.9)

DEVICE_MEMORY_LIMIT = conf("spark.rapids.tpu.memory.hbm.limitBytes").doc(
    "Absolute device memory budget override; 0 = derive from allocFraction"
).bytes_conf(0)

HOST_SPILL_STORAGE_SIZE = conf(
    "spark.rapids.tpu.memory.host.spillStorageSize").doc(
    "Bytes of host memory used for spilled device buffers before disk "
    "(reference spark.rapids.memory.host.spillStorageSize)").bytes_conf("1g")

SPILL_DIRS = conf("spark.rapids.tpu.memory.spill.dirs").doc(
    "Comma-separated local dirs for the disk spill tier "
    "(reference uses Spark local dirs, RapidsDiskStore.scala)").string_conf(
    None)

DIRECT_SPILL_ENABLED = conf(
    "spark.rapids.tpu.memory.direct.storage.spill.enabled").doc(
    "Spill the disk tier through the batched aligned direct-I/O store "
    "(O_DIRECT; the GDS analog — reference "
    "spark.rapids.memory.gpu.direct.storage.spill.enabled, RapidsGdsStore)"
).boolean_conf(False)

DIRECT_SPILL_BATCH_BYTES = conf(
    "spark.rapids.tpu.memory.direct.storage.spill.batchWriteBufferSize").doc(
    "Size at which a direct-spill batch file rotates (reference GDS "
    "batchWriteBufferSize)").bytes_conf("64m")

STRICT_DEVICE_BUDGET = conf("spark.rapids.tpu.memory.hbm.strictBudget").doc(
    "When a registration cannot spill the device tier back under the "
    "budget, raise a retryable DeviceOomError (the DeviceMemoryEventHandler "
    "OOM analog) so the task-scoped retry framework (runtime/retry.py) can "
    "spill, split the input batch and re-run. false restores the lenient "
    "accounting that silently leaves the device tier over budget"
).boolean_conf(True)

RETRY_MAX_SPLITS = conf("spark.rapids.tpu.memory.retry.maxSplits").doc(
    "Times one input batch may be split in half by OOM split-and-retry "
    "before the error is re-raised (reference RmmRapidsRetryIterator's "
    "splitSpillableInHalfByRows ladder)").integer_conf(8)

RETRY_SPLIT_FLOOR_BYTES = conf(
    "spark.rapids.tpu.memory.retry.splitFloorBytes").doc(
    "Split-and-retry never produces a batch smaller than this (nor below 2 "
    "rows); at the floor one spill-only retry runs and then the OOM "
    "propagates").bytes_conf("64k")

TEST_FAULTS = conf("spark.rapids.tpu.test.faults").doc(
    "Deterministic fault-injection spec 'kind:site:trigger,...' — kinds "
    "oom / splitoom / error / slow / corrupt / leak / disk_full (the "
    "reference's transport / exec_kill / hang / cancel raise "
    "NotImplementedError); trigger COUNT, COUNT@SKIP or pPROB; e.g. "
    "'splitoom:exchange.map:2,oom:agg.merge:1' (grammar + site list in "
    "runtime/faults.py). Chaos testing only — never set in production; "
    "empty disables").string_conf(None)

TEST_FAULTS_SEED = conf("spark.rapids.tpu.test.faults.seed").doc(
    "Seed for probabilistic (pPROB) fault triggers; each (kind, site) "
    "entry draws from its own stream seeded by (seed, kind, site), so one "
    "seed yields one deterministic schedule per site even under the "
    "pipeline's worker-thread interleavings").integer_conf(0)

UNSPILL_ENABLED = conf("spark.rapids.tpu.memory.hbm.unspill.enabled").doc(
    "Re-promote spilled buffers back to device memory on access "
    "(reference spark.rapids.memory.gpu.unspill.enabled)").boolean_conf(False)

SPILL_CHECKSUM = conf("spark.rapids.tpu.memory.spill.checksum.enabled").doc(
    "Stamp disk-tier spill payloads with a CRC32C checksum and verify on "
    "unspill; a mismatch raises SpillCorruptionError, which shuffle readers "
    "treat as a fetch failure (map-stage recompute) instead of decoding "
    "silently corrupt rows").boolean_conf(True)

OOM_DUMP_DIR = conf("spark.rapids.tpu.memory.hbm.oomDumpDir").doc(
    "Directory to write allocator state on device OOM "
    "(reference spark.rapids.memory.gpu.oomDumpDir)").string_conf(None)

MEMORY_LEAK_CHECK = conf("spark.rapids.tpu.memory.leak.check").doc(
    "End-of-query leak detection: after an action drains, any catalog "
    "buffer still registered by the finished query is reported and "
    "reclaimed (runtime/memory.BufferCatalog.finish_query). false disables "
    "(the buffers then linger until process exit)").boolean_conf(True)

MEMORY_LEAK_STRICT = conf("spark.rapids.tpu.memory.leak.strict").doc(
    "Escalate a detected end-of-query leak into a MemoryLeakError after "
    "the reclaim, so test suites fail loudly on any leak instead of "
    "logging it (chaos specs use the 'leak' fault kind to prove the "
    "detector end to end)").boolean_conf(False)

PIPELINE_ENABLED = conf("spark.rapids.tpu.pipeline.enabled").doc(
    "Run each plan segment's batch loop on its own worker thread at the "
    "pipeline breakers (scan, exchange map/reduce, join build, sort, final "
    "collect), connected by bounded byte-budgeted queues, so host decode, "
    "device compute and exchange I/O overlap (runtime/pipeline.py). Every "
    "producer enqueues on the consumer's CUDA stream. Results are "
    "bit-identical either way").boolean_conf(True)

PIPELINE_QUEUE_DEPTH = conf("spark.rapids.tpu.pipeline.queueDepth").doc(
    "Batches one pipeline queue edge may hold ahead of its consumer; 2 is "
    "classic double buffering (batch N resident while N+1 decodes/uploads)"
).integer_conf(2)

PIPELINE_MAX_QUEUE_BYTES = conf("spark.rapids.tpu.pipeline.maxQueueBytes").doc(
    "Byte cap per pipeline queue edge; the effective budget also shrinks "
    "to the spill catalog's free host headroom "
    "(runtime/memory.host_prefetch_budget) and queued device batches are "
    "registered as spillable so the OOM-retry ladder can steal them"
).bytes_conf("256m")

NUM_LOCAL_TASKS = conf("spark.rapids.tpu.sql.localScheduler.numThreads").doc(
    "Threads that run an exchange's map tasks, one input partition each "
    "(stands in for Spark executor task slots)").integer_conf(4)

# the default is the reference's default shim's (AQE on since Spark 3.2)
ADAPTIVE_COALESCE_ENABLED = conf(
    "spark.rapids.tpu.sql.adaptive.coalescePartitions.enabled").doc(
    "After a shuffle map stage materializes, merge contiguous small reduce "
    "partitions into advisory-sized reader partitions (AQE; reference "
    "GpuCustomShuffleReaderExec + Spark CoalesceShufflePartitions)"
).boolean_conf(True)

ADVISORY_PARTITION_BYTES = conf(
    "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes").doc(
    "Target size of a coalesced post-shuffle partition "
    "(Spark spark.sql.adaptive.advisoryPartitionSizeInBytes)").bytes_conf("64m")

PARQUET_WRITER_TYPE = conf("spark.rapids.tpu.sql.format.parquet.writer.type").doc(
    "NATIVE encodes Parquet pages from device columns (null compaction, "
    "null count and min/max on the device, thrift framing on the host, "
    "io/parquet_write_native.py); ARROW writes each batch through host "
    "pyarrow. A partitioned write takes the arrow writer either way; a "
    "native encoder's failure raises").string_conf("NATIVE")

ORC_WRITER_TYPE = conf("spark.rapids.tpu.sql.format.orc.writer.type").doc(
    "NATIVE encodes ORC stripes from device columns (the device prep of the "
    "parquet writer, RLEv2/protobuf framing on the host, "
    "io/orc_write_native.py); ARROW writes through host pyarrow. A "
    "partitioned write takes the arrow writer either way").string_conf(
    "NATIVE")

CSV_WRITER_TYPE = conf("spark.rapids.tpu.sql.format.csv.writer.type").doc(
    "NATIVE formats CSV text from one transfer per device column "
    "(io/csv_write_native.py); ARROW writes through host pyarrow"
).string_conf("NATIVE")

CSV_ENABLED = conf("spark.rapids.tpu.sql.format.csv.enabled").doc(
    "Plan CSV scans (reference spark.rapids.sql.format.csv.enabled). The "
    "port has no host plan, so a CSV scan with this false raises "
    "NotImplementedError when the plan is built").boolean_conf(True)

ORC_ENABLED = conf("spark.rapids.tpu.sql.format.orc.enabled").doc(
    "Plan ORC scans (reference spark.rapids.sql.format.orc.enabled). The "
    "port has no host plan, so an ORC scan with this false raises "
    "NotImplementedError when the plan is built").boolean_conf(True)

ORC_DEVICE_DECODE = conf("spark.rapids.tpu.sql.orc.deviceDecode.enabled").doc(
    "Decode in-scope ORC stripes on the device (protobuf and RLEv2 run "
    "headers on the host, the packed bits unpacked on the device, "
    "io/orc_native.py); out-of-scope files go through the arrow reader "
    "whole, out-of-scope columns column by column. Taken on a CUDA device; "
    "on the CPU only when the key is set explicitly").boolean_conf(True)

CSV_DEVICE_DECODE = conf("spark.rapids.tpu.sql.csv.deviceDecode.enabled").doc(
    "Parse in-scope CSV files on the device (a host boundary scan, the "
    "digits turned into numbers on the device, io/csv_native.py); "
    "out-of-scope files go through the arrow reader. Taken on a CUDA "
    "device; on the CPU only when the key is set explicitly"
).boolean_conf(True)

CSV_READ_FLOATS = conf("spark.rapids.tpu.sql.csv.read.float.enabled").doc(
    "Allow double CSV columns on the device parse; its last division by a "
    "power of ten can differ from strtod by 1 ulp (reference "
    "spark.rapids.sql.csv.read.float.enabled, same default)"
).boolean_conf(False)

STAGE_FUSION_ENABLED = conf("spark.rapids.tpu.sql.stageFusion.enabled").doc(
    "Whole-stage fusion switch. The port fuses no programs; of what the key "
    "governs it reads these: the sort-based group-by's per-batch key probe "
    "(skip the sort when the live rows arrive sorted by their one 64-bit "
    "key with no null, else pack the key as value - min when its range "
    "fits), the right-sizing of an aggregate's partial at its group count, "
    "the HAVING filter folded into the aggregate's finalize, the hoist of "
    "a bare stream-side projection into an inner broadcast hash join (a "
    "stream-side filter, or a projection over one, is hoisted either way), "
    "the probe chain of stacked inner single-key broadcast hash joins and "
    "the group-by chain below. False turns all of them "
    "off").boolean_conf(True)

SCAN_FUSION_ENABLED = conf("spark.rapids.tpu.sql.stageFusion.scan.enabled").doc(
    "Fuse the parquet decode into the consuming aggregate's update. "
    "Accepted for the reference's configurations and satisfied either way: "
    "an encoded chunk is decoded at its first read by whichever consumer "
    "reads it first, the aggregate's update included "
    "(columnar/encoded.py)").boolean_conf(True)

GROUPBY_CHAIN_ENABLED = conf(
    "spark.rapids.tpu.sql.stageFusion.groupBy.chain.enabled").doc(
    "Chain the aggregation's per-batch update -> concat -> merge step with "
    "a predicted output capacity: one host sync per batch in place of the "
    "unchained loop's group counts and probes. A mispredicted capacity "
    "discards the chained result and reruns the batch unchained. Batches "
    "below a capacity of 1024 go unchained. Requires stageFusion.enabled"
).boolean_conf(True)


class RapidsConf:
    """Resolved view over user settings."""

    def __init__(self, settings: dict | None = None):
        self.settings = dict(settings or {})
        unknown = [k for k in self.settings
                   if k.startswith("spark.rapids.tpu.") and k not in _REGISTERED]
        if unknown:
            raise NotImplementedError(
                f"spark.rapids.tpu confs not ported yet: {unknown}")

    def get(self, entry: ConfEntry):
        return entry.get(self.settings)
