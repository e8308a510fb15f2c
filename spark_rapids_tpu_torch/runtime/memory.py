"""The device memory runtime — counterpart of
``spark_rapids_tpu/runtime/memory.py``: the device budget, the tiered spill
stores and spillable batches.

Reference: GpuDeviceManager (device and pool), RapidsBufferCatalog /
RapidsBufferStore (a catalog keyed by buffer id over chained tiers device →
host → disk, with ``synchronousSpill``), DeviceMemoryEventHandler (an
allocation failure triggers a spill), SpillableColumnarBatch and
SpillPriorities.

The budget is enforced when a batch is registered: every batch in the
catalog counts against the device budget at its capacity-padded size
(``ColumnarBatch.device_memory_size()``, as the reference counts it, not
what the caching allocator holds), and a registration spills
lower-priority buffers synchronously until the new one fits. The tiers are
the device (torch tensors), the host (numpy arrays) and disk files under
``spark.rapids.tpu.memory.spill.dirs``.

The reference's host image knows flat columns only. The port's extension
of the same tiers takes every column kind the port has: flat columns
(strings keep their host dictionary; decimals, bytes, shorts, floats and
timestamps their buffers), ``ListVector``/``MapVector``/``StructVector``
to any depth, and ``EncodedColumnVector``: a chunk still encoded keeps its
packed buffer on the host and comes back encoded (so it is decoded once,
at its first read, wherever it lives); a decoded one spills its dense
arrays.

Not ported yet: the heap profiler (``_maybe_sample``, ``heap_snapshot``,
``query_memory``, ``set_profile_options``), the event-log and tracing
records, and the multi-tenant scheduler's per-query demotion.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import itertools
import os
import pickle
import tempfile
import threading
import typing

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ListVector, MapVector,
                                                    StructVector,
                                                    TorchColumnVector)
from spark_rapids_tpu_torch.runtime import faults as F
from spark_rapids_tpu_torch.runtime.arm import LeakTracker
from spark_rapids_tpu_torch.runtime.retry import (DeviceOomError,
                                                  SpillCapacityError)

# -- spill priorities (reference SpillPriorities.scala:26) ---------------------
# Lower value spills FIRST.
OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY = -1000.0   # shuffle output: spill early
ACTIVE_ON_DECK_PRIORITY = 100.0                 # batches queued for processing
# batches an operator is actively coalescing or probing spill LAST
ACTIVE_BATCHING_PRIORITY = 200.0

#: the reference's device size when the backend reports none (one v5e's
#: HBM); the CPU takes it too, so that both packages' CPU tests compare
#: equal budgets
CPU_DEVICE_BYTES = 16 << 30


class TierEnum:
    DEVICE = "DEVICE"
    HOST = "HOST"
    DISK = "DISK"


# -- allocation sites and query tags ------------------------------------------
# Every catalogued buffer carries the subsystem that registered it
# ("exchange.block", "pipeline.queue", ...): an explicit alloc_site() block
# first, then the fault-injection scope (every retry attempt runs in one),
# then the unattributed bucket. The OOM dump and the leak report name it.

UNATTRIBUTED_SITE = "catalog.add_batch"

_alloc_tls = threading.local()
_query_tls = threading.local()


@contextlib.contextmanager
def alloc_site(site: str, retained: bool = False):
    """Tag catalog registrations inside the block with allocation site
    `site`; ``retained=True`` exempts them from the end-of-query leak
    check."""
    prev = getattr(_alloc_tls, "site", None)
    _alloc_tls.site = (site, retained)
    try:
        yield
    finally:
        _alloc_tls.site = prev


def current_alloc_site() -> "tuple[str, bool]":
    """(site, retained) for a registration happening now on this thread."""
    v = getattr(_alloc_tls, "site", None)
    if v is not None:
        return v
    s = F.current_scope()
    if s:
        return s, False
    return UNATTRIBUTED_SITE, False


@contextlib.contextmanager
def query_context(query_id):
    """Tag registrations on this thread with the action ``query_id`` (the
    reference re-enters its metrics collector on every worker thread for
    the same purpose); the threads an action starts re-enter it."""
    prev = getattr(_query_tls, "query", None)
    _query_tls.query = query_id
    try:
        yield
    finally:
        _query_tls.query = prev


def current_query():
    return getattr(_query_tls, "query", None)


class MemoryLeakError(RuntimeError):
    """The end-of-query leak check found buffers still registered by a
    finished query and ``memory.leak.strict`` is on."""


class BufferClosedError(RuntimeError):
    """A spillable buffer was acquired after close()/remove()."""


class SpillCorruptionError(RuntimeError):
    """A disk-tier spill payload failed its CRC on unspill
    (memory.spill.checksum.enabled). Shuffle readers take it as a fetch
    failure — invalidate the map outputs and recompute — instead of
    decoding corrupt rows."""

    retryable = True


# -- the host images of device columns ----------------------------------------

@dataclasses.dataclass
class HostColumn:
    """Host image of one flat TorchColumnVector (RapidsHostColumnVector)."""
    dtype: T.DataType
    data: np.ndarray
    validity: np.ndarray
    dictionary: typing.Any  # pyarrow StringArray or None

    def nbytes(self) -> int:
        out = self.data.nbytes + self.validity.nbytes
        if self.dictionary is not None:
            out += self.dictionary.nbytes
        return out


@dataclasses.dataclass
class HostListColumn:
    """Host image of a ListVector (a MapVector when ``values`` is set)."""
    dtype: T.DataType
    lengths: np.ndarray
    validity: np.ndarray
    flat: typing.Any
    total: int
    offsets: typing.Any
    values: typing.Any = None

    def nbytes(self) -> int:
        out = self.lengths.nbytes + self.validity.nbytes + self.flat.nbytes()
        if self.values is not None:
            out += self.values.nbytes()
        return out


@dataclasses.dataclass
class HostStructColumn:
    dtype: T.DataType
    fields: list
    validity: np.ndarray

    def nbytes(self) -> int:
        return self.validity.nbytes + sum(f.nbytes() for f in self.fields)


@dataclasses.dataclass
class HostEncodedColumn:
    """Host image of a still-encoded EncodedColumnVector: its packed buffer
    and where each of the decode's arguments lies in it (byte offset,
    byte length, dtype, shape)."""
    dtype: T.DataType
    buf: np.ndarray
    views: dict
    n_rows: int
    capacity: int
    want: torch.dtype
    default: typing.Any
    dictionary: typing.Any

    def nbytes(self) -> int:
        return self.buf.nbytes + (self.dictionary.nbytes
                                  if self.dictionary is not None else 0)


@dataclasses.dataclass
class HostBatch:
    columns: list
    num_rows: int
    schema: typing.Any
    metadata: typing.Any = None   # scan provenance (input_file_name family)
    device: typing.Any = None

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _encoded_to_host(v) -> HostEncodedColumn:
    e = v._enc
    buf = e.buf
    base = buf.data_ptr()
    views = {}
    for name in ("words", "table", "defs", "dictionary"):
        t = getattr(e, name)
        if t is None:
            views[name] = None
            continue
        off = t.data_ptr() - base
        nb = t.numel() * t.element_size()
        if not (t.is_contiguous() and 0 <= off
                and off + nb <= buf.numel() * buf.element_size()):
            raise ValueError(f"encoded chunk's {name} is not a view of its "
                             "packed buffer")
        views[name] = (off, nb, t.dtype, tuple(t.shape))
    return HostEncodedColumn(v.dtype, _np(buf), views, e.n_rows, e.capacity,
                             e.want, e.default, v.dictionary)


def vector_to_host(v: TorchColumnVector):
    """The host image of one device column of any kind."""
    from spark_rapids_tpu_torch.columnar.encoded import EncodedColumnVector
    if isinstance(v, EncodedColumnVector):
        if v._mat is None:
            return _encoded_to_host(v)
        return HostColumn(v.dtype, _np(v.data), _np(v.validity),
                          v.dictionary)
    if isinstance(v, MapVector):
        return HostListColumn(v.dtype, _np(v.data), _np(v.validity),
                              vector_to_host(v.flat), v.total, v._offsets,
                              vector_to_host(v.values))
    if isinstance(v, ListVector):
        return HostListColumn(v.dtype, _np(v.data), _np(v.validity),
                              vector_to_host(v.flat), v.total, v._offsets)
    if isinstance(v, StructVector):
        return HostStructColumn(v.dtype, [vector_to_host(f)
                                          for f in v.fields],
                                _np(v.validity))
    return HostColumn(v.dtype, _np(v.data), _np(v.validity), v.dictionary)


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def host_to_vector(h, device) -> TorchColumnVector:
    """The device column of a host image (``vector_to_host``'s inverse)."""
    if isinstance(h, HostEncodedColumn):
        from spark_rapids_tpu_torch.columnar import encoded as EN
        buf = _to_dev(h.buf, device)
        raw = buf.view(torch.uint8)
        args = {}
        for name, spec in h.views.items():
            if spec is None:
                args[name] = None
                continue
            off, nb, dt, shape = spec
            args[name] = raw[off:off + nb].view(dt).reshape(shape)
        return EN.EncodedColumnVector(h.dtype, EN.EncodedChunk(
            buf, args["words"], args["table"], args["defs"],
            args["dictionary"], h.n_rows, h.capacity, h.want, h.default),
            h.dictionary)
    if isinstance(h, HostListColumn):
        flat = host_to_vector(h.flat, device)
        if h.values is not None:
            return MapVector(h.dtype, _to_dev(h.lengths, device),
                             _to_dev(h.validity, device), flat,
                             host_to_vector(h.values, device), h.total,
                             h.offsets)
        return ListVector(h.dtype, _to_dev(h.lengths, device),
                          _to_dev(h.validity, device), flat, h.total,
                          h.offsets)
    if isinstance(h, HostStructColumn):
        return StructVector(h.dtype, [host_to_vector(f, device)
                                      for f in h.fields],
                            _to_dev(h.validity, device))
    return TorchColumnVector(h.dtype, _to_dev(h.data, device),
                             _to_dev(h.validity, device), h.dictionary)


def batch_device(batch: ColumnarBatch):
    for c in batch.columns:
        enc = getattr(c, "_enc", None)
        if enc is not None and getattr(c, "_mat", None) is None:
            return enc.buf.device
        return c.data.device
    return None


def batch_to_host(batch: ColumnarBatch) -> HostBatch:
    return HostBatch([vector_to_host(c) for c in batch.columns],
                     batch.num_rows, batch.schema, batch.metadata,
                     batch_device(batch))


def host_to_batch(hb: HostBatch) -> ColumnarBatch:
    dev = hb.device if hb.device is not None else torch.device("cpu")
    return ColumnarBatch([host_to_vector(c, dev) for c in hb.columns],
                         hb.num_rows, hb.schema, metadata=hb.metadata)


class RapidsBuffer:
    """One catalogued buffer; knows which tier holds it
    (reference RapidsBufferStore.RapidsBufferBase)."""

    __slots__ = ("buffer_id", "tier", "priority", "size", "_device", "_host",
                 "_path", "_handle", "spill_callback", "query", "_crc",
                 "site", "retained", "_disk_len")

    def __init__(self, buffer_id: int, batch: ColumnarBatch, priority: float,
                 spill_callback=None, query=None,
                 site: str = UNATTRIBUTED_SITE, retained: bool = False):
        self.buffer_id = buffer_id
        self.tier = TierEnum.DEVICE
        self.priority = priority
        self.size = batch.device_memory_size()
        self._device: ColumnarBatch | None = batch
        self._host: HostBatch | None = None
        self._path: str | None = None
        self._handle = None          # (file, offset, len) in the direct store
        self.spill_callback = spill_callback
        self.query = query
        self._crc = None             # disk-tier payload checksum
        self.site = site
        self.retained = retained
        self._disk_len = 0           # bytes held in the disk tier


class BufferCatalog:
    """Tiered buffer catalog with budget-driven spill (reference
    RapidsBufferCatalog + RapidsBufferStore.synchronousSpill +
    DeviceMemoryEventHandler): the device tier's budget check runs at
    registration."""

    def __init__(self, device_budget: int, host_budget: int,
                 spill_dir: str | None = None, unspill: bool = False,
                 oom_dump_dir: str | None = None, direct_spill: bool = False,
                 direct_batch_bytes: int = 64 << 20,
                 strict_budget: bool = True, spill_checksum: bool = True):
        self.device_budget = device_budget
        self.host_budget = host_budget
        self._spill_checksum = spill_checksum
        # strict: a registration that cannot spill back under budget raises
        # a retryable DeviceOomError instead of leaving the tier over budget
        self._strict = strict_budget
        self._spill_dir = spill_dir
        self._unspill = unspill
        self._oom_dump_dir = oom_dump_dir
        self._direct_spill = direct_spill
        self._direct_batch_bytes = direct_batch_bytes
        self._direct_store = None
        self._lock = threading.RLock()
        self._buffers: dict[int, RapidsBuffer] = {}
        self._ids = itertools.count(1)
        self.device_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        #: the device tier's high-water mark of registered bytes
        self.watermark_bytes = 0
        # reference GpuMetric spill counters, plus the unspill traffic
        self.spilled_to_host_bytes = 0
        self.spilled_to_disk_bytes = 0
        self.spilled_to_host_buffers = 0
        self.spilled_to_disk_buffers = 0
        self.read_from_host_buffers = 0
        self.read_from_disk_buffers = 0

    # -- registration --------------------------------------------------------
    def add_batch(self, batch: ColumnarBatch,
                  priority: float = ACTIVE_ON_DECK_PRIORITY,
                  spill_callback=None) -> int:
        # fault-injection checkpoint: the ambient operator scope
        # ("joins.build" ...) or the bare registration site
        F.maybe_inject("oom", F.current_scope() or "catalog.add_batch")
        site, retained = current_alloc_site()
        with self._lock:
            bid = next(self._ids)
            buf = RapidsBuffer(bid, batch, priority, spill_callback,
                               query=current_query(), site=site,
                               retained=retained)
            self._buffers[bid] = buf
            self.device_bytes += buf.size
            try:
                self._ensure_device_budget(exclude=bid, strict=self._strict)
            except DeviceOomError:
                # a failed registration leaves nothing charged: the retry
                # ladder registers again from scratch
                del self._buffers[bid]
                self.device_bytes -= buf.size
                raise
            self.watermark_bytes = max(self.watermark_bytes,
                                       self.device_bytes)
            return bid

    def _ensure_device_budget(self, exclude: int | None = None,
                              strict: bool = False):
        if self.device_bytes <= self.device_budget:
            return
        # spill the lowest-priority device buffers first
        heap = [(b.priority, b.buffer_id) for b in self._buffers.values()
                if b.tier == TierEnum.DEVICE and b.buffer_id != exclude]
        heapq.heapify(heap)
        while self.device_bytes > self.device_budget and heap:
            _, bid = heapq.heappop(heap)
            self._spill_device_buffer(self._buffers[bid])
        if self.device_bytes > self.device_budget:
            # nothing left to spill and still over budget: the OOM analog
            self._dump_oom_state(exclude)
            if strict:
                spillable, pinned = self._device_breakdown(exclude)
                new_sz = (self._buffers[exclude].size
                          if exclude in self._buffers else 0)
                raise DeviceOomError(
                    f"device tier over budget after spill exhaustion: "
                    f"{self.device_bytes}B > budget {self.device_budget}B "
                    f"(new buffer {new_sz}B, other device buffers: "
                    f"spillable {spillable}B, pinned>=ACTIVE_BATCHING "
                    f"{pinned}B)",
                    requested=new_sz, budget=self.device_budget,
                    spillable_bytes=spillable, pinned_bytes=pinned)

    def _device_breakdown(self, exclude=None):
        """(spillable, pinned) device-tier bytes without `exclude`; pinned
        is ACTIVE_BATCHING_PRIORITY and above."""
        spillable = pinned = 0
        for b in self._buffers.values():
            if b.tier != TierEnum.DEVICE or b.buffer_id == exclude:
                continue
            if b.priority >= ACTIVE_BATCHING_PRIORITY:
                pinned += b.size
            else:
                spillable += b.size
        return spillable, pinned

    def _dump_oom_state(self, exclude):
        if not self._oom_dump_dir:
            return
        import datetime
        import time
        # a workload stuck over budget must not write a file an allocation
        now = time.monotonic()
        if now - getattr(self, "_last_oom_dump", -1e9) < 60.0:
            return
        self._last_oom_dump = now
        try:
            os.makedirs(self._oom_dump_dir, exist_ok=True)
            stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
            path = os.path.join(self._oom_dump_dir, f"hbm-oom-{stamp}.txt")
            with open(path, "w") as f:
                f.write(f"device_bytes={self.device_bytes} "
                        f"budget={self.device_budget} "
                        f"host_bytes={self.host_bytes} "
                        f"host_budget={self.host_budget} "
                        f"buffers={len(self._buffers)} "
                        f"over_budget_buffer={exclude}\n")
                for tier in (TierEnum.DEVICE, TierEnum.HOST, TierEnum.DISK):
                    spillable = pinned = 0
                    for b in self._buffers.values():
                        if b.tier != tier:
                            continue
                        if b.priority >= ACTIVE_BATCHING_PRIORITY:
                            pinned += b.size
                        else:
                            spillable += b.size
                    f.write(f"tier={tier} spillable_bytes={spillable} "
                            f"pinned_bytes={pinned}\n")
                live_by_site: dict = {}
                for b in self._buffers.values():
                    if b.tier == TierEnum.DEVICE:
                        live_by_site[b.site] = \
                            live_by_site.get(b.site, 0) + b.size
                f.write("top sites by live device bytes:\n")
                for site, live in sorted(live_by_site.items(),
                                         key=lambda kv: -kv[1])[:10]:
                    f.write(f"site={site} live_device={live}\n")
                f.write("buffer_id\ttier\tsize\tpriority\tsite\tquery\n")
                for b in sorted(self._buffers.values(),
                                key=lambda x: -x.size):
                    f.write(f"{b.buffer_id}\t{b.tier}\t{b.size}\t"
                            f"{b.priority}\t{b.site}\t{b.query}\n")
        except OSError:
            pass  # dumping must never turn an OOM into a crash

    def _spill_device_buffer(self, buf: RapidsBuffer):
        hb = batch_to_host(buf._device)
        buf._host = hb
        buf._device = None
        buf.tier = TierEnum.HOST
        self.device_bytes -= buf.size
        self.host_bytes += hb.nbytes()
        self.spilled_to_host_bytes += buf.size
        self.spilled_to_host_buffers += 1
        if buf.spill_callback:
            buf.spill_callback(buf.size)
        self._ensure_host_budget()

    def _ensure_host_budget(self):
        if self.host_bytes <= self.host_budget:
            return
        heap = [(b.priority, b.buffer_id) for b in self._buffers.values()
                if b.tier == TierEnum.HOST]
        heapq.heapify(heap)
        while self.host_bytes > self.host_budget and heap:
            _, bid = heapq.heappop(heap)
            self._spill_host_buffer(self._buffers[bid])

    def _spill_dir_path(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="rapids_torch_spill_")
        os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    def _get_direct_store(self):
        if self._direct_store is None:
            from spark_rapids_tpu_torch.runtime.direct_spill import \
                DirectSpillStore
            self._direct_store = DirectSpillStore(
                os.path.join(self._spill_dir_path(), "direct"),
                batch_bytes=self._direct_batch_bytes)
        return self._direct_store

    @property
    def direct_active(self) -> bool:
        """True when the direct store wrote its current file with
        O_DIRECT; False when it fell back to buffered I/O, or never ran."""
        st = self._direct_store
        return bool(st is not None and st.direct_active)

    def _spill_host_buffer(self, buf: RapidsBuffer):
        hb = buf._host
        payload = pickle.dumps(hb, protocol=pickle.HIGHEST_PROTOCOL)
        # CRC the clean payload; the chaos checkpoint may then flip a byte
        # of what lands on disk, which the read side must detect
        if self._spill_checksum:
            from spark_rapids_tpu_torch.runtime.checksum import block_checksum
            buf._crc = block_checksum(payload)
        payload = F.maybe_corrupt("spill.write", payload)
        # disk-capacity checkpoint before any byte lands: an injected or a
        # real ENOSPC is the typed, retryable SpillCapacityError, and the
        # buffer stays whole in the host tier
        F.maybe_inject("disk_full", "spill.write")
        try:
            if self._direct_spill:
                buf._handle = self._get_direct_store().write(payload)
                buf._path = None
            else:
                path = os.path.join(self._spill_dir_path(),
                                    f"buffer-{buf.buffer_id}.spill")
                try:
                    with open(path, "wb") as f:
                        f.write(payload)
                except OSError:
                    # a partial file must not be unspilled later
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                    raise
                buf._path = path
                buf._handle = None
        except OSError as e:
            import errno
            buf._crc = None
            if e.errno == errno.ENOSPC:
                raise SpillCapacityError(
                    f"disk spill tier full writing buffer "
                    f"{buf.buffer_id} ({len(payload)} B): {e}") from e
            raise
        self.host_bytes -= hb.nbytes()
        self.spilled_to_disk_bytes += hb.nbytes()
        self.spilled_to_disk_buffers += 1
        buf._disk_len = hb.nbytes()
        self.disk_bytes += buf._disk_len
        buf._host = None
        buf.tier = TierEnum.DISK

    # -- access --------------------------------------------------------------
    def acquire_batch(self, buffer_id: int) -> ColumnarBatch:
        """The buffer as a device batch. A spilled one is copied back; with
        unspill on it moves back into the device tier (reference
        unspill.enabled), else the device copy is transient."""
        with self._lock:
            try:
                buf = self._buffers[buffer_id]
            except KeyError:
                raise BufferClosedError(
                    f"buffer {buffer_id} removed") from None
            if buf.tier == TierEnum.DEVICE:
                return buf._device
            hb = buf._host
            if hb is None:
                if buf._handle is not None:
                    payload = self._get_direct_store().read(buf._handle)
                else:
                    with open(buf._path, "rb") as f:
                        payload = f.read()
                if buf._crc is not None:
                    from spark_rapids_tpu_torch.runtime.checksum import \
                        block_checksum
                    got = block_checksum(payload)
                    if got != buf._crc:
                        raise SpillCorruptionError(
                            f"buffer {buffer_id} spill payload checksum "
                            f"mismatch on unspill (stored {buf._crc:#x}, "
                            f"read {got:#x}, {len(payload)}B)")
                hb = pickle.loads(payload)
                self.read_from_disk_buffers += 1
            else:
                self.read_from_host_buffers += 1
            batch = host_to_batch(hb)
            if self._unspill:
                if buf.tier == TierEnum.HOST:
                    self.host_bytes -= hb.nbytes()
                elif buf._handle is not None:
                    self._get_direct_store().delete(buf._handle)
                    buf._handle = None
                else:
                    os.unlink(buf._path)
                    buf._path = None
                if buf.tier == TierEnum.DISK:
                    self.disk_bytes -= buf._disk_len
                    buf._disk_len = 0
                buf._host = None
                buf._device = batch
                buf.tier = TierEnum.DEVICE
                self.device_bytes += buf.size
                self._ensure_device_budget(exclude=buffer_id)
                self.watermark_bytes = max(self.watermark_bytes,
                                           self.device_bytes)
            return batch

    def get_tier(self, buffer_id: int) -> str:
        return self._buffers[buffer_id].tier

    def buffer_site(self, buffer_id: int) -> str:
        with self._lock:
            buf = self._buffers.get(buffer_id)
            return buf.site if buf is not None else UNATTRIBUTED_SITE

    def remove(self, buffer_id: int):
        with self._lock:
            buf = self._buffers.pop(buffer_id, None)
            if buf is None:
                return
            if buf.tier == TierEnum.DEVICE:
                self.device_bytes -= buf.size
            elif buf.tier == TierEnum.HOST:
                self.host_bytes -= buf._host.nbytes()
            else:
                self.disk_bytes -= buf._disk_len
                if buf._handle is not None:
                    self._get_direct_store().delete(buf._handle)
                elif buf._path:
                    with contextlib.suppress(OSError):
                        os.unlink(buf._path)

    def synchronous_spill(self, target_device_bytes: int) -> int:
        """Spill until the device tier holds <= target bytes; the bytes
        spilled (reference RapidsBufferStore.synchronousSpill:145)."""
        with self._lock:
            before = self.device_bytes
            saved = self.device_budget
            try:
                self.device_budget = target_device_bytes
                self._ensure_device_budget()
            finally:
                self.device_budget = saved
            return before - self.device_bytes

    def spill_counts(self) -> dict:
        """Buffers and bytes that moved between the tiers so far."""
        with self._lock:
            return {
                "to_host_buffers": self.spilled_to_host_buffers,
                "to_host_bytes": self.spilled_to_host_bytes,
                "to_disk_buffers": self.spilled_to_disk_buffers,
                "to_disk_bytes": self.spilled_to_disk_bytes,
                "from_host_buffers": self.read_from_host_buffers,
                "from_disk_buffers": self.read_from_disk_buffers,
                "device_watermark_bytes": self.watermark_bytes,
            }

    def finish_query(self, query_id, leak_check: bool = True):
        """End-of-query check: any non-retained buffer still registered by
        the finished query is a leak; it is reclaimed, and the leak is
        returned as {bytes, buffers, sites} (None on a clean query)."""
        with self._lock:
            leaked = ([b for b in self._buffers.values()
                       if b.query == query_id and not b.retained]
                      if leak_check else [])
        if not leaked:
            return None
        by_site: dict = {}
        total = 0
        for b in leaked:
            by_site[b.site] = by_site.get(b.site, 0) + b.size
            total += b.size
        # reclaim: holding the bytes after the report would punish every
        # later query for it
        for b in leaked:
            self.remove(b.buffer_id)
        return {"bytes": total, "buffers": len(leaked), "sites": by_site}

    @property
    def num_buffers(self):
        return len(self._buffers)


def host_prefetch_budget(max_buffer_bytes: int) -> int:
    """Byte budget for buffering ahead of a consumer (every pipeline queue
    edge, runtime/pipeline.py): the configured cap, shrunk to the catalog's
    free host headroom so prefetched data never pushes spilled buffers to
    disk, and at least 16 MiB so a producer can always stage one batch."""
    cat = DeviceManager.get().catalog
    headroom = max(cat.host_budget - cat.host_bytes, 0)
    return max(min(max_buffer_bytes, headroom), 16 << 20)


class SpillableColumnarBatch:
    """Handle over a catalogued batch; keeps its data spillable while an
    operator holds it (reference SpillableColumnarBatch.scala:29,74)."""

    def __init__(self, batch: ColumnarBatch,
                 priority: float = ACTIVE_ON_DECK_PRIORITY,
                 catalog: "BufferCatalog | None" = None, spill_callback=None):
        self.catalog = catalog or DeviceManager.get().catalog
        self.buffer_id = self.catalog.add_batch(batch, priority,
                                                spill_callback)
        self._site = self.catalog.buffer_site(self.buffer_id)
        self.num_rows = batch.num_rows
        self.schema = batch.schema
        self.size = batch.device_memory_size()
        self._closed = False
        self._leak = LeakTracker.track(
            f"SpillableColumnarBatch#{self.buffer_id}")

    def get_batch(self) -> ColumnarBatch:
        if self._closed:
            raise BufferClosedError(f"buffer {self.buffer_id} used after "
                                    "close")
        return self.catalog.acquire_batch(self.buffer_id)

    def close(self):
        if not self._closed:
            self._closed = True
            LeakTracker.release(self._leak)
            # chaos hook ("leak:<site>:N"): the handle closes but the
            # catalog entry stays, which the end-of-query check must catch
            if F.should_leak(self._site):
                return
            self.catalog.remove(self.buffer_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def device_budget_bytes(conf: C.RapidsConf, device) -> int:
    """``memory.hbm.limitBytes``, or when that is 0 the card's total memory
    (``torch.cuda.mem_get_info``) times ``allocFraction``; the CPU takes
    ``CPU_DEVICE_BYTES`` as the card's size."""
    limit = conf.get(C.DEVICE_MEMORY_LIMIT)
    if limit:
        return int(limit)
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
    else:
        total = CPU_DEVICE_BYTES
    return int(total * conf.get(C.DEVICE_MEMORY_FRACTION))


class DeviceManager:
    """Process-wide device state: the device, its budget and the buffer
    catalog (reference GpuDeviceManager + RapidsBufferCatalog.init)."""

    _instance: "DeviceManager | None" = None
    _lock = threading.Lock()

    def __init__(self, conf: C.RapidsConf, device="cpu"):
        self.conf = conf
        self.device = torch.device(device)
        spill_dirs = conf.get(C.SPILL_DIRS)
        self.catalog = BufferCatalog(
            device_budget=device_budget_bytes(conf, self.device),
            host_budget=conf.get(C.HOST_SPILL_STORAGE_SIZE),
            spill_dir=spill_dirs.split(",")[0] if spill_dirs else None,
            unspill=conf.get(C.UNSPILL_ENABLED),
            oom_dump_dir=conf.get(C.OOM_DUMP_DIR),
            direct_spill=conf.get(C.DIRECT_SPILL_ENABLED),
            direct_batch_bytes=conf.get(C.DIRECT_SPILL_BATCH_BYTES),
            strict_budget=conf.get(C.STRICT_DEVICE_BUDGET),
            spill_checksum=conf.get(C.SPILL_CHECKSUM),
        )

    @classmethod
    def initialize(cls, conf: C.RapidsConf | None = None,
                   device="cpu") -> "DeviceManager":
        with cls._lock:
            cls._instance = DeviceManager(conf or C.RapidsConf(), device)
            return cls._instance

    @classmethod
    def get(cls) -> "DeviceManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DeviceManager(C.RapidsConf())
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._instance = None
