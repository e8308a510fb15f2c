"""Deterministic fault injection — counterpart of
``spark_rapids_tpu/runtime/faults.py``, the chaos layer of the retry ladder.

Nothing in a single-process run exercises the OOM and fetch recovery
ladders by itself, so faults are injected: a seeded registry set from
``spark.rapids.tpu.test.faults`` arms named sites across memory and
shuffle, and the tests show that injected failures recover to results bit
for bit the clean run's. The reference tests the same ladders with
RmmSpark.forceRetryOOM / forceSplitAndRetryOOM task hooks.

Spec grammar (comma-separated entries), the reference's::

    entry   := kind ":" site ":" trigger
    kind    := "oom" | "splitoom" | "transport" | "error" | "exec_kill"
             | "hang" | "cancel" | "slow" | "corrupt" | "leak" | "disk_full"
    trigger := COUNT | COUNT "@" SKIP | "p" PROB

``oom`` raises a retryable ``runtime.retry.DeviceOomError``, ``splitoom`` a
``SplitAndRetryOom``, ``error`` a plain ``RuntimeError`` (a fault no ladder
absorbs), ``slow`` sleeps 250 ms at the site and goes on, ``disk_full``
raises a retryable ``SpillCapacityError`` at the disk-spill writer
("spill.write"). ``corrupt`` never raises: it arms :func:`maybe_corrupt`'s
payload site ("spill.write") to flip one byte, so the spill CRC must catch
it. ``leak`` never raises either: it arms :func:`should_leak` at a buffer's
release (``SpillableColumnarBatch.close``, matched against the buffer's
allocation site) to skip the catalog release, which the end-of-query leak
detector must catch and reclaim. ``transport``, ``exec_kill``, ``hang`` and
``cancel`` need the shuffle transport, the cluster and the query scheduler,
which are not ported: :func:`configure` raises ``NotImplementedError`` for
them (:func:`parse_spec` still parses them).

COUNT injects on that many eligible hits; ``@SKIP`` first lets SKIP hits
pass; ``pPROB`` injects each hit with the given probability from a per-site
stream seeded by (seed, kind, site), so one seed is one schedule per site
whatever order the pipeline's threads hit the sites in.

Sites: the ``with_retry``/``call_with_retry`` attempts check their
``scope`` ("joins.build", "joins.gather", "agg.update", "agg.merge",
"sort.sort", "exchange.map", "exchange.write", "broadcast.build",
"coalesce.concat"); catalog registrations outside a scope check
"catalog.add_batch"; the pipeline's queues check "pipeline.put" /
"pipeline.get" and their edge-qualified "pipeline.put.<edge>" /
"pipeline.get.<edge>" through :func:`maybe_inject_any`.
"""

from __future__ import annotations

import contextlib
import random
import re
import threading

_lock = threading.Lock()
_active = False
_entries: list = []
_injected: list = []
_tls = threading.local()

_KINDS = ("oom", "splitoom", "transport", "error", "exec_kill", "hang",
          "cancel", "slow", "corrupt", "leak", "disk_full")
#: kinds whose machinery (transport, cluster, scheduler) is not ported
UNPORTED_KINDS = ("transport", "exec_kill", "hang", "cancel")
_ENTRY_RE = re.compile(
    r"^(?P<kind>[a-z_]+):(?P<site>[A-Za-z0-9_.\-]+):"
    r"(?:(?P<count>\d+)(?:@(?P<skip>\d+))?|p(?P<prob>0?\.\d+|1(?:\.0*)?))$")


class _Entry:
    __slots__ = ("kind", "site", "count", "skip", "prob", "rng")

    def __init__(self, kind, site, count, skip, prob, seed=0):
        self.kind = kind
        self.site = site
        self.count = count
        self.skip = skip
        self.prob = prob
        # a per-site stream: pPROB draws must not depend on which other
        # sites' threads drew first; str seeds hash through sha512, so one
        # (seed, kind, site) is one schedule in every process
        self.rng = random.Random(f"{seed}|{kind}|{site}")


def parse_spec(spec: str, seed: int = 0) -> list:
    entries = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        m = _ENTRY_RE.match(raw)
        if not m or m.group("kind") not in _KINDS:
            raise ValueError(
                f"bad fault spec entry {raw!r}; want kind:site:trigger with "
                f"kind in {_KINDS} and trigger COUNT[@SKIP] or pPROB")
        entries.append(_Entry(
            m.group("kind"), m.group("site"),
            int(m.group("count")) if m.group("count") else 0,
            int(m.group("skip") or 0),
            float(m.group("prob")) if m.group("prob") else None,
            seed=seed))
    return entries


def configure(spec: str | None, seed: int = 0) -> None:
    """Arm (or with None/empty, disarm) the process-wide injector."""
    global _active, _entries
    entries = parse_spec(spec, seed) if spec else []
    refused = sorted({e.kind for e in entries if e.kind in UNPORTED_KINDS})
    if refused:
        raise NotImplementedError(
            f"fault kinds {refused} need the shuffle transport, the cluster "
            "or the query scheduler, which are not ported yet")
    with _lock:
        _entries = entries
        _injected.clear()
        _active = bool(_entries)


def reset() -> None:
    configure(None)


def is_active() -> bool:
    return _active


def injected_log() -> list:
    """[(kind, site), ...] in injection order."""
    with _lock:
        return list(_injected)


@contextlib.contextmanager
def scope(site: str | None):
    """Thread-local site label: catalog registrations inside the block
    check `site` instead of "catalog.add_batch"."""
    prev = getattr(_tls, "site", None)
    _tls.site = site
    try:
        yield
    finally:
        _tls.site = prev


def current_scope() -> str | None:
    return getattr(_tls, "site", None)


def _select(site: str, kind_ok) -> "str | None":
    """Find the first armed entry for `site` whose kind satisfies
    `kind_ok` and apply its trigger; the firing kind (logged), or None."""
    with _lock:
        for e in _entries:
            if not kind_ok(e.kind) or e.site != site:
                continue
            if e.prob is not None:
                if e.rng.random() < e.prob:
                    _injected.append((e.kind, site))
                    return e.kind
                return None
            if e.count <= 0:
                continue
            if e.skip > 0:
                e.skip -= 1
                return None
            e.count -= 1
            _injected.append((e.kind, site))
            return e.kind
    return None


def _select_and_fire(site: str, kind_ok) -> None:
    kind = _select(site, kind_ok)
    if kind is not None:
        _raise(kind, site)


def maybe_inject(kind: str, site: str) -> None:
    """Raise the fault armed for (kind, site), if any; a flag check when
    injection is off. An "oom" checkpoint also fires "splitoom" entries
    (the same fault with a stronger demand), and any checkpoint fires
    "slow"."""
    if not _active:
        return
    _select_and_fire(site, lambda k: k == kind
                     or (kind == "oom" and k == "splitoom")
                     or k == "slow")


def maybe_inject_any(site: str) -> None:
    """Raise whatever fault is armed for `site` — the pipeline's queue
    hooks. "corrupt", "leak" and "disk_full" stay silent here: they act
    only at their own payload, release and spill-writer sites."""
    if not _active:
        return
    _select_and_fire(site, lambda k: k not in ("corrupt", "leak",
                                               "disk_full"))


def should_leak(site: str) -> bool:
    """Release checkpoint: True when a "leak" entry is armed for `site`,
    and the caller then skips the release it was about to make."""
    if not _active:
        return False
    return _select(site, lambda k: k == "leak") is not None


def maybe_corrupt(site: str, data: bytes) -> bytes:
    """Payload checkpoint: with a "corrupt" entry armed for `site`, flip
    one byte in the middle of `data`; else `data` unchanged. Site:
    "spill.write" (the disk-tier spill payload, runtime/memory.py)."""
    if not _active or not data:
        return data
    if _select(site, lambda k: k == "corrupt") is None:
        return data
    flipped = bytearray(data)
    flipped[len(flipped) // 2] ^= 0xFF
    return bytes(flipped)


def _raise(kind: str, site: str):
    if kind == "slow":
        import time
        time.sleep(0.25)
        return
    if kind == "disk_full":
        from spark_rapids_tpu_torch.runtime.retry import SpillCapacityError
        raise SpillCapacityError(
            f"[fault-injection] disk full (ENOSPC) at {site}", injected=True)
    if kind == "error":
        raise RuntimeError(f"[fault-injection] error at {site}")
    from spark_rapids_tpu_torch.runtime.retry import (DeviceOomError,
                                                      SplitAndRetryOom)
    cls = SplitAndRetryOom if kind == "splitoom" else DeviceOomError
    raise cls(f"[fault-injection] device OOM at {site}", injected=True)
