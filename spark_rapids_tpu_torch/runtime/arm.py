"""RAII helpers and buffer accounting — counterpart of
``spark_rapids_tpu/runtime/arm.py`` (reference Arm.scala:23-100,
withResource/closeOnExcept). Torch tensors are reference-counted, so RAII
shrinks to (a) context helpers for what does need closing (spillable
batches, spill handles) and (b) a registry of live tracked resources that
the tests hold empty, the way the reference uses cudf's leak detection."""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager


@contextmanager
def with_resource(resource):
    """withResource: close on scope exit (Arm.scala:30)."""
    try:
        yield resource
    finally:
        resource.close()


@contextmanager
def close_on_except(resource):
    """closeOnExcept: close only if the body throws (Arm.scala:63)."""
    try:
        yield resource
    except BaseException:
        resource.close()
        raise


class LeakTracker:
    """Registry of live tracked resources; tests call assert_no_leaks()."""

    _lock = threading.Lock()
    _live: dict[int, str] = {}
    _next = 0

    @classmethod
    def track(cls, what: str) -> int:
        with cls._lock:
            cls._next += 1
            cls._live[cls._next] = what
            return cls._next

    @classmethod
    def release(cls, token: int):
        with cls._lock:
            cls._live.pop(token, None)

    @classmethod
    def live_count(cls) -> int:
        with cls._lock:
            return len(cls._live)

    @classmethod
    def assert_no_leaks(cls):
        with cls._lock:
            if cls._live:
                leaked = list(cls._live.values())
                cls._live.clear()
                raise AssertionError(f"leaked resources: {leaked}")

    @classmethod
    def warn_leaks(cls):
        with cls._lock:
            for what in cls._live.values():
                warnings.warn(f"resource leak: {what}")
            cls._live.clear()
