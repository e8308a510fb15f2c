"""Device admission control — counterpart of
``spark_rapids_tpu/runtime/semaphore.py``; ``DeviceSemaphore`` is the port's
``TpuSemaphore`` (reference GpuSemaphore.scala:101).

N tasks may hold the device at once (``spark.rapids.tpu.sql.concurrentTpuTasks``,
default 2); a task acquires before its first device use and releases when
it completes or blocks on a queue. A counted semaphore keyed by task,
re-entrant per task. A task is a ``TaskContext``: its exit releases the
permit. A thread outside every ``TaskContext`` (a caller iterating a plan
itself) is not gated, since nothing would ever release its permit (the
reference gives such a thread a task id that keeps its permit until the
thread ends). The reference's wait-time metric and its polled
cancellation check are not ported (runtime/metrics.py, scheduler.py).
"""

from __future__ import annotations

import itertools
import threading

_task_counter = itertools.count(1)
_task_local = threading.local()


def current_task_id() -> int | None:
    """The calling thread's task id, or None outside every task."""
    return getattr(_task_local, "task_id", None)


class TaskContext:
    """Per-task scope: the task's permit is released when it ends
    (reference GpuSemaphore's task-completion listener)."""

    def __init__(self):
        self.task_id = next(_task_counter)
        self._outer = None

    def __enter__(self):
        # keep the enclosing task id, so that a nested task run inline does
        # not orphan the outer task's permit
        self._outer = getattr(_task_local, "task_id", None)
        _task_local.task_id = self.task_id
        return self

    def __exit__(self, *exc):
        DeviceSemaphore.get().release_if_necessary(self.task_id)
        _task_local.task_id = self._outer
        return False


class DeviceSemaphore:
    _instance = None
    _lock = threading.Lock()

    def __init__(self, max_concurrent: int):
        self.max_concurrent = max_concurrent
        self._sem = threading.Semaphore(max_concurrent)
        self._holders: dict[int, int] = {}
        self._holders_lock = threading.Lock()

    @classmethod
    def initialize(cls, max_concurrent: int):
        with cls._lock:
            cls._instance = cls(max_concurrent)

    @classmethod
    def get(cls) -> "DeviceSemaphore":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(2)
            return cls._instance

    def acquire_if_necessary(self, task_id: int | None = None) -> None:
        """Idempotent per-task acquire: a task holds at most one permit
        however many of its operators ask (reference acquireIfNecessary).
        Outside every task it does nothing."""
        if task_id is None:
            task_id = current_task_id()
            if task_id is None:
                return
        with self._holders_lock:
            if task_id in self._holders:
                return
        self._sem.acquire()
        with self._holders_lock:
            self._holders[task_id] = 1

    def release_if_necessary(self, task_id: int | None = None) -> None:
        """Release the task's permit entirely (reference completeAndRelease;
        the calling thread's task by default): a thread does it before it
        blocks on a queue, a map stage or a broadcast build, so that a held
        permit never starves the thread it waits for."""
        if task_id is None:
            task_id = current_task_id()
            if task_id is None:
                return
        with self._holders_lock:
            if self._holders.pop(task_id, None) is None:
                return
        self._sem.release()
