"""Direct-I/O batched spill store — counterpart of
``spark_rapids_tpu/runtime/direct_spill.py`` (reference RapidsGdsStore.scala:32
and its BatchSpiller, :123).

The reference writes spilled device buffers to NVMe through cuFile and
coalesces small buffers into aligned batch files. The chip machine has no
cuFile, so this is the reference's own host-side analog: page-aligned
O_DIRECT writes that bypass the page cache.

  * small buffers append into one open batch file at aligned offsets
    (BatchSpiller.addBuffer); a handle is (file_id, offset, length);
  * a sealed batch file is unlinked when its last live buffer is deleted,
    and rotation unlinks the outgoing file at once when every buffer in it
    already died;
  * O_DIRECT through a page-aligned mmap bounce buffer, falling back to
    buffered I/O for good where the filesystem refuses O_DIRECT (tmpfs,
    some containers) — the reference's own host fallback, not a device
    one. ``direct_active`` says which one the current file took.

The reference's movement-ledger records are not ported.
"""

from __future__ import annotations

import mmap
import os
import threading


ALIGN = 4096


class _BatchFile:
    def __init__(self, path: str):
        self.path = path
        self.size = 0
        self.live = 0      # live buffer count; unlink at zero (refcount)
        self.sealed = False


class DirectSpillStore:
    """Batched aligned spill writes; returns opaque handles."""

    def __init__(self, directory: str, batch_bytes: int = 64 << 20,
                 use_direct: bool = True):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.batch_bytes = max(batch_bytes, ALIGN)
        self._lock = threading.Lock()
        self._files: dict[int, _BatchFile] = {}
        self._next_file = 0
        self._current: int | None = None
        self._fd: int | None = None       # open fd for the current file
        self._fd_direct = False
        self._direct = use_direct
        self._direct_works: bool | None = None  # latched on first failure
        # reused page-aligned bounce buffer for O_DIRECT writes
        self._bounce = mmap.mmap(-1, ALIGN)

    # -- internals (all under self._lock) -------------------------------------

    def _open_fd(self, path: str) -> int:
        direct = (self._direct and self._direct_works is not False
                  and hasattr(os, "O_DIRECT"))
        flags = os.O_WRONLY | os.O_CREAT
        if direct:
            try:
                fd = os.open(path, flags | os.O_DIRECT, 0o600)
                self._fd_direct = True
                return fd
            except OSError:
                self._direct_works = False
        self._fd_direct = False
        return os.open(path, flags, 0o600)

    def _close_fd(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _unlink_file(self, fid: int) -> None:
        bf = self._files.pop(fid, None)
        if bf is not None:
            try:
                os.unlink(bf.path)
            except OSError:
                pass

    def _rotate(self) -> int:
        """Seal the current batch file and open a fresh one."""
        old = self._current
        if old is not None:
            self._files[old].sealed = True
            self._close_fd()
            if self._files[old].live <= 0:
                self._unlink_file(old)  # every buffer already died
        fid = self._next_file
        self._next_file += 1
        bf = _BatchFile(os.path.join(self.dir, f"spill-batch-{fid}.bin"))
        self._files[fid] = bf
        self._current = fid
        self._fd = self._open_fd(bf.path)
        return fid

    def _write_aligned(self, fid: int, payload: bytes) -> int:
        """Append `payload` at an aligned offset via the open fd."""
        bf = self._files[fid]
        offset = bf.size
        padded = -(-len(payload) // ALIGN) * ALIGN
        if len(self._bounce) < padded:
            self._bounce.close()
            self._bounce = mmap.mmap(-1, padded)
        self._bounce.seek(0)
        self._bounce.write(payload)
        self._bounce.write(b"\0" * (padded - len(payload)))
        view = memoryview(self._bounce)[:padded]
        try:
            os.pwrite(self._fd, view, offset)
        except OSError:
            if not self._fd_direct:
                raise
            # filesystem accepted O_DIRECT at open but refused the write
            # (some FUSE/network mounts) — fall back for good
            self._direct_works = False
            self._close_fd()
            self._fd = self._open_fd(bf.path)
            os.pwrite(self._fd, view, offset)
        bf.size += padded
        return offset

    # -- public --------------------------------------------------------------

    def write(self, payload: bytes) -> tuple[int, int, int]:
        """Spill one serialized buffer; returns handle (file_id, offset, len).
        Buffers accumulate into the current batch file until it reaches
        batch_bytes, then a new file starts (BatchSpiller rotation)."""
        with self._lock:
            fid = self._current
            if fid is None or self._files[fid].size >= self.batch_bytes:
                fid = self._rotate()
            offset = self._write_aligned(fid, payload)
            self._files[fid].live += 1
        return (fid, offset, len(payload))

    def read(self, handle: tuple[int, int, int]) -> bytes:
        fid, offset, length = handle
        with self._lock:
            path = self._files[fid].path
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def delete(self, handle: tuple[int, int, int]) -> None:
        fid, _, _ = handle
        with self._lock:
            bf = self._files.get(fid)
            if bf is None:
                return
            bf.live -= 1
            # the open batch file keeps accepting writes even at live==0
            # (rotation reclaims it — matches the reference's pending blob)
            if bf.live <= 0 and bf.sealed:
                self._unlink_file(fid)

    def close(self) -> None:
        with self._lock:
            self._close_fd()
            for fid in list(self._files):
                self._unlink_file(fid)
            self._current = None
            self._bounce.close()

    @property
    def direct_active(self) -> bool:
        return bool(self._fd_direct)
