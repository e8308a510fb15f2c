"""Native (C++) host code of the port: the parquet column-chunk scanner.

Counterpart of ``spark_rapids_tpu/native/__init__.py``'s scanner half. The
port builds its own copy of the source, ``parquet_host.cpp`` beside this
file, with ``g++ -O3 -fPIC -std=c++17 -shared`` at first use into
``build/native/lib<name>-<source digest>.so`` of the checkout (as
``ops/cuda_kernels`` builds the CUDA sources), and loads it with
``ctypes.CDLL``, which releases the GIL for every call. A build writes to a
temporary name and renames it into place, so processes that build at once
leave one whole library.

There is no fallback: a missing compiler or a failed build raises
``NativeBuildError`` with the compiler's output, and the scan fails with it.
The wrappers take and return numpy arrays, one call per column chunk; no
Python runs per page header, per run or per value. Error codes of the C
source map onto two exceptions: ``ScopeRefused`` (a ``NotImplementedError``:
a chunk outside the device decode's scope, which the scan reads through
arrow) and ``ValueError`` (a malformed chunk, which fails the scan).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
SOURCE = os.path.join(_DIR, "parquet_host.cpp")
CXX = "g++"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

#: int64 fields of one SrPage row: num_values, def_off, n_present,
#: bit_width, body_off, body_len, values_off, seg_off, seg_count
PAGE_FIELDS = 9
#: int64 fields of one SrSeg row: kind (0 rle, 1 packed), count, value,
#: byte_off (page-relative), byte_len
SEG_FIELDS = 5
#: int64 fields of one page header row of sr_page_headers: page_type,
#: body_off, compressed_size, uncompressed_size, num_values, def_len,
#: v2_compressed
HDR_FIELDS = 7
#: int64 fields of one page of sr_scan_pages: version (1 or 2), num_values,
#: data_off, data_len, levels_off, levels_len
DESC_FIELDS = 6

MALFORMED, PAGE_TYPE, ENCODING, CAPACITY, NO_DICT, DEF_CAPACITY, NESTED = \
    range(-1, -8, -1)
_ERRORS = {MALFORMED: "malformed chunk", PAGE_TYPE: "unsupported page type",
           ENCODING: "unsupported page encoding",
           CAPACITY: "capacity exceeded", NO_DICT: "no dictionary page",
           DEF_CAPACITY: "def levels exceed num_values",
           NESTED: "repeated (nested) v2 page"}
_SCOPE = (PAGE_TYPE, ENCODING, NO_DICT, NESTED)

_LOCK = threading.Lock()
_LIBS: dict = {}


class NativeBuildError(RuntimeError):
    """The native library could not be built (no compiler, or the compiler
    refused the source); the message carries the compiler's output."""


class ScopeRefused(NotImplementedError):
    """The chunk is outside the device decode's scope (``code``, one of the
    scope error codes)."""

    def __init__(self, code: int):
        super().__init__(f"native parquet scan: {_ERRORS[code]}")
        self.code = code


def so_path(src: str, build_dir: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{name}-{digest}.so")


def build_library(src: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` into ``build_dir`` unless that digest is built;
    returns the library's path. Raises ``NativeBuildError``."""
    out = so_path(src, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXXFLAGS, "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"cannot run {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeBuildError(
            f"{' '.join(cmd)} exited {res.returncode}:\n{res.stdout}"
            f"{res.stderr}")
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "sr_scan_chunk": [_P, _I64, _I64, ctypes.c_int32, _P, _I64, _P, _I64, _P,
                      _I64, _P],
    "sr_page_headers": [_P, _I64, _I64, _P, _I64],
    "sr_scan_pages": [_P, _I64, _P, _I64, ctypes.c_int32, _P, _P, _I64, _P,
                      _I64],
    "sr_decode_hybrid": [_P, _I64, _I64, _I64, _I64, _P],
    "sr_pack_table": [_P, _I64, _P, _P],
    "sr_pack_words": [_P, _I64, _P, _I64, _P, _P, _P],
}


def parquet_lib():
    """The scanner library, built and loaded at first use."""
    with _LOCK:
        lib = _LIBS.get(SOURCE)
        if lib is None:
            lib = ctypes.CDLL(build_library(SOURCE, BUILD_DIR))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I64
            _LIBS[SOURCE] = lib
        return lib


def _check(code: int, what: str) -> int:
    if code >= 0:
        return code
    if code in _SCOPE:
        raise ScopeRefused(code)
    raise ValueError(f"{what}: {_ERRORS.get(code, code)}")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _as_bytes(buf) -> np.ndarray:
    return np.frombuffer(buf, np.uint8) if not isinstance(
        buf, np.ndarray) else buf


def _grown(call, what: str, caps: tuple, growth: tuple):
    """Run ``call(*caps)`` and grow the caller's arrays while it reports
    CAPACITY; a chunk that never fits is malformed."""
    for _ in range(6):
        code = call(*caps)
        if code != CAPACITY:
            return _check(code, what)
        caps = tuple(c * g for c, g in zip(caps, growth))
    raise ValueError(f"{what}: page/run capacity never converged")


def scan_chunk(buf, num_values: int, max_def: int):
    """``sr_scan_chunk`` over an UNCOMPRESSED chunk of v1 data pages:
    ``(pages (P, 9) int64, segs (S, 5) int64, def levels (num_values,)
    int32, (dictionary body_off, body_len, num_values))``. Raises
    ``ScopeRefused`` (code ``PAGE_TYPE`` for v2 pages) or ``ValueError``."""
    lib = parquet_lib()
    body = _as_bytes(buf)
    defs = np.empty(max(num_values, 1), np.int32)
    dict_info = np.empty(3, np.int64)
    out = {}

    def call(pages_cap, segs_cap):
        out["pages"] = np.empty((pages_cap, PAGE_FIELDS), np.int64)
        out["segs"] = np.empty((segs_cap, SEG_FIELDS), np.int64)
        return lib.sr_scan_chunk(
            _ptr(body), body.size, num_values, max_def, _ptr(out["pages"]),
            pages_cap, _ptr(out["segs"]), segs_cap, _ptr(defs), defs.size,
            _ptr(dict_info))
    n = _grown(call, "native parquet scan", (1024, 8192), (4, 16))
    pages = out["pages"][:n]
    n_segs = int(pages[-1, 7] + pages[-1, 8]) if n else 0
    return (pages, out["segs"][:n_segs], defs[:num_values],
            tuple(int(v) for v in dict_info))


def page_headers(buf, num_values: int) -> np.ndarray:
    """``sr_page_headers``: one ``HDR_FIELDS`` row per page of a chunk of
    any codec, the dictionary page included."""
    lib = parquet_lib()
    body = _as_bytes(buf)
    out = {}

    def call(cap):
        out["h"] = np.empty((cap, HDR_FIELDS), np.int64)
        return lib.sr_page_headers(_ptr(body), body.size, num_values,
                                   _ptr(out["h"]), cap)
    n = _grown(call, "native parquet page headers", (256,), (8,))
    return out["h"][:n]


def scan_pages(body: np.ndarray, descs: np.ndarray, max_def: int,
               num_values: int):
    """``sr_scan_pages`` over data pages held uncompressed in ``body``
    (``descs``: one ``DESC_FIELDS`` row a page): ``(pages, segs, def
    levels)`` as ``scan_chunk`` returns them."""
    lib = parquet_lib()
    descs = np.ascontiguousarray(descs, np.int64)
    n_pages = descs.shape[0]
    pages = np.empty((n_pages, PAGE_FIELDS), np.int64)
    defs = np.empty(max(num_values, 1), np.int32)
    out = {}

    def call(segs_cap):
        out["segs"] = np.empty((segs_cap, SEG_FIELDS), np.int64)
        return lib.sr_scan_pages(
            _ptr(body), body.size, _ptr(descs), n_pages, max_def,
            _ptr(pages), _ptr(out["segs"]), segs_cap, _ptr(defs), defs.size)
    _grown(call, "native parquet page scan", (8192,), (16,))
    n_segs = int(pages[-1, 7] + pages[-1, 8]) if n_pages else 0
    return pages, out["segs"][:n_segs], defs[:num_values]


def decode_hybrid(page, pos: int, bit_width: int, total: int) -> np.ndarray:
    """``sr_decode_hybrid``: the ``total`` int32 values of the hybrid stream
    ``page[pos:]`` at ``bit_width`` (zero past its end); the reference's
    ``decode_rle_host``."""
    lib = parquet_lib()
    data = _as_bytes(page)
    out = np.empty(total, np.int32)
    _check(lib.sr_decode_hybrid(_ptr(data), data.size, pos, bit_width, total,
                                _ptr(out)), "native hybrid decode")
    return out


def pack_table(pages: np.ndarray, segs: np.ndarray):
    """``sr_pack_table``: the ``(P, 8)`` int32 page table of a packed chunk
    (``ops/cuda_kernels.PAGE_FIELDS``) and its total index words."""
    lib = parquet_lib()
    pages = np.ascontiguousarray(pages, np.int64)
    segs = np.ascontiguousarray(segs, np.int64)
    table = np.empty((pages.shape[0], 8), np.int32)
    words = _check(lib.sr_pack_table(_ptr(pages), pages.shape[0], _ptr(segs),
                                     _ptr(table)), "native pack table")
    return table, words


def pack_words(body: np.ndarray, pages: np.ndarray, segs: np.ndarray,
               table: np.ndarray, words: np.ndarray) -> None:
    """``sr_pack_words``: write every page's index words into ``words`` (a
    contiguous int32 array, the words section of the caller's buffer)."""
    lib = parquet_lib()
    pages = np.ascontiguousarray(pages, np.int64)
    segs = np.ascontiguousarray(segs, np.int64)
    table = np.ascontiguousarray(table, np.int32)
    need = int(table[-1, 2] + table[-1, 3]) if table.shape[0] else 0
    if (words.dtype != np.int32 or not words.flags.c_contiguous
            or words.size < need):
        raise ValueError(f"pack_words: want {need} contiguous int32 words")
    _check(lib.sr_pack_words(_ptr(body), body.size, _ptr(pages),
                             pages.shape[0], _ptr(segs), _ptr(table),
                             _ptr(words)), "native pack words")
