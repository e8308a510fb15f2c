"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
their launch counts.

Counterpart of ``spark_rapids_tpu/ops/pallas_kernels.py``. Each kernel lives in
``csrc/`` as CUDA C++ with a plain C interface. It is compiled by ``nvcc`` for
``sm_90a`` at first use, into ``build/cuda/`` of the checkout, and loaded with
``ctypes``. Each wrapper here:

- checks device, dtype, shape and contiguity, and raises on anything else;
- takes the plain PyTorch version only for a tensor on the CPU. For a CUDA
  tensor it launches the kernel or raises: there is no probe latch and no
  fallback, so a broken kernel cannot hide behind the plain version;
- allocates its output with ``torch.empty`` and launches on the current stream;
- raises if the launch reports a CUDA error;
- adds one to ``launches[name]`` where it launches the kernel, and nowhere else.

Kernels ported so far (see PERF.md for the table of all TPU kernels):

* ``chunk_decode`` — ``csrc/chunkdecode.cu``, replaces
  ``pallas_kernels.bitunpack128`` and the per-page device work around it:
  one launch decodes a whole dictionary-encoded parquet column chunk
  (unpack, dictionary gather, null spread, canonical nulls).
  ``bitunpack128`` is a call of the same kernel with one page and no
  dictionary. Both count under ``launches["bitunpack128"]``.
* ``onehot_sums_f32`` — ``csrc/onehot.cu``, replaces
  ``pallas_kernels.onehot_sum_f32`` (the dense group-by's count-like bucket
  sums): one launch takes all of an aggregate batch's count-like requests
  over its codes. ``onehot_sum_f32`` is its one-request call. Both count
  under ``launches["onehot_sum_f32"]``, one a launch.
* ``murmur3_words`` — ``csrc/murmur3.cu``, replaces
  ``pallas_kernels.murmur3_words`` (Spark's string hash, for every string
  key of a hash exchange).
* ``radix_ranks`` and ``radix_partition_permutation`` — ``csrc/radix.cu``,
  replace ``pallas_kernels.radix_ranks`` and the reference's permutation
  around it (stable counting ranks; the permutation, scan and scatter
  inside the kernels, behind every exchange's partition step). Both count
  under ``launches["radix_ranks"]``.
* ``hash_join_build`` and ``hash_join_probe`` — ``csrc/hashjoin.cu``,
  replace ``pallas_kernels.hash_join_build`` and ``hash_join_probe`` (the
  broadcast hash join's 8-slot Fibonacci table over a sparse unique build
  key: its build, one launcher call of a memset and two kernels, and its
  probe).

Map tasks of an exchange run on a thread pool, so the launch counts and the
first build are taken under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")

# kernel library name -> CUDA source under csrc/
SOURCES = {"chunkdecode": "chunkdecode.cu", "onehot": "onehot.cu",
           "murmur3": "murmur3.cu", "radix": "radix.cu",
           "hashjoin": "hashjoin.cu"}

#: launches of each kernel since the last reset_launches()
launches = {"bitunpack128": 0, "onehot_sum_f32": 0, "murmur3_words": 0,
            "radix_ranks": 0, "hash_join_build": 0, "hash_join_probe": 0}

_LIBS: dict = {}
_FNS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _LOCK:
        launches[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _so_path(name: str) -> str:
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=None) -> dict:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together. Returns, per library, the nvcc seconds
    (0.0 when it was already built) and ptxas' lines."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    info, procs = {}, {}
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            info[name] = {"seconds": 0.0, "ptxas": []}
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, so)
    failed = []
    for name, (proc, t0, tmp, so) in procs.items():
        out, err = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}{err}")
            continue
        os.replace(tmp, so)
        info[name] = {"seconds": secs,
                      "ptxas": [ln.strip() for ln in (out + err).splitlines()
                                if "ptxas" in ln]}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def _launcher(lib: str, symbol: str, argtypes: list):
    """The C launch function ``symbol`` of kernel library ``lib``, built and
    loaded at first use; it returns a CUDA error code."""
    fn = _FNS.get(symbol)
    if fn is None:
        with _LOCK:
            if lib not in _LIBS:
                build_all([lib])
                _LIBS[lib] = ctypes.CDLL(_so_path(lib))
            fn = getattr(_LIBS[lib], symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[symbol] = fn
    return fn


# ---------------------------------------------------------------------------
# parquet chunk decode (and bitunpack128, its one-page, dictionary-less call)
# ---------------------------------------------------------------------------

#: the int32 fields of one row of the chunk decode's page table, in order
#: (csrc/chunkdecode.cu's ``Page``). ``row_off``/``row_count``: the page's
#: rows in the chunk; ``word_off``/``n_words``: its index words in the word
#: stream; ``n_present``: its non-null values; ``present_before``: the
#: non-null values of the pages before it; ``has_nulls``: 0 or 1.
PAGE_FIELDS = ("row_off", "row_count", "word_off", "n_words", "bit_width",
               "n_present", "present_before", "has_nulls")


def _chunk_launch(words, pages, defs, dictionary, n_rows: int, capacity: int,
                  value_bytes: int, default_bits: int, values, valid) -> None:
    """Launch csrc/chunkdecode.cu on CUDA tensors that the caller checked;
    ``pages`` is an int32 ``(P, 8)`` table or a tuple of one page's fields,
    passed by value; with no dictionary (``value_bytes`` 0) the values are
    the unpacked indices."""
    launch = _launcher("chunkdecode", "chunk_decode_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    if isinstance(pages, torch.Tensor):
        table, num_pages, one = pages.data_ptr(), pages.shape[0], (0,) * 8
    else:
        table, num_pages, one = None, 1, pages
    _off, row_count, _w, n_words, bw, n_present, _pb, has_nulls = one
    err = launch(
        words.device.index, table, num_pages, row_count, n_words, bw,
        n_present, has_nulls, words.data_ptr(),
        None if defs is None else defs.data_ptr(),
        None if dictionary is None else dictionary.data_ptr(),
        0 if dictionary is None else dictionary.numel(), n_rows, capacity,
        value_bytes, default_bits, values.data_ptr(),
        None if valid is None else valid.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk decode launch failed: CUDA error {err}")
    _count("bitunpack128")


def _default_bits(want: torch.dtype, default) -> int:
    """The default value of dtype ``want`` as the unsigned integer of its
    bytes (little-endian), as the kernel writes it."""
    raw = torch.tensor([default], dtype=want).view(torch.uint8).numpy()
    return int.from_bytes(raw.tobytes(), "little")


def chunk_decode(words: torch.Tensor, pages, defs, dictionary, n_rows: int,
                 capacity: int, want: torch.dtype, default):
    """Decode a dictionary-encoded parquet column chunk in one launch:
    ``(values (capacity,) want, validity (capacity,) bool)``.

    words: ``(W,)`` int32, every page's index words, each page's little-endian
    bit-packed indices at its own bit width (bit width 32 for indices the host
    decoded from RLE runs); pages: the ``(P, 8)`` int32 page table
    (``PAGE_FIELDS``), or a tuple of one page's 8 fields; defs: ``None`` when
    no page has nulls, else ``(>= n_rows,)`` bool or uint8 def levels (0/1)
    of the chunk's rows; dictionary: ``(nd,)`` of dtype ``want`` (the
    conversion to the column's type is elementwise, so it happens before the
    gather).

    A valid row takes the dictionary entry of its index, clamped into the
    dictionary (0 for an empty one); an invalid row and every row past
    ``n_rows`` take ``default``. Bit for bit what the reference's per-page
    decode returns (``parquet_native.chunk_to_device``)."""
    on = words.device
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("chunk_decode takes 1-D int32 words, got "
                        f"{words.dtype} of shape {tuple(words.shape)}")
    if isinstance(pages, torch.Tensor):
        if (pages.dtype != torch.int32 or pages.dim() != 2
                or pages.shape[1] != len(PAGE_FIELDS) or pages.shape[0] < 1):
            raise TypeError("chunk_decode takes a (P >= 1, 8) int32 page "
                            f"table, got {pages.dtype} {tuple(pages.shape)}")
        if pages.device != on:
            raise ValueError(f"chunk_decode: words on {on}, pages on "
                             f"{pages.device}")
    elif len(pages) != len(PAGE_FIELDS):
        raise TypeError(f"chunk_decode: a page has {len(PAGE_FIELDS)} fields")
    elif pages[0] or pages[2] or pages[6]:
        raise ValueError("chunk_decode: a page given by value starts at row "
                         "0, word 0, with no values before it")
    if not 0 <= n_rows <= capacity:
        raise ValueError(f"chunk_decode: n_rows {n_rows} outside "
                         f"[0, capacity {capacity}]")
    if defs is not None:
        if defs.dtype not in (torch.bool, torch.uint8) or defs.dim() != 1 \
                or defs.numel() < n_rows:
            raise TypeError("chunk_decode takes 1-D bool or uint8 def levels "
                            f"covering {n_rows} rows, got {defs.dtype} "
                            f"{tuple(defs.shape)}")
        if defs.device != on:
            raise ValueError(f"chunk_decode: words on {on}, defs on "
                             f"{defs.device}")
    if dictionary.dtype != want or dictionary.dim() != 1:
        raise TypeError(f"chunk_decode takes a 1-D {want} dictionary, got "
                        f"{dictionary.dtype} {tuple(dictionary.shape)}")
    if dictionary.device != on:
        raise ValueError(f"chunk_decode: words on {on}, dictionary on "
                         f"{dictionary.device}")
    if on.type == "cpu":
        return chunk_decode_plain(words, pages, defs, dictionary, n_rows,
                                  capacity, want, default)
    if on.type != "cuda":
        raise TypeError(f"chunk_decode: no kernel for {on}")
    tensors = [t for t in (words, pages, defs, dictionary)
               if t is not None and not isinstance(t, tuple)]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("chunk_decode takes contiguous tensors")
    if isinstance(pages, torch.Tensor) and pages.data_ptr() % 16:
        raise ValueError("chunk_decode reads each page with 16-byte loads: "
                         "the page table must be 16-byte aligned")
    value_bytes = torch.empty((), dtype=want).element_size()
    if value_bytes not in (1, 2, 4, 8):
        raise TypeError(f"chunk_decode: no kernel for {want} values")
    if dictionary.data_ptr() % dictionary.element_size():
        raise ValueError("chunk_decode: the dictionary is not aligned to "
                         "its element size")
    values = torch.empty((capacity,), dtype=want, device=on)
    valid = torch.empty((capacity,), dtype=torch.bool, device=on)
    if capacity:
        _chunk_launch(words, pages, defs, dictionary, n_rows, capacity,
                      value_bytes, _default_bits(want, default), values,
                      valid)
    return values, valid


def chunk_decode_plain(words: torch.Tensor, pages, defs, dictionary,
                       n_rows: int, capacity: int, want: torch.dtype,
                       default):
    """Plain PyTorch version of ``chunk_decode`` on any device, page by page
    as the reference decodes: ``bitunpack128_plain`` of the page's words, the
    dictionary gather with the index clamped into it, and the spread of
    present values over the page's rows by the prefix count of its def
    levels; then the pages at their rows and the default everywhere else."""
    dev = words.device
    rows = [pages] if not isinstance(pages, torch.Tensor) else pages.tolist()
    fill = torch.tensor(default, dtype=want, device=dev)
    values = torch.full((capacity,), default, dtype=want, device=dev)
    valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    nd = dictionary.shape[0]
    for (row_off, row_count, word_off, n_words, bw, n_present, _pb,
         has_nulls) in rows:
        row_count = min(row_count, n_rows - row_off)
        if row_count <= 0:
            continue
        pcap = 8
        while pcap < n_present:
            pcap <<= 1
        idx = bitunpack128_plain(words[word_off:word_off + n_words], bw,
                                 n_present, pcap)
        if nd:
            present = dictionary[idx.clamp(0, nd - 1).long()]
        else:
            present = torch.zeros((pcap,), dtype=want, device=dev)
        if defs is not None and has_nulls:
            dl = defs[row_off:row_off + row_count].to(torch.bool)
        else:
            dl = torch.ones((row_count,), dtype=torch.bool, device=dev)
        rank = torch.cumsum(dl.to(torch.int32), 0, dtype=torch.int32) - 1
        v = present[rank.clamp(0, pcap - 1).long()]
        values[row_off:row_off + row_count] = torch.where(dl, v, fill)
        valid[row_off:row_off + row_count] = dl
    return values, valid


def bitunpack128(words_u32: torch.Tensor, bit_width: int, n: int,
                 capacity: int) -> torch.Tensor:
    """Unpack ``n`` little-endian bit-packed values of ``bit_width`` bits from
    32-bit words into a ``(capacity,)`` int32 tensor; slots >= n are 0. A
    buffer longer than the values need is truncated; a shorter one reads as
    zeros past its end (the Pallas kernel's contract). On the card it is the
    chunk decode kernel over one page with no dictionary.

    words_u32: ``(ceil(n/128)*4*bw,)`` int32 — packed little-endian words
    (``bytes_to_words_u32``). The name keeps the TPU kernel's, whose 128-value
    rows span exactly ``4*bw`` words; the CUDA kernel needs no such blocking.
    """
    if not 1 <= bit_width <= 32:
        raise ValueError(f"bit width {bit_width} out of range")
    if n < 0 or capacity < 0:
        raise ValueError(f"negative count n={n} capacity={capacity}")
    if words_u32.dtype != torch.int32 or words_u32.dim() != 1:
        raise TypeError("bitunpack128 takes a 1-D int32 word tensor, got "
                        f"{words_u32.dtype} of shape {tuple(words_u32.shape)}")
    if words_u32.device.type == "cpu":
        return bitunpack128_plain(words_u32, bit_width, n, capacity)
    if words_u32.device.type != "cuda":
        raise TypeError(f"bitunpack128: no kernel for {words_u32.device}")
    if not words_u32.is_contiguous():
        raise ValueError("bitunpack128 takes a contiguous word tensor")
    out = torch.empty((capacity,), dtype=torch.int32, device=words_u32.device)
    if capacity:
        _chunk_launch(words_u32, (0, n, 0, words_u32.numel(), bit_width, n,
                                  0, 0), None, None, min(n, capacity),
                      capacity, 0, 0, out, None)
    return out


def bitunpack128_plain(words_u32: torch.Tensor, bit_width: int, n: int,
                       capacity: int) -> torch.Tensor:
    """Plain PyTorch version of ``bitunpack128`` on any device. torch's ``>>``
    on int32 is arithmetic, so the words widen to int64 masked to their 32
    unsigned bits, and a value is cut from the 64-bit window of its two
    covering words."""
    bw = bit_width
    dev = words_u32.device
    n_words = words_u32.numel()
    need = (n * bw + 31) // 32
    width = max(n_words, need) + 2
    wpad = torch.zeros((width,), dtype=torch.int64, device=dev)
    wpad[:n_words] = words_u32.to(torch.int64) & 0xFFFFFFFF
    idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    off = idx * bw
    w0 = (off >> 5).clamp(0, width - 2)
    sh = off & 31
    window = wpad[w0] | (wpad[w0 + 1] << 32)
    vals = (window >> sh) & ((1 << bw) - 1)
    vals = torch.where(idx < n, vals, torch.zeros_like(vals))
    # reinterpret the unsigned 32-bit result as int32
    vals = torch.where(vals >= (1 << 31), vals - (1 << 32), vals)
    return vals.to(torch.int32)


def bytes_to_words_u32(packed: np.ndarray) -> np.ndarray:
    """Host prep: pad a uint8 byte buffer to 4-byte alignment and view it as
    little-endian int32 words for ``bitunpack128``."""
    nb = len(packed)
    pad = -nb % 4
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint8)])
    return packed.view("<i4").astype(np.int32)


# ---------------------------------------------------------------------------
# per-code bucket sums (the dense group-by's count-like reductions)
# ---------------------------------------------------------------------------

#: n_domain float32 buckets fill a block's default 48 KB of shared memory
ONEHOT_MAX_DOMAIN = 12288
#: requests one launch of csrc/onehot.cu takes (its kMaxRequests); a longer
#: list splits into launches of this many
ONEHOT_MAX_REQUESTS = 16
#: the value types csrc/onehot.cu reads, by its ValueType code; None (no
#: value column) is its kOne, every row counting 1
_ONEHOT_TYPES = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
                 torch.float32: 3, None: 4}


def onehot_sums_f32(codes: torch.Tensor, reqs, n_domain: int) -> torch.Tensor:
    """``(k, n_domain)`` float32 bucket sums of ``k`` requests over one set of
    codes, in one launch per ``ONEHOT_MAX_REQUESTS`` requests::

        out[j, d] = sum of vals_j[i] over the rows i with codes[i] == d
                    and mask_j[i]

    Rows whose code lies outside ``[0, n_domain)`` are dropped: a caller
    drops a row that is not live by giving it such a code. Sums of 0/1
    values are exact below 2^24 rows.

    codes: ``(cap,)`` int32; reqs: ``[(vals, mask), ...]``, each ``vals`` a
    ``(cap,)`` bool, int32, int64 or float32 tensor read in its own type (a
    bool counts 1), or None (every row counts 1, and no column is read),
    each ``mask`` a ``(cap,)`` bool tensor or None (every row). A request
    whose value is its mask passes the mask as ``vals`` and None as
    ``mask``, and is read once.
    """
    if not 0 <= n_domain <= ONEHOT_MAX_DOMAIN:
        raise ValueError(f"onehot_sums_f32: domain {n_domain} outside "
                         f"[0, {ONEHOT_MAX_DOMAIN}]")
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise TypeError("onehot_sums_f32 takes 1-D int32 codes, got "
                        f"{codes.dtype} of shape {tuple(codes.shape)}")
    tensors = [codes]
    for vals, mask in reqs:
        if vals is not None:
            if (vals.dtype not in _ONEHOT_TYPES
                    or vals.shape != codes.shape):
                raise TypeError("onehot_sums_f32 takes bool, int32, int64 or "
                                "float32 values shaped like the codes, got "
                                f"{vals.dtype} {tuple(vals.shape)}")
            tensors.append(vals)
        if mask is not None:
            if mask.dtype != torch.bool or mask.shape != codes.shape:
                raise TypeError("onehot_sums_f32 takes bool masks shaped like "
                                f"the codes, got {mask.dtype} "
                                f"{tuple(mask.shape)}")
            tensors.append(mask)
    if any(t.device != codes.device for t in tensors):
        raise ValueError("onehot_sums_f32: inputs on different devices")
    if codes.device.type == "cpu":
        return onehot_sums_f32_plain(codes, reqs, n_domain)
    if codes.device.type != "cuda":
        raise TypeError(f"onehot_sums_f32: no kernel for {codes.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("onehot_sums_f32 takes contiguous tensors")
    out = torch.empty((len(reqs), n_domain), dtype=torch.float32,
                      device=codes.device)
    if n_domain == 0:
        return out
    launch = _launcher("onehot", "onehot_sums_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(codes.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    for j0 in range(0, len(reqs), ONEHOT_MAX_REQUESTS):
        part = reqs[j0:j0 + ONEHOT_MAX_REQUESTS]
        k = len(part)
        vals = (ctypes.c_void_p * k)(*[ptr(v) for v, _m in part])
        masks = (ctypes.c_void_p * k)(*[ptr(m) for _v, m in part])
        types = (ctypes.c_int * k)(*[
            _ONEHOT_TYPES[None if v is None else v.dtype] for v, _m in part])
        err = launch(codes.device.index, codes.data_ptr(), codes.numel(),
                     n_domain, k, vals, masks, types, out[j0].data_ptr(),
                     stream)
        if err != 0:
            raise RuntimeError(f"onehot_sums_f32 launch failed: CUDA error "
                               f"{err}")
        _count("onehot_sum_f32")
    return out


def onehot_sums_f32_plain(codes: torch.Tensor, reqs,
                          n_domain: int) -> torch.Tensor:
    """Plain PyTorch version of ``onehot_sums_f32`` on any device: per
    request, its values as float32 (ones where it has none) with the rows
    outside its mask zeroed, through ``onehot_sum_f32_plain``."""
    rows = []
    for vals, mask in reqs:
        v = (torch.ones(codes.shape, dtype=torch.float32, device=codes.device)
             if vals is None else vals.to(torch.float32))
        if mask is not None:
            v = torch.where(mask, v, torch.zeros((), dtype=torch.float32,
                                                 device=v.device))
        rows.append(onehot_sum_f32_plain(v, codes, n_domain))
    if not rows:
        return torch.zeros((0, n_domain), dtype=torch.float32,
                           device=codes.device)
    return torch.stack(rows)


def onehot_sum_f32(vals: torch.Tensor, codes: torch.Tensor,
                   n_domain: int) -> torch.Tensor:
    """``(n_domain,)`` float32 sums of ``vals`` per code: ``out[d]`` adds the
    rows whose code is ``d``; rows whose code lies outside ``[0, n_domain)``
    are dropped. Counts of 0/1 values are exact below 2^24 rows. On the card
    it is the one-request launch of ``onehot_sums_f32``.

    vals: ``(cap,)`` float32; codes: ``(cap,)`` int32 on the same device.
    """
    if not 0 <= n_domain <= ONEHOT_MAX_DOMAIN:
        raise ValueError(f"onehot_sum_f32: domain {n_domain} outside "
                         f"[0, {ONEHOT_MAX_DOMAIN}]")
    if vals.dtype != torch.float32 or vals.dim() != 1:
        raise TypeError("onehot_sum_f32 takes 1-D float32 values, got "
                        f"{vals.dtype} of shape {tuple(vals.shape)}")
    if codes.dtype != torch.int32 or codes.shape != vals.shape:
        raise TypeError("onehot_sum_f32 takes int32 codes shaped like the "
                        f"values, got {codes.dtype} {tuple(codes.shape)}")
    if codes.device != vals.device:
        raise ValueError(f"onehot_sum_f32: values on {vals.device}, codes on "
                         f"{codes.device}")
    if vals.device.type == "cpu":
        return onehot_sum_f32_plain(vals, codes, n_domain)
    return onehot_sums_f32(codes, [(vals, None)], n_domain)[0]


def onehot_sum_f32_plain(vals: torch.Tensor, codes: torch.Tensor,
                         n_domain: int) -> torch.Tensor:
    """Plain PyTorch version of ``onehot_sum_f32`` on any device: a
    scatter-add into ``n_domain + 1`` buckets, the last one taking the rows
    whose code lies outside the domain."""
    inside = (codes >= 0) & (codes < n_domain)
    idx = torch.where(inside, codes, torch.full_like(codes, n_domain))
    out = torch.zeros((n_domain + 1,), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:n_domain]


# ---------------------------------------------------------------------------
# Spark murmur3 string hash
# ---------------------------------------------------------------------------

def murmur3_words(words: torch.Tensor, lengths: torch.Tensor,
                  seed) -> torch.Tensor:
    """Spark ``Murmur3_x86_32.hashUnsafeBytes`` per row → ``(n,)`` int32.

    words: ``(n, W)`` int32, each row's UTF-8 bytes packed little-endian and
    zero-padded; lengths: ``(n,)`` int32 byte lengths; seed: an int, or an
    ``(n,)`` int32 running hash (the partitioner chains column hashes).
    Whole words mix first, then each of the ``length % 4`` tail bytes as a
    signed Java byte, then fmix with the length.
    """
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError("murmur3_words takes (n, W) int32 words, got "
                        f"{words.dtype} of shape {tuple(words.shape)}")
    n, W = words.shape
    if W < 1:
        raise ValueError("murmur3_words needs at least one word per row")
    if lengths.dtype != torch.int32 or lengths.shape != (n,):
        raise TypeError("murmur3_words takes (n,) int32 lengths, got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    per_row = isinstance(seed, torch.Tensor)
    if per_row and (seed.dtype != torch.int32 or seed.shape != (n,)):
        raise TypeError("murmur3_words takes an int seed or (n,) int32 "
                        f"seeds, got {seed.dtype} {tuple(seed.shape)}")
    tensors = [words, lengths] + ([seed] if per_row else [])
    if any(t.device != words.device for t in tensors):
        raise ValueError("murmur3_words: inputs on different devices")
    if words.device.type == "cpu":
        return murmur3_words_plain(words, lengths, seed)
    if words.device.type != "cuda":
        raise TypeError(f"murmur3_words: no kernel for {words.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("murmur3_words takes contiguous tensors")
    out = torch.empty((n,), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    launch = _launcher("murmur3", "murmur3_words_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    seed_scalar = 0 if per_row else ((int(seed) + (1 << 31)) % (1 << 32)
                                     - (1 << 31))
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = launch(words.device.index, words.data_ptr(), lengths.data_ptr(),
                 seed.data_ptr() if per_row else None, seed_scalar, n, W,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"murmur3_words launch failed: CUDA error {err}")
    _count("murmur3_words")
    return out


def murmur3_words_plain(words: torch.Tensor, lengths: torch.Tensor,
                        seed) -> torch.Tensor:
    """Plain PyTorch version of ``murmur3_words`` on any device, in int64
    holding 32 unsigned bits (``ops/hashing.py``'s arithmetic). As in the
    Pallas kernel, a row mixes ``min(length // 4, W)`` whole words and takes
    its tail bytes from word ``length // 4``, read as 0 past the row."""
    from spark_rapids_tpu_torch.ops import hashing as H
    n, W = words.shape
    lens = lengths.to(torch.int64)
    n_words = torch.div(lens, 4, rounding_mode="floor")
    n_tail = lens - 4 * n_words
    h1 = H._seed_u32(seed, lengths)
    w64 = words.to(torch.int64) & H._MASK
    for i in range(W):
        h1 = torch.where(i < n_words, H._mix_h1(h1, H._mix_k1(w64[:, i])), h1)
    inside = (n_words >= 0) & (n_words < W)
    idx = n_words.clamp(0, W - 1).unsqueeze(1)
    tail_word = torch.where(inside, w64.gather(1, idx).squeeze(1),
                            torch.zeros_like(lens))
    for t in range(3):
        byte = (tail_word >> (8 * t)) & 0xFF
        sbyte = torch.where(byte >= 128, byte - 256, byte) & H._MASK
        h1 = torch.where(t < n_tail, H._mix_h1(h1, H._mix_k1(sbyte)), h1)
    return H._to_i32(H._fmix(h1, lens))


# ---------------------------------------------------------------------------
# radix partition: stable counting ranks over a small id domain
# ---------------------------------------------------------------------------

#: lane cap, as the TPU kernel's (hash-join buckets top out here)
RADIX_MAX_PARTS = 4096


def _radix_steps(cap: int) -> int:
    """Steps of 32 rows each warp of csrc/radix.cu walks: 16 (a block of 8
    warps owns 4,096 rows), halved while that leaves fewer than 256 blocks,
    so that a small input still spreads over the card."""
    steps = 16
    while steps > 1 and -(-cap // (256 * steps)) < 256:
        steps //= 2
    return steps


def _check_radix(ids: torch.Tensor, num_lanes: int, who: str) -> None:
    if not 0 <= num_lanes <= RADIX_MAX_PARTS:
        raise ValueError(f"{who}: domain {num_lanes} outside "
                         f"[0, {RADIX_MAX_PARTS}]")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"{who} takes 1-D int32 ids, got "
                        f"{ids.dtype} of shape {tuple(ids.shape)}")
    if ids.device.type not in ("cpu", "cuda"):
        raise TypeError(f"{who}: no kernel for {ids.device}")
    if ids.device.type == "cuda" and not ids.is_contiguous():
        raise ValueError(f"{who} takes a contiguous id tensor")


def _radix_launch(ids: torch.Tensor, num_lanes: int, counts, ranks,
                  perm) -> None:
    """The three kernels of csrc/radix.cu, in one launcher call: ranks and
    ``counts``, or (``ranks`` None) the permutation into ``perm``."""
    cap = ids.shape[0]
    steps = _radix_steps(cap)
    nblocks = -(-cap // (256 * steps))
    # per-block counts, then the permutation's lane totals
    scratch = torch.empty((nblocks * num_lanes + num_lanes,),
                          dtype=torch.int32, device=ids.device)
    launch = _launcher("radix", "radix_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = launch(ids.device.index, ids.data_ptr(), cap, num_lanes, steps,
                 scratch.data_ptr(),
                 None if counts is None else counts.data_ptr(),
                 None if ranks is None else ranks.data_ptr(),
                 None if perm is None else perm.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radix launch failed: CUDA error {err}")
    _count("radix_ranks")


def radix_ranks(ids: torch.Tensor, num_lanes: int):
    """Stable radix ranks of int32 ``ids`` over ``[0, num_lanes)``.

    Returns ``(ranks (cap,) int32, counts (num_lanes,) int32)`` with
    ``ranks[i] = #{j < i : ids[j] == ids[i]}`` and ``counts[l] = #{ids ==
    l}``. Ids outside ``[0, num_lanes)`` get rank 0 and are not counted.
    """
    _check_radix(ids, num_lanes, "radix_ranks")
    if ids.device.type == "cpu":
        return radix_ranks_plain(ids, num_lanes)
    cap = ids.shape[0]
    if cap == 0 or num_lanes == 0:
        return (torch.zeros((cap,), dtype=torch.int32, device=ids.device),
                torch.zeros((num_lanes,), dtype=torch.int32,
                            device=ids.device))
    ranks = torch.empty((cap,), dtype=torch.int32, device=ids.device)
    counts = torch.empty((num_lanes,), dtype=torch.int32, device=ids.device)
    _radix_launch(ids, num_lanes, counts, ranks, None)
    return ranks, counts


def radix_ranks_plain(ids: torch.Tensor, num_lanes: int):
    """Plain PyTorch version of ``radix_ranks`` on any device: a stable
    argsort groups equal ids, and a row's rank is its position in the
    sorted order less its id's first position."""
    cap = ids.shape[0]
    dev = ids.device
    inside = (ids >= 0) & (ids < num_lanes)
    key = torch.where(inside, ids.to(torch.int64),
                      torch.full((cap,), num_lanes, dtype=torch.int64,
                                 device=dev))
    order = torch.argsort(key, stable=True)
    all_counts = torch.bincount(key, minlength=num_lanes + 1)
    starts = torch.cumsum(all_counts, 0) - all_counts
    sorted_rank = (torch.arange(cap, dtype=torch.int64, device=dev)
                   - starts[key[order]])
    ranks = torch.empty((cap,), dtype=torch.int64, device=dev)
    ranks[order] = sorted_rank
    ranks = torch.where(inside, ranks, torch.zeros_like(ranks))
    return ranks.to(torch.int32), all_counts[:num_lanes].to(torch.int32)


def radix_partition_permutation(ids: torch.Tensor,
                                num_lanes: int) -> torch.Tensor:
    """Stable permutation (int64) grouping rows by id, equal to
    ``argsort(ids, stable=True)`` when every id lies in ``[0, num_lanes)``.
    On the card it is one launcher call whose kernels count, scan and
    scatter (``perm[offset[id] + rank] = row``): no torch op runs between the
    ids and the permutation. It is defined only for ids inside the domain:
    a row outside it takes no slot there, and on the CPU collides with the
    first row of the last lane, so callers keep every id inside it (the
    partition step's padding sentinel has its own lane)."""
    _check_radix(ids, num_lanes, "radix_partition_permutation")
    cap = ids.shape[0]
    if cap and num_lanes == 0:
        raise ValueError("radix_partition_permutation: an empty domain "
                         "holds no id")
    if ids.device.type == "cpu":
        return radix_partition_permutation_plain(ids, num_lanes)
    perm = torch.empty((cap,), dtype=torch.int64, device=ids.device)
    if cap:
        _radix_launch(ids, num_lanes, None, None, perm)
    return perm


def radix_partition_permutation_plain(ids: torch.Tensor,
                                      num_lanes: int) -> torch.Tensor:
    """Plain PyTorch version of ``radix_partition_permutation`` on any
    device: ``radix_ranks_plain``, an exclusive scan of its counts, and one
    1:1 scatter, as the reference does around its Pallas call
    (``pallas_kernels.py:389-399``)."""
    cap = ids.shape[0]
    ranks, counts = radix_ranks_plain(ids, num_lanes)
    counts = counts.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    dest = offsets[ids.clamp(0, num_lanes - 1).long()] + ranks
    perm = torch.zeros((cap,), dtype=torch.int64, device=ids.device)
    perm.scatter_(0, dest, torch.arange(cap, dtype=torch.int64,
                                        device=ids.device))
    return perm


# ---------------------------------------------------------------------------
# hash-table join over unique fixed-point keys: build and probe
# ---------------------------------------------------------------------------

#: slots per bucket; the build refuses a table whose bucket holds more
HJ_SLOTS = 8
#: the key of an empty slot; the join takes the table only when every build
#: key lies above it (its engage gate), and an empty slot's row is -1
HJ_EMPTY = -(1 << 63)
#: the Fibonacci multiplier 0x9E3779B97F4A7C15 as a signed int64
_HJ_MULT = 0x9E3779B97F4A7C15 - (1 << 64)


def hash_join_buckets(n_build: int) -> int:
    """Bucket count for a build of ``n_build`` rows: about 0.25 load over
    ``HJ_SLOTS``-deep buckets, at most 4,096 buckets; 0 when the build cannot
    stay under 0.5 load (more than 16,384 rows), and the caller takes
    another join mode. The reference's sizing, unchanged."""
    want = 128
    while want * HJ_SLOTS < 4 * max(n_build, 1) and want < 4096:
        want *= 2
    if want * HJ_SLOTS < 2 * n_build:
        return 0
    return want


def _check_buckets(num_buckets: int) -> int:
    if (num_buckets & (num_buckets - 1) or num_buckets < 128
            or num_buckets > RADIX_MAX_PARTS):
        raise ValueError(f"num_buckets {num_buckets}: need a power of two "
                         f"in [128, {RADIX_MAX_PARTS}]")
    return num_buckets.bit_length() - 1


def hash_join_bucket(keys_i64: torch.Tensor, h_bits: int) -> torch.Tensor:
    """int32 bucket of each int64 key: the top ``h_bits`` bits of ``key *
    0x9E3779B97F4A7C15`` mod 2^64. torch's int64 product wraps in two's
    complement (the tests hold it against numpy uint64 over the whole int64
    range), and its ``>>`` is arithmetic, so the shifted value is masked to
    ``h_bits`` bits to make the shift logical."""
    h = keys_i64 * _HJ_MULT
    return ((h >> (64 - h_bits)) & ((1 << h_bits) - 1)).to(torch.int32)


def hash_join_build(keys_i64: torch.Tensor, eligible: torch.Tensor,
                    num_buckets: int):
    """The ``(num_buckets * HJ_SLOTS,)`` open table over unique int64 keys,
    as ``pallas_kernels.hash_join_build`` builds it: a key's bucket is its
    Fibonacci hash, its slot its stable rank within the bucket. Returns
    ``(table_keys int64, table_rows int32, ok)``, ``ok`` a 0-dim bool tensor
    on the device that is False when a bucket holds more than ``HJ_SLOTS``
    keys or two slots hold one key; the caller then discards the table.
    Ineligible rows (nulls, padding) are never inserted. An overfull bucket
    holds its ``HJ_SLOTS - 1`` lowest rows and, in its last slot, its highest
    row, which is the reference's last write. On the card it is one launcher
    call of csrc/hashjoin.cu (a memset and two kernels), bit for bit
    ``hash_join_build_plain``."""
    h_bits = _check_buckets(num_buckets)
    if keys_i64.dtype != torch.int64 or keys_i64.dim() != 1:
        raise TypeError("hash_join_build takes 1-D int64 keys, got "
                        f"{keys_i64.dtype} of shape {tuple(keys_i64.shape)}")
    if eligible.dtype != torch.bool or eligible.shape != keys_i64.shape:
        raise TypeError("hash_join_build takes a bool eligibility mask "
                        f"shaped like the keys, got {eligible.dtype} "
                        f"{tuple(eligible.shape)}")
    if eligible.device != keys_i64.device:
        raise ValueError(f"hash_join_build: keys on {keys_i64.device}, mask "
                         f"on {eligible.device}")
    dev = keys_i64.device
    if dev.type == "cpu":
        return hash_join_build_plain(keys_i64, eligible, num_buckets)
    if dev.type != "cuda":
        raise TypeError(f"hash_join_build: no kernel for {dev}")
    if not (keys_i64.is_contiguous() and eligible.is_contiguous()):
        raise ValueError("hash_join_build takes contiguous tensors")
    hs = num_buckets * HJ_SLOTS
    table_keys = torch.empty((hs,), dtype=torch.int64, device=dev)
    table_rows = torch.empty((hs,), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    # per bucket its count, then its HJ_SLOTS staging words
    scratch = torch.empty((num_buckets * (1 + HJ_SLOTS),), dtype=torch.int32,
                          device=dev)
    launch = _launcher("hashjoin", "hash_join_build_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(dev.index, keys_i64.data_ptr(), eligible.data_ptr(),
                 keys_i64.numel(), h_bits, scratch.data_ptr(),
                 scratch[num_buckets:].data_ptr(), table_keys.data_ptr(),
                 table_rows.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hash_join_build launch failed: CUDA error {err}")
    _count("hash_join_build")
    return table_keys, table_rows, ok


def hash_join_build_plain(keys_i64: torch.Tensor, eligible: torch.Tensor,
                          num_buckets: int):
    """Plain PyTorch version of ``hash_join_build`` on any device, as the
    reference builds the table: ``radix_ranks_plain`` of the buckets gives
    each key its slot (ranks past the last slot clamp to it), a max-scatter
    writes the rows (so the highest row wins a shared last slot), a gather
    the keys, and the 28 slot pairs of every bucket are compared."""
    h_bits = _check_buckets(num_buckets)
    dev = keys_i64.device
    cap = keys_i64.shape[0]
    hs = num_buckets * HJ_SLOTS
    bucket = torch.where(eligible, hash_join_bucket(keys_i64, h_bits),
                         torch.full_like(keys_i64, num_buckets,
                                         dtype=torch.int32))
    ranks, counts = radix_ranks_plain(bucket, num_buckets)
    ok = counts.max() <= HJ_SLOTS
    slot = (bucket.long() * HJ_SLOTS
            + torch.clamp(ranks, max=HJ_SLOTS - 1).long())
    slot = torch.where(eligible, slot, torch.full_like(slot, hs))
    rows = torch.full((hs + 1,), -1, dtype=torch.int32, device=dev)
    rows.scatter_reduce_(0, slot, torch.arange(cap, dtype=torch.int32,
                                               device=dev), reduce="amax")
    table_rows = rows[:hs]
    keys_ext = torch.cat([keys_i64, torch.full((1,), HJ_EMPTY,
                                               dtype=torch.int64,
                                               device=dev)])
    table_keys = keys_ext[torch.where(table_rows >= 0, table_rows,
                                      cap).long()]
    # a duplicate key lands in one bucket with two ranks: the 28 slot pairs
    # of every bucket are compared, as the reference's static column compares
    t2 = table_keys.view(num_buckets, HJ_SLOTS)
    si, ti = torch.triu_indices(HJ_SLOTS, HJ_SLOTS, offset=1, device=dev)
    a, b = t2[:, si], t2[:, ti]
    dup = ((a == b) & (a != HJ_EMPTY)).any()
    return table_keys, table_rows, ok & ~dup


def hash_join_probe(table_keys: torch.Tensor, table_rows: torch.Tensor,
                    stream_i64: torch.Tensor, num_buckets: int):
    """``(pos int32, found bool)`` per stream key: the build row of the slot
    of the key's bucket that holds the key, or -1. A slot is occupied when its
    row is >= 0, so an empty slot never matches. Validity and liveness of
    stream rows are the caller's mask.

    table_keys: ``(num_buckets * HJ_SLOTS,)`` int64 and table_rows: the same
    length int32, from ``hash_join_build``; stream_i64: ``(n,)`` int64.
    """
    h_bits = _check_buckets(num_buckets)
    hs = num_buckets * HJ_SLOTS
    if table_keys.dtype != torch.int64 or table_keys.shape != (hs,):
        raise TypeError(f"hash_join_probe takes ({hs},) int64 table keys, "
                        f"got {table_keys.dtype} {tuple(table_keys.shape)}")
    if table_rows.dtype != torch.int32 or table_rows.shape != (hs,):
        raise TypeError(f"hash_join_probe takes ({hs},) int32 table rows, "
                        f"got {table_rows.dtype} {tuple(table_rows.shape)}")
    if stream_i64.dtype != torch.int64 or stream_i64.dim() != 1:
        raise TypeError("hash_join_probe takes 1-D int64 stream keys, got "
                        f"{stream_i64.dtype} of shape "
                        f"{tuple(stream_i64.shape)}")
    tensors = (table_keys, table_rows, stream_i64)
    if any(t.device != stream_i64.device for t in tensors):
        raise ValueError("hash_join_probe: inputs on different devices")
    if stream_i64.device.type == "cpu":
        return hash_join_probe_plain(table_keys, table_rows, stream_i64,
                                     num_buckets)
    if stream_i64.device.type != "cuda":
        raise TypeError(f"hash_join_probe: no kernel for {stream_i64.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hash_join_probe takes contiguous tensors")
    if table_keys.data_ptr() % 16 or table_rows.data_ptr() % 16:
        raise ValueError("hash_join_probe reads each bucket with 16-byte "
                         "loads: the tables must be 16-byte aligned")
    n = stream_i64.shape[0]
    pos = torch.empty((n,), dtype=torch.int32, device=stream_i64.device)
    found = torch.empty((n,), dtype=torch.bool, device=stream_i64.device)
    if n == 0:
        return pos, found
    launch = _launcher("hashjoin", "hash_join_probe_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    stream = torch.cuda.current_stream(stream_i64.device).cuda_stream
    err = launch(stream_i64.device.index, table_keys.data_ptr(),
                 table_rows.data_ptr(), stream_i64.data_ptr(), n, h_bits,
                 pos.data_ptr(), found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hash_join_probe launch failed: CUDA error {err}")
    _count("hash_join_probe")
    return pos, found


def hash_join_probe_plain(table_keys: torch.Tensor, table_rows: torch.Tensor,
                          stream_i64: torch.Tensor, num_buckets: int):
    """Plain PyTorch version of ``hash_join_probe`` on any device: the
    bucket's 8 slots compared one after another, the last hit winning as in
    the TPU kernel's loop."""
    h_bits = _check_buckets(num_buckets)
    base = hash_join_bucket(stream_i64, h_bits).long() * HJ_SLOTS
    pos = torch.full(stream_i64.shape, -1, dtype=torch.int32,
                     device=stream_i64.device)
    found = torch.zeros(stream_i64.shape, dtype=torch.bool,
                        device=stream_i64.device)
    for s in range(HJ_SLOTS):
        row = table_rows[base + s]
        hit = (table_keys[base + s] == stream_i64) & (row >= 0)
        pos = torch.where(hit, row, pos)
        found = found | hit
    return pos, found
