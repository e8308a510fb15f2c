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

* ``bitunpack128`` — ``csrc/bitunpack.cu``, replaces
  ``pallas_kernels.bitunpack128`` (parquet RLE_DICTIONARY index unpack).
* ``onehot_sum_f32`` — ``csrc/onehot.cu``, replaces
  ``pallas_kernels.onehot_sum_f32`` (the dense group-by's count-like bucket
  sums).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")

# kernel library name -> CUDA source under csrc/
SOURCES = {"bitunpack": "bitunpack.cu", "onehot": "onehot.cu"}

#: launches of each kernel since the last reset_launches()
launches = {"bitunpack128": 0, "onehot_sum_f32": 0}

_LIBS: dict = {}
_FNS: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
        if lib not in _LIBS:
            build_all([lib])
            _LIBS[lib] = ctypes.CDLL(_so_path(lib))
        fn = getattr(_LIBS[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


# ---------------------------------------------------------------------------
# parquet bit-unpack
# ---------------------------------------------------------------------------

def bitunpack128(words_u32: torch.Tensor, bit_width: int, n: int,
                 capacity: int) -> torch.Tensor:
    """Unpack ``n`` little-endian bit-packed values of ``bit_width`` bits from
    32-bit words into a ``(capacity,)`` int32 tensor; slots >= n are 0. A
    buffer longer than the values need is truncated; a shorter one reads as
    zeros past its end (the Pallas kernel's contract).

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
    launch = _launcher("bitunpack", "bitunpack128_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    out = torch.empty((capacity,), dtype=torch.int32, device=words_u32.device)
    stream = torch.cuda.current_stream(words_u32.device).cuda_stream
    err = launch(
        words_u32.device.index, words_u32.data_ptr(), words_u32.numel(),
        bit_width, n, capacity, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bitunpack128 launch failed: CUDA error {err}")
    launches["bitunpack128"] += 1
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


def onehot_sum_f32(vals: torch.Tensor, codes: torch.Tensor,
                   n_domain: int) -> torch.Tensor:
    """``(n_domain,)`` float32 sums of ``vals`` per code: ``out[d]`` adds the
    rows whose code is ``d``; rows whose code lies outside ``[0, n_domain)``
    are dropped. Counts of 0/1 values are exact below 2^24 rows.

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
    if vals.device.type != "cuda":
        raise TypeError(f"onehot_sum_f32: no kernel for {vals.device}")
    if not (vals.is_contiguous() and codes.is_contiguous()):
        raise ValueError("onehot_sum_f32 takes contiguous tensors")
    out = torch.empty((n_domain,), dtype=torch.float32, device=vals.device)
    if n_domain == 0:
        return out
    launch = _launcher("onehot", "onehot_sum_f32_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = launch(vals.device.index, vals.data_ptr(), codes.data_ptr(),
                 vals.numel(), n_domain, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"onehot_sum_f32 launch failed: CUDA error {err}")
    launches["onehot_sum_f32"] += 1
    return out


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
