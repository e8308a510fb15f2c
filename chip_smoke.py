"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py [--sf 1.0] [--reps 3] [--profile]

It imports the port (``spark_rapids_tpu_torch``) and nothing of JAX, then:

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds every CUDA kernel from ``spark_rapids_tpu_torch/csrc`` with nvcc
   (one process per source, all started together) and prints the build time
   and ptxas' register/shared-memory lines;
3. holds each kernel against its plain PyTorch version on the card:
   bitunpack128 (the chunk decode kernel over one page, no dictionary)
   exactly, at every bit width 1..32 for n = 20,000 (a parquet page) and
   n = 2^20; the chunk decode exactly (values and validity) on every
   dictionary column chunk of the TPC-H q1 scan, and against the per-page
   route it replaced;
   onehot_sum_f32 (the one-request call of the fused count launch) exactly
   on 0/1 values and within 1e-5 of each bucket's sum of magnitudes on
   other float32 values (atomics add in a changing order), at q1's batch
   shape and at the largest dense domain;
   murmur3_words bit for bit at n = 20,000 and 2^20, W = 1..8, lengths
   0..4W of multi-byte UTF-8 rows cut anywhere, scalar and row-varying
   seeds; radix_ranks exactly (ranks and counts) at 2, 5, 9, 129 and 4,096
   lanes, cap 8, 16,384, 2^19 and 2^20, with ids outside the domain, and
   radix_partition_permutation equal to torch's stable argsort;
   hash_join_probe bit for bit (rows and flags) at n = 2^20 against 10,000
   build keys (4,096 buckets) and 200 (128 buckets), about half of the
   stream keys hits, with null rows' zeros and the empty-slot key;
   hash_join_build bit for bit (tables and ok) at 16,384 keys in 4,096
   buckets: unique, overfull, duplicate and ineligible keys;
4. runs five TPC-H paths at scale factor ``--sf`` (data generated from the
   fixed seed into build/) through ``TorchSession()`` on the card:
   q1 (the table directory as one partition: scan, COMPLETE aggregate,
   sort), q1-files (one partition per file: PARTIAL aggregate, hash
   exchange on the keys, AQE reader, FINAL aggregate), q1-repartition
   (``repartition(8, "l_returnflag", "l_linestatus")`` of the whole scan,
   then q1 as in q1-files), q5 (five broadcast hash joins, all on the
   direct-address table, then the dense group-by on ``n_name`` and the
   sort) and q5-sparse (q5 with the supplier join on sparse 64-bit ids,
   whose build takes the hash table: hash_join_build once,
   hash_join_probe once per stream batch). Each path has one run with the
   launch counts reset just before and read just after (every kernel of
   the path must have launched: the chunk decode once per dictionary chunk
   of the q1 scan, the count kernel once per aggregate batch with
   count-like requests, murmur3_words twice and the radix permutation once
   per batch an exchange partitioned, hash_join_probe never on q5, on
   q5-sparse hash_join_build once per hash build and radix_ranks never),
   and its peak device memory; each join prints its build side, probe
   mode, build rows and buckets. Then ``--reps`` timed runs of each path
   (at most ``Q1_REPS`` of each q1 path), the paths in turns; every result
   is held against the NumPy oracle. One more run of each path records the
   inputs it hands to the kernels, and each kernel is held against its
   plain version on them (the fused count launch on every batch of one q1
   and one q5-sparse run, bit for bit);
5. times each kernel, its plain version and, where one exists, the PyTorch
   call that computes the same function, on the paths' inputs, beside the
   least time the card could take (bytes over 3.35 TB/s, operations over
   the float32 peak), and prints each exchange's map-stage host seconds;
   the chunk decode on the q1 scan's chunks also beside every device op of
   the per-page route it replaced; the radix permutation on the exchange
   paths' ids beside torch.argsort(stable=True);
   the fused count launch on one q1 run's batches also beside every device
   op of its route, the per-request chain of the route it replaced
   (``where``, cast and onehot_sum_f32 per request, over today's
   one-request launch), torch.bincount per request and the dense
   aggregate's float sums, with its bound on both bases; for
   hash_join_probe, which no single PyTorch call computes, it also times
   the reference's own alternative on the same inputs (the ``one`` probe
   mode: sorted build keys, torch.searchsorted, one compare, one gather);
   hash_join_build beside torch.sort of its keys (the ``one`` mode's
   build); radix_ranks, which no path calls, on the q5-sparse hash build's
   bucket ids, beside torch.argsort(stable=True);
6. prints one JSON line describing every ported kernel, the card's name and
   power limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero, before printing any result, when no CUDA device is
available, and on any failed phase.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM memory rate and float32 rate outside the tensor cores (NVIDIA
# data sheet, 700 W): the bounds of a kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the chunk decode kernel's symbol, as the profiler names its launches
KERNEL_NAME = "chunk_decode_kernel"
# timed runs of each q1 path: fewer than the q5 paths' --reps, so that the
# five paths at SF1 take no longer than the three q1 paths did before
Q1_REPS = 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean time between one fn() call and the next, from CUDA events around
    reps back-to-back calls. When the host cannot enqueue work as fast as the
    card runs it, this is the host's launch rate, not device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device time of one fn() call from CUDA events around reps calls
    that the host enqueues while the card sleeps, so that the card then runs
    them back to back without waiting on the host (launch gaps included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # ~0.1 s of card clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Mean device time of one fn() call: the summed durations of the device
    activities (kernels, copies, memsets) it ran, traced by torch.profiler
    over reps calls; ``match`` keeps only activities whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a trace can come back without its device records (seen up to three
    # times in a row), so a trace that saw nothing is taken again
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and (match is None or match in e.name))
        if us > 0:
            return us / reps / 1e3
    print(f"device_ms: 5 traces saw no device activity ({match}); timed "
          "with CUDA events around calls queued behind a sleep instead")
    return queued_ms(fn, reps)


def unpack_bound_ms(n: int, bw: int, capacity: int) -> float:
    """Least time for one bitunpack128 call: read n*bw/8 packed bytes once,
    write 4*capacity output bytes once, over the card's memory rate."""
    return (n * bw / 8 + 4 * capacity) / HBM_BYTES_PER_S * 1e3


def onehot_bound_ms(n: int, n_domain: int) -> tuple:
    """(bytes ms, operations ms) of one onehot_sum_f32 call: read n codes
    and n values once and write n_domain sums; n float32 adds."""
    return ((8 * n + 4 * n_domain) / HBM_BYTES_PER_S * 1e3,
            n / F32_OPS_PER_S * 1e3)


def counts_bound_ms(codes, reqs, n_domain: int) -> tuple:
    """(bytes ms, operations ms) of one fused count launch: read the codes
    and each request's mask and values once, as the path hands them in (a
    count of every row has neither), and write the (k, n_domain) sums; one
    float32 add a row a request."""
    n = codes.numel()
    read = 4 * n + sum(
        (0 if v is None else v.numel() * v.element_size())
        + (0 if m is None else n) for v, m in reqs)
    return ((read + 4 * len(reqs) * n_domain) / HBM_BYTES_PER_S * 1e3,
            n * len(reqs) / F32_OPS_PER_S * 1e3)


def counts_check(codes, reqs, n_domain: int) -> float:
    """The fused count launch against its plain version on 0/1 values, bit
    for bit; raises on a difference, else returns 0."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    got = CK.onehot_sums_f32(codes, reqs, n_domain)
    want = CK.onehot_sums_f32_plain(codes, reqs, n_domain)
    if not torch.equal(got, want):
        raise AssertionError(f"onehot_sums_f32 != plain at n={codes.numel()} "
                             f"D={n_domain} k={len(reqs)}")
    return 0.0


def per_request_chain(codes, reqs, n_domain: int):
    """The count route before the fused launch, request by request, over
    today's kernel: a column of ones for a count of every row, the mask
    applied with ``where``, the cast to float32, one onehot_sum_f32 call
    (the one-request launch) and the cast of its sums to int64."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    out = []
    for v, m in reqs:
        if v is None:
            v = torch.ones_like(codes, dtype=torch.bool)
        x = v if m is None else torch.where(m, v, torch.zeros_like(v))
        out.append(CK.onehot_sum_f32(x.to(torch.float32), codes,
                                     n_domain).to(torch.int64))
    return out


def fused_route(codes, reqs, n_domain: int):
    """The count route of ops/grouping.resolve_dense_group_sums: one fused
    call and the casts of its sums to the states' int64 and int32."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    sums = CK.onehot_sums_f32(codes, reqs, n_domain)
    return sums.to(torch.int64), sums.to(torch.int32)


def build_check(keys, eligible, num_buckets: int) -> int:
    """hash_join_build against its plain version, bit for bit (tables and
    ok); raises on a difference, else returns 0."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    got = CK.hash_join_build(keys, eligible, num_buckets)
    want = CK.hash_join_build_plain(keys, eligible, num_buckets)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"hash_join_build != plain at n={keys.numel()} "
                             f"buckets={num_buckets}")
    return 0


def clone_args(obj, memo: dict):
    """A copy of a call's arguments with every tensor cloned once, so that
    tensors the call passed twice (a value that is its own mask) stay one."""
    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            memo[id(obj)] = obj.clone()
        return memo[id(obj)]
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone_args(x, memo) for x in obj)
    return obj


def onehot_check(vals, codes, n_domain: int, exact: bool) -> float:
    """Max |kernel - plain| of onehot_sum_f32; raises past the tolerance:
    exact for 0/1 values, else 1e-5 of each bucket's sum of magnitudes."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    got = CK.onehot_sum_f32(vals, codes, n_domain).double()
    want = CK.onehot_sum_f32_plain(vals, codes, n_domain).double()
    err = float((got - want).abs().max()) if n_domain else 0.0
    if exact:
        ok = torch.equal(got, want)
    else:
        mags = CK.onehot_sum_f32_plain(vals.abs(), codes, n_domain).double()
        ok = bool(((got - want).abs() <= 1e-5 * mags).all())
    if not ok:
        raise AssertionError(f"onehot_sum_f32 != plain at n={vals.numel()} "
                             f"D={n_domain} exact={exact}: max err {err}")
    return err


def chunk_census(lineitem_dir: str):
    """Every column chunk of the q1 scan that the device decode takes (a
    dictionary chunk), read on the host exactly as the scan reads it:
    [(ChunkPages, capacity)], and the count of its data pages."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    from spark_rapids_tpu_torch.io import parquet_native as PN
    chunks, pages = [], 0
    for f in sorted(os.listdir(lineitem_dir)):
        if not f.endswith(".parquet"):
            continue
        path = os.path.join(lineitem_dir, f)
        md = pq.ParquetFile(path).metadata
        for rg in range(md.num_row_groups):
            cap = bucket_capacity(max(md.row_group(rg).num_rows, 1))
            for ci in range(md.num_columns):
                try:
                    chunk = PN.read_chunk_pages(path, rg, ci, md=md)
                except NotImplementedError:
                    continue      # arrow fallback column: no kernel
                chunks.append((chunk, cap))
                pages += len(chunk.index_segments)
    return chunks, pages


def per_page_route(chunk, capacity: int, device):
    """The scan's decode of one chunk before the fused kernel, page by page:
    per page an upload of its words and its def levels, one bitunpack128
    launch, the dictionary gather and the rank spread (RLE pages decode on
    the host and gather); then the concatenation, the padding and the
    canonical nulls. Returns (values, validity), to time against the fused
    decode and to hold it against."""
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    from spark_rapids_tpu_torch.io import parquet_native as PN
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    _st, want, default, dictionary, _sd = PN.chunk_column(chunk, None)
    dict_dev = dictionary.to(device)
    all_vals, all_valid = [], []
    for (num_values, def_levels, bw, page_bytes, values_off, segs) in \
            chunk.index_segments:
        pcap = bucket_capacity(max(num_values, 1))
        n_present = int(def_levels.sum())
        if PN._all_packed(segs):
            vals, valid = PD.decode_dictionary_page(
                np.frombuffer(PN._packed_bytes(page_bytes, segs), np.uint8),
                bw, n_present, def_levels, dict_dev, pcap)
        else:
            idx = PN.decode_rle_host(page_bytes, values_off + 1,
                                     len(page_bytes), bw, n_present) \
                if segs else np.zeros(0, np.int32)
            nd = int(dict_dev.shape[0])
            idx_h = np.zeros(pcap, np.int64)
            idx_h[:len(idx)] = np.clip(idx, 0, max(nd - 1, 0))
            present = (dict_dev[torch.from_numpy(idx_h).to(device)] if nd
                       else torch.zeros((pcap,), dtype=want, device=device))
            dl = torch.zeros((pcap,), dtype=torch.bool)
            dl[:len(def_levels)] = torch.from_numpy(def_levels.astype(bool))
            vals, valid = PD.expand_present_to_rows(present, dl.to(device),
                                                    pcap)
        all_vals.append(vals[:num_values])
        all_valid.append(valid[:num_values])
    vals, valid = torch.cat(all_vals), torch.cat(all_valid)
    n = chunk.num_values
    out_v = torch.zeros((capacity,), dtype=vals.dtype, device=device)
    out_v[:n] = vals[:n]
    out_m = torch.zeros((capacity,), dtype=torch.bool, device=device)
    out_m[:n] = valid[:n]
    fill = torch.tensor(default, dtype=want, device=device)
    return torch.where(out_m, out_v, fill), out_m


def chunk_bound_ms(packed, want, capacity: int) -> float:
    """Least time for one chunk decode: read its packed words, its page
    table, its def levels and its dictionary once, and write the values and
    the validity bytes once, over the card's memory rate."""
    size = torch.empty((), dtype=want).element_size()
    read = (4 * packed.words[1] + 32 * packed.num_pages
            + (packed.defs[1] if packed.defs is not None else 0)
            + size * packed.dictionary[1])
    return (read + (size + 1) * capacity) / HBM_BYTES_PER_S * 1e3


def check_q1(got, exp):
    """bench.py's q1 check: keys exact, numbers within 1e-6 relative."""
    if len(got) != len(exp):
        raise AssertionError(f"q1 rows {len(got)} != oracle {len(exp)}")
    for g_, e in zip(got, exp):
        g = list(g_.values())
        if g[0] != e[0] or g[1] != e[1]:
            raise AssertionError(f"q1 keys {g[:2]} != oracle {e[:2]}")
        for a, b in zip(g[2:], e[2:]):
            if abs(a - b) > 1e-6 * max(1.0, abs(b)):
                raise AssertionError(f"q1 row {g} != oracle {e}")


def murmur3_bound_ms(words, lengths) -> tuple:
    """(bytes ms, operations ms) of one murmur3_words call: read the (n, W)
    words, the lengths and the seeds once and write n hashes; per row 11
    integer operations a mixed word, 15 a tail byte and 8 for fmix, counted
    at the float32 rate (the data sheet gives no int32 rate)."""
    n, W = words.shape
    lens = lengths.long()
    whole = torch.clamp(torch.div(lens, 4, rounding_mode="floor"), 0, W)
    ops = int((11 * whole + 15 * (lens % 4) + 8).sum())
    return ((4 * W + 12) * n / HBM_BYTES_PER_S * 1e3,
            ops / F32_OPS_PER_S * 1e3)


def perm_bound_ms(cap: int) -> float:
    """Least time for one radix_partition_permutation: read cap 4-byte ids
    and write cap 8-byte slots once, over the card's memory rate."""
    return 12 * cap / HBM_BYTES_PER_S * 1e3


def radix_bound_ms(cap: int, num_lanes: int) -> tuple:
    """(bytes ms, operations ms) of one radix_ranks call: read cap ids and
    write cap ranks and num_lanes counts once; about 4 operations a row
    (the range check, the count, the peer match, the rank's add)."""
    return ((8 * cap + 4 * num_lanes) / HBM_BYTES_PER_S * 1e3,
            4 * cap / F32_OPS_PER_S * 1e3)


def utf8_rows(rng, n: int, W: int, dev):
    """(words, lengths) of n random rows of 0..4W bytes drawn from the UTF-8
    of ASCII, "é" and "日本", so that rows end mid-character too."""
    pool = np.frombuffer(("aé日本z" * 8).encode("utf-8"), np.uint8)
    raw = pool[rng.integers(0, len(pool), (n, 4 * W))]
    lens = rng.integers(0, 4 * W + 1, n).astype(np.int32)
    raw = np.where(np.arange(4 * W)[None, :] < lens[:, None], raw, 0)
    words = np.ascontiguousarray(raw.astype(np.uint8)).view("<i4")
    return (torch.from_numpy(words.astype(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev))


def murmur3_check(words, lengths, seed) -> int:
    """murmur3_words against its plain version, bit for bit; raises on a
    difference, else returns 0 (the largest difference)."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    got = CK.murmur3_words(words, lengths, seed)
    want = CK.murmur3_words_plain(words, lengths, seed)
    if not torch.equal(got, want):
        raise AssertionError(f"murmur3_words != plain at n={words.shape[0]} "
                             f"W={words.shape[1]}")
    return 0


def radix_check(ids, num_lanes: int, in_domain: bool) -> int:
    """radix_ranks (ranks and counts) against its plain version exactly,
    and, for ids all inside the domain, radix_partition_permutation against
    torch's stable argsort; raises on a difference, else returns 0."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    ranks, counts = CK.radix_ranks(ids, num_lanes)
    want_r, want_c = CK.radix_ranks_plain(ids, num_lanes)
    if not (torch.equal(ranks, want_r) and torch.equal(counts, want_c)):
        raise AssertionError(f"radix_ranks != plain at cap={ids.numel()} "
                             f"lanes={num_lanes}")
    if in_domain:
        perm = CK.radix_partition_permutation(ids, num_lanes)
        if not torch.equal(perm, torch.argsort(ids, stable=True)):
            raise AssertionError(
                f"radix_partition_permutation != stable argsort at "
                f"cap={ids.numel()} lanes={num_lanes}")
    return 0


def check_q5(got, exp):
    """bench.py's q5 check: nation names exact, revenue within 1e-6
    relative."""
    if len(got) != len(exp):
        raise AssertionError(f"q5 rows {len(got)} != oracle {len(exp)}")
    for g, (n, v) in zip(got, exp):
        if g["n_name"] != n or abs(g["revenue"] - v) > 1e-6 * max(1.0,
                                                                  abs(v)):
            raise AssertionError(f"q5 row {g} != oracle {(n, v)}")


def probe_bound_ms(n: int, num_buckets: int) -> float:
    """Least time for one hash_join_probe call: read n 8-byte keys and
    write n 4-byte rows and n 1-byte flags, and read the table of 8 slots
    of 8 + 4 bytes per bucket once, over the card's memory rate."""
    return (n * (8 + 4 + 1) + 8 * num_buckets * 12) / HBM_BYTES_PER_S * 1e3


def probe_inputs(rng, n: int, n_build: int, dev):
    """(build keys, stream keys) on the card: n_build sparse unique int64
    keys about 10^10 apart (a third negative), and n stream keys of which
    about half are hits, 5 % null rows' canonical 0, and the first the
    empty-slot key int64 min."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    keys = (rng.permutation(n_build).astype(np.int64) + 1) * 9_999_991_337
    keys[::3] *= -1
    stream = np.where(rng.random(n) < 0.5, rng.choice(keys, n),
                      rng.integers(-2**62, 2**62, n)).astype(np.int64)
    stream[rng.random(n) < 0.05] = 0
    stream[0] = CK.HJ_EMPTY
    return (torch.from_numpy(keys).to(dev), torch.from_numpy(stream).to(dev))


def probe_check(tk, tr, stream, num_buckets: int) -> int:
    """hash_join_probe against its plain version, bit for bit (rows and
    flags); raises on a difference, else returns 0."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    pos, found = CK.hash_join_probe(tk, tr, stream, num_buckets)
    want_pos, want_found = CK.hash_join_probe_plain(tk, tr, stream,
                                                    num_buckets)
    if not (torch.equal(pos, want_pos) and torch.equal(found, want_found)):
        raise AssertionError(f"hash_join_probe != plain at "
                             f"n={stream.numel()} buckets={num_buckets}")
    return 0


def one_mode_inputs(tk, tr):
    """The build the reference's ``one`` probe mode would hold for the same
    table: its keys sorted once, and their build rows in that order."""
    occupied = tr >= 0
    keys, order = torch.sort(tk[occupied])
    return keys, tr[occupied][order]


def one_mode_probe(sorted_keys, rows, stream):
    """``(pos, found)`` by the ``one`` mode's formulation: one
    torch.searchsorted, one compare, one gather."""
    lo = torch.clamp(torch.searchsorted(sorted_keys, stream),
                     max=sorted_keys.numel() - 1)
    found = sorted_keys[lo] == stream
    return torch.where(found, rows[lo], -1), found


def joins(plan) -> list:
    """The hash joins of an exec tree, top down."""
    from spark_rapids_tpu_torch.exec.joins import HashJoinExec
    out = [plan] if isinstance(plan, HashJoinExec) else []
    for c in plan.children:
        out += joins(c)
    return out


def exchanges(plan) -> list:
    """The shuffle exchanges of an exec tree, top down."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    out = [plan] if isinstance(plan, ShuffleExchangeExec) else []
    for c in plan.children:
        out += exchanges(c)
    return out


def profile_run(label: str, run, repo: str) -> None:
    """Trace one run with torch.profiler (device busy time, the largest
    device items) and profile it once more on the host with cProfile."""
    import collections
    import cProfile
    import io
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = collections.Counter()
    launched = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
            launched[e.name] += 1
    dev_s = sum(by_kernel.values()) / 1e6
    print(f"profile {label}: wall {wall:.4f} s, device kernel time "
          f"{dev_s:.4f} s, device idle share {1 - dev_s / wall:.4f}, "
          f"{sum(launched.values())} kernel launches")
    for kname, us in by_kernel.most_common(12):
        print(f"  {us / 1e3:10.3f} ms {launched[kname]:6d}x {kname[:90]}")
    prof_host = cProfile.Profile()
    prof_host.enable()
    run()
    torch.cuda.synchronize()
    prof_host.disable()
    buf = io.StringIO()
    pstats.Stats(prof_host, stream=buf).sort_stats("cumulative") \
        .print_stats("spark_rapids_tpu_torch", 18)
    print(f"host profile {label} (cProfile, cumulative s, port functions):")
    for ln in buf.getvalue().splitlines():
        if "spark_rapids_tpu_torch" in ln or "ncalls" in ln:
            print("  " + ln.replace(repo + os.sep, ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the q1 run (default 1.0)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs of each path after the first (default "
                         "3; at most Q1_REPS for the q1 paths)")
    ap.add_argument("--map-threads", type=int, default=None,
                    help="spark.rapids.tpu.sql.localScheduler.numThreads "
                         "of the session (default: the conf's default)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one run of each path with "
                         "torch.profiler and cProfile")
    args = ap.parse_args()
    # progress must survive a kill at a time limit, so flush every line
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    info = CK.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    for lib, bi in info.items():
        print(f"build {lib}: {bi['seconds']:.2f} s nvcc")
        for ln in bi["ptxas"]:
            print(f"  {ln}")

    # -- 2. kernel vs plain at fixed shapes ---------------------------------
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    rng = np.random.default_rng(20260729)
    max_err = 0
    shape_rows = []
    for n in (20_000, 1 << 20):
        cap = bucket_capacity(n)
        for bw in range(1, 33):
            # the TPU kernel's input length, ceil(n/128)*4*bw words: longer
            # than the values need, so the truncation rule is exercised
            nw = -(-n // 128) * 4 * bw
            words = torch.from_numpy(
                rng.integers(-2**31, 2**31, nw, dtype=np.int64)
                .astype(np.int32)).to(dev)
            got = CK.bitunpack128(words, bw, n, cap)
            want = CK.bitunpack128_plain(words, bw, n, cap)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(
                    f"bitunpack128 != plain at bw={bw} n={n}: max err {err}")

            def kernel():
                CK.bitunpack128(words, bw, n, cap)

            def plain():
                CK.bitunpack128_plain(words, bw, n, cap)
            shape_rows.append((n, bw, device_ms(kernel, 20, KERNEL_NAME),
                               device_ms(plain, 5), call_ms(kernel, 100),
                               unpack_bound_ms(n, bw, cap)))
    print("bitunpack128 n bw kernel_device_ms plain_device_ms "
          "kernel_call_ms bound_ms")
    for n, bw, k, p, c, b in shape_rows:
        print(f"  {n} {bw} {k:.6f} {p:.6f} {c:.6f} {b:.6f}")

    # onehot_sum_f32 at q1's batch shape (2^20 rows, 4 x 3 key codes) and
    # at the largest dense domain; -2, -1, D and D+1 are outside and drop
    oh_err = 0.0
    for n, dom in ((1 << 20, 12), (1 << 20, 4096)):
        codes = torch.from_numpy(
            rng.integers(-2, dom + 2, n).astype(np.int32)).to(dev)
        ones = torch.from_numpy(
            (rng.random(n) < 0.7).astype(np.float32)).to(dev)
        vals = torch.from_numpy(
            rng.normal(0, 10, n).astype(np.float32)).to(dev)
        oh_err = max(oh_err, onehot_check(ones, codes, dom, True),
                     onehot_check(vals, codes, dom, False))
    print(f"onehot_sum_f32 random inputs: max |kernel - plain| {oh_err}")
    # the fused count launch bit for bit on 0/1 values of every type and on
    # counts of every row (no column), with masks and values that are their
    # own mask, a tenth of the rows dropped with the code dom as the dense
    # aggregate drops the rows that are not live, at q1's batch and merge
    # shapes and past one launch's requests
    for n, dom, k in ((1 << 20, 12, 6), (8, 12, 8),
                      (20_000, 4096, CK.ONEHOT_MAX_REQUESTS + 1)):
        codes = torch.from_numpy(np.where(
            rng.random(n) < 0.9, rng.integers(-2, dom + 2, n),
            dom).astype(np.int32)).to(dev)
        reqs = []
        for j in range(k):
            t = (np.bool_, np.int32, np.int64, np.float32)[j % 4]
            v = torch.from_numpy((rng.random(n) < 0.7).astype(t)).to(dev)
            reqs.append((None if j % 5 == 4 else v,
                         None if j % 3 == 2 else torch.from_numpy(
                             rng.random(n) < 0.8).to(dev)))
        counts_check(codes, reqs, dom)
    print("onehot_sums_f32 random 0/1 inputs: bit for bit")

    # murmur3_words bit for bit: a page-sized and a batch-sized n, W 1..8,
    # lengths 0..4W of multi-byte UTF-8 cut anywhere, scalar and per-row
    # seeds; device times at W = 1, 2, 8
    mm_err = 0
    mm_rows = []
    for n in (20_000, 1 << 20):
        for W in range(1, 9):
            words, lens = utf8_rows(rng, n, W, dev)
            seeds = torch.from_numpy(rng.integers(
                -2**31, 2**31, n).astype(np.int32)).to(dev)
            mm_err = max(mm_err, murmur3_check(words, lens, 42),
                         murmur3_check(words, lens, seeds))
            if W in (1, 2, 8):
                mm_rows.append((n, W, device_ms(
                    lambda: CK.murmur3_words(words, lens, seeds), 20,
                    "murmur3_words_kernel"), device_ms(
                    lambda: CK.murmur3_words_plain(words, lens, seeds), 3),
                    murmur3_bound_ms(words, lens)[0]))
    torch.cuda.synchronize()
    print("murmur3_words n W kernel_device_ms plain_device_ms bound_ms")
    for n, W, k, p_, b in mm_rows:
        print(f"  {n} {W} {k:.6f} {p_:.6f} {b:.6f}")

    # radix_ranks exactly, with ids outside the domain (-1 and past it);
    # the permutation against torch's stable argsort on ids inside it
    rx_err = 0
    rx_rows = []
    for lanes in (2, 5, 9, 129, 4096):
        for cap in (8, 16_384, 1 << 19, 1 << 20):
            ids = torch.from_numpy(rng.integers(
                -1, lanes + 2, cap).astype(np.int32)).to(dev)
            inside = torch.from_numpy(rng.integers(
                0, lanes, cap).astype(np.int32)).to(dev)
            rx_err = max(rx_err, radix_check(ids, lanes, False),
                         radix_check(inside, lanes, True))
            if cap == 1 << 20 or (cap, lanes) == (16_384, 4096):
                rx_rows.append((cap, lanes, device_ms(
                    lambda: CK.radix_ranks(inside, lanes), 20, "radix_"),
                    device_ms(lambda: CK.radix_ranks_plain(inside, lanes), 3),
                    device_ms(lambda: torch.argsort(inside, stable=True), 5),
                    device_ms(lambda: CK.radix_partition_permutation(
                        inside, lanes), 20, "radix_"),
                    radix_bound_ms(cap, lanes)[0], perm_bound_ms(cap)))
    torch.cuda.synchronize()
    print("radix cap lanes ranks_kernel_device_ms ranks_plain_device_ms "
          "argsort_device_ms permutation_kernel_device_ms ranks_bound_ms "
          "permutation_bound_ms")
    for cap, lanes, k, p_, a_, pk, b, pb in rx_rows:
        print(f"  {cap} {lanes} {k:.6f} {p_:.6f} {a_:.6f} {pk:.6f} {b:.6f} "
              f"{pb:.6f}")

    # hash_join_probe bit for bit at the two table sizes a path can give
    # (the SF1 supplier build, 10,000 keys in 4,096 buckets; a small build
    # in the fewest, 128 buckets); device times beside the one-mode
    # formulation on the same inputs
    hj_err = 0
    hj_rows = []
    for n, n_build in ((1 << 20, 10_000), (1 << 20, 200)):
        keys, stream = probe_inputs(rng, n, n_build, dev)
        nb = CK.hash_join_buckets(n_build)
        tk, tr, ok = CK.hash_join_build(
            keys, torch.ones(n_build, dtype=torch.bool, device=dev), nb)
        if not bool(ok):
            raise AssertionError(f"hash_join_build refused {n_build} "
                                 f"sparse keys in {nb} buckets")
        hj_err = max(hj_err, probe_check(tk, tr, stream, nb))
        sk, rows = one_mode_inputs(tk, tr)
        if not torch.equal(one_mode_probe(sk, rows, stream)[1],
                           CK.hash_join_probe(tk, tr, stream, nb)[1]):
            raise AssertionError("the one-mode formulation disagrees with "
                                 "hash_join_probe")
        hj_rows.append((n, n_build, nb, device_ms(
            lambda: CK.hash_join_probe(tk, tr, stream, nb), 20,
            "hash_join_probe_kernel"), device_ms(
            lambda: CK.hash_join_probe_plain(tk, tr, stream, nb), 5),
            device_ms(lambda: one_mode_probe(sk, rows, stream), 10),
            probe_bound_ms(n, nb)))
    torch.cuda.synchronize()
    print("hash_join_probe n build_keys buckets kernel_device_ms "
          "plain_device_ms one_mode_device_ms bound_ms")
    for n, n_build, nb, k, p_, o_, b in hj_rows:
        print(f"  {n} {n_build} {nb} {k:.6f} {p_:.6f} {o_:.6f} {b:.6f}")

    # hash_join_build bit for bit at the largest build (16,384 keys, 4,096
    # buckets): 10,000 eligible sparse keys as q5-sparse's, then every key
    # (some buckets overfill), 12 keys of one bucket, a duplicate key, and
    # 60 % eligible
    hb_err = 0
    keys, _ = probe_inputs(rng, 1, 16_384, dev)
    first = torch.arange(16_384, device=dev) < 10_000
    pool = torch.arange(1, 1 << 22, dtype=torch.int64, device=dev) * 7919
    crowd = pool[CK.hash_join_bucket(pool, 12) == 0][:12]
    crowded = keys.clone()
    crowded[torch.linspace(0, 16_383, 12, device=dev).long()] = crowd
    dup = keys.clone()
    dup[8_000] = dup[3]
    ineligible = torch.from_numpy(rng.random(16_384) < 0.6).to(dev)
    every = torch.ones(16_384, dtype=torch.bool, device=dev)
    for k, e in ((keys, first), (keys, every), (crowded, every),
                 (dup, first), (keys, ineligible)):
        hb_err = max(hb_err, build_check(k, e, 4096))
    print("hash_join_build at (16,384, 4,096): bit for bit on 5 cases")

    # -- 3. q1 data and its chunk census -------------------------------------
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.io import parquet_native as PN
    from spark_rapids_tpu_torch.session import TorchSession
    data_dir = os.path.join(repo, "build", f"tpch_sf{args.sf:g}")
    t0 = time.perf_counter()
    paths = tpch.generate(args.sf, data_dir)
    print(f"data: sf={args.sf:g} at {data_dir} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    census, census_pages = chunk_census(paths["lineitem"])
    print(f"census: {len(census)} dictionary chunks (one chunk decode "
          f"launch each) holding {census_pages} data pages, "
          f"{time.perf_counter() - t0:.1f} s")
    if not census:
        raise AssertionError("the q1 scan has no chunk for the chunk decode")
    # each chunk packed and on the card, as the scan hands it to the kernel
    dev_chunks = []
    for chunk, cap in census:
        _st, want, default, dictionary, _sd = PN.chunk_column(chunk, None)
        packed = PN.pack_chunk(chunk, dictionary, cap, pin=True)
        views = PN.chunk_views(packed.buf.to(dev, non_blocking=True), packed,
                               want)
        dev_chunks.append((views, packed.n_rows, cap, want, default,
                           chunk_bound_ms(packed, want, cap)))
    for (chunk, cap), (views, n_rows, _c, want, default, _b) in zip(
            census, dev_chunks):
        got = CK.chunk_decode(*views, n_rows, cap, want, default)
        plain = CK.chunk_decode_plain(*views, n_rows, cap, want, default)
        old = per_page_route(chunk, cap, dev)
        for a, b, what in ((got, plain, "its plain version"),
                           (got, old, "the per-page route")):
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(
                    f"chunk decode != {what} on a q1 chunk of "
                    f"{len(chunk.index_segments)} pages ({want})")
    torch.cuda.synchronize()

    def all_chunks(fn):
        def run():
            for views, n_rows, cap, want, default, _b in dev_chunks:
                fn(*views, n_rows, cap, want, default)
        return run

    def routes(fn):
        def run():
            for chunk, cap in census:
                fn(chunk, cap)
        return run

    def wall_s(run) -> float:
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    chunk_ms = device_ms(all_chunks(CK.chunk_decode), 3, KERNEL_NAME)
    chunk_plain_ms = device_ms(all_chunks(CK.chunk_decode_plain), 2)
    chunk_call_ms = call_ms(all_chunks(CK.chunk_decode), 5, 1)
    chunk_bound = sum(c[-1] for c in dev_chunks)
    fused = routes(lambda chunk, cap: PN.chunk_to_device(chunk, None, cap,
                                                         dev))
    per_page = routes(lambda chunk, cap: per_page_route(chunk, cap, dev))
    fused_ms, per_page_ms = device_ms(fused, 2), device_ms(per_page, 2)
    fused_s, per_page_s = wall_s(fused), wall_s(per_page)
    print(f"q1 chunks: {len(dev_chunks)} chunk decode launches for "
          f"{census_pages} pages; kernel {chunk_ms:.4f} ms device "
          f"({chunk_call_ms:.4f} ms enqueued back to back), plain "
          f"{chunk_plain_ms:.4f} ms device, bound {chunk_bound:.6f} ms "
          f"(bytes) per q1 scan")
    print(f"q1 chunks, whole device side of the decode per q1 scan: fused "
          f"route (pack, one pinned copy, one launch a chunk) "
          f"{fused_ms:.4f} ms of device ops, {fused_s:.4f} s host wall; "
          f"per-page route (two pageable copies and ~10 ops a page) "
          f"{per_page_ms:.4f} ms of device ops, {per_page_s:.4f} s host "
          f"wall")
    del dev_chunks

    # -- 4. the five paths through the session on the card -----------------
    spark = TorchSession(
        {} if args.map_threads is None else
        {"spark.rapids.tpu.sql.localScheduler.numThreads": args.map_threads})
    exp_q1 = tpch.np_q1(tpch.load_np({"lineitem": paths["lineitem"]}))
    exp_q5 = tpch.np_q5(tpch.load_np(paths))
    li_dir = paths["lineitem"]
    li_files = sorted(os.path.join(li_dir, f) for f in os.listdir(li_dir)
                      if f.endswith(".parquet"))
    all_paths = {
        # the table directory: one partition, a COMPLETE aggregate
        "q1": lambda: tpch.q1(tpch.load(spark, paths)),
        # one partition per file: PARTIAL -> hash exchange -> FINAL
        "q1-files": lambda: tpch.q1(
            {"lineitem": spark.read_parquet(li_files)}),
        # the whole scan through a hash exchange on q1's keys, then q1
        "q1-repartition": lambda: tpch.q1({"lineitem": spark.read_parquet(
            li_dir).repartition(8, "l_returnflag", "l_linestatus")}),
        # five broadcast hash joins on the direct-address table
        "q5": lambda: tpch.q5(tpch.load(spark, paths)),
        # the supplier join on sparse ids: the hash table
        "q5-sparse": lambda: tpch.q5_sparse(tpch.load(spark, paths)),
    }
    q1_labels = ("q1", "q1-files", "q1-repartition")

    def check(label, res):
        if label in q1_labels:
            check_q1(res.to_pylist(), exp_q1)
        else:
            check_q5(res.to_pylist(), exp_q5)
    exchange_kernels = ("bitunpack128", "onehot_sum_f32", "murmur3_words",
                        "radix_ranks")
    path_kernels = {"q1": ("bitunpack128", "onehot_sum_f32"),
                    "q1-files": exchange_kernels,
                    "q1-repartition": exchange_kernels,
                    "q5": ("bitunpack128", "onehot_sum_f32"),
                    "q5-sparse": ("bitunpack128", "onehot_sum_f32",
                                  "hash_join_build", "hash_join_probe")}
    # the dense aggregate's batches, counted beside the launches: each batch
    # with count-like requests is one count launch (at most
    # ONEHOT_MAX_REQUESTS distinct requests each)
    from spark_rapids_tpu_torch.ops import grouping as G
    resolve = G.resolve_dense_group_sums
    agg_batches = []

    def counting_resolve(reqs, codes, n_domain, live):
        if codes.shape[0] < (1 << 24):
            agg_batches.append(len({(id(v), id(m))
                                    for v, m, _a, cl in reqs if cl}))
        return resolve(reqs, codes, n_domain, live)
    counts_by_path = {}
    batches_by_path = {}
    peak_by_path = {}
    for label, make_df in all_paths.items():
        plan = make_df().physical_plan()
        torch.cuda.reset_peak_memory_stats(dev)
        agg_batches.clear()
        G.resolve_dense_group_sums = counting_resolve
        CK.reset_launches()
        t0 = time.perf_counter()
        try:
            res = plan.execute_collect()
        finally:
            G.resolve_dense_group_sums = resolve
        first_s = time.perf_counter() - t0
        counts = dict(CK.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        check(label, res)
        for k in path_kernels[label]:
            if counts[k] <= 0:
                raise AssertionError(
                    f"kernel {k} never launched on the {label} path")
        count_batches = [k for k in agg_batches if k]
        if (any(k > CK.ONEHOT_MAX_REQUESTS for k in count_batches)
                or counts["onehot_sum_f32"] != len(count_batches)):
            raise AssertionError(
                f"{label}: {len(count_batches)} aggregate batches with "
                f"count-like requests ({count_batches} distinct requests) "
                f"but the count kernel launched {counts['onehot_sum_f32']} "
                f"times (want one launch a batch)")
        batches_by_path[label] = count_batches
        exs = exchanges(plan)
        batches = sum(e.map_batches for e in exs)
        if label in q1_labels:
            if counts["bitunpack128"] != len(census):
                raise AssertionError(
                    f"{label}: the chunk decode launched "
                    f"{counts['bitunpack128']} times, the scan has "
                    f"{len(census)} dictionary chunks")
            if (counts["murmur3_words"] != 2 * batches
                    or counts["radix_ranks"] != batches):
                raise AssertionError(
                    f"{label}: {batches} partitioned batches (two string "
                    f"keys each) but murmur3_words launched "
                    f"{counts['murmur3_words']} and radix_ranks "
                    f"{counts['radix_ranks']} times")
        js = joins(plan)
        hashed = [j for j in js if j.stats["probe_mode"] == "hash"]
        hash_builds = len(hashed) + sum(j.stats["hash_refused"] for j in js)
        if label == "q5" and (hashed or counts["hash_join_probe"]):
            raise AssertionError(
                f"q5 took the hash table: {len(hashed)} hash joins, "
                f"{counts['hash_join_probe']} hash_join_probe launches")
        if label == "q5-sparse":
            probed = sum(j.stats["stream_batches"] for j in hashed)
            if len(hashed) != 1 or counts["hash_join_probe"] != probed:
                raise AssertionError(
                    f"q5-sparse: {len(hashed)} hash joins probed {probed} "
                    f"stream batches, hash_join_probe launched "
                    f"{counts['hash_join_probe']} times (want one join, "
                    f"one launch per stream batch)")
            if (counts["hash_join_build"] != hash_builds
                    or counts["radix_ranks"] != 0):
                raise AssertionError(
                    f"q5-sparse: {hash_builds} hash builds, hash_join_build "
                    f"launched {counts['hash_join_build']} and radix_ranks "
                    f"{counts['radix_ranks']} times (want one build launch "
                    f"a hash build and no radix_ranks)")
        counts_by_path[label] = counts
        peak_by_path[label] = peak
        print(f"{label} first run: {first_s:.3f} s; launches {counts}; "
              f"{len(count_batches)} aggregate batches with count-like "
              f"requests, distinct requests each {count_batches}; peak "
              f"device memory {peak} B")
        for e in exs:
            print(f"{label} exchange {e.args_string()} over "
                  f"{e.child.num_partitions} map partitions: "
                  f"{e.map_batches} batches partitioned in "
                  f"{e.partition_seconds:.4f} s host (partition + write); "
                  f"map stage {e.map_seconds:.4f} s host wall, child "
                  f"included")
        for j in js:
            st = j.stats
            print(f"{label} join {j.join_type}: build {j.build_side} "
                  f"{j.exchange.output.names}, {st['build_rows']} rows, "
                  f"probe mode {st['probe_mode']}, buckets "
                  f"{st['hash_buckets']}, hash builds refused "
                  f"{st['hash_refused']}; {st['stream_batches']} stream "
                  f"batches; build {j.exchange.build_seconds:.4f} s host")

    # timed runs, the paths taken in turns (forward, then backward) so that
    # the shared host's drift falls on all of them alike
    times = {label: [] for label in all_paths}
    order = list(all_paths)
    for rep in range(args.reps):
        for label in (order if rep % 2 == 0 else order[::-1]):
            if label in q1_labels and rep >= Q1_REPS:
                continue
            t0 = time.perf_counter()
            res = all_paths[label]().collect()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
            check(label, res)
    for label, ts in times.items():
        if ts:
            print(f"{label} sf={args.sf:g} on {name}: median "
                  f"{statistics.median(ts):.4f} s, min {min(ts):.4f} s, "
                  f"max {max(ts):.4f} s over {len(ts)} runs: "
                  f"{[round(t, 4) for t in ts]}; peak device memory "
                  f"{peak_by_path[label]} B")

    # the inputs the paths hand to the kernels: the fused count launch in
    # one q1 and one q5-sparse run (and q1's whole batches, for the float
    # sums beside it); murmur3_words and radix_partition_permutation in one
    # run of each exchange path; hash_join_probe and hash_join_build in one
    # q5-sparse run. The permutation counts its launches under radix_ranks,
    # the fused count launch under onehot_sum_f32.
    recorded = {"onehot_sums_f32": [], "murmur3_words": [],
                "radix_partition_permutation": [], "hash_join_probe": [],
                "hash_join_build": []}
    counter_of = {"radix_partition_permutation": "radix_ranks",
                  "onehot_sums_f32": "onehot_sum_f32"}
    launchers = {k: getattr(CK, k) for k in recorded}
    q1_batches = []

    def recorder(call, into):
        def record(*args_):
            into.append(clone_args(args_, {}))
            return call(*args_)
        return record
    exchange_knames = ["murmur3_words", "radix_partition_permutation"]
    for label, knames in (("q1", ["onehot_sums_f32"]),
                          ("q1-files", exchange_knames),
                          ("q1-repartition", exchange_knames),
                          ("q5-sparse", ["onehot_sums_f32", "hash_join_probe",
                                         "hash_join_build"])):
        before = {k: len(recorded[k]) for k in knames}
        for k in knames:
            setattr(CK, k, recorder(launchers[k], recorded[k]))
        if label == "q1":
            G.resolve_dense_group_sums = recorder(resolve, q1_batches)
        try:
            check(label, all_paths[label]().collect())
        finally:
            for k in knames:
                setattr(CK, k, launchers[k])
            G.resolve_dense_group_sums = resolve
        for k in knames:
            got = len(recorded[k]) - before[k]
            counted = counts_by_path[label].get(counter_of.get(k, k))
            if counted is not None and got != counted:
                raise AssertionError(
                    f"recorded {got} {k} calls on {label}, the counted run "
                    f"launched {counted}")

    oh_calls = recorded["onehot_sums_f32"]
    # every batch the two runs counted, bit for bit; then q1's alone
    oh_err = max([oh_err] + [counts_check(*a) for a in oh_calls])
    oh_calls = oh_calls[:counts_by_path["q1"]["onehot_sum_f32"]]
    mm_err = max([murmur3_check(*a) for a in recorded["murmur3_words"]],
                 default=mm_err)
    rx_err = max([radix_check(ids, lanes, True) for ids, lanes
                  in recorded["radix_partition_permutation"]], default=rx_err)
    torch.cuda.synchronize()

    def each_call(fn, calls):
        def run():
            for a in calls:
                fn(*a)
        return run

    def bincount_calls(calls):
        """Per request, what torch.bincount takes: its values as float32
        with the rows outside its mask zeroed (made here, outside the
        timing), or no weights for a count of every row, and the codes."""
        out = []
        for codes, reqs, dom in calls:
            for v, m in reqs:
                w = None if v is None else v.to(torch.float32)
                if m is not None:
                    w = torch.where(m, w, torch.zeros_like(w))
                out.append((codes, w, dom))
        return out

    def bincount(codes, w, dom):
        # codes of dropped rows are dom (the pad bucket), never negative
        return torch.bincount(codes, weights=w, minlength=dom)[:dom]
    bc_calls = bincount_calls(oh_calls)
    oh_ms = device_ms(each_call(CK.onehot_sums_f32, oh_calls), 5,
                      "onehot_sums_kernel")
    oh_plain_ms = device_ms(each_call(CK.onehot_sums_f32_plain, oh_calls), 3)
    oh_lib_ms = device_ms(each_call(bincount, bc_calls), 5)
    oh_route_ms = device_ms(each_call(fused_route, oh_calls), 5)
    oh_chain_ms = device_ms(each_call(per_request_chain, oh_calls), 3)
    oh_call_ms = call_ms(each_call(CK.onehot_sums_f32, oh_calls), 5, 1)
    oh_bytes_ms, oh_ops_ms = (sum(x) for x in zip(*(
        counts_bound_ms(*a) for a in oh_calls)))
    oh_bound_ms = max(oh_bytes_ms, oh_ops_ms)
    oh_bound_by = "bytes" if oh_bytes_ms >= oh_ops_ms else "operations"
    # PR 4's basis: 8 B a row a request (a float32 value and a code)
    oh_old_bound_ms = sum(onehot_bound_ms(c.numel(), dom)[0] * len(r)
                          for c, r, dom in oh_calls)
    # the dense aggregate's float sums on the same batches (stacked f64
    # matvecs, not a kernel), every other request left out
    float_batches = [([r for r in reqs if not r[3] and r[2].is_floating_point],
                      codes, dom, live)
                     for reqs, codes, dom, live in q1_batches]
    float_ms = device_ms(each_call(resolve, float_batches), 3)
    shapes = sorted({(c.numel(), dom, len(r)) for c, r, dom in oh_calls})
    print(f"q1 count kernel (onehot_sums_f32): {len(oh_calls)} launches for "
          f"{len(batches_by_path['q1'])} aggregate batches at (n, D, k) "
          f"{shapes}; kernel {oh_ms:.4f} ms device ({oh_call_ms:.4f} ms "
          f"enqueued back to back), plain {oh_plain_ms:.4f} ms, every device "
          f"op of the fused route (memset, kernel, casts of the sums) "
          f"{oh_route_ms:.4f} ms, the per-request chain over today's kernel "
          f"(where, cast, onehot_sum_f32, cast per request) "
          f"{oh_chain_ms:.4f} ms, "
          f"torch.bincount per request {oh_lib_ms:.4f} ms; bound "
          f"{oh_bound_ms:.6f} ms ({oh_bound_by}; codes and each request's "
          f"inputs once), {oh_old_bound_ms:.6f} ms on the "
          f"per-request basis (8 B a row a request); the float sums of the "
          f"same {len(float_batches)} batches (stacked f64 matvecs) "
          f"{float_ms:.4f} ms device per q1 run")

    # murmur3_words and radix_ranks: one run of q1-files plus one of
    # q1-repartition, every call as the paths made it
    mm_calls = recorded["murmur3_words"]
    mm_ms = device_ms(each_call(CK.murmur3_words, mm_calls), 5,
                      "murmur3_words_kernel")
    mm_plain_ms = device_ms(each_call(CK.murmur3_words_plain, mm_calls), 3)
    mm_call_ms = call_ms(each_call(CK.murmur3_words, mm_calls), 5, 1)
    mm_bytes_ms, mm_ops_ms = (sum(x) for x in zip(*(
        murmur3_bound_ms(w, ln) for w, ln, _s in mm_calls)))
    mm_bound_ms = max(mm_bytes_ms, mm_ops_ms)
    mm_bound_by = "bytes" if mm_bytes_ms >= mm_ops_ms else "operations"
    shapes = sorted({tuple(w.shape) for w, _l, _s in mm_calls})
    print(f"exchange paths murmur3_words: {len(mm_calls)} launches at "
          f"(n, W) {shapes}; kernel {mm_ms:.4f} ms device ({mm_call_ms:.4f} "
          f"ms enqueued back to back), plain {mm_plain_ms:.4f} ms, bound "
          f"{mm_bound_ms:.6f} ms ({mm_bound_by}; bytes {mm_bytes_ms:.6f}, "
          f"operations {mm_ops_ms:.6f}); no PyTorch call hashes strings")

    # radix_partition_permutation: every call of one q1-files and one
    # q1-repartition run; beside it the stable argsort that computes the
    # same permutation, and radix_ranks on the same ids
    rx_calls = recorded["radix_partition_permutation"]

    def argsort(ids, lanes):
        return torch.argsort(ids, stable=True)
    rx_ms = device_ms(each_call(CK.radix_partition_permutation, rx_calls), 5,
                      "radix_")
    rx_plain_ms = device_ms(each_call(CK.radix_partition_permutation_plain,
                                      rx_calls), 3)
    rx_lib_ms = device_ms(each_call(argsort, rx_calls), 5)
    rx_ranks_ms = device_ms(each_call(CK.radix_ranks, rx_calls), 5, "radix_")
    rx_all_ms = device_ms(each_call(CK.radix_partition_permutation,
                                    rx_calls), 5)
    rx_call_ms = call_ms(each_call(CK.radix_partition_permutation, rx_calls),
                         5, 1)
    rx_bound_ms = sum(perm_bound_ms(ids.numel()) for ids, _l in rx_calls)
    shapes = sorted({(ids.numel(), lanes) for ids, lanes in rx_calls})
    print(f"exchange paths radix_partition_permutation: {len(rx_calls)} "
          f"calls at (cap, lanes) {shapes}; kernels {rx_ms:.4f} ms device "
          f"(every device op of the call {rx_all_ms:.4f} ms; "
          f"{rx_call_ms:.4f} ms enqueued back to back), plain "
          f"{rx_plain_ms:.4f} ms, torch.argsort(stable=True) {rx_lib_ms:.4f} "
          f"ms (the same permutation), radix_ranks on the same ids "
          f"{rx_ranks_ms:.4f} ms, bound {rx_bound_ms:.6f} ms (bytes: 4 B "
          f"in, 8 B out a row)")

    # hash_join_probe: every call of one q5-sparse run; beside it the
    # reference's one-mode formulation on the same inputs (its sorted build
    # made outside the timing, as the build does it once)
    hj_calls = recorded["hash_join_probe"]
    hj_err = max([probe_check(*a) for a in hj_calls], default=hj_err)
    one_calls = [(*one_mode_inputs(tk, tr), stream)
                 for tk, tr, stream, _nb in hj_calls]
    for (tk, tr, stream, nb), oc in zip(hj_calls, one_calls):
        if not torch.equal(one_mode_probe(*oc)[1],
                           CK.hash_join_probe(tk, tr, stream, nb)[1]):
            raise AssertionError("the one-mode formulation disagrees with "
                                 "hash_join_probe on a q5-sparse input")
    torch.cuda.synchronize()
    hj_ms = device_ms(each_call(CK.hash_join_probe, hj_calls), 5,
                      "hash_join_probe_kernel")
    hj_plain_ms = device_ms(each_call(CK.hash_join_probe_plain, hj_calls), 3)
    hj_one_ms = device_ms(each_call(one_mode_probe, one_calls), 5)
    hj_call_ms = call_ms(each_call(CK.hash_join_probe, hj_calls), 5, 1)
    hj_bound_ms = sum(probe_bound_ms(stream.numel(), nb)
                      for _tk, _tr, stream, nb in hj_calls)
    shapes = sorted({(stream.numel(), nb) for _k, _r, stream, nb in hj_calls})
    print(f"q5-sparse hash_join_probe: {len(hj_calls)} launches at (n, "
          f"buckets) {shapes}; kernel {hj_ms:.4f} ms device ({hj_call_ms:.4f} "
          f"ms enqueued back to back), plain {hj_plain_ms:.4f} ms, the "
          f"one-mode formulation (searchsorted, compare, gather) "
          f"{hj_one_ms:.4f} ms, bound {hj_bound_ms:.6f} ms (bytes); no "
          f"single PyTorch call probes a hash table")

    # hash_join_build: the kernel (memset, insert, finalize) against its
    # plain version, and beside them the one mode's build, one sort of the
    # keys
    hb_calls = recorded["hash_join_build"]
    hb_err = max([hb_err] + [build_check(*a) for a in hb_calls])
    hb_ms = device_ms(each_call(CK.hash_join_build, hb_calls), 5)
    hb_plain_ms = device_ms(each_call(CK.hash_join_build_plain, hb_calls), 3)
    hb_sort_ms = device_ms(each_call(
        lambda keys, _e, _nb: torch.sort(keys), hb_calls), 5)
    hb_call_ms = call_ms(each_call(CK.hash_join_build, hb_calls), 20, 3)
    # read the keys and the mask once, write the two tables once
    hb_bound_ms = sum((9 * keys.numel() + 12 * 8 * nb) / HBM_BYTES_PER_S * 1e3
                      for keys, _e, nb in hb_calls)
    print(f"q5-sparse hash_join_build: {len(hb_calls)} builds at (cap, "
          f"buckets) {sorted({(k.numel(), nb) for k, _e, nb in hb_calls})}; "
          f"kernels {hb_ms:.4f} ms device (memset, insert, finalize; "
          f"{hb_call_ms:.4f} ms enqueued back to back), plain "
          f"{hb_plain_ms:.4f} ms, torch.sort of the keys (the one mode's "
          f"build) {hb_sort_ms:.4f} ms, bound {hb_bound_ms:.6f} ms (bytes)")
    # radix_ranks at the build's shape, on its bucket ids (4,096 lanes,
    # ineligible rows past the domain), which the reference's build ranks;
    # beside it torch's stable argsort
    build_radix = [(torch.where(e, CK.hash_join_bucket(k, nb.bit_length() - 1),
                                torch.full_like(k, nb, dtype=torch.int32)), nb)
                   for k, e, nb in hb_calls]
    rb_err = max([radix_check(ids, lanes, False)
                  for ids, lanes in build_radix], default=0)
    rb_ms = device_ms(each_call(CK.radix_ranks, build_radix), 5, "radix_")
    rb_plain_ms = device_ms(each_call(CK.radix_ranks_plain, build_radix), 3)
    rb_argsort_ms = device_ms(each_call(argsort, build_radix), 5)
    rb_bytes_ms, rb_ops_ms = (sum(x) for x in zip(*(
        radix_bound_ms(ids.numel(), lanes) for ids, lanes in build_radix)))
    rb_bound_ms = max(rb_bytes_ms, rb_ops_ms)
    rb_bound_by = "bytes" if rb_bytes_ms >= rb_ops_ms else "operations"
    print(f"radix_ranks on q5-sparse's build bucket ids: {len(build_radix)} "
          f"calls at (cap, lanes) "
          f"{sorted({(ids.numel(), lanes) for ids, lanes in build_radix})}; "
          f"kernel {rb_ms:.4f} ms device, plain {rb_plain_ms:.4f} ms, "
          f"torch.argsort(stable=True) {rb_argsort_ms:.4f} ms, bound "
          f"{rb_bound_ms:.6f} ms")
    del recorded, oh_calls, mm_calls, rx_calls, hj_calls, one_calls, hb_calls
    del build_radix, bc_calls, q1_batches, float_batches

    if args.profile:
        for label, make_df in all_paths.items():
            profile_run(label, lambda: make_df().collect(), repo)

    # -- 5. the kernels line, the card, the verdict --------------------------
    # "launches" counts the runs whose inputs the times cover: the q1 path's
    # for bitunpack128 (the chunk decode) and onehot_sum_f32 (the fused
    # count launch), q1-files plus q1-repartition for murmur3_words and
    # radix_partition_permutation, q5-sparse for hash_join_build and
    # hash_join_probe; launches_by_path has every path's, under the counter
    # each kernel counts on. radix_ranks is called by no main path: the
    # radix kernels run there only inside the permutation, whose entry
    # carries their launches (counted under radix_ranks) and their times,
    # so its own entry is timed off the paths, on q5-sparse's build bucket
    # ids, with no launches
    exchange_paths = ("q1-files", "q1-repartition")

    def entry(kname, source, line, launch_paths, err, ms, plain_ms, bound,
              bound_by, library_ms, counter=None):
        counter = counter or kname
        return {
            "name": kname, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{source}",
            "replaces": f"spark_rapids_tpu/ops/pallas_kernels.py:{line}",
            "launches": sum(counts_by_path[p][counter] for p in launch_paths),
            "launches_by_path": {p: c[counter]
                                 for p, c in counts_by_path.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}
    kernels = [
        # the fused chunk decode: times over every dictionary chunk of one
        # q1 scan; per_page_route_ms is every device op of the per-page
        # route it replaced, fused_route_ms the fused route's (copy + kernel)
        dict(entry("bitunpack128", "chunkdecode.cu", 221, ("q1",), max_err,
                   chunk_ms, chunk_plain_ms, chunk_bound, "bytes", None),
             chunks=len(census), pages=census_pages,
             fused_route_ms=fused_ms, per_page_route_ms=per_page_ms,
             fused_route_host_s=fused_s, per_page_route_host_s=per_page_s),
        # the fused count launch over one q1 run's batches; library_ms is
        # torch.bincount once per request; fused_route_ms is every device op
        # of the route; per_request_chain_new_kernel_ms the replaced route's
        # per-request chain (where, cast, call, cast) over this kernel's
        # one-request launch, not the replaced kernel; float_sums_ms the
        # same batches' stacked f64 float sums
        dict(entry("onehot_sum_f32", "onehot.cu", 289, ("q1",), oh_err,
                   oh_ms, oh_plain_ms, oh_bound_ms, oh_bound_by, oh_lib_ms),
             aggregate_batches=len(batches_by_path["q1"]),
             fused_route_ms=oh_route_ms,
             per_request_chain_new_kernel_ms=oh_chain_ms,
             per_request_bound_ms=oh_old_bound_ms, float_sums_ms=float_ms),
        entry("murmur3_words", "murmur3.cu", 169, exchange_paths, mm_err,
              mm_ms, mm_plain_ms, mm_bound_ms, mm_bound_by, None),
        # timed off the main paths, on q5-sparse's hash build bucket ids;
        # no main path calls it (see above)
        dict(entry("radix_ranks", "radix.cu", 359, (), max(rx_err, rb_err),
                   rb_ms, rb_plain_ms, rb_bound_ms, rb_bound_by,
                   rb_argsort_ms), launches_by_path={}, on_main_path=False,
             timed_on="q5-sparse hash build bucket ids"),
        # on the exchange paths' ids; counts under radix_ranks
        dict(entry("radix_partition_permutation", "radix.cu", 389,
                   exchange_paths, rx_err, rx_ms, rx_plain_ms, rx_bound_ms,
                   "bytes", rx_lib_ms, counter="radix_ranks"),
             all_device_ops_ms=rx_all_ms, radix_ranks_same_ids_ms=rx_ranks_ms),
        # no single PyTorch call probes a hash table: library_ms is null and
        # one_mode_ms is the reference's own alternative on the same inputs
        dict(entry("hash_join_probe", "hashjoin.cu", 479, ("q5-sparse",),
                   hj_err, hj_ms, hj_plain_ms, hj_bound_ms, "bytes", None),
             one_mode_ms=hj_one_ms),
        # no PyTorch call builds this table: library_ms is null and sort_ms
        # is the one mode's build, one sort of the keys
        dict(entry("hash_join_build", "hashjoin.cu", 421, ("q5-sparse",),
                   hb_err, hb_ms, hb_plain_ms, hb_bound_ms, "bytes", None),
             sort_ms=hb_sort_ms),
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
