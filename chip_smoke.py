"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py [--sf 1.0] [--tpcds-sf 1.0] [--reps 3]
                          [--profile] [--parent-tree DIR]

It imports the port (``spark_rapids_tpu_torch``) and nothing of JAX, then:

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds every CUDA kernel from ``spark_rapids_tpu_torch/csrc`` with nvcc
   (one process per source, all started together) and prints the build time
   and ptxas' register/shared-memory lines, then the native parquet scanner
   from ``spark_rapids_tpu_torch/native`` with g++;
3. holds each kernel against its plain PyTorch version on the card:
   bitunpack128 (the chunk decode kernel over one page, no dictionary)
   exactly, at every bit width 1..32 for n = 20,000 (a parquet page) and
   n = 2^20; the chunk decode exactly (values and validity) on every
   dictionary column chunk of the TPC-H q1 scan (the 7 lineitem columns
   q1 reads), and against the per-page route it replaced;
   onehot_sum_f32 (the one-request call of the fused count launch) exactly
   on 0/1 values and within 1e-5 of each bucket's sum of magnitudes on
   other float32 values (atomics add in a changing order), at q1's batch
   shape and at the largest dense domain;
   murmur3_words bit for bit at n = 20,000 and 2^20, W = 1..8, lengths
   0..4W of multi-byte UTF-8 rows cut anywhere, scalar and row-varying
   seeds; radix_ranks exactly (ranks and counts) at 2, 5, 9, 129 and 4,096
   lanes, cap 8, 16,384, 2^19 and 2^20, with ids outside the domain, and
   radix_partition_permutation equal to torch's stable argsort;
   hash_join_probe bit for bit (rows and flags) against 10,000 build keys
   (4,096 buckets) and 200 (128 buckets), at n = 1, 31, 33, 2^20 + 5 and
   2^20, hit shares 0, 0.5 and 1, with null rows' zeros and the empty-slot
   key, on a full bucket hit in all 8 slots and on int64 min in an occupied
   slot;
   hash_join_build bit for bit (tables and ok) at 16,384 keys in 4,096
   buckets: unique, overfull, duplicate and ineligible keys;
4. reads the q1 scan's dictionary chunks on the host twice, with the
   native scanner (``read_chunk_pages`` and ``pack_chunk``, built with g++
   from ``spark_rapids_tpu_torch/native``) and with its plain version, the
   Python page parser, and holds the packed buffers bit for bit; then runs
   thirteen TPC-H paths at scale factor ``--sf`` (data generated from the
   fixed seed into build/) through ``TorchSession()`` on the card, every
   scan pruned to the columns its query reads:
   q1 (the table directory as one partition: scan, COMPLETE aggregate,
   sort), q1-files (one partition per file: PARTIAL aggregate, hash
   exchange on the keys, AQE reader, FINAL aggregate), q1-repartition
   (``repartition(8, "l_returnflag", "l_linestatus")`` of the whole scan,
   then q1 as in q1-files), q5 (five broadcast hash joins, all on the
   direct-address table, then the dense group-by on ``n_name`` and the
   sort) and q5-sparse (q5 with the supplier join on sparse 64-bit ids,
   whose build takes the hash table: hash_join_build once,
   hash_join_probe once per stream batch), q3 (two joins, the sort-based
   group-by on three integer keys, the sort and ``limit(10)``) and q18 (the
   sort-based group-by of all of lineitem on ``l_orderkey``, whose batches
   arrive sorted and skip the sort, a HAVING filter, two joins, the sort
   and ``limit(100)``), and the official q1, q3 and q5 SQL text through
   ``spark.sql`` over the tables' temp views (sql-q1, sql-q3, sql-q5; q5's
   ``c_nationkey = s_nationkey`` is a second key of the customer join,
   which takes the rank path), q1 over the lineitem files rewritten
   UNCOMPRESSED (q1-uncompressed: every chunk in one ``sr_scan_chunk``
   call), q1 with the device decode off (q1-arrow: the MULTITHREADED arrow
   reader, each column staged from pinned memory in one copy), and q1 over
   lineitem rewritten as hive directories ``l_returnflag=A|N|R`` without
   the column (q1-hive: a constant STRING partition column, the arrow
   reader, PARTIAL -> hash exchange -> FINAL). Each path has one run with
   the launch counts and the scan route counts reset just before and read
   just after (every kernel of the path must have launched: the chunk
   decode once per dictionary chunk of the columns its scans read (the
   pruned census; each scan prints its columns and must read exactly its
   query's, ``Q_TABLES``), and the native scanner must have read every one
   of those chunks and the Python parser none (``parquet_native.routes``;
   the arrow paths' scans read none and launch no chunk decode), the count
   kernel once per aggregate batch with
   count-like requests, murmur3_words twice and the radix permutation once
   per batch an exchange partitioned, hash_join_probe never on q5, on
   q5-sparse hash_join_build once per hash build and radix_ranks never,
   on q3, q18 and sql-q3 no kernel but the chunk decode, and on sql-q5 one
   rank join on two keys),
   and its peak device memory; each join prints its keys, build side, probe
   mode, build rows and buckets; each aggregate its mode, its update and
   merge batches, how many took the sort-based path and skipped the sort,
   its group counts, its host seconds and host syncs; q3 and q18 their
   plan's shape. Then ``--reps`` timed runs of each path
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
   mode: sorted build keys, torch.searchsorted, one compare, one gather),
   at 2^20 rows for each table and hit share and on q5-sparse's inputs, and
   with ``--parent-tree DIR`` the kernel of another checkout (the parent
   commit's) on the same inputs;
   hash_join_build beside torch.sort of its keys (the ``one`` mode's
   build); radix_ranks, which no path calls, on the q5-sparse hash build's
   bucket ids, beside torch.argsort(stable=True);
   then generates TPC-DS at ``--tpcds-sf`` (default 1.0: 2.88M store_sales
   rows, the reference generator's seeds) into build/, computes the NumPy
   oracles of the reference's 22 DataFrame queries once (outside every
   timed window) and runs each query as a path (ds-q3 ... ds-q88; q53, q63,
   q89 and q98 run the window exec over an aggregate, q88 seven
   nested-loop joins of eight keyless counts) through
   ``TorchSession()`` on the card: one run with the launch and route
   counts reset just before and read just after (equal to the oracle under
   ``tpcds.check_rows`` and ``FLOAT_COLS``; every scan reads only columns
   the query names and takes the device decode; the chunk decode once per
   dictionary chunk of the pruned scans; every decimal chunk refused by
   the decode and read through arrow, none by the Python parser; the count
   kernel once per aggregate batch with count-like requests, and on ds-q6
   and ds-q43 at least once; its aggregates, joins, window execs and
   nested-loop joins (rows in, partitions, rows out) and peak device
   memory), then ``--reps`` timed runs of each, in turns, each held against
   its oracle; then the 27 official TPC-DS SQL texts the port lowers
   (``tpcds.SQL_PORTED``) through ``spark.sql`` over the same files'
   temp views, as paths sql-ds-q3 ... sql-ds-q26: each planned once and
   run once with the counts reset just before and read just after (the
   oracle's rows under ``check_rows`` and the text's float columns; the
   scans, routes and launches checked as on the ds paths, the count kernel
   on sql-ds-q43; q97's full outer join on the rank path
   with its probe mode, build rows, stream partitions and unmatched build
   rows emitted, q61's nested-loop join), then at most ``SQL_DS_REPS``
   timed runs of each, in turns, each held against its oracle, and one
   traced run of each for its device idle share; each text prints its
   median wall, spread, peak memory, idle share, scan routes and chunk
   decode launches, and the DataFrame twin's median wall from the same
   call where the text has one;
6. prints how many traces ``device_ms`` took and found short, one JSON
   line describing every ported kernel (its launches on every path, the
   TPC-DS paths among them, under ``launches_by_path``), the card's name
   and power limit, and last ``{"ok": true, "device": {...}}``. With
   ``--profile`` each path's host profile, the TPC-DS paths' and the SQL
   texts' too, must show no call of the Python page parser.

Device times come from torch.profiler traces (``traced``: a warm-up of
64 tiny kernels first, since a trace can lose its first launches' device
records). A trace is refused when a host call that enqueued device work
has no device record of its correlation id, or a counted kernel has fewer
records than its launches (``trace_check``): ``device_ms`` takes it again
and, after five short traces, times with CUDA events and prints a "short
traces" line, and the kernels line marks such a time (an entry's
``timing`` is "cuda_events" for its ``ms``, and ``cuda_event_times``
names every key so taken); ``--profile`` prints each path's device
records and host enqueue calls beside its idle share and marks a "SHORT
TRACE", whose idle share is only an upper bound.

It exits non-zero, before printing any result, when no CUDA device is
available, and on any failed phase.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
# timed runs of each q1 path: fewer than the other paths' --reps
Q1_REPS = 2
# timed runs of each official TPC-DS SQL text (the sql-ds paths)
SQL_DS_REPS = 2


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


class QueuedMs(float):
    """A time that device_ms took from queued_ms after five short traces:
    the kernels line marks it (an entry's "timing" and "cuda_event_times"),
    since it holds launch gaps that a traced time does not."""


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


# host-side calls that enqueue device work, as torch.profiler names them
# (runtime and low-level API launches, async copies and memsets)
ENQUEUE_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                 "cudaMemsetAsync")
# kernels whose launches cuda_kernels counts, by the name device_ms matches:
# the counter, and the device records of that name one counted launch makes
COUNTED = {KERNEL_NAME: ("bitunpack128", 1),
           "onehot_sums_kernel": ("onehot_sum_f32", 1),
           "murmur3_words_kernel": ("murmur3_words", 1),
           "radix_": ("radix_ranks", 3),
           "hash_join_insert_kernel": ("hash_join_build", 1),
           "hash_join_probe_kernel": ("hash_join_probe", 1)}
# the region of a trace that its census covers, and the launches before it
# whose device records a trace may lose (traced)
# the functions of the Python page parser, which no path may call
PYTHON_PARSER = ("parse_rle_hybrid", "decode_rle_host", "parse_page_header",
                 "read_chunk_pages_plain", "pack_chunk_plain")
TRACE_MARK = "chip_smoke.traced"
WARMUP_LAUNCHES = 64
# traces device_ms took, those it found short, and its CUDA-event fallbacks
TRACES = {"taken": 0, "short": 0, "fallbacks": 0}


def trace_check(events, match: str | None = None,
                want: int | None = None) -> tuple:
    """Census of one torch.profiler trace, given as (name, on_device,
    correlation id) tuples: (device records, host calls that enqueue device
    work, device records whose name contains ``match`` (all of them for
    None), why the trace is short or ""). A trace is short when it has no
    device record, when a host enqueue call has no device record of its
    correlation id (the profiler lost it: so always when the device records
    are fewer than the host enqueue calls), or when fewer records match than
    ``want``: a time or an idle share summed from it would be too small."""
    device = host = matched = 0
    ran, enqueued = set(), []
    for name, on_device, corr in events:
        if on_device:
            device += 1
            matched += match is None or match in name
            ran.add(corr)
        elif name.startswith(ENQUEUE_CALLS):
            host += 1
            enqueued.append(corr)
    lost = sum(c not in ran for c in enqueued)
    why = ""
    if device == 0:
        why = "no device records"
    elif lost:
        why = (f"{lost} of {host} host enqueue calls without a device record "
               f"({device} device records)")
    elif want is not None and matched < want:
        why = f"{matched} {match} records for {want} counted launches"
    return device, host, matched, why


def traced(run) -> tuple:
    """Trace run() with torch.profiler. A trace can lose the device records
    of its first launches, however long they run (3 or 4 after the card sat
    idle or the paths had run, up to about 18 right after the SF1 paths),
    so WARMUP_LAUNCHES tiny sleep kernels go first, inside the same trace,
    and the census covers only the host calls inside run's region and the
    device records that the warm-up did not enqueue. Returns (the census's
    (name, on_device, correlation id) tuples for trace_check, [(name, us)]
    of its device records, run's wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(WARMUP_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function(TRACE_MARK):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    mark = next(e for e in host if e.name() == TRACE_MARK)
    lo, hi = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    warm = {e.correlation_id() for e in host if e.start_ns() < lo
            and e.name().startswith(ENQUEUE_CALLS)}
    inside = [e for e in host
              if lo <= e.start_ns() <= hi and e.name() != TRACE_MARK]
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and e.correlation_id() not in warm
              and not e.name().startswith(TRACE_MARK)]
    census = ([(e.name(), False, e.correlation_id()) for e in inside]
              + [(e.name(), True, e.correlation_id()) for e in device])
    return census, [(e.name(), e.duration_ns() / 1e3) for e in device], wall


def device_ms(fn, reps: int, match: str | None = None,
              per_call: int | None = None) -> float:
    """Mean device time of one fn() call: the summed durations of the device
    records (kernels, copies, memsets) it ran, traced by torch.profiler over
    reps calls (traced); ``match`` keeps only records whose name contains
    it. ``per_call`` is the matched records one call makes; for a ``match``
    in COUNTED it defaults to what the counted launches of the traced calls
    make. A short trace (trace_check) is taken again; after five, the time
    comes from CUDA events around calls queued behind a sleep (queued_ms),
    and a line says so."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    counter, per_launch = COUNTED.get(match, (None, 0))
    fn()
    torch.cuda.synchronize()
    why = ""

    def run():
        for _ in range(reps):
            fn()
    for _ in range(5):
        before = CK.launches[counter] if counter else 0
        census, device, _wall = traced(run)
        if per_call is not None:
            want = reps * per_call
        elif counter:
            want = (CK.launches[counter] - before) * per_launch
        else:
            want = None
        TRACES["taken"] += 1
        why = trace_check(census, match, want)[3]
        if not why:
            us = sum(t for name, t in device
                     if match is None or match in name)
            return us / reps / 1e3
        TRACES["short"] += 1
    TRACES["fallbacks"] += 1
    print(f"device_ms: 5 short traces ({match}; the last had {why}); timed "
          "with CUDA events around calls queued behind a sleep instead")
    return QueuedMs(queued_ms(fn, reps))


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


def column_chunks(table_columns: dict):
    """``(path, footer, row group, column, capacity)`` of every column
    chunk of the named columns of each table directory (``{dir: columns}``,
    the columns a pruned scan reads), in the scan's order."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    for d, columns in table_columns.items():
        for f in sorted(os.listdir(d)):
            if not f.endswith(".parquet"):
                continue
            path = os.path.join(d, f)
            md = pq.ParquetFile(path).metadata
            for rg in range(md.num_row_groups):
                cap = bucket_capacity(max(md.row_group(rg).num_rows, 1))
                for ci in range(md.num_columns):
                    if md.schema.column(ci).path in columns:
                        yield path, md, rg, ci, cap


def chunk_census(table_columns: dict):
    """Every column chunk that the device decode takes (a dictionary chunk)
    of ``column_chunks(table_columns)``, read on the host exactly as the
    scan reads it: [(ChunkPages, capacity)], the count of their data pages,
    and the count of the chunks of those columns that the decode refuses
    (read through arrow)."""
    from spark_rapids_tpu_torch.io import parquet_native as PN
    chunks, pages, refused = [], 0, 0
    for path, md, rg, ci, cap in column_chunks(table_columns):
        try:
            chunk = PN.read_chunk_pages(path, rg, ci, md=md)
        except NotImplementedError:
            refused += 1  # arrow fallback column: no kernel
            continue
        chunks.append((chunk, cap))
        pages += len(chunk.index_segments)
    return chunks, pages, refused


def host_scan(table_columns: dict, read, pack):
    """The host side of the scan of every dictionary chunk of
    ``column_chunks(table_columns)`` by ``read`` (a chunk reader) and
    ``pack`` (a chunk packer): (host seconds, the packed buffers)."""
    from spark_rapids_tpu_torch.io import parquet_native as PN
    bufs, secs = [], 0.0
    for path, md, rg, ci, cap in column_chunks(table_columns):
        t0 = time.perf_counter()
        try:
            chunk = read(path, rg, ci, md=md)
        except NotImplementedError:
            continue
        _st, _want, _d, dictionary, _sd = PN.chunk_column(chunk, None)
        packed = pack(chunk, dictionary, cap)
        secs += time.perf_counter() - t0
        bufs.append(packed.buf)
    return secs, bufs


def rewrite_uncompressed(src: str, dst: str) -> str:
    """``src``'s parquet files rewritten into ``dst`` with compression NONE,
    with the same row groups, page size and dictionary encoding (the
    writer's defaults, as the generator's); kept when already there."""
    import pyarrow.parquet as pq
    if not os.path.isdir(dst):
        tmp = f"{dst}.{os.getpid()}.tmp"
        os.makedirs(tmp)
        for f in sorted(os.listdir(src)):
            if f.endswith(".parquet"):
                pf = pq.ParquetFile(os.path.join(src, f))
                pq.write_table(pf.read(), os.path.join(tmp, f),
                               compression="NONE",
                               row_group_size=pf.metadata.row_group(0)
                               .num_rows)
        os.replace(tmp, dst)
    return dst


def rewrite_hive(src: str, dst: str, key: str) -> str:
    """``src``'s table rewritten into hive directories ``dst/key=v`` (one
    file each, the column taken out of the files); kept when already
    there."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    if not os.path.isdir(dst):
        tmp = f"{dst}.{os.getpid()}.tmp"
        t = pq.read_table(src)
        for v in sorted(pc.unique(t[key]).to_pylist()):
            d = os.path.join(tmp, f"{key}={v}")
            os.makedirs(d)
            pq.write_table(t.filter(pc.equal(t[key], v)).drop_columns([key]),
                           os.path.join(d, "part-0000.parquet"))
        del t
        os.replace(tmp, dst)
    return dst


# the columns each TPC-H query reads of each table: the port's copy of
# bench.py's Q_TABLES, which the JAX package's pruned plans read
Q_TABLES = {
    "q1": {"lineitem": ["l_discount", "l_extendedprice", "l_linestatus",
                        "l_quantity", "l_returnflag", "l_shipdate", "l_tax"]},
    "q3": {"customer": ["c_custkey", "c_mktsegment"],
           "orders": ["o_custkey", "o_orderdate", "o_orderkey",
                      "o_shippriority"],
           "lineitem": ["l_discount", "l_extendedprice", "l_orderkey",
                        "l_shipdate"]},
    "q5": {"customer": ["c_custkey", "c_nationkey"],
           "orders": ["o_custkey", "o_orderdate", "o_orderkey"],
           "lineitem": ["l_discount", "l_extendedprice", "l_orderkey",
                        "l_suppkey"],
           "supplier": ["s_nationkey", "s_suppkey"],
           "nation": ["n_name", "n_nationkey", "n_regionkey"],
           "region": ["r_name", "r_regionkey"]},
    "q18": {"customer": ["c_custkey"],
            "orders": ["o_custkey", "o_orderdate", "o_orderkey",
                       "o_totalprice"],
            "lineitem": ["l_orderkey", "l_quantity"]},
}
# the TPC-H query each path answers
QUERY_OF = {"q1": "q1", "q1-files": "q1", "q1-repartition": "q1",
            "q5": "q5", "q5-sparse": "q5", "q3": "q3", "q18": "q18",
            "sql-q1": "q1", "sql-q3": "q3", "sql-q5": "q5",
            "q1-uncompressed": "q1", "q1-arrow": "q1", "q1-hive": "q1"}


def scans(plan) -> list:
    """``(table directory, scan exec)`` of each file scan of an exec tree,
    top down; the table directory is the directory of the scan's files, or
    the root of its hive partition directories."""
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    if isinstance(plan, FileSourceScanExec):
        # a hive table's directory is the root of its partition directories
        dirs = set()
        for part in plan.node.partitions:
            for p in part.paths:
                d = os.path.dirname(p)
                for _kv in part.partition_values:
                    d = os.path.dirname(d)
                dirs.add(d)
        if len(dirs) != 1:
            raise AssertionError(f"a scan over several directories {dirs}")
        return [(dirs.pop(), plan)]
    return [s for c in plan.children for s in scans(c)]


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


def check_q3(got, exp):
    """bench.py's q3 check (order keys exact, revenue within 1e-6
    relative), with the order date and the ship priority held exactly."""
    import datetime
    if len(got) != len(exp):
        raise AssertionError(f"q3 rows {len(got)} != oracle {len(exp)}")
    for g, (k, d, p, rev) in zip(got, exp):
        gd = (g["o_orderdate"] - datetime.date(1970, 1, 1)).days
        if (g["l_orderkey"] != k or gd != d or g["o_shippriority"] != p
                or abs(g["revenue"] - rev) > 1e-6 * max(1.0, abs(rev))):
            raise AssertionError(f"q3 row {g} != oracle {(k, d, p, rev)}")


def check_q18(got, exp):
    """bench.py's q18 check: customer and order keys and the order date
    exact, total price and quantity within 1e-6 relative; and not empty."""
    import datetime
    if not exp or len(got) != len(exp):
        raise AssertionError(f"q18 rows {len(got)}, oracle {len(exp)} "
                             f"(want the same, more than none)")
    for g, (c, o, d, t, q) in zip(got, exp):
        gd = (g["o_orderdate"] - datetime.date(1970, 1, 1)).days
        if (g["c_custkey"] != c or g["o_orderkey"] != o or gd != d
                or abs(g["o_totalprice"] - t) > 1e-6 * max(1.0, abs(t))
                or abs(g["sum_qty"] - q) > 1e-6 * max(1.0, abs(q))):
            raise AssertionError(f"q18 row {g} != oracle {(c, o, d, t, q)}")


def aggregates(plan) -> list:
    """The aggregate execs of an exec tree, top down."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    out = [plan] if isinstance(plan, HashAggregateExec) else []
    for c in plan.children:
        out += aggregates(c)
    return out


def ladder_shape(label: str, plan) -> str:
    """q3's and q18's plan shape, checked: GlobalLimitExec over SortExec,
    one aggregate (COMPLETE, on the sort-based path), under a FilterExec
    (the HAVING) on q18. Returns a line that names it."""
    from spark_rapids_tpu_torch.exec import basic as XB
    from spark_rapids_tpu_torch.exec.sort import SortExec

    def walk(p):
        yield p
        for c in p.children:
            yield from walk(c)
    aggs = aggregates(plan)
    having = [p for p in walk(plan) if isinstance(p, XB.FilterExec)
              and aggs and p.child is aggs[0]]
    if not (isinstance(plan, XB.GlobalLimitExec)
            and isinstance(plan.child, SortExec) and len(aggs) == 1
            and aggs[0].mode == "complete" and aggs[0].stats["segment"] > 0
            and len(having) == (label == "q18")):
        raise AssertionError(f"{label}: unexpected plan\n{plan}")
    return (f"GlobalLimitExec({plan.limit}) > SortExec > "
            + ("FilterExec (HAVING) > " if having else "... > ")
            + f"HashAggregateExec mode={aggs[0].mode} (segment path); the "
            "limit reads no count back (row counts are host ints)")


def probe_bound_ms(n: int, num_buckets: int) -> float:
    """Least time for one hash_join_probe call: read n 8-byte keys and
    write n 4-byte rows and n 1-byte flags, and read the table of 8 slots
    of 8 + 4 bytes per bucket once, over the card's memory rate."""
    return (n * (8 + 4 + 1) + 8 * num_buckets * 12) / HBM_BYTES_PER_S * 1e3


def probe_build_keys(rng, n_build: int, dev):
    """n_build sparse unique int64 build keys on the card, about 10^10
    apart, a third of them negative."""
    keys = (rng.permutation(n_build).astype(np.int64) + 1) * 9_999_991_337
    keys[::3] *= -1
    return torch.from_numpy(keys).to(dev)


def probe_stream(rng, n: int, keys, share: float, dev):
    """n stream keys on the card, each a build key with probability share,
    else a random int64; below share 1, 5 % of them (hits too) are null
    rows' canonical 0 and the first is the empty-slot key int64 min."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    k = keys.cpu().numpy()
    stream = np.where(rng.random(n) < share, rng.choice(k, n),
                      rng.integers(-2**62, 2**62, n)).astype(np.int64)
    if share < 1:
        stream[rng.random(n) < 0.05] = 0
        stream[0] = CK.HJ_EMPTY
    return torch.from_numpy(stream).to(dev)


def probe_check(tk, tr, stream, num_buckets: int, probe=None) -> int:
    """hash_join_probe (or ``probe``, called the same way) against its plain
    version, bit for bit (rows and flags); raises on a difference, else
    returns 0."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    pos, found = (probe or CK.hash_join_probe)(tk, tr, stream, num_buckets)
    want_pos, want_found = CK.hash_join_probe_plain(tk, tr, stream,
                                                    num_buckets)
    if not (torch.equal(pos, want_pos) and torch.equal(found, want_found)):
        raise AssertionError(f"hash_join_probe != plain at "
                             f"n={stream.numel()} buckets={num_buckets}")
    return 0


def tree_probe(tree: str):
    """hash_join_probe of another checkout of this repo (a git archive of
    the parent commit): its csrc/hashjoin.cu built with nvcc into
    build/cuda/ and loaded, called like cuda_kernels.hash_join_probe on CUDA
    tensors. Its launches are not counted."""
    import ctypes
    import hashlib

    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    src = os.path.join(tree, "spark_rapids_tpu_torch", "csrc", "hashjoin.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(CK._BUILD_DIR, f"libhashjoin-tree-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(CK._BUILD_DIR, exist_ok=True)
        out = subprocess.run(CK.nvcc_command(src, so), capture_output=True,
                             text=True, check=True)
        for ln in (out.stdout + out.stderr).splitlines():
            if "ptxas" in ln:
                print(f"  {tree}: {ln.strip()}")
    fn = ctypes.CDLL(so).hash_join_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def probe(tk, tr, stream, num_buckets):
        n = stream.numel()
        pos = torch.empty((n,), dtype=torch.int32, device=stream.device)
        found = torch.empty((n,), dtype=torch.bool, device=stream.device)
        err = fn(stream.device.index, tk.data_ptr(), tr.data_ptr(),
                 stream.data_ptr(), n, num_buckets.bit_length() - 1,
                 pos.data_ptr(), found.data_ptr(),
                 torch.cuda.current_stream(stream.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{tree} hash_join_probe: CUDA error {err}")
        return pos, found
    return probe


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


def of_type(plan, cls) -> list:
    """The execs of an exec tree that are instances of ``cls``, top down."""
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        out += of_type(c, cls)
    return out


def exchanges(plan) -> list:
    """The shuffle exchanges of an exec tree, top down."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    out = [plan] if isinstance(plan, ShuffleExchangeExec) else []
    for c in plan.children:
        out += exchanges(c)
    return out


def sql_idle_share(run) -> str:
    """The device idle share of one traced run (1 - device activity time /
    wall), as text; a trace that stays short after three (trace_check)
    gives only an upper bound, and says so."""
    for attempt in range(3):
        census, device, wall = traced(run)
        why = trace_check(census)[3]
        if not why:
            break
    busy = sum(us for _name, us in device) / 1e6
    if why:
        return (f"SHORT TRACE ({why}): device idle share at most "
                f"{1 - busy / wall:.4f}")
    return (f"device idle share {1 - busy / wall:.4f} (traced wall "
            f"{wall:.4f} s, device activity {busy:.4f} s)")


def profile_run(label: str, run, repo: str) -> None:
    """Trace one run with torch.profiler (traced: device busy time, the
    largest device items) and profile it once more on the host with
    cProfile. Each trace prints its device records and host enqueue calls;
    a short trace (trace_check, or fewer records of a counted kernel than
    its launches in the run) is taken again, at most three times, and one
    that stays short prints its idle share marked as from a short trace."""
    import collections
    import cProfile
    import io
    import pstats

    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    for attempt in range(3):
        before = dict(CK.launches)
        census, device, wall = traced(run)
        n_dev, n_host, _m, why = trace_check(census)
        for match, (counter, per) in COUNTED.items():
            counted = CK.launches[counter] - before[counter]
            if not why and counted:
                why = trace_check(census, match, counted * per)[3]
        if not why:
            break
    by_kernel = collections.Counter()
    launched = collections.Counter()
    for name, us in device:
        by_kernel[name] += us
        launched[name] += 1
    dev_s = sum(by_kernel.values()) / 1e6
    share = (f"device idle share {1 - dev_s / wall:.4f}" if not why else
             f"SHORT TRACE ({why}) after {attempt + 1} traces: device idle "
             f"share at most {1 - dev_s / wall:.4f}, not whole")
    print(f"profile {label}: wall {wall:.4f} s, device activity time "
          f"{dev_s:.4f} s, {share}; {n_dev} device records for {n_host} "
          f"host enqueue calls (trace {attempt + 1})")
    for kname, us in by_kernel.most_common(12):
        print(f"  {us / 1e3:10.3f} ms {launched[kname]:6d}x {kname[:90]}")
    prof_host = cProfile.Profile()
    prof_host.enable()
    run()
    torch.cuda.synchronize()
    prof_host.disable()
    buf = io.StringIO()
    st = pstats.Stats(prof_host, stream=buf)
    # the Python page parser (the scanner's plain version) runs on no path
    parsed = {fn: v[1] for (f, _ln, fn), v in st.stats.items()
              if f.endswith("parquet_native.py") and fn in PYTHON_PARSER}
    if any(parsed.values()):
        raise AssertionError(f"{label}: the Python page parser ran on the "
                             f"path: calls {parsed}")
    print(f"host profile {label}: calls of {', '.join(PYTHON_PARSER)}: 0")
    st.sort_stats("cumulative").print_stats("spark_rapids_tpu_torch", 18)
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
    ap.add_argument("--tpcds-sf", type=float, default=1.0,
                    help="TPC-DS scale factor of the 22 TPC-DS paths "
                         "(default 1.0: 2.88M store_sales rows)")
    ap.add_argument("--map-threads", type=int, default=None,
                    help="spark.rapids.tpu.sql.localScheduler.numThreads "
                         "of the session (default: the conf's default)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one run of each path with "
                         "torch.profiler and cProfile")
    ap.add_argument("--parent-tree", default=None,
                    help="another checkout of this repo (a git archive of "
                         "the parent commit): its hash_join_probe kernel is "
                         "timed beside this one on the same inputs")
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
    from spark_rapids_tpu_torch import native as N
    t0 = time.perf_counter()
    info = CK.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    for lib, bi in info.items():
        print(f"build {lib}: {bi['seconds']:.2f} s nvcc")
        for ln in bi["ptxas"]:
            print(f"  {ln}")
    # the native scanner (g++), which the scans load at first use
    t0 = time.perf_counter()
    N.parquet_lib()
    print(f"build native scanner {os.path.relpath(N.SOURCE, repo)}: "
          f"{time.perf_counter() - t0:.2f} s ({N.CXX} "
          f"{' '.join(N.CXXFLAGS)}) into "
          f"{os.path.relpath(N.BUILD_DIR, repo)}")

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
    # in the fewest, 128 buckets), at hit shares 0, 0.5 and 1 (an anti join
    # finds few keys, q5-sparse's supplier join every one) and at the ragged
    # lengths 1, 31, 33 and 2^20 + 5; device times at 2^20 beside the parent
    # tree's kernel (--parent-tree), the plain version, the one-mode
    # formulation on the same inputs and the bound
    parent_probe = tree_probe(args.parent_tree) if args.parent_tree else None
    hj_err = 0
    hj_rows = []
    for n_build in (10_000, 200):
        keys = probe_build_keys(rng, n_build, dev)
        nb = CK.hash_join_buckets(n_build)
        tk, tr, ok = CK.hash_join_build(
            keys, torch.ones(n_build, dtype=torch.bool, device=dev), nb)
        if not bool(ok):
            raise AssertionError(f"hash_join_build refused {n_build} "
                                 f"sparse keys in {nb} buckets")
        sk, rows = one_mode_inputs(tk, tr)
        for n in (1, 31, 33, (1 << 20) + 5):
            hj_err = max(hj_err, probe_check(
                tk, tr, probe_stream(rng, n, keys, 0.5, dev), nb))
        for share in (0.0, 0.5, 1.0):
            stream = probe_stream(rng, 1 << 20, keys, share, dev)
            hj_err = max(hj_err, probe_check(tk, tr, stream, nb))
            if not torch.equal(one_mode_probe(sk, rows, stream)[1],
                               CK.hash_join_probe(tk, tr, stream, nb)[1]):
                raise AssertionError("the one-mode formulation disagrees "
                                     "with hash_join_probe")
            parent_ms = None
            if parent_probe is not None:
                probe_check(tk, tr, stream, nb, parent_probe)
                parent_ms = device_ms(
                    lambda: parent_probe(tk, tr, stream, nb), 20,
                    "hash_join_probe_kernel", per_call=1)
            hj_rows.append((n_build, nb, share, float(
                CK.hash_join_probe(tk, tr, stream, nb)[1].float().mean()),
                device_ms(lambda: CK.hash_join_probe(tk, tr, stream, nb), 20,
                          "hash_join_probe_kernel"), parent_ms,
                device_ms(lambda: CK.hash_join_probe_plain(tk, tr, stream,
                                                           nb), 5),
                device_ms(lambda: one_mode_probe(sk, rows, stream), 10),
                probe_bound_ms(1 << 20, nb)))
    # a full bucket of 8 keys hit in every slot, with misses of the same
    # bucket; and int64 min in an occupied slot (only hash_join_build_plain
    # makes such a table: the join path keeps int64 min out), found by a
    # stream key of int64 min
    pool = torch.arange(1, 1 << 22, dtype=torch.int64, device=dev) * 7919
    crowd = pool[CK.hash_join_bucket(pool, 7) == 0][:40]
    other = probe_build_keys(rng, 200, dev)
    other = other[CK.hash_join_bucket(other, 7) != 0][:100]
    keys = torch.cat([crowd[:8], other])
    tk, tr, ok = CK.hash_join_build(
        keys, torch.ones(keys.numel(), dtype=torch.bool, device=dev), 128)
    if not bool(ok) or not bool((tr[:8] >= 0).all()):
        raise AssertionError("hash_join_build: no full bucket")
    stream = crowd[torch.from_numpy(rng.integers(0, 40, 1000)).to(dev)]
    hj_err = max(hj_err, probe_check(tk, tr, stream, 128))
    keys[50] = CK.HJ_EMPTY
    tk, tr, _ok = CK.hash_join_build_plain(
        keys, torch.ones(keys.numel(), dtype=torch.bool, device=dev), 128)
    stream = torch.cat([keys[45:55], keys[45:55]])
    hj_err = max(hj_err, probe_check(tk, tr, stream, 128))
    if not bool(CK.hash_join_probe(tk, tr, stream, 128)[1][5]):
        raise AssertionError("hash_join_probe missed int64 min in an "
                             "occupied slot")
    torch.cuda.synchronize()
    print("hash_join_probe n build_keys buckets hit_share found_share "
          "kernel_device_ms parent_device_ms plain_device_ms "
          "one_mode_device_ms bound_ms")
    for n_build, nb, share, f_, k, pk, p_, o_, b in hj_rows:
        print(f"  {1 << 20} {n_build} {nb} {share} {f_:.4f} {k:.6f} "
              f"{'not measured' if pk is None else f'{pk:.6f}'} {p_:.6f} "
              f"{o_:.6f} {b:.6f}")
    print("hash_join_probe bit for bit at n = 1, 31, 33, 2^20 + 5 and 2^20 "
          "(hit shares 0, 0.5, 1) on both tables, on a full bucket and on "
          "int64 min in an occupied slot")

    # hash_join_build bit for bit at the largest build (16,384 keys, 4,096
    # buckets): 10,000 eligible sparse keys as q5-sparse's, then every key
    # (some buckets overfill), 12 keys of one bucket, a duplicate key, and
    # 60 % eligible
    hb_err = 0
    keys = probe_build_keys(rng, 16_384, dev)
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
    census, census_pages, _refused = chunk_census(
        {paths["lineitem"]: Q_TABLES["q1"]["lineitem"]})
    print(f"census: {len(census)} dictionary chunks of the 7 lineitem "
          f"columns q1 reads (one chunk decode launch each) holding "
          f"{census_pages} data pages, {time.perf_counter() - t0:.1f} s")
    if not census:
        raise AssertionError("the q1 scan has no chunk for the chunk decode")
    # the host side of the q1 scan: the native scanner (read_chunk_pages,
    # pack_chunk) against its plain version, the reference's Python page
    # parser (read_chunk_pages_plain, pack_chunk_plain), on the same chunks;
    # the packed buffers bit for bit
    q1_columns = {paths["lineitem"]: Q_TABLES["q1"]["lineitem"]}
    native_s, native_bufs = host_scan(q1_columns, PN.read_chunk_pages,
                                      PN.pack_chunk)
    plain_s, plain_bufs = host_scan(q1_columns, PN.read_chunk_pages_plain,
                                    PN.pack_chunk_plain)
    if len(native_bufs) != len(census) or not all(
            torch.equal(a, b) for a, b in zip(native_bufs, plain_bufs)):
        raise AssertionError("pack_chunk over the native scan differs from "
                             "the Python route on a q1 chunk")
    del native_bufs, plain_bufs
    print(f"q1 host scan of {len(census)} dictionary chunks (read + pack, "
          f"host seconds): native scanner {native_s:.4f} s, Python page "
          f"parser (plain) {plain_s:.4f} s; packed buffers bit for bit")
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

    # -- 4. the thirteen paths through the session on the card -------------
    threads = ({} if args.map_threads is None else
               {"spark.rapids.tpu.sql.localScheduler.numThreads":
                args.map_threads})
    spark = TorchSession(threads)
    # the arrow reader path (MULTITHREADED, the conf's default strategy)
    arrow_spark = TorchSession(
        {**threads, "spark.rapids.tpu.sql.parquet.deviceDecode.enabled":
         "false"})
    exp_q1 = tpch.np_q1(tpch.load_np({"lineitem": paths["lineitem"]}))
    tb = tpch.load_np(paths)
    exp_q5 = tpch.np_q5(tb)
    tpch_columns = {t: list(cols) for t, cols in tb.items()}
    li_dir = paths["lineitem"]

    def sql(spark, q):
        from spark_rapids_tpu_torch.sql.tpch_queries import SQL_QUERIES
        tpch.load(spark, paths)       # registers the tables as temp views
        return spark.sql(SQL_QUERIES[q])
    li_files = sorted(os.path.join(li_dir, f) for f in os.listdir(li_dir)
                      if f.endswith(".parquet"))
    t0 = time.perf_counter()
    unc_dir = rewrite_uncompressed(li_dir, os.path.join(
        repo, "build", f"tpch_sf{args.sf:g}_uncompressed", "lineitem"))
    hive_dir = rewrite_hive(li_dir, os.path.join(
        repo, "build", f"tpch_sf{args.sf:g}_hive", "lineitem"),
        "l_returnflag")
    print(f"data: lineitem rewritten UNCOMPRESSED at {unc_dir} and as hive "
          f"directories l_returnflag=A|N|R at {hive_dir} in "
          f"{time.perf_counter() - t0:.1f} s")
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
        # two joins, the sort-based group-by on three integer keys, limit
        "q3": lambda: tpch.q3(tpch.load(spark, paths)),
        # the sort-based group-by of all of lineitem, HAVING, two joins
        "q18": lambda: tpch.q18(tpch.load(spark, paths)),
        # the official SQL text through spark.sql over the temp views that
        # tpch.load registers: q1 as the q1 path; q3 as the q3 path; q5
        # with c_nationkey = s_nationkey as a second key of the customer
        # join, which takes the rank path
        "sql-q1": lambda: sql(spark, "q1"),
        "sql-q3": lambda: sql(spark, "q3"),
        "sql-q5": lambda: sql(spark, "q5"),
        # q1 over UNCOMPRESSED files: every chunk in one sr_scan_chunk call
        "q1-uncompressed": lambda: tpch.q1(
            {"lineitem": spark.read_parquet(unc_dir)}),
        # q1 through the arrow reader (device decode off), MULTITHREADED
        "q1-arrow": lambda: tpch.q1(tpch.load(arrow_spark, paths)),
        # q1 over hive directories: l_returnflag is a constant STRING
        # partition column, the partitions take the arrow reader, and the
        # three partitions plan PARTIAL -> hash exchange -> FINAL
        "q1-hive": lambda: tpch.q1(
            {"lineitem": spark.read_parquet(hive_dir)}),
    }
    q1_labels = ("q1", "q1-files", "q1-repartition", "q1-uncompressed",
                 "q1-arrow", "q1-hive")
    # the paths whose scans take the arrow reader: no chunk decode
    arrow_labels = ("q1-arrow", "q1-hive")
    ladder_labels = ("q3", "q18", "sql-q3")
    exp_ladder = {"q3": tpch.np_q3(tb), "q18": tpch.np_q18(tb)}
    del tb
    print(f"q18 oracle: {len(exp_ladder['q18'])} rows at sf={args.sf:g}")
    # the pruned census: the dictionary chunks of the columns a scan of
    # each table reads in each query, one chunk decode each
    table_dirs = {os.path.normpath(p): t for t, p in paths.items()}
    table_dirs[os.path.normpath(unc_dir)] = "lineitem"
    table_dirs[os.path.normpath(hive_dir)] = "lineitem"
    census_memo = {}

    def scan_chunks(d, columns) -> tuple:
        """(dictionary chunks, refused chunks) of the columns in d."""
        key = (d, tuple(sorted(columns)))
        if key not in census_memo:
            chunks, _pages, refused = chunk_census({d: list(columns)})
            census_memo[key] = (len(chunks), refused)
        return census_memo[key]

    def check(label, res):
        q = QUERY_OF[label]
        if q == "q1":
            check_q1(res.to_pylist(), exp_q1)
        elif q in ("q3", "q18"):
            (check_q3 if q == "q3" else check_q18)(res.to_pylist(),
                                                    exp_ladder[q])
        else:
            check_q5(res.to_pylist(), exp_q5)
    exchange_kernels = ("bitunpack128", "onehot_sum_f32", "murmur3_words",
                        "radix_ranks")
    path_kernels = {"q1": ("bitunpack128", "onehot_sum_f32"),
                    "q1-files": exchange_kernels,
                    "q1-repartition": exchange_kernels,
                    "q5": ("bitunpack128", "onehot_sum_f32"),
                    "q5-sparse": ("bitunpack128", "onehot_sum_f32",
                                  "hash_join_build", "hash_join_probe"),
                    "q3": ("bitunpack128",), "q18": ("bitunpack128",),
                    "sql-q1": ("bitunpack128", "onehot_sum_f32"),
                    "sql-q3": ("bitunpack128",),
                    "sql-q5": ("bitunpack128", "onehot_sum_f32"),
                    "q1-uncompressed": ("bitunpack128", "onehot_sum_f32"),
                    "q1-arrow": ("onehot_sum_f32",),
                    "q1-hive": ("onehot_sum_f32", "murmur3_words",
                                "radix_ranks")}
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
    routes_by_path = {}
    batches_by_path = {}
    peak_by_path = {}
    for label, make_df in all_paths.items():
        plan = make_df().physical_plan()
        torch.cuda.reset_peak_memory_stats(dev)
        agg_batches.clear()
        G.resolve_dense_group_sums = counting_resolve
        CK.reset_launches()
        PN.reset_routes()
        t0 = time.perf_counter()
        try:
            res = plan.execute_collect()
        finally:
            G.resolve_dense_group_sums = resolve
        first_s = time.perf_counter() - t0
        counts = dict(CK.launches)
        routes = dict(PN.routes)
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
        # every scan reads exactly the query's columns of its table; on the
        # device decode the native scanner reads each dictionary chunk of
        # them (none parsed in Python) and the chunk decode launches once
        # per chunk; the arrow reader's scans read no chunk natively
        want_chunks = want_refused = 0
        for d, ex in scans(plan):
            cols = ex.output.names
            table = table_dirs[os.path.normpath(d)]
            want = Q_TABLES[QUERY_OF[label]].get(table)
            data_cols = ex.node._data_columns()
            n, refused = ((0, 0) if label in arrow_labels
                          else scan_chunks(d, data_cols))
            print(f"{label} scan {table}: read {len(cols)} of "
                  f"{len(tpch_columns[table])} columns {cols}; {n} "
                  f"dictionary chunks; batches {ex.stats}")
            if want is None or sorted(cols) != sorted(want):
                raise AssertionError(
                    f"{label}: the {table} scan read {cols}, the query "
                    f"reads {want}")
            arrow_scan = label in arrow_labels
            if (ex.stats["device_batches"] > 0) == arrow_scan or \
                    (ex.stats["arrow_batches"] > 0) != arrow_scan or \
                    (arrow_scan and ex.stats["strategy"] != "MULTITHREADED"):
                way = ("the MULTITHREADED arrow reader" if arrow_scan
                       else "the device decode")
                raise AssertionError(f"{label}: the {table} scan took "
                                     f"{ex.stats}, want {way}")
            want_chunks += n
            want_refused += refused
        if counts["bitunpack128"] != want_chunks:
            raise AssertionError(
                f"{label}: the chunk decode launched "
                f"{counts['bitunpack128']} times, the pruned scans have "
                f"{want_chunks} dictionary chunks")
        native = ("native_chunk" if label == "q1-uncompressed"
                  else "native_pages")
        want_routes = {"native_chunk": 0, "native_pages": 0,
                       "arrow": want_refused, "python": 0}
        want_routes[native] += want_chunks
        if routes != want_routes:
            raise AssertionError(
                f"{label}: scan routes {routes}, want {want_routes} (every "
                f"dictionary chunk of the pruned scans native, none in "
                f"Python)")
        routes_by_path[label] = routes
        print(f"{label} scan routes: {routes}")
        exs = exchanges(plan)
        batches = sum(e.map_batches for e in exs)
        if label in q1_labels:
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
        if label == "sql-q5":
            ranked = [j for j in js if j.stats["probe_mode"] == "rank"]
            if (len(ranked) != 1 or len(ranked[0].left_keys) != 2
                    or any(len(j.left_keys) != 1 for j in js
                           if j is not ranked[0])):
                raise AssertionError(
                    f"sql-q5: want one rank join on two keys and single-key "
                    f"joins elsewhere; joins "
                    f"{[(j.stats['probe_mode'], len(j.left_keys)) for j in js]}")
        if label in ladder_labels:
            others = {k: v for k, v in counts.items()
                      if k != "bitunpack128" and v}
            if others:
                raise AssertionError(
                    f"{label}: no dense aggregate, exchange or hash join, "
                    f"but kernels launched: {others}")
            print(f"{label} plan: {ladder_shape(label, plan)}")
            modes = [j.stats["probe_mode"] for j in js]
            print(f"{label} joins: probe modes {modes}"
                  + ("" if all(m == "dense" for m in modes) else
                     " (not all dense: see the join lines)"))
        for a in aggregates(plan):
            st = a.stats
            calls = st["updates"] + st["merges"]
            # host syncs: one group count a call, one per probe, and one
            # per compaction of prefiltered rows on the segment path
            pre = (st["updates"] if a.prefilter is not None
                   and st["segment"] else 0)
            print(f"{label} aggregate mode={a.mode}: {st['updates']} update "
                  f"and {st['merges']} merge batches, {st['segment']} on "
                  f"the segment path, {st['presorted']} presorted "
                  f"({st['probes']} probes); groups {st['groups']}; "
                  f"{st['seconds']:.4f} s host; host syncs "
                  f"{calls + st['probes'] + pre} ({calls} group counts, "
                  f"{st['probes']} probes, {pre} prefilter compactions)")
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
            keys = " and ".join(
                f"{lk.name} = {rk.name}"
                for lk, rk in zip(j.left_keys, j.right_keys))
            print(f"{label} join {j.join_type} on {keys}: build "
                  f"{j.build_side} "
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
    hj_parent_ms = None
    if parent_probe is not None:
        for a in hj_calls:
            probe_check(*a, parent_probe)
        hj_parent_ms = device_ms(each_call(parent_probe, hj_calls), 5,
                                 "hash_join_probe_kernel",
                                 per_call=len(hj_calls))
    hj_plain_ms = device_ms(each_call(CK.hash_join_probe_plain, hj_calls), 3)
    hj_one_ms = device_ms(each_call(one_mode_probe, one_calls), 5)
    hj_call_ms = call_ms(each_call(CK.hash_join_probe, hj_calls), 5, 1)
    hj_bound_ms = sum(probe_bound_ms(stream.numel(), nb)
                      for _tk, _tr, stream, nb in hj_calls)
    hj_found = sum(int(CK.hash_join_probe(*a)[1].sum()) for a in hj_calls)
    shapes = sorted({(stream.numel(), nb) for _k, _r, stream, nb in hj_calls})
    parent = ("not measured" if hj_parent_ms is None
              else f"{hj_parent_ms:.4f} ms")
    print(f"q5-sparse hash_join_probe: {len(hj_calls)} launches at (n, "
          f"buckets) {shapes}, {hj_found} of "
          f"{sum(a[2].numel() for a in hj_calls)} keys found; kernel "
          f"{hj_ms:.4f} ms device ({hj_call_ms:.4f} ms enqueued back to "
          f"back), parent tree's kernel {parent}, plain {hj_plain_ms:.4f} "
          f"ms, the one-mode formulation "
          f"(searchsorted, compare, gather) {hj_one_ms:.4f} ms, bound "
          f"{hj_bound_ms:.6f} ms (bytes); no single PyTorch call probes a "
          f"hash table")

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

    # -- 4b. the TPC-DS DataFrame paths through the session on the card ------
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.exec.joins import NestedLoopJoinExec
    from spark_rapids_tpu_torch.exec.window import WindowExec
    ds_dir = os.path.join(repo, "build", f"tpcds_sf{args.tpcds_sf:g}")
    t0 = time.perf_counter()
    ds_paths = tpcds.generate(args.tpcds_sf, ds_dir)
    print(f"data: TPC-DS sf={args.tpcds_sf:g} at {ds_dir} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ds_tb = tpcds.load_np(ds_paths)
    ds_table_cols = {t: list(c) for t, c in ds_tb.items()}
    # the oracles (Python loops over every store_sales row), once a path,
    # outside every timed window
    exp_ds = {q: [tuple(r) for r in tpcds.NP_QUERIES[q](ds_tb)]
              for q in tpcds.QUERIES}
    # the official SQL texts' oracles: the DataFrame twin's rows where the
    # text has a twin, else its SQL-only oracle
    sql_oracles = tpcds.sql_suite_oracles()
    exp_sql = {q: (exp_ds[q] if q in tpcds.QUERIES
                   else [tuple(r) for r in sql_oracles[q][0](ds_tb)])
               for q in tpcds.SQL_PORTED}
    del ds_tb
    print(f"TPC-DS oracles: {len(exp_ds)} queries and {len(exp_sql)} SQL "
          f"texts in {time.perf_counter() - t0:.1f} s; rows "
          f"{ {q: len(r) for q, r in exp_ds.items()} }; SQL rows "
          f"{ {q: len(r) for q, r in exp_sql.items()} }")
    for q, rows in list(exp_ds.items()) + list(exp_sql.items()):
        if not rows:
            raise AssertionError(f"TPC-DS {q}: the oracle has no rows")
    ds_dirs = {os.path.normpath(p): t for t, p in ds_paths.items()}
    ds_labels = [f"ds-{q}" for q in tpcds.QUERIES]
    ds_query = {f"ds-{q}": q for q in tpcds.QUERIES}

    def ds_run(q):
        return tpcds.QUERIES[q](tpcds.load(spark, ds_paths))

    def ds_named(q) -> set:
        """Every name a query's text quotes (its columns among them): a
        pruned scan reads no column outside it."""
        import inspect
        import re
        src = inspect.getsource(tpcds.QUERIES[q])
        for helper in ("_star", "_ticket_counts", "_win"):
            if helper + "(" in src:
                src += inspect.getsource(getattr(tpcds, helper))
        return set(re.findall(r'"(\w+)"', src))
    # the kernels each path must launch: the chunk decode on every path,
    # the count kernel where a dense aggregate has count-like sums (q6's
    # category averages and state counts, q43's store group-by)
    ds_kernels = {label: ("bitunpack128",) for label in ds_labels}
    ds_kernels["ds-q6"] = ds_kernels["ds-q43"] = ("bitunpack128",
                                                  "onehot_sum_f32")
    def counted_ds_run(label, plan, named, kernels, check):
        """The counted run of one TPC-DS path (a DataFrame query or an SQL
        text): the launch and route counts reset just before and read just
        after, the result held by ``check``; every kernel of ``kernels``
        launched, the count kernel once per aggregate batch with
        count-like requests; every scan pruned to names the query's text
        quotes (``named``), its dictionary chunks native and one chunk
        decode each, every decimal chunk refused by the decode and read
        through arrow, none parsed in Python. Prints the scans, aggregates,
        window execs and nested-loop joins; returns the lines the path's
        timing line repeats (each nested-loop and full outer join's
        stats)."""
        torch.cuda.reset_peak_memory_stats(dev)
        agg_batches.clear()
        G.resolve_dense_group_sums = counting_resolve
        CK.reset_launches()
        PN.reset_routes()
        t0 = time.perf_counter()
        try:
            res = plan.execute_collect()
        finally:
            G.resolve_dense_group_sums = resolve
        first_s = time.perf_counter() - t0
        counts = dict(CK.launches)
        routes = dict(PN.routes)
        peak = torch.cuda.max_memory_allocated(dev)
        check(res)
        for k in kernels:
            if counts[k] <= 0:
                raise AssertionError(
                    f"kernel {k} never launched on the {label} path")
        count_batches = [k for k in agg_batches if k]
        if (any(k > CK.ONEHOT_MAX_REQUESTS for k in count_batches)
                or counts["onehot_sum_f32"] != len(count_batches)):
            raise AssertionError(
                f"{label}: {len(count_batches)} aggregate batches with "
                f"count-like requests but the count kernel launched "
                f"{counts['onehot_sum_f32']} times (want one a batch)")
        want_chunks = want_refused = dec_chunks = 0
        for d, ex in scans(plan):
            table = ds_dirs[os.path.normpath(d)]
            cols = ex.node._data_columns()
            n, refused = scan_chunks(d, cols)
            decimals = [f.name for f in ex.output
                        if isinstance(f.data_type, T.DecimalType)]
            n_dec, dec_refused = (scan_chunks(d, decimals) if decimals
                                  else (0, 0))
            print(f"{label} scan {table}: read {len(cols)} of "
                  f"{len(ds_table_cols[table])} columns {cols}; {n} "
                  f"dictionary chunks, {refused} refused ({dec_refused} "
                  f"decimal); batches {ex.stats}")
            if not set(cols) <= named or not cols:
                raise AssertionError(
                    f"{label}: the {table} scan read {cols}, beyond the "
                    f"columns the query names")
            if n_dec or ex.stats["arrow_batches"] or \
                    not ex.stats["device_batches"]:
                raise AssertionError(
                    f"{label}: the {table} scan took {ex.stats}, "
                    f"{n_dec} decimal chunks natively (want the device "
                    f"decode, decimal chunks through arrow)")
            want_chunks += n
            want_refused += refused
            dec_chunks += dec_refused
        if counts["bitunpack128"] != want_chunks:
            raise AssertionError(
                f"{label}: the chunk decode launched "
                f"{counts['bitunpack128']} times, the pruned scans have "
                f"{want_chunks} dictionary chunks")
        want_routes = {"native_chunk": 0, "native_pages": want_chunks,
                       "arrow": want_refused, "python": 0}
        if routes != want_routes:
            raise AssertionError(
                f"{label}: scan routes {routes}, want {want_routes}")
        routes_by_path[label] = routes
        counts_by_path[label] = counts
        peak_by_path[label] = peak
        batches_by_path[label] = count_batches
        for a in aggregates(plan):
            st = a.stats
            print(f"{label} aggregate mode={a.mode} keys="
                  f"{len(a.group_exprs)}: {st['updates']} update and "
                  f"{st['merges']} merge batches, {st['segment']} on the "
                  f"segment path; groups {st['groups']}; "
                  f"{st['seconds']:.4f} s host")
        for w in of_type(plan, WindowExec):
            print(f"{label} window exec: {w.stats['input_rows']} rows in "
                  f"{w.stats['partitions']} partitions, "
                  f"{w.stats['output_rows']} rows out")
        extra = []
        for j in of_type(plan, NestedLoopJoinExec):
            st = j.stats
            extra.append(
                f"nested-loop join {j.join_type}: {st['stream_rows']} "
                f"stream rows in {st['partitions']} partitions x "
                f"{st['build_rows']} build rows, {st['pairs']} pairs, "
                f"{st['output_rows']} rows out")
        for j in joins(plan):
            st = j.stats
            if j.join_type == "fullouter":
                extra.append(
                    f"full outer join on {len(j.left_keys)} keys: probe "
                    f"mode {st['probe_mode']}, {st['build_rows']} build "
                    f"rows, {st['stream_partitions']} stream partitions, "
                    f"{st['stream_batches']} stream batches, "
                    f"{st['unmatched_build_rows']} unmatched build rows "
                    f"emitted")
        modes = [(j.join_type, j.stats["probe_mode"], len(j.left_keys))
                 for j in joins(plan)]
        print(f"{label} first run: {first_s:.3f} s; {res.num_rows} rows "
              f"equal to the oracle; launches "
              f"{ {k: v for k, v in counts.items() if v} }; routes {routes} "
              f"({dec_chunks} decimal chunks through arrow); "
              f"{len(count_batches)} aggregate batches with count-like "
              f"requests; joins (type, probe mode, keys) {modes}; peak "
              f"device memory {peak} B" + "".join(f"; {e}" for e in extra))
        return extra

    for label in ds_labels:
        q = ds_query[label]
        counted_ds_run(label, ds_run(q).physical_plan(), ds_named(q),
                       ds_kernels[label],
                       lambda res, q=q: tpcds.check_rows(
                           [tuple(r.values()) for r in res.to_pylist()],
                           exp_ds[q], tpcds.FLOAT_COLS[q]))
    ds_times = {label: [] for label in ds_labels}
    for rep in range(args.reps):
        for label in (ds_labels if rep % 2 == 0 else ds_labels[::-1]):
            q = ds_query[label]
            t0 = time.perf_counter()
            res = ds_run(q).collect()
            torch.cuda.synchronize()
            ds_times[label].append(time.perf_counter() - t0)
            tpcds.check_rows([tuple(r.values()) for r in res.to_pylist()],
                             exp_ds[q], tpcds.FLOAT_COLS[q])
    for label, ts in ds_times.items():
        print(f"{label} sf={args.tpcds_sf:g} on {name}: median "
              f"{statistics.median(ts):.4f} s, min {min(ts):.4f} s, max "
              f"{max(ts):.4f} s over {len(ts)} runs: "
              f"{[round(t, 4) for t in ts]}; peak device memory "
              f"{peak_by_path[label]} B; launches "
              f"{ {k: v for k, v in counts_by_path[label].items() if v} }")

    # -- 4c. the official TPC-DS SQL texts through spark.sql on the card -----
    # the 27 texts the port lowers, on the same SF1 files, as paths
    # sql-ds-q3 ... : each lowered and planned once, one run with the counts
    # reset just before and read just after, then the timed runs in turns,
    # then one traced run for the device idle share
    from spark_rapids_tpu_torch.sql.tpcds_queries import SQL_QUERIES as DS_SQL
    tpcds.load(spark, ds_paths)          # registers the temp views
    sql_labels = [f"sql-ds-{q}" for q in tpcds.SQL_PORTED]
    sql_query = {f"sql-ds-{q}": q for q in tpcds.SQL_PORTED}
    sql_float = {q: sql_oracles[q][1] for q in tpcds.SQL_PORTED}

    def sql_run(q):
        return spark.sql(DS_SQL[q])

    def sql_check(q, res):
        tpcds.check_rows([tuple(r.values()) for r in res.to_pylist()],
                         exp_sql[q], sql_float[q])
    # the kernels each text must launch: the chunk decode on every one, the
    # count kernel where a dense aggregate has count-like sums (q43's seven
    # nullable sums over 12 stores, as its DataFrame twin; at SF1 q7's
    # i_item_id group-by is past the dense domain)
    sql_kernels = {label: ("bitunpack128",) for label in sql_labels}
    sql_kernels["sql-ds-q43"] = ("bitunpack128", "onehot_sum_f32")
    sql_lines = {}
    for label in sql_labels:
        q = sql_query[label]
        plan = sql_run(q).physical_plan()
        sql_lines[label] = counted_ds_run(
            label, plan, set(re.findall(r"\w+", DS_SQL[q])),
            sql_kernels[label], lambda res, q=q: sql_check(q, res))
        full = [j.stats for j in joins(plan) if j.join_type == "fullouter"]
        if q == "q97" and (len(full) != 1 or full[0]["probe_mode"] != "rank"
                           or full[0]["unmatched_build_rows"] <= 0):
            raise AssertionError(f"{label}: full outer joins {full}")
        if q == "q61" and not of_type(plan, NestedLoopJoinExec):
            raise AssertionError(f"{label}: no nested-loop join")
    sql_reps = min(args.reps, SQL_DS_REPS)
    sql_times = {label: [] for label in sql_labels}
    for rep in range(sql_reps):
        for label in (sql_labels if rep % 2 == 0 else sql_labels[::-1]):
            q = sql_query[label]
            t0 = time.perf_counter()
            res = sql_run(q).collect()
            torch.cuda.synchronize()
            sql_times[label].append(time.perf_counter() - t0)
            sql_check(q, res)
    for label, ts in sql_times.items():
        q = sql_query[label]
        idle = sql_idle_share(lambda: sql_run(q).collect())
        twin = (f"; DataFrame twin ds-{q} median "
                f"{statistics.median(ds_times['ds-' + q]):.4f} s"
                if f"ds-{q}" in ds_times else "; no DataFrame twin")
        print(f"{label} sf={args.tpcds_sf:g} on {name}: median "
              f"{statistics.median(ts):.4f} s, min {min(ts):.4f} s, max "
              f"{max(ts):.4f} s over {len(ts)} runs: "
              f"{[round(t, 4) for t in ts]}{twin}; {idle}; peak device "
              f"memory {peak_by_path[label]} B; scan routes "
              f"{routes_by_path[label]}; chunk decode launches "
              f"{counts_by_path[label]['bitunpack128']}"
              + "".join(f"; {e}" for e in sql_lines[label]))

    if args.profile:
        for label, make_df in all_paths.items():
            profile_run(label, lambda: make_df().collect(), repo)
        for label in ds_labels:
            profile_run(label, lambda: ds_run(ds_query[label]).collect(),
                        repo)
        for label in sql_labels:
            profile_run(label, lambda: sql_run(sql_query[label]).collect(),
                        repo)

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
             host_scan_native_s=native_s, host_scan_plain_s=plain_s,
             scan_routes_by_path=routes_by_path,
             paths=[p for p, c in counts_by_path.items()
                    if c["bitunpack128"]],
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
        # parent_ms: the parent tree's kernel on the same inputs
        # (--parent-tree), else null
        dict(entry("hash_join_probe", "hashjoin.cu", 479, ("q5-sparse",),
                   hj_err, hj_ms, hj_plain_ms, hj_bound_ms, "bytes", None),
             one_mode_ms=hj_one_ms, parent_ms=hj_parent_ms),
        # no PyTorch call builds this table: library_ms is null and sort_ms
        # is the one mode's build, one sort of the keys
        dict(entry("hash_join_build", "hashjoin.cu", 421, ("q5-sparse",),
                   hb_err, hb_ms, hb_plain_ms, hb_bound_ms, "bytes", None),
             sort_ms=hb_sort_ms),
    ]
    # how each entry's times were taken: "timing" for its ms, and every key
    # whose time came from CUDA events after five short traces (QueuedMs)
    for k in kernels:
        k["timing"] = ("cuda_events" if isinstance(k["ms"], QueuedMs)
                       else "trace")
        k["cuda_event_times"] = sorted(key for key, v in k.items()
                                       if isinstance(v, QueuedMs))
    print(f"traces: device_ms took {TRACES['taken']}, {TRACES['short']} short "
          f"(taken again), {TRACES['fallbacks']} timed with CUDA events "
          f"after five short ones")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
