"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py [--sf 1.0] [--tpcds-sf 1.0] [--reps 1]
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
   sort-based group-by of all of lineitem on ``l_orderkey``, whose first
   batch arrives sorted and skips the sort and whose later batches take
   the group-by chain, a HAVING folded into its finalize, two joins, the
   sort and ``limit(100)``), and the official q1, q3 and q5 SQL text through
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
   its oracle; then the 40 official TPC-DS SQL texts
   (``tpcds.SQL_PORTED``) through ``spark.sql`` over the same files'
   temp views, as paths sql-ds-q3 ... sql-ds-q69: each lowered, planned
   and run once with the counts reset just before the text is lowered
   (its eager subqueries run there, and their scans and launches count
   with the path's) and read just after (the oracle's rows under
   ``check_rows`` and the text's float columns; the scans, routes and
   launches checked as on the ds paths, the count kernel on sql-ds-q43;
   on every path with a hash exchange, one radix launch per partitioned
   batch and one ``murmur3_words`` per string key of each, required on
   the union-fed exchanges of sql-ds-q14, q33 and q56, each exchange's
   keys, partitions and own launches printed beside the path's totals;
   the Expand and Union execs' rows;
   q97's full outer join on the rank path
   with its probe mode, build rows, stream partitions and unmatched build
   rows emitted, q61's nested-loop join), then at most ``SQL_DS_REPS``
   timed runs of each, in turns, each held against its oracle, and one
   traced run of each for its device idle share; each text prints its
   median wall, spread, peak memory, idle share, scan routes and chunk
   decode launches, and the DataFrame twin's median wall from the same
   call where the text has one; then sql-ds-q28 under each DISTINCT
   rewrite (the two-aggregate form it takes, and the general Expand form
   forced), 4 runs each in turns, each equal to the oracle, their medians
   and peaks printed;
   then the five read-write paths at ``--sf`` (``etl_paths``): etl-parquet
   (lineitem and TPC-DS store_sales, read by the device decode and written
   by the native parquet writer, SNAPPY; pyarrow reads both back equal to
   the source; q1 over the written lineitem), etl-orc (the same through
   the native ORC writer, SNAPPY; pyarrow.orc reads both back equal; the
   port's ORC scan reads every written lineitem column back equal, the
   integers, doubles and strings on the device and the date through
   arrow; q1 through ``read_orc``), orc-foreign (lineitem written by
   pyarrow's ORC writer, ZSTD with string dictionaries, which the ORC
   decode refuses: q1 through the arrow reader), etl-csv (the native CSV
   writer over one lineitem file of four, to keep the script within its
   time; pyarrow's CSV reader reads it back equal; the six numeric
   columns through the device parse with
   ``spark.rapids.tpu.sql.csv.read.float.enabled``, integers exact and
   doubles within 1 ulp; q1 with the full schema, through the arrow
   reader, against np_q1 of that file) and etl-hive (a parquet write
   partitioned by l_returnflag,
   through the arrow writer, read back through hive discovery: q1 over
   three partitions through a hash exchange). Each write runs once, traced
   (wall, rows/s, bytes, files, the writer's routes, the source scan's
   chunk decodes and routes, the device idle share); each path's counts
   are set to 0 before its write and read after its counted q1 read-back
   (equal to ``np_q1``, its scan pruned to q1's columns, the format's
   routes equal to the prediction), with its peak device memory; then
   ``Q1_REPS`` timed q1 read-backs;
   then sweep-sf1 (``sweep_path``): the typed ``qa`` table (strF, nameF,
   byteF, shortF, intF, longF, floatF, doubleF, decimalF, booleanF, dateF,
   timestampF; 10 % nulls from ``SWEEP_SEED`` in every column but longF)
   built from the SF1 lineitem files, one row a lineitem row, written by
   pyarrow as 4 files into build/, by the native parquet and ORC writers
   (pyarrow reads each back equal to the source, column by column) and,
   one file of four, by the native CSV writer (``read_csv`` with the typed
   schema reads it back equal); then 20 statements over the pyarrow copy
   through ``spark.sql`` and the DataFrame API (LIKE, ``||``, the string,
   math and datetime functions, casts across the twelve types,
   ``%``/``pmod``/``div``, stddev/variance, ``nullif``/``least``/
   ``greatest``/``<=>``, ``pmod(hash(nameF, intF), 8)``, a 6.0M-row string
   projection), each counted once (the chunk decode once per dictionary
   chunk of its columns, none for a scan with a timestamp, which takes the
   arrow reader; the count kernel once per aggregate batch;
   ``murmur3_words`` once per batch of the hash statement), timed
   ``SWEEP_REPS`` times and traced once, each result held against an
   oracle over numpy and pyarrow.compute (a numpy Murmur3 for ``hash()``;
   floats within the stated tolerance); then the chunk decode at value
   widths 1, 2 and 4-float, ``murmur3_words`` and ``onehot_sums_f32`` on
   the path's own inputs against their plain versions, timed beside their
   bounds (``sweep_sf1`` in their kernels-line entries);
   then dfapi-sf1 (``dfapi_paths``), on the SF1 TPC-DS files: ds-windows
   (``store_sales`` read from its 4 files as 4 partitions, joined to
   ``item``, ``with_column``/``with_column_renamed``/``drop``, one
   ``window`` of five expressions over four partition/order specs, which
   plans four chained window execs over three hash exchanges and a
   gather, then ``filter(rn <= 3)``) and sql-ds-windows (the same query as
   SQL text), both counted like the TPC-DS paths and held row for row to
   a numpy oracle; over ``spark.range(0, 2**27, num_slices=8)``:
   range-count (``count()``), range-group-count (the id modulo 4,000 as a
   string key, through the dense count kernel and a hash exchange),
   range-sorted-sample and range-sorted-aggregates
   (``sort_within_partitions``, then ``monotonically_increasing_id()`` and
   ``spark_partition_id()``, held to their closed form on a sample and on
   keyless max/sum/count); input-files and input-files-repartition
   (``group_by(input_file_name()).count()`` over the 4 files: each file's
   footer row count, then ``""`` after a repartition). Each path is
   counted once with every launch predicted (the chunk decode a
   dictionary chunk, the count kernel an aggregate batch, the radix step
   a partitioned batch, ``murmur3_words`` a string key of each, no hash
   build), timed ``--reps`` times and traced once for its idle share;
   then nested-sf1 (``nested_paths``), arrays, structs and maps as device
   columns on the same SF1 files: collect-orders (lineitem's 6.0M rows →
   ``collect_list(l_suppkey)``, ``collect_set(l_returnflag)``,
   ``collect_list(l_shipdate)`` and ``count(*)`` per order, 1.5M groups,
   then ``size``, ``element_at(.., 1)``, ``element_at(.., -1)``,
   ``array_contains(flags, 'R')`` and a struct over them), its
   ``repartition(8, l_orderkey)`` then ``explode``/``posexplode`` and a
   group-by count (6.0M exploded rows), split-words (``store_sales`` ⋈
   ``item``, ``split(i_item_desc, ' ')``, ``size`` and an item) and its
   explode counted by word (8.64M rows), struct-map (a struct, a map and
   an array over ``store_sales``, extracted fused and from the
   materialized columns), nested-write (the collected frame to parquet
   through the arrow writer, read back into list columns and exploded),
   pivot (``group_by(l_returnflag).pivot(l_linestatus, ['F', 'O'])``) and
   pivot-first (``PivotFirst`` over the same keys), and row-buffer
   (lineitem's fixed-width columns and q1's columns through the packed
   row format both ways, then q1 over the rows); each held against a
   numpy/pyarrow oracle from the source files, counted once with every
   launch predicted, timed ``NESTED_REPS`` more times and traced once;
   then deep-nested-sf1 (``deep_nested_paths``), nested elements and
   fields and ``rand()`` on the same files: nested-orders (lineitem by
   order: ``first`` of the flag and status and ``collect_list`` of a
   five-field struct, 1.5M orders of 6.0M structs, through
   ``repartition(4, l_orderkey)`` into parquet by the arrow writer and read
   back), nested-orders-explode (the four read-back files, ``explode`` of
   the ``array<struct>``, a sum by ``l_suppkey % 1000``),
   nested-orders-extract (``lines[0].l_suppkey``, ``size``, ``when``,
   ``coalesce`` and ``=`` over the arrays of structs), nested-orders-rollup
   (ROLLUP over (flag, status) carrying the arrays into ``collect_list``:
   an ``array<array<struct>>``), ds-word-lists (store_sales ⋈ item by
   customer, ``collect_list(split(i_item_desc, ' '))``, exploded twice)
   and sample-rand (``rand(42)`` over lineitem, and a ``rand(7) < 0.01``
   sample counted, bit for bit a CPU session's on the same files); each
   held to a numpy/pyarrow oracle, counted once with every launch
   predicted, timed ``DEEP_REPS`` more times and traced once;
   then ordered-nested-sf1 (``ordered_nested_paths``), the order over
   whole nested values on the same files: nested-max-min (1.5M supplier
   lists ``collect_list(l_suppkey)`` by order, then ``max`` and ``min`` of
   them by ``l_orderkey % 10000``), nested-sort (the lists as a global
   ``order_by(desc(supps), l_orderkey)``, the whole order held to numpy's
   lexicographic sort), nested-collect-set (by supplier,
   ``collect_set`` of a struct of the flag, the status and the ship year,
   and of a two-string array)
   and nested-set-of-lines (the read-back nested-orders files,
   ``collect_set(lines)`` by ``size(lines)``: 1.5M distinct
   ``array<struct>``); each with its rank passes, counted, timed
   ``ORDERED_REPS`` more times and traced once; then the group-by
   remainder (the packed key with its range hint, the right-sizing, the
   chain and the fused HAVING) beside ``stageFusion.enabled=false`` on q3,
   q18, ds-windows and sql-ds-q14 (``groupby_rest_compare``): walls in
   turns, aggregate host syncs and the sorts' device time, recorded beside
   the card and held to the same rows; and last join-fusion-sf1
   (``join_fusion_paths``): ladder-fusion (q3, q5, q5-sparse and q18
   beside ``stageFusion.enabled=false``, on/off/off/on, each turn counted:
   the chains and hoists, the joins' host syncs and device time, the same
   rows), chain-3hop (lineitem filtered and projected through orders,
   customer and nation, one chain of three hops), chain-dup-build (a chain
   over a duplicate-keyed partsupp build, every batch degraded to the
   hops one after another), q1-encoded and q1-dense (each chunk decoded
   at its first read, and every chunk decoded as the scan yields it, bit
   for bit, every chunk decoded once) and scan-pushed-filter
   (TPC-H q6's predicate pushed into the scan, its double conjuncts the
   residual on the card); each held to a numpy/pyarrow oracle, counted
   with its launches predicted, timed ``JOIN_FUSION_REPS`` more times and
   traced once. The TPC-H paths' chains and hoists are checked against
   ``FUSION_SHAPES``. Every phase runs under the session's default conf,
   the pipelined stages on. Then runtime-sf1
   (``runtime_paths``): the ladder under ``bench.py``'s session confs with
   the pipeline on and off in turns, q1-repartition under a device budget
   of half its shuffle blocks (the spill tiers and the direct store),
   q1-files through the serializing shuffle, q1-files and q5 under
   injected OOMs, a corrupted spill payload recomputed, and a range
   exchange with a local sort against numpy's sort; each counted with its
   launches predicted (``runtime_prediction``) and traced once;
6. prints how many traces ``device_ms`` took and found short, one JSON
   line describing every ported kernel (``launches``, its launches summed
   over every path's counted run; each path's, the TPC-DS paths among
   them, under ``launches_by_path``; ``timed_paths_launches``, those of
   the runs its times cover), the card's name
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
import contextlib
import datetime
import faulthandler
import json
import math
import os
import re
import shutil
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
# seconds after which a run that has not finished dumps every thread's stack
# and exits 1: a hang (a deadlock among the pipelined stages, say) fails
# inside the 1,200 s the script has and shows where it stood
WATCHDOG_S = 1140
# timed runs of each q1 path, at most (``--reps`` may ask fewer)
Q1_REPS = 2
# timed runs of each official TPC-DS SQL text (the sql-ds paths): 1 since
# the read-write paths took the script past 1.3 times its earlier length
SQL_DS_REPS = 1


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


def traced(run, raw: bool = False) -> tuple:
    """Trace run() with torch.profiler. A trace can lose the device records
    of its first launches, however long they run (3 or 4 after the card sat
    idle or the paths had run, up to about 18 right after the SF1 paths),
    so WARMUP_LAUNCHES tiny sleep kernels go first, inside the same trace,
    and the census covers only the host calls inside run's region and the
    device records that the warm-up did not enqueue. Returns (the census's
    (name, on_device, correlation id) tuples for trace_check, [(name, us)]
    of its device records, run's wall seconds); with ``raw`` also (the host
    events inside run's region, the device records) as kineto events."""
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
    out = (census, [(e.name(), e.duration_ns() / 1e3) for e in device], wall)
    return out + ((inside, device),) if raw else out


def join_device_ms(run) -> tuple:
    """(device ms of the work the hash joins enqueued, device ms of every
    record, traced wall s, why the trace is short or "") of one run(): a
    device record counts for the joins when the host call that enqueued it
    started inside a ``HashJoin.probe`` range (``exec/joins.PROBE_RANGE``,
    around each build, probe, emit and chain pass, entered only while
    ``exec/joins.TRACE_RANGES`` is set, as it is for this trace) on the same
    thread. A short trace is taken again, at most three times."""
    from spark_rapids_tpu_torch.exec import joins as JX
    JX.TRACE_RANGES = True
    try:
        for _ in range(3):
            census, device, wall, (host, dev_ev) = traced(run, raw=True)
            why = trace_check(census)[3]
            if not why:
                break
    finally:
        JX.TRACE_RANGES = False
    PROBE_RANGE = JX.PROBE_RANGE
    ranges = {}
    for e in host:
        if e.name() == PROBE_RANGE:
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    joined = set()
    for e in host:
        if e.name().startswith(ENQUEUE_CALLS) and any(
                lo <= e.start_ns() <= hi
                for lo, hi in ranges.get(e.start_thread_id(), ())):
            joined.add(e.correlation_id())
    join_us = sum(e.duration_ns() for e in dev_ev
                  if e.correlation_id() in joined) / 1e3
    return (join_us / 1e3, sum(us for _n, us in device) / 1e3, wall, why)


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
    one aggregate (COMPLETE, on the sort-based path), and no FilterExec
    above it: q18's HAVING is folded into the aggregate's finalize
    (``fuse_having``). Returns a line that names it."""
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
            and not having
            and (aggs[0].postfilter is not None) == (label == "q18")):
        raise AssertionError(f"{label}: unexpected plan\n{plan}")
    return (f"GlobalLimitExec({plan.limit}) > SortExec > "
            + ("... > HashAggregateExec (HAVING fused) "
               if aggs[0].postfilter is not None else
               "... > HashAggregateExec ")
            + f"mode={aggs[0].mode} (segment path); the limit reads no "
            "count back (row counts are host ints)")


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
    """The hash joins of an exec tree, top down; a probe chain's hops count
    as its joins, the top hop first (each keeps its own stats)."""
    from spark_rapids_tpu_torch.exec.joins import (BroadcastHashJoinChainExec,
                                                   HashJoinExec)
    out = [plan] if isinstance(plan, HashJoinExec) else []
    if isinstance(plan, BroadcastHashJoinChainExec):
        out = plan.hops[::-1]
    for c in plan.children:
        out += joins(c)
    return out


def join_execs(plan) -> list:
    """The probe chains and the unchained hash joins of an exec tree, top
    down: the execs whose ``stats["syncs"]`` sum to the joins' host syncs."""
    from spark_rapids_tpu_torch.exec.joins import (BroadcastHashJoinChainExec,
                                                   HashJoinExec)
    out = ([plan] if isinstance(plan, (HashJoinExec,
                                       BroadcastHashJoinChainExec)) else [])
    for c in plan.children:
        out += join_execs(c)
    return out


def fusion_shape(plan) -> str:
    """Each chain's hops with their probe modes and each join's hoisted
    prefilter and preproject, top down, as text."""
    from spark_rapids_tpu_torch.exec.joins import BroadcastHashJoinChainExec

    def one(j):
        keys = " and ".join(f"{lk.name} = {rk.name}"
                            for lk, rk in zip(j.left_keys, j.right_keys))
        return (f"{keys} [{j.stats['probe_mode']}"
                + (", prefilter" if j.stream_prefilter is not None else "")
                + (", preproject" if j.stream_preproject is not None
                   else "") + "]")
    parts = []
    for x in join_execs(plan):
        if isinstance(x, BroadcastHashJoinChainExec):
            parts.append(f"chain of {len(x.hops)} hops (" + " -> ".join(
                one(h) for h in x.hops) + ")")
        else:
            parts.append(f"join {one(x)}")
    return "; ".join(parts) or "no hash join"


def fusion_signature(plan) -> tuple:
    """Top down: ("chain", each hop's (prefilter?, preproject?)) for a
    chain, ("join", (prefilter?, preproject?)) for an unchained hash
    join."""
    from spark_rapids_tpu_torch.exec.joins import BroadcastHashJoinChainExec

    def hoists(j):
        return (j.stream_prefilter is not None,
                j.stream_preproject is not None)
    return tuple(
        ("chain", tuple(hoists(h) for h in x.hops))
        if isinstance(x, BroadcastHashJoinChainExec) else ("join", hoists(x))
        for x in join_execs(plan))


# the chains and hoists the planner forms on the TPC-H paths (the
# reference's planner forms the same on q3, q5 and q18,
# tests/test_torch_join_fusion.py): TPC-H q5 and q18 chain two hops, q3's
# two joins take their stream's filter and projection
_PP, _PF_PP, _PF, _NONE = (False, True), (True, True), (True, False), \
    (False, False)
FUSION_SHAPES = {
    "q3": (("join", _PF_PP), ("join", _PF_PP)),
    "sql-q3": (("join", _PF), ("join", _PF)),
    "q5": (("chain", (_PP, _PP)), ("join", _PF_PP), ("join", _PP),
           ("join", _NONE)),
    "q5-sparse": (("join", _PF), ("chain", (_PP, _PP)), ("join", _PF_PP),
                  ("join", _NONE)),
    "sql-q5": (("chain", (_NONE, _NONE)), ("join", _NONE),
               ("chain", (_NONE, _NONE))),
    "q18": (("chain", (_PP, _PP)),),
}


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


# the read-write paths: the port's writers and its ORC and CSV scans, on
# TPC-H lineitem (and TPC-DS store_sales, for its decimal money columns)
ETL_LABELS = ("etl-parquet", "etl-orc", "orc-foreign", "etl-csv", "etl-hive")
ETL_KERNELS = {"etl-parquet": ("bitunpack128", "onehot_sum_f32"),
               "etl-orc": ("bitunpack128", "onehot_sum_f32"),
               "orc-foreign": ("onehot_sum_f32",),
               "etl-csv": ("bitunpack128", "onehot_sum_f32"),
               "etl-hive": ("bitunpack128", "onehot_sum_f32",
                            "murmur3_words", "radix_ranks")}
# the six numeric lineitem columns the etl-csv path parses on the device
CSV_NUMERIC = ("l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice",
               "l_discount", "l_tax")


def data_files(d: str, ext: str) -> list:
    """The data files of a directory tree, sorted by path (as a scan lists
    them), without the '_'/'.' entries."""
    out = []
    for dirpath, dirnames, files in os.walk(d):
        dirnames[:] = sorted(x for x in dirnames
                             if not x.startswith(("_", ".")))
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith(ext) and not f.startswith(("_", "."))]
    return sorted(out)


def traced_write(run) -> tuple:
    """One write under the tracer: (its result, wall seconds, device busy
    seconds, the idle share as text; from a short trace only a bound)."""
    got = []
    census, device, wall = traced(lambda: got.append(run()))
    why = trace_check(census)[3]
    busy = sum(us for _name, us in device) / 1e6
    share = (f"device idle share {1 - busy / wall:.4f}" if not why else
             f"SHORT TRACE ({why}): device idle share at most "
             f"{1 - busy / wall:.4f}")
    return got[0], wall, busy, share


def max_ulp(got, want) -> int:
    """The largest distance in units in the last place between two float64
    columns (nulls equal), or raises when their null layouts differ."""
    g = got.combine_chunks() if hasattr(got, "combine_chunks") else got
    w = want.combine_chunks() if hasattr(want, "combine_chunks") else want
    gv, wv = g.is_valid().to_numpy(zero_copy_only=False), \
        w.is_valid().to_numpy(zero_copy_only=False)
    if not np.array_equal(gv, wv):
        raise AssertionError("the CSV read's nulls differ from the source's")
    a = g.fill_null(0.0).to_numpy(zero_copy_only=False)[gv].view(np.int64)
    b = w.fill_null(0.0).to_numpy(zero_copy_only=False)[wv].view(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def etl_paths(spark, dev, name, li_files, ss_files, exp_q1, root, counting,
              agg_batches, scan_chunks, q1_reps, sf: float) -> tuple:
    """The five read-write paths, each once with the counts reset just
    before its write (``counting``) and read just after its counted q1
    read-back, then ``q1_reps`` timed q1 read-backs. Returns each path's
    (launch counts, peak device memory), and the lines it printed."""
    import pyarrow as pa
    import pyarrow.csv as pcsv
    import pyarrow.orc as pa_orc     # the machine must have it: no skip
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.io import csv_native as CN
    from spark_rapids_tpu_torch.io import orc_native as ON
    from spark_rapids_tpu_torch.io import parquet_native as PN
    from spark_rapids_tpu_torch.io import writer as WR
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    li_src = pa.concat_tables([pq.read_table(f) for f in li_files])
    ss_src = pa.concat_tables([pq.read_table(f) for f in ss_files])
    # one batch (one written file) per source row group: the scan's device
    # decode yields one batch a row group
    li_groups = [pq.ParquetFile(f).metadata.num_row_groups for f in li_files]
    ss_groups = [pq.ParquetFile(f).metadata.num_row_groups for f in ss_files]
    li_dir, ss_dir = (os.path.dirname(li_files[0]),
                      os.path.dirname(ss_files[0]))
    li_chunks, li_refused = scan_chunks(li_dir, li_src.column_names)
    ss_chunks, ss_refused = scan_chunks(ss_dir, ss_src.column_names)
    # the flags of each source row group: the partitioned write's files
    flags = sum(len(pa.compute.unique(pq.ParquetFile(f).read_row_group(
        g, columns=["l_returnflag"]).column(0)))
        for f in li_files for g in range(pq.ParquetFile(f).metadata
                                         .num_row_groups))
    full = T.StructType.from_arrow(li_src.schema)
    numeric = T.StructType([full[c] for c in CSV_NUMERIC])
    csv_spark = TorchSession(
        {**spark.conf.settings,
         "spark.rapids.tpu.sql.csv.read.float.enabled": "true"},
        device=spark.device)
    print(f"etl sources: lineitem {li_src.num_rows} rows x "
          f"{li_src.num_columns} columns in {len(li_files)} files "
          f"({sum(li_groups)} row groups, {li_chunks} dictionary chunks), "
          f"store_sales {ss_src.num_rows} rows x {ss_src.num_columns} "
          f"columns in {len(ss_files)} files ({sum(ss_groups)} row groups, "
          f"{ss_chunks} dictionary chunks) read in "
          f"{time.perf_counter() - t0:.1f} s")
    q1_cols = sorted(Q_TABLES["q1"]["lineitem"])
    out_of = {k: os.path.join(root, k) for k in (
        "lineitem_parquet", "store_sales_parquet", "lineitem_orc",
        "store_sales_orc", "lineitem_orc_foreign", "lineitem_csv",
        "lineitem_hive")}
    results, lines = {}, []

    def written(d, ext, read, src):
        """pyarrow's read of every file of d, in order, equal to src."""
        files = data_files(d, ext)
        back = pa.concat_tables([read(f) for f in files])
        if not back.equals(src):
            raise AssertionError(f"{d}: pyarrow's read-back differs from "
                                 f"the source ({back.schema} vs "
                                 f"{src.schema})")
        return files

    def write(label, what, df_write, src_rows, files_want, routes_want,
              chunks_want):
        """One traced write, its routes and its scan's chunk decodes."""
        launched = dict(CK.launches)
        PN.reset_routes()
        WR.reset_routes()
        st, wall, busy, idle = traced_write(df_write)
        routes = dict(WR.routes)
        scan = dict(PN.routes)
        decodes = CK.launches["bitunpack128"] - launched["bitunpack128"]
        if (st.num_rows, st.num_files) != (src_rows, files_want) or \
                routes != routes_want:
            raise AssertionError(
                f"{label} {what}: wrote {st.num_rows} rows in "
                f"{st.num_files} files by {routes}, want {src_rows} rows in "
                f"{files_want} files by {routes_want}")
        n, refused = chunks_want
        if decodes != n or scan != {"native_chunk": 0, "native_pages": n,
                                    "arrow": refused, "python": 0}:
            raise AssertionError(
                f"{label} {what}: the source scan launched {decodes} chunk "
                f"decodes with routes {scan}, want {n} and {refused} "
                f"through arrow")
        line = (f"{label} write {what} on {name}: wall {wall:.4f} s, "
                f"{st.num_rows} rows, {st.num_rows / wall:.0f} rows/s, "
                f"{st.num_bytes} B in {st.num_files} files; writer routes "
                f"{routes}; source scan {decodes} chunk decodes, routes "
                f"{scan}; {idle} (device activity {busy:.4f} s)")
        print(line)
        lines.append(line)
        return st

    def read_back(label, make_df, routes_of, routes_want, exp=exp_q1):
        """The counted q1 read-back: equal to np_q1 (``exp``), its scan
        pruned to q1's columns, its format's routes as predicted."""
        for mod in (PN, ON, CN):
            mod.reset_routes()
        launched = dict(CK.launches)
        plan = tpch.q1({"lineitem": make_df()}).physical_plan()
        t0 = time.perf_counter()
        res = plan.execute_collect()
        first = time.perf_counter() - t0
        check_q1(res.to_pylist(), exp)
        routes = dict(routes_of.routes)
        if routes != routes_want:
            raise AssertionError(f"{label} q1 read-back: routes {routes}, "
                                 f"want {routes_want}")
        for _d, ex in scans(plan):
            if sorted(ex.output.names) != q1_cols:
                raise AssertionError(
                    f"{label}: the read-back scan read {ex.output.names}, "
                    f"q1 reads {q1_cols}")
        own = {k: CK.launches[k] - launched[k] for k in CK.launches}
        print(f"{label} q1 read-back first run: {first:.3f} s; routes "
              f"{routes}; scan columns {q1_cols}; launches "
              f"{ {k: v for k, v in own.items() if v} }")
        return plan, own

    def timed_q1(label, make_df, exp=exp_q1):
        ts = []
        for _ in range(q1_reps):
            t0 = time.perf_counter()
            res = tpch.q1({"lineitem": make_df()}).collect()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check_q1(res.to_pylist(), exp)
        line = (f"{label} q1 read-back sf={sf:g} on {name}: median "
                f"{statistics.median(ts):.4f} s, min {min(ts):.4f} s, max "
                f"{max(ts):.4f} s over {len(ts)} runs: "
                f"{[round(t, 4) for t in ts]}")
        print(line)
        lines.append(line)

    def finish(label, own_q1, exchanges_of=None):
        counts = dict(CK.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        for k in ETL_KERNELS[label]:
            if counts[k] <= 0:
                raise AssertionError(f"kernel {k} never launched on the "
                                     f"{label} path")
        count_batches = [k for k in agg_batches if k]
        if counts["onehot_sum_f32"] != len(count_batches):
            raise AssertionError(
                f"{label}: {len(count_batches)} aggregate batches with "
                f"count-like requests, {counts['onehot_sum_f32']} count "
                f"launches")
        if exchanges_of is not None:
            batches = sum(e.map_batches for e in exchanges(exchanges_of))
            if (counts["murmur3_words"] != 2 * batches
                    or counts["radix_ranks"] != batches):
                raise AssertionError(
                    f"{label}: {batches} partitioned batches but "
                    f"murmur3_words launched {counts['murmur3_words']} and "
                    f"radix_ranks {counts['radix_ranks']} times")
        line = (f"{label} counted run (write and q1 read-back): launches "
                f"{ {k: v for k, v in counts.items() if v} }; peak device "
                f"memory {peak} B")
        print(line)
        lines.append(line)
        results[label] = (counts, peak)

    n_li = sum(li_groups)
    native = {"native_files": n_li, "arrow_files": 0}

    # etl-parquet: lineitem and store_sales through the native parquet
    # writer (SNAPPY), read back by pyarrow; q1 over the written lineitem
    with counting():
        out = out_of["lineitem_parquet"]
        write("etl-parquet", "lineitem parquet",
              lambda: spark.read_parquet(li_files).write_parquet(
                  out, mode="overwrite"),
              li_src.num_rows, n_li, native, (li_chunks, li_refused))
        written(out, ".parquet", pq.read_table, li_src)
        out_ss = out_of["store_sales_parquet"]
        write("etl-parquet", "store_sales parquet",
              lambda: spark.read_parquet(ss_files).write_parquet(
                  out_ss, mode="overwrite"),
              ss_src.num_rows, sum(ss_groups),
              {"native_files": sum(ss_groups), "arrow_files": 0},
              (ss_chunks, ss_refused))
        written(out_ss, ".parquet", pq.read_table, ss_src)
        # the written files: the two flag columns dictionary-encoded (one
        # chunk decode each a file), the five others PLAIN (arrow)
        _plan, own = read_back(
            "etl-parquet", lambda: spark.read_parquet(out), PN,
            {"native_chunk": 0, "native_pages": 2 * n_li,
             "arrow": 5 * n_li, "python": 0})
        if own["bitunpack128"] != 2 * n_li:
            raise AssertionError(f"etl-parquet: {own['bitunpack128']} chunk "
                                 f"decodes in the read-back, want {2 * n_li}")
        finish("etl-parquet", own)
    timed_q1("etl-parquet", lambda: spark.read_parquet(out_of[
        "lineitem_parquet"]))

    # etl-orc: the same through the native ORC writer (SNAPPY), read back by
    # pyarrow.orc and by the port's ORC scan; q1 over it
    def orc_read(f):
        return pa_orc.ORCFile(f).read()
    with counting():
        out = out_of["lineitem_orc"]
        write("etl-orc", "lineitem orc",
              lambda: spark.read_parquet(li_files).write_orc(
                  out, mode="overwrite"),
              li_src.num_rows, n_li, native, (li_chunks, li_refused))
        written(out, ".orc", orc_read, li_src)
        out_ss = out_of["store_sales_orc"]
        write("etl-orc", "store_sales orc",
              lambda: spark.read_parquet(ss_files).write_orc(
                  out_ss, mode="overwrite"),
              ss_src.num_rows, sum(ss_groups),
              {"native_files": sum(ss_groups), "arrow_files": 0},
              (ss_chunks, ss_refused))
        written(out_ss, ".orc", orc_read, ss_src)
        # the port's ORC scan of every column: the two int64, four double
        # and two string columns on the device, l_shipdate (DATE) through
        # arrow, one stripe a file
        ON.reset_routes()
        t0 = time.perf_counter()
        back = spark.read_orc(out).collect()
        whole_s = time.perf_counter() - t0
        if not back.equals(li_src):
            raise AssertionError("etl-orc: read_orc of the written lineitem "
                                 "differs from the source")
        if ON.routes != {"device_columns": 8 * n_li,
                         "arrow_columns": n_li, "arrow_files": 0}:
            raise AssertionError(f"etl-orc: whole read routes {ON.routes}")
        line = (f"etl-orc read_orc of every column: {whole_s:.3f} s, equal "
                f"to the source; routes {dict(ON.routes)}")
        print(line)
        lines.append(line)
        del back
        # q1 reads four doubles and two strings on the device, the date
        # through arrow
        _plan, own = read_back(
            "etl-orc", lambda: spark.read_orc(out), ON,
            {"device_columns": 6 * n_li, "arrow_columns": n_li,
             "arrow_files": 0})
        finish("etl-orc", own)
    timed_q1("etl-orc", lambda: spark.read_orc(out_of["lineitem_orc"]))

    # orc-foreign: lineitem written by pyarrow's ORC writer (ZSTD, string
    # dictionaries, its default stripe size), one file per source file; the
    # ORC decode refuses ZSTD, so every file goes through the arrow reader
    out = out_of["lineitem_orc_foreign"]
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    t0 = time.perf_counter()
    for i, f in enumerate(li_files):
        pa_orc.write_table(pq.read_table(f), os.path.join(
            out, f"part-{i:04d}.orc"), compression="zstd",
            dictionary_key_size_threshold=1.0)
    foreign_s = time.perf_counter() - t0
    fmeta = [pa_orc.ORCFile(f) for f in data_files(out, ".orc")]
    line = (f"orc-foreign: pyarrow wrote {len(fmeta)} ZSTD files, "
            f"{sum(m.nstripes for m in fmeta)} stripes, in {foreign_s:.2f} s "
            f"(set-up, not the port)")
    print(line)
    lines.append(line)
    written(out, ".orc", orc_read, li_src)
    with counting():
        _plan, own = read_back(
            "orc-foreign", lambda: spark.read_orc(out), ON,
            {"device_columns": 0, "arrow_columns": 0,
             "arrow_files": len(li_files)})
        finish("orc-foreign", own)
    timed_q1("orc-foreign", lambda: spark.read_orc(
        out_of["lineitem_orc_foreign"]))

    # etl-csv: the native CSV writer over one lineitem file of four (to
    # keep the script within its time: the write of all four took 32.5 s
    # of host text formatting); pyarrow's CSV reader reads it back
    # equal; the six numeric columns through the device parse; q1 with the
    # full schema (strings and a date: the arrow reader) against np_q1 of
    # that file
    one_dir = os.path.join(root, "lineitem_one_file")
    if os.path.isdir(one_dir):
        shutil.rmtree(one_dir)
    os.makedirs(one_dir)
    one = os.path.join(one_dir, os.path.basename(li_files[0]))
    try:
        os.link(li_files[0], one)
    except OSError:
        shutil.copyfile(li_files[0], one)
    one_src = pq.read_table(one)
    n_one = li_groups[0]
    one_chunks = scan_chunks(one_dir, one_src.column_names)
    exp_q1_one = tpch.np_q1(tpch.load_np({"lineitem": one_dir}))

    def csv_read(f):
        return pcsv.read_csv(f, convert_options=pcsv.ConvertOptions(
            column_types=li_src.schema))
    with counting():
        out = out_of["lineitem_csv"]
        write("etl-csv", "lineitem csv (one file of four)",
              lambda: spark.read_parquet(one_dir).write_csv(
                  out, mode="overwrite"),
              one_src.num_rows, n_one,
              {"native_files": n_one, "arrow_files": 0}, one_chunks)
        written(out, ".csv", csv_read, one_src)
        CN.reset_routes()
        t0 = time.perf_counter()
        back = csv_spark.read_csv(out, schema=numeric).collect()
        num_s = time.perf_counter() - t0
        if CN.routes != {"device_files": n_one, "arrow_files": 0}:
            raise AssertionError(f"etl-csv: numeric read routes {CN.routes}")
        ulps = {}
        for c in CSV_NUMERIC:
            if pa.types.is_floating(one_src.schema.field(c).type):
                ulps[c] = max_ulp(back[c], one_src[c])
                if ulps[c] > 1:
                    raise AssertionError(f"etl-csv: {c} {ulps[c]} ulp from "
                                         f"the source")
            elif not back[c].equals(one_src[c]):
                raise AssertionError(f"etl-csv: {c} differs from the source")
        line = (f"etl-csv read_csv of the six numeric columns (device parse, "
                f"{n_one} files): {num_s:.3f} s, {back.num_rows} rows; "
                f"integers exact, doubles' largest distance in ulp {ulps}")
        print(line)
        lines.append(line)
        del back
        _plan, own = read_back(
            "etl-csv", lambda: csv_spark.read_csv(out, schema=full), CN,
            {"device_files": 0, "arrow_files": n_one}, exp=exp_q1_one)
        finish("etl-csv", own)
    timed_q1("etl-csv", lambda: csv_spark.read_csv(out_of["lineitem_csv"],
                                                   schema=full),
             exp=exp_q1_one)

    # etl-hive: a partitioned parquet write (the arrow writer), read back
    # through hive discovery: three partitions, PARTIAL -> exchange -> FINAL
    with counting():
        out = out_of["lineitem_hive"]
        write("etl-hive", "lineitem parquet partitioned by l_returnflag",
              lambda: spark.read_parquet(li_files).write_parquet(
                  out, partition_by=["l_returnflag"], mode="overwrite"),
              li_src.num_rows, flags,
              {"native_files": 0, "arrow_files": flags},
              (li_chunks, li_refused))
        dirs = sorted(x for x in os.listdir(out) if not x.startswith("_"))
        if dirs != ["l_returnflag=A", "l_returnflag=N", "l_returnflag=R"]:
            raise AssertionError(f"etl-hive: directories {dirs}")
        plan, own = read_back("etl-hive", lambda: spark.read_parquet(out),
                              PN, {"native_chunk": 0, "native_pages": 0,
                                   "arrow": 0, "python": 0})
        finish("etl-hive", own, exchanges_of=plan)
        line = f"etl-hive: directories {dirs}"
        print(line)
        lines.append(line)
    timed_q1("etl-hive", lambda: spark.read_parquet(out_of["lineitem_hive"]))
    return results, lines


QA_STRINGS = ["alpha", "Beta", "gamma", "", "déjà vu", "x" * 20]
QA_NAMES = 150_000
SWEEP_SEED = 15
# timed runs of each sweep-sf1 statement after its counted run: 1 since
# deep-nested-sf1 took the script past 850 s on a slower host
SWEEP_REPS = 1


def _u32(x):
    return np.asarray(x, np.uint64) & 0xFFFFFFFF


def _mix_k1(k1):
    k1 = _u32(k1 * 0xCC9E2D51)
    k1 = _u32((k1 << 15) | (k1 >> 17))
    return _u32(k1 * 0x1B873593)


def _mix_h1(h1, k1):
    h1 = _u32(h1 ^ k1)
    h1 = _u32((h1 << 13) | (h1 >> 19))
    return _u32(h1 * 5 + 0xE6546B64)


def _fmix(h1, length):
    h1 = _u32(h1 ^ np.uint64(length))
    h1 = _u32(h1 ^ (h1 >> 16))
    h1 = _u32(h1 * 0x85EBCA6B)
    h1 = _u32(h1 ^ (h1 >> 13))
    h1 = _u32(h1 * 0xC2B2AE35)
    return _u32(h1 ^ (h1 >> 16))


def np_murmur3_int(v, seed):
    """Spark's ``Murmur3_x86_32.hashInt`` in numpy: (value int32, seed
    uint32 array or int) → uint32."""
    k1 = _mix_k1(_u32(np.asarray(v, np.int64)))
    return _fmix(_mix_h1(_u32(np.asarray(seed, np.int64)), k1), 4)


def np_murmur3_bytes(strings, seed: int):
    """Spark's ``hashUnsafeBytes`` of each string's UTF-8 bytes in numpy:
    the whole little-endian words, then each tail byte (signed) on its
    own; strings of one byte length hash together."""
    data = [s.encode("utf-8") for s in strings]
    out = np.zeros(len(data), np.uint64)
    by_len = {}
    for i, b in enumerate(data):
        by_len.setdefault(len(b), []).append(i)
    for n, idx in by_len.items():
        raw = np.frombuffer(b"".join(data[i] for i in idx), np.uint8)
        raw = raw.reshape(len(idx), n) if n else raw.reshape(len(idx), 0)
        h1 = np.full(len(idx), seed, np.uint64)
        whole = n // 4
        for w in range(whole):
            word = (raw[:, 4 * w].astype(np.uint64)
                    | raw[:, 4 * w + 1].astype(np.uint64) << 8
                    | raw[:, 4 * w + 2].astype(np.uint64) << 16
                    | raw[:, 4 * w + 3].astype(np.uint64) << 24)
            h1 = _mix_h1(h1, _mix_k1(word))
        for t in range(4 * whole, n):
            sb = raw[:, t].astype(np.int8).astype(np.int64)
            h1 = _mix_h1(h1, _mix_k1(_u32(sb)))
        out[idx] = _fmix(h1, n)
    return out


def _signed32(u):
    return np.asarray(u, np.uint64).astype(np.uint32).view(np.int32)


def qa_source(li_files, seed: int = SWEEP_SEED):
    """The sweep's ``qa`` table from the lineitem files, one row a lineitem
    row, the typed columns of spark-rapids' qa_nightly tables: 10 % nulls
    from ``numpy.random.default_rng(seed)`` in every column but longF.
    Returns (the arrow table, its columns as numpy (values, valid))."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    li = pa.concat_tables([pq.read_table(f, columns=[
        "l_orderkey", "l_suppkey", "l_quantity", "l_discount",
        "l_extendedprice", "l_returnflag", "l_shipdate"]) for f in li_files])
    n = li.num_rows
    rng = np.random.default_rng(seed)
    k = li.column("l_orderkey").to_numpy().astype(np.int64)
    date = li.column("l_shipdate").cast(pa.int32()).to_numpy()
    price = li.column("l_extendedprice").to_numpy()
    cols = {
        "strF": (k % 6).astype(np.int32),
        "nameF": ((k * 2654435761) % QA_NAMES).astype(np.int32),
        "byteF": li.column("l_quantity").to_numpy().astype(np.int8),
        "shortF": ((k * 7919) % 65536 - 32768).astype(np.int16),
        "intF": li.column("l_suppkey").to_numpy().astype(np.int32),
        "longF": k,
        "floatF": li.column("l_discount").to_numpy().astype(np.float32),
        "doubleF": price,
        "decimalF": np.round(price * 100).astype(np.int64),
        "booleanF": (li.column("l_returnflag").to_numpy(
            zero_copy_only=False) == "R"),
        "dateF": date,
        "timestampF": (date.astype(np.int64) * 86_400_000_000
                       + ((k * 7919) % 86400) * 1_000_000),
    }
    valid = {c: (np.ones(n, bool) if c == "longF"
                 else rng.random(n) >= 0.1) for c in cols}
    names = pa.array([f"Customer#{i:09d}" for i in range(QA_NAMES)])

    def arr(c):
        v, m = cols[c], ~valid[c]
        if c == "strF":
            return pa.DictionaryArray.from_arrays(
                pa.array(v, mask=m), pa.array(QA_STRINGS))
        if c == "nameF":
            return pa.DictionaryArray.from_arrays(pa.array(v, mask=m), names)
        if c == "decimalF":
            words = np.zeros((n, 2), np.int64)
            words[:, 0] = v
            bits = np.packbits(valid[c], bitorder="little")
            return pa.Array.from_buffers(
                pa.decimal128(12, 2), n,
                [pa.py_buffer(bits.tobytes()), pa.py_buffer(words.tobytes())])
        if c == "dateF":
            return pa.array(v, mask=m).cast(pa.date32())
        if c == "timestampF":
            return pa.array(v, mask=m).cast(pa.timestamp("us", tz="UTC"))
        return pa.array(v, mask=m)
    t = pa.table({c: arr(c) for c in cols})
    t = t.set_column(0, "strF", t.column("strF").cast(pa.string()))
    t = t.set_column(1, "nameF", t.column("nameF").cast(pa.string()))
    return t, {c: (cols[c], valid[c]) for c in cols}, names.to_pylist()


def _rows_close(got, exp, rel: float, what: str):
    """Rows (tuples) equal: floats within ``rel`` relative (NaN equal),
    everything else exactly."""
    if len(got) != len(exp):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(exp)}")
    for g, e in zip(got, exp):
        if len(g) != len(e):
            raise AssertionError(f"{what}: row {g} vs {e}")
        for a, b in zip(g, e):
            if isinstance(b, float) and a is not None:
                ok = (math.isnan(a) and math.isnan(b)) or (
                    abs(a - b) <= rel * max(abs(b), 1e-300))
            else:
                ok = a == b
            if not ok:
                raise AssertionError(f"{what}: row {g} vs oracle {e}")


def sweep_path(spark, dev, name, li_files, root, counting, agg_batches,
               scan_chunks, reps: int) -> tuple:
    """sweep-sf1: the qa table from SF1 lineitem (about 6.0M rows, twelve
    typed columns) written by pyarrow's writer as four files and by the
    port's native parquet, ORC and CSV writers (each read back equal), then
    the sweep's statements over the pyarrow copy through ``spark.sql`` and
    the DataFrame API, each held against a numpy/pyarrow oracle. Returns
    each statement's (launch counts, peak device memory), the recorded
    kernel calls for the kernels line, and the lines printed."""
    import datetime as _dt
    import decimal

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.orc as pa_orc
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.arithmetic import IntegralDivide
    from spark_rapids_tpu_torch.io import csv_native as CN
    from spark_rapids_tpu_torch.io import parquet_native as PN
    from spark_rapids_tpu_torch.io import writer as WR
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK

    lines = []

    def say(line):
        print(line)
        lines.append(line)
    t0 = time.perf_counter()
    src, npc, names = qa_source(li_files)
    n = src.num_rows
    qa_dir = os.path.join(root, "qa_pyarrow")
    if os.path.isdir(qa_dir):
        shutil.rmtree(qa_dir)
    os.makedirs(qa_dir)
    per = -(-n // 4)
    for i in range(4):
        pq.write_table(src.slice(i * per, per),
                       os.path.join(qa_dir, f"part-{i}.parquet"))
    groups = sum(pq.ParquetFile(f).metadata.num_row_groups
                 for f in data_files(qa_dir, ".parquet"))
    say(f"sweep-sf1 source: qa {n} rows x {src.num_columns} columns "
        f"({', '.join(f'{f.name} {f.type}' for f in src.schema)}) from "
        f"{len(li_files)} lineitem files, written by pyarrow as 4 files, "
        f"{groups} row groups, in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")

    # -- the port's three writers, each read back equal ----------------------
    def same(back, want, what):
        for c in want.column_names:
            g, w = back.column(c), want.column(c)
            if pa.types.is_timestamp(w.type):
                us = pa.timestamp("us", tz="UTC")
                g, w = g.cast(us), w.cast(us)
            if not g.equals(w):
                raise AssertionError(f"sweep-sf1 {what}: column {c} differs "
                                     f"from the source")
    for fmt in ("parquet", "orc"):
        out = os.path.join(root, f"qa_{fmt}")
        WR.reset_routes()
        t0 = time.perf_counter()
        st = getattr(spark.read_parquet(qa_dir), f"write_{fmt}")(
            out, mode="overwrite")
        wall = time.perf_counter() - t0
        read = (pq.read_table if fmt == "parquet"
                else lambda f: pa_orc.ORCFile(f).read())
        back = pa.concat_tables([read(f) for f in data_files(out, "." + fmt)])
        same(back, src, f"{fmt} write")
        say(f"sweep-sf1 write {fmt} on {name}: wall {wall:.4f} s, "
            f"{st.num_rows} rows in {st.num_files} files by "
            f"{dict(WR.routes)}; pyarrow's read-back equal to the source, "
            f"column by column")
    csv_src = src.slice(0, per)
    out = os.path.join(root, "qa_csv")
    WR.reset_routes()
    t0 = time.perf_counter()
    st = spark.create_dataframe(csv_src).write_csv(out, mode="overwrite")
    wall = time.perf_counter() - t0
    CN.reset_routes()
    t1 = time.perf_counter()
    back = spark.read_csv(out, schema=T.StructType.from_arrow(
        src.schema)).collect()
    read_s = time.perf_counter() - t1
    # CSV holds no difference between an empty string and a null one
    strf = pc.if_else(pc.equal(csv_src.column("strF"), ""),
                      pa.scalar(None, pa.string()), csv_src.column("strF"))
    same(back, csv_src.set_column(0, "strF", strf), "csv write")
    if CN.routes != {"device_files": 0, "arrow_files": st.num_files}:
        raise AssertionError(f"sweep-sf1 csv read routes {CN.routes}")
    say(f"sweep-sf1 write csv (one file of four) on {name}: wall "
        f"{wall:.4f} s, {st.num_rows} rows in {st.num_files} files by "
        f"{dict(WR.routes)}; read_csv with the typed schema {read_s:.3f} s, "
        f"routes {dict(CN.routes)} (the timestamp sends the file to "
        f"arrow), equal to the source")
    del back

    spark.create_or_replace_temp_view("qa", spark.read_parquet(qa_dir))

    def qa():
        return spark.read_parquet(qa_dir)

    # -- the oracles: numpy and pyarrow.compute over the source -------------
    def v(c):
        return npc[c][0]

    def ok(*cs):
        m = np.ones(n, bool)
        for c in cs:
            m &= npc[c][1]
        return m
    name_arr = np.array(names, dtype=object)
    str_arr = np.array(QA_STRINGS, dtype=object)
    fs = lambda x: float(x)          # noqa: E731
    key_s = lambda r: (r[0] is None, str(r[0]))   # noqa: E731

    def like(pattern, values):
        import re as _re
        from spark_rapids_tpu_torch.ops.strings import like_to_regex
        rx = _re.compile(like_to_regex(pattern))
        return np.array([rx.match(s) is not None for s in values])

    def o_like_both():
        m = ok("nameF") & like("%er#0000%1%", names)[v("nameF")]
        return [(int(m.sum()),)]

    def o_like_prefix():
        m = ok("nameF", "strF") & like("Customer#00001%", names)[v("nameF")] \
            & ~np.array(["a" in s for s in QA_STRINGS])[v("strF")]
        return [(int(m.sum()),)]

    def by_str(fn):
        rows = []
        g = np.where(ok("strF"), v("strF"), 6)
        for code in range(7):
            rows.append(fn(None if code == 6 else QA_STRINGS[code], g == code))
        return sorted(rows, key=key_s)

    def o_strings():
        def row(s, m):
            if s is None:
                return (None, int(m.sum()), None, None, None, None, None)
            return (s, int(m.sum()), s.upper(), s.lower(),
                    len(s) * int(m.sum()), s.strip(" ") + "!", s + "-" + s)
        return by_str(row)

    def o_dense():
        def row(s, m):
            mb, mi, md = m & ok("byteF"), m & ok("intF"), m & ok("doubleF")
            return (s, int(m.sum()), int(mb.sum()),
                    int(v("intF")[mi].astype(np.int64).sum()) if mi.any()
                    else None,
                    fs(v("doubleF")[md].mean()) if md.any() else None)
        return by_str(row)

    def o_moments():
        def row(s, m):
            out = [s]
            for c in ("doubleF", "floatF", "shortF"):
                x = v(c)[m & ok(c)].astype(np.float64)
                out += [fs(x.std(ddof=1)), fs(x.var())]
            return tuple(out)
        return by_str(row)

    def o_remainders():
        def rsum(c, d, neg=False):
            x = v(c)[ok(c)].astype(np.int64)
            if neg:
                x = (-v(c)[ok(c)]).astype(np.int64)   # wraps in its type
            return int(np.fmod(x, d).sum())
        return [(rsum("intF", 7), rsum("shortF", 13), rsum("byteF", 3),
                 rsum("shortF", 5, neg=True))]

    def o_pmod_div():
        def pmod(x, d):
            r = np.fmod(x, d)
            return np.where(r < 0, np.fmod(r + d, d), r)
        i = v("intF")[ok("intF")].astype(np.int64)
        s = v("shortF")[ok("shortF")].astype(np.int64)
        m = ok("shortF", "byteF")
        q = np.trunc(v("shortF")[m].astype(np.float64)
                     / v("byteF")[m]).astype(np.int64)
        return [(int(pmod(i, -5).sum()), int(pmod(s, 7).sum()),
                 int(q.sum()))]

    def half_up_1(x):
        # the prices print with two decimals (k / 100): HALF_UP to one is
        # (k + 5) // 10 tenths, exactly, in integers
        k = np.round(x * 100).astype(np.int64)
        return np.floor_divide(k + 5, 10) / 10.0

    def o_math():
        d = v("doubleF")[ok("doubleF")]
        f = v("floatF")[ok("floatF")]
        return [(fs(half_up_1(d).sum()), fs(np.sqrt(d).sum()),
                 int(np.floor(d).astype(np.int64).sum()),
                 int(np.ceil(f * np.float32(100)).astype(np.int64).sum()))]

    def o_math_df():
        d = v("doubleF")[ok("doubleF")]
        f = v("floatF")[ok("floatF")].astype(np.float64)
        return [(fs(np.log10(d).sum()), fs((f * f).sum()),
                 fs(np.round(d).sum()))]

    def o_casts():
        def s(c, conv=np.int64):
            return v(c)[ok(c)].astype(conv)
        day = np.floor_divide(v("timestampF")[ok("timestampF")],
                              86_400_000_000).max()
        big = (v("longF").astype(np.int64) & 0xFFFF).astype(
            np.uint16).view(np.int16)
        fl = v("floatF")[ok("floatF")]
        return [(int(s("byteF").sum()), fs(s("shortF", np.float64).sum()),
                 fs(s("floatF", np.float64).sum()),
                 fs((s("decimalF") / 100.0).sum()), int(ok("dateF").sum()),
                 _dt.date(1970, 1, 1) + _dt.timedelta(days=int(day)),
                 max(str(x) for x in np.unique(s("intF"))),
                 decimal.Decimal(int(np.round(
                     s("doubleF", np.float64) * 100).astype(np.int64).sum())
                 ).scaleb(-2),
                 int(s("booleanF").sum()), int(big.astype(np.int64).sum()),
                 fs(fl.min()),
                 int(v("shortF")[ok("shortF")].astype(np.int8).max()), 0)]

    def civil(days):
        d = np.asarray(days).astype("datetime64[D]")
        y = d.astype("datetime64[Y]").astype(np.int64) + 1970
        mo = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
        dom = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
        return y, mo, dom

    base_ts = (8049 * 86_400 + 6 * 3600) * 1_000_000   # 1992-01-15 06:00

    def months_between(a_us, b_us):
        da, db = a_us // 86_400_000_000, b_us // 86_400_000_000
        ya, ma, dda = civil(da)
        yb, mb, ddb = civil(db)
        months = ((ya - yb) * 12 + (ma - mb)).astype(np.float64)

        def mlen(y, m):
            start = ((y - 1970) * 12 + m - 1).astype("datetime64[M]")
            return ((start + 1).astype("datetime64[D]")
                    - start.astype("datetime64[D]")).astype(np.int64)
        same_ = (dda == ddb) | ((dda == mlen(ya, ma)) & (ddb == mlen(yb, mb)))
        secs = ((dda - ddb) * 86_400 + (a_us - da * 86_400_000_000)
                // 1_000_000 - (b_us - db * 86_400_000_000) // 1_000_000)
        out = np.where(same_, months, months + secs / (31 * 86_400.0))
        return np.floor(out * 1e8 + 0.5) / 1e8

    def o_dates():
        y, mo, dom = civil(v("dateF")[ok("dateF")])
        ts = v("timestampF")[ok("timestampF")]
        _, tmo, _ = civil(ts // 86_400_000_000)
        hours = (ts % 86_400_000_000) // 3_600_000_000
        return [(int(y.sum()), int(((tmo - 1) // 3 + 1).sum()),
                 int(dom.sum()), int(hours.sum()),
                 int((v("dateF")[ok("dateF")].astype(np.int64) - 8035).sum()),
                 fs(months_between(ts, np.full(ts.shape, base_ts)).sum()))]

    def o_date_format():
        d = v("dateF")[ok("dateF")].astype("datetime64[D]")
        ym, cnt = np.unique(d.astype("datetime64[M]"), return_counts=True)
        rows = [(str(a), int(b)) for a, b in zip(ym, cnt)]
        nulls = int((~ok("dateF")).sum())
        return sorted(rows + [(None, nulls)], key=key_s)

    def o_ts_filter():
        m = ok("timestampF", "dateF") & (v("timestampF") < 9131 *
                                         86_400_000_000) & (v("dateF") >= 8766)
        return [(int(m.sum()),)]

    def o_nullif():
        b, s, i = v("byteF").astype(np.int64), v("shortF").astype(
            np.int64), v("intF").astype(np.int64)
        mb, ms, mi = ok("byteF"), ok("shortF"), ok("intF")
        nb = mb & (b != 1)
        lst = np.where(mb & ms, np.minimum(b, s), np.where(mb, b, s))
        grt = np.where(mi & ms, np.maximum(i, s), np.where(mi, i, s))
        return [(int(b[nb].sum()), int(lst[mb | ms].sum()),
                 int(grt[mi | ms].sum()),
                 int((ok("strF") & (v("strF") != 0)).sum()))]

    def o_eq_null_safe():
        mb, ms = ok("byteF"), ok("shortF")
        eq = (mb & ms & (v("byteF").astype(np.int64) == v("shortF"))) | (
            ~mb & ~ms)
        return [(int(eq.sum()),)]

    def o_hash():
        h_names = np_murmur3_bytes(names, 42)
        h = np.where(ok("nameF"), h_names[v("nameF")], np.uint64(42))
        h = np.where(ok("intF"), np_murmur3_int(v("intF"), h), h)
        b = np.mod(_signed32(h).astype(np.int64), 8)
        keys, cnt = np.unique(b, return_counts=True)
        return [(int(a), int(c)) for a, c in zip(keys, cnt)]

    def o_project():
        s = src.column("strF").combine_chunks()
        nm = src.column("nameF").combine_chunks()
        b = pc.cast(src.column("byteF").combine_chunks(), pa.string())
        long_ = pc.greater_equal(pc.utf8_length(s), 8)
        lp = pc.if_else(long_, pc.utf8_slice_codeunits(s, 0, 8),
                        pc.utf8_lpad(s, 8, "*"))
        return pa.table({
            "u": pc.utf8_upper(nm), "p": lp,
            "r": pc.replace_substring_regex(nm, "0+", "0"),
            "w": pc.coalesce(pc.binary_join_element_wise(s, b, "-"),
                             s, b, pa.scalar("", pa.string()))})

    def o_mod_group():
        m = ok("intF")
        k = np.where(m, np.fmod(v("intF").astype(np.int64), 5), -99)
        rows = []
        for key in sorted(set(k.tolist())):
            g = k == key
            gb = g & ok("byteF")
            rows.append((None if key == -99 else key, int(g.sum()),
                         int(v("byteF")[gb].astype(np.int64).sum())))
        return sorted(rows, key=key_s)

    def o_in_columns():
        b = v("byteF").astype(np.int64)
        a1 = np.fmod(v("shortF").astype(np.int64), 50)
        a2 = np.fmod(v("intF").astype(np.int64), 50)
        hit = ok("byteF") & ((ok("shortF") & (b == a1))
                             | (ok("intF") & (b == a2)))
        return [(int(hit.sum()),)]

    def o_unix():
        d = v("dateF")[ok("dateF")].max()
        ts = v("timestampF")[ok("timestampF")]
        return [(str(np.datetime64(int(d), "D")),
                 int((ts // 1_000_000).sum()))]

    col = F.col
    statements = [
        ("like-both-ends", "sql", lambda: spark.sql(
            "select count(*) c from qa where nameF like '%er#0000%1%'"),
         o_like_both, 0.0),
        ("like-prefix-not-like", "sql", lambda: spark.sql(
            "select count(*) c from qa where nameF like 'Customer#00001%' "
            "and strF not like '%a%'"), o_like_prefix, 0.0),
        ("string-functions", "sql", lambda: spark.sql(
            "select strF, count(*) n, max(upper(strF)) u, "
            "min(lower(strF)) l, sum(length(strF)) len, "
            "max(trim(strF) || '!') t, max(concat(strF, '-', strF)) c "
            "from qa group by strF"), o_strings, 0.0),
        ("dense-counts", "sql", lambda: spark.sql(
            "select strF, count(*) n, count(byteF) nb, sum(intF) si, "
            "avg(doubleF) ad from qa group by strF"), o_dense, 1e-9),
        ("stddev-variance", "sql", lambda: spark.sql(
            "select strF, stddev_samp(doubleF) sd, var_pop(doubleF) vd, "
            "stddev_samp(floatF) sf, var_pop(floatF) vf, "
            "stddev_samp(shortF) ss, var_pop(shortF) vs from qa "
            "group by strF"), o_moments, 1e-6),
        ("remainders", "sql", lambda: spark.sql(
            "select sum(intF % 7) a, sum(shortF % 13) b, sum(byteF % 3) c, "
            "sum(-shortF % 5) d from qa"), o_remainders, 0.0),
        ("pmod-div", "df", lambda: qa().agg(
            F.sum(F.pmod("intF", -5)).alias("a"),
            F.sum(F.pmod("shortF", 7)).alias("b"),
            F.sum(IntegralDivide(col("shortF"), col("byteF"))).alias("c")),
         o_pmod_div, 0.0),
        ("math-functions", "sql", lambda: spark.sql(
            "select sum(round(doubleF, 1)) r, sum(sqrt(doubleF)) s, "
            "sum(floor(doubleF)) f, sum(ceil(floatF * 100)) c from qa"),
         o_math, 1e-9),
        ("log-pow-bround", "df", lambda: qa().agg(
            F.sum(F.log10("doubleF")).alias("l"),
            F.sum(F.pow("floatF", 2.0)).alias("p"),
            F.sum(F.bround("doubleF", 0)).alias("b")), o_math_df, 1e-9),
        ("casts", "sql", lambda: spark.sql(
            "select sum(cast(byteF as bigint)) a, "
            "sum(cast(shortF as double)) b, sum(cast(floatF as double)) c, "
            "sum(cast(decimalF as double)) d, "
            "count(cast(dateF as timestamp)) e, "
            "max(cast(timestampF as date)) f, max(cast(intF as string)) g, "
            "sum(cast(doubleF as decimal(14,2))) h, "
            "sum(cast(booleanF as int)) i, sum(cast(longF as smallint)) j, "
            "min(cast(cast(floatF as string) as float)) k, "
            "max(cast(shortF as tinyint)) l, count(cast(strF as int)) m "
            "from qa"), o_casts, 1e-9),
        ("date-parts", "df", lambda: qa().agg(
            F.sum(F.year("dateF")).alias("y"),
            F.sum(F.quarter("timestampF")).alias("q"),
            F.sum(F.dayofmonth("dateF")).alias("d"),
            F.sum(F.hour("timestampF")).alias("h"),
            F.sum(F.datediff("dateF", F.lit(8035, T.DATE))).alias("dd"),
            F.sum(F.months_between(
                "timestampF", F.lit(base_ts, T.TIMESTAMP))).alias("mb")),
         o_dates, 1e-9),
        ("date-format", "df", lambda: qa().group_by(
            F.date_format("dateF", "yyyy-MM").alias("ym")).agg(
            F.count().alias("n")), o_date_format, 0.0),
        ("timestamp-literal", "sql", lambda: spark.sql(
            "select count(*) c from qa where timestampF < "
            "timestamp '1995-01-01 00:00:00' and dateF >= date '1994-01-01'"),
         o_ts_filter, 0.0),
        ("nullif-least-greatest", "sql", lambda: spark.sql(
            "select sum(nullif(byteF, 1)) a, sum(least(byteF, shortF)) b, "
            "sum(greatest(intF, shortF)) c, count(nullif(strF, 'alpha')) d "
            "from qa"), o_nullif, 0.0),
        ("eq-null-safe", "df", lambda: qa().filter(
            col("byteF").eqNullSafe(col("shortF"))).agg(
            F.count().alias("n")), o_eq_null_safe, 0.0),
        ("hash", "df", lambda: qa().select(
            F.pmod(F.hash("nameF", "intF"), F.lit(8)).alias("b")).group_by(
            "b").agg(F.count().alias("n")), o_hash, 0.0),
        ("project-strings", "df", lambda: qa().select(
            F.upper("nameF").alias("u"), F.lpad("strF", 8, "*").alias("p"),
            F.regexp_replace("nameF", "0+", "0").alias("r"),
            F.concat_ws("-", "strF", F.col("byteF").cast(T.STRING)).alias(
                "w")), o_project, None),
        ("remainder-group", "sql", lambda: spark.sql(
            "select intF % 5 k, count(*) n, sum(byteF) s from qa "
            "group by intF % 5"), o_mod_group, 0.0),
        ("in-over-columns", "sql", lambda: spark.sql(
            "select count(*) c from qa where byteF in (shortF % 50, "
            "intF % 50)"), o_in_columns, 0.0),
        ("unix-time", "df", lambda: qa().agg(
            F.max(F.from_unixtime(F.unix_timestamp("dateF"),
                                  "yyyy-MM-dd")).alias("m"),
            F.sum(F.unix_timestamp("timestampF")).alias("s")),
         o_unix, 0.0),
    ]
    oracles, oracle_s = {}, {}
    t0 = time.perf_counter()
    for label, _k, _make, oracle, _rel in statements:
        t1 = time.perf_counter()
        oracles[label] = oracle()
        oracle_s[label] = time.perf_counter() - t1
    slow = sorted(oracle_s.items(), key=lambda kv: -kv[1])[:3]
    say(f"sweep-sf1 oracles (numpy and pyarrow.compute, outside every "
        f"timed window): {time.perf_counter() - t0:.1f} s; the slowest "
        f"{[(k, round(x, 1)) for k, x in slow]}")

    def check(label, res):
        exp = oracles[label]
        rel = dict((s[0], s[4]) for s in statements)[label]
        if rel is None:          # a whole table
            if res.num_rows != exp.num_rows:
                raise AssertionError(f"sweep-sf1 {label}: {res.num_rows} "
                                     f"rows, want {exp.num_rows}")
            for i, c in enumerate(exp.column_names):
                if not res.column(i).combine_chunks().equals(
                        exp.column(c).combine_chunks()):
                    raise AssertionError(f"sweep-sf1 {label}: column {c} "
                                         f"differs from the oracle")
            return
        got = [tuple(r.values()) for r in res.to_pylist()]
        if len(exp) > 1:
            got = sorted(got, key=key_s)
        _rows_close(got, exp, rel, f"sweep-sf1 {label}")

    results, calls = {}, {"chunk_decode": [], "murmur3_words": [],
                          "onehot_sums_f32": []}
    for label, kind, make, _o, _rel in statements:
        full = f"sweep-sf1/{label}"
        with counting():
            t0 = time.perf_counter()
            plan = make().physical_plan()
            res = plan.execute_collect()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts = dict(CK.launches)
            routes = dict(PN.routes)
            peak = torch.cuda.max_memory_allocated(dev)
            count_batches = [k for k in agg_batches if k]
        check(label, res)
        want, stats, cols = 0, [], []
        for d, ex in scans(plan):
            cs = ex.node._data_columns()
            cols.append(cs)
            stats.append(dict(ex.stats))
            if any(isinstance(f.data_type, T.TimestampType)
                   for f in ex.output):
                if ex.stats["device_batches"] or not ex.stats["arrow_batches"]:
                    raise AssertionError(f"{full}: a scan with a timestamp "
                                         f"took {ex.stats}")
            else:
                if ex.stats["arrow_batches"] or not ex.stats["device_batches"]:
                    raise AssertionError(f"{full}: the scan took {ex.stats}")
                want += scan_chunks(d, cs)[0]
        if counts["bitunpack128"] != want:
            raise AssertionError(f"{full}: {counts['bitunpack128']} chunk "
                                 f"decodes, the scans have {want} dictionary "
                                 f"chunks")
        if counts["onehot_sum_f32"] != len(count_batches):
            raise AssertionError(f"{full}: {len(count_batches)} aggregate "
                                 f"batches with count-like requests, "
                                 f"{counts['onehot_sum_f32']} count launches")
        if label == "hash":
            batches = sum(s["device_batches"] for s in stats)
            if counts["murmur3_words"] != batches or not batches:
                raise AssertionError(f"{full}: murmur3_words launched "
                                     f"{counts['murmur3_words']} times over "
                                     f"{batches} batches")
        if label in ("dense-counts", "stddev-variance", "date-format") and \
                not counts["onehot_sum_f32"]:
            raise AssertionError(f"{full}: no dense count launch")
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = make().collect()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check(label, r)
        idle = sql_idle_share(lambda: make().collect())
        results[full] = (counts, peak)
        say(f"{full} ({kind}) on {name}: median {statistics.median(ts):.4f} "
            f"s, min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
            f"runs: {[round(x, 4) for x in ts]} (first {first:.3f} s); "
            f"{res.num_rows} rows equal to the oracle; {idle}; peak device "
            f"memory {peak} B; scan columns {cols}; scan batches {stats}; "
            f"parquet routes {routes}; chunk decode launches "
            f"{counts['bitunpack128']} (predicted {want}); launches "
            f"{ {k: c for k, c in counts.items() if c} }")

    # the kernels' inputs on this path, recorded from one more run of the
    # statements that hand them: the chunk decode of the three narrow and
    # float columns, the count kernel of the dense group-bys, the string
    # hash of hash()
    rec = {k: getattr(CK, k) for k in calls}

    def recorder(k):
        def record(*args_):
            calls[k].append(clone_args(args_, {}))
            return rec[k](*args_)
        return record
    for k in calls:
        setattr(CK, k, recorder(k))
    try:
        qa().select("byteF", "shortF", "floatF").collect()
        for label, _kind, make, _o, _rel in statements:
            if label in ("dense-counts", "stddev-variance", "hash"):
                make().collect()
    finally:
        for k in calls:
            setattr(CK, k, rec[k])
    torch.cuda.synchronize()
    return results, calls, lines


DFAPI_RANGE_ROWS = 1 << 27     # spark.range's throughput-demo size
DFAPI_RANGE_SLICES = 8
DFAPI_SAMPLE_MOD = 1_000_003
# the customer window's order: (ss_item_sk, ss_ticket_number) repeats in the
# generator's tickets, so the sale's time and demographic break its ties
DFAPI_CUST_ORDER = ("ss_sold_date_sk", "ss_ticket_number", "ss_item_sk",
                    "ss_sold_time_sk", "ss_cdemo_sk")
DFAPI_SS_COLS = ("ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk",
                 "ss_customer_sk", "ss_cdemo_sk", "ss_hdemo_sk",
                 "ss_store_sk", "ss_ticket_number", "ss_quantity",
                 "ss_net_paid")
DFAPI_OUT = ("ss_item_sk", "ss_sold_date_sk", "ss_sold_time_sk", "customer",
             "ss_cdemo_sk", "ss_store_sk", "ss_ticket_number", "ss_quantity",
             "ss_net_paid", "i_category", "rn", "prev_paid", "cat_rank",
             "item_qty", "store_rank")


def dec_cents(col) -> tuple:
    """A decimal128 column (p <= 18) as its unscaled int64 values and its
    validity, from arrow's buffers (the low word of each value)."""
    import pyarrow as pa
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64).reshape(-1, 2)
    vals = words[arr.offset:arr.offset + len(arr), 0].copy()
    valid = ~np.asarray(arr.is_null().to_numpy(zero_copy_only=False))
    return vals, valid


def ds_windows_oracle(ss_files, item_dir) -> dict:
    """ds-windows' rows over numpy: the five window columns of every
    store_sales row joined to its item, then the rows with rn <= 3, as
    columns sorted by (customer, rn). Refuses an order that is not total
    within a customer."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    ss = pa.concat_tables([pq.read_table(f, columns=list(DFAPI_SS_COLS))
                           for f in ss_files])
    item = pq.read_table(item_dir, columns=["i_item_sk", "i_category"])
    col = {c: ss.column(c).to_numpy() for c in DFAPI_SS_COLS
           if c != "ss_net_paid"}
    paid, paid_ok = dec_cents(ss.column("ss_net_paid"))
    if not paid_ok.all():
        raise AssertionError("ds-windows oracle: ss_net_paid has nulls")
    n = len(paid)
    cats, item_cat = np.unique(np.asarray(
        item.column("i_category").to_pylist(), dtype=object),
        return_inverse=True)
    item_sk = item.column("i_item_sk").to_numpy()
    by_sk = np.argsort(item_sk)
    pos = by_sk[np.searchsorted(item_sk[by_sk], col["ss_item_sk"])]
    if not np.array_equal(item_sk[pos], col["ss_item_sk"]):
        raise AssertionError("ds-windows oracle: a sale without its item")
    cat_idx = item_cat[pos]
    cust = col["ss_customer_sk"]
    # row_number and lag over (customer order by DFAPI_CUST_ORDER)
    keys = [col[c] for c in DFAPI_CUST_ORDER]
    order = np.lexsort(tuple(reversed([cust] + keys)))
    skeys = np.stack([cust[order]] + [k[order] for k in keys])
    if np.all(skeys[:, 1:] == skeys[:, :-1], axis=0).any():
        raise AssertionError("ds-windows: the customer order is not total")
    sc = cust[order]
    start = np.r_[True, sc[1:] != sc[:-1]]
    grp_start = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    rn = np.empty(n, np.int64)
    rn[order] = np.arange(n) - grp_start + 1
    prev = np.empty(n, np.int64)
    prev_ok = np.empty(n, bool)
    sp = paid[order]
    prev[order] = np.r_[0, sp[:-1]]
    prev_ok[order] = ~start
    prev[~prev_ok] = 0
    # rank over (i_category order by ss_net_paid desc)
    o2 = np.lexsort((-paid, cat_idx))
    c2, p2 = cat_idx[o2], paid[o2]
    cstart = np.r_[True, c2[1:] != c2[:-1]]
    tie = cstart | np.r_[True, p2[1:] != p2[:-1]]
    first_of_tie = np.maximum.accumulate(np.where(tie, np.arange(n), 0))
    first_of_cat = np.maximum.accumulate(np.where(cstart, np.arange(n), 0))
    cat_rank = np.empty(n, np.int64)
    cat_rank[o2] = first_of_tie - first_of_cat + 1
    # sum(ss_quantity) over (ss_item_sk); dense_rank over (ss_store_sk)
    item_qty = np.bincount(col["ss_item_sk"],
                           weights=col["ss_quantity"].astype(np.float64))
    item_qty = np.rint(item_qty).astype(np.int64)[col["ss_item_sk"]]
    store_rank = np.unique(col["ss_store_sk"], return_inverse=True)[1] + 1
    keep = np.nonzero(rn <= 3)[0]
    keep = keep[np.lexsort((rn[keep], cust[keep]))]
    out = {"ss_item_sk": col["ss_item_sk"], "ss_sold_date_sk":
           col["ss_sold_date_sk"], "ss_sold_time_sk": col["ss_sold_time_sk"],
           "customer": cust, "ss_cdemo_sk": col["ss_cdemo_sk"],
           "ss_store_sk": col["ss_store_sk"],
           "ss_ticket_number": col["ss_ticket_number"],
           "ss_quantity": col["ss_quantity"].astype(np.int64),
           "ss_net_paid": paid, "i_category": cats[cat_idx], "rn": rn,
           "prev_paid": prev, "cat_rank": cat_rank, "item_qty": item_qty,
           "store_rank": store_rank}
    res = {k: v[keep] for k, v in out.items()}
    res["prev_paid_valid"] = prev_ok[keep]
    res["n_rows_in"] = n
    return res


def check_ds_windows(res, exp, label: str) -> None:
    """``res`` (the collected table) equal to the oracle column for column,
    after sorting by (customer, rn)."""
    import pyarrow.compute as pc
    if res.column_names != list(DFAPI_OUT):
        raise AssertionError(f"{label}: columns {res.column_names}, want "
                             f"{list(DFAPI_OUT)}")
    if res.num_rows != len(exp["rn"]):
        raise AssertionError(f"{label}: {res.num_rows} rows, the oracle "
                             f"{len(exp['rn'])}")
    res = res.take(pc.sort_indices(res, [("customer", "ascending"),
                                         ("rn", "ascending")]))
    for c in DFAPI_OUT:
        col = res.column(c)
        if c in ("ss_net_paid", "prev_paid"):
            got, ok = dec_cents(col)
            want_ok = exp.get(c + "_valid", np.ones(len(got), bool))
            same = np.array_equal(ok, want_ok) and np.array_equal(
                got[ok], exp[c][ok])
        elif c == "i_category":
            same = col.to_pylist() == exp[c].tolist()
        else:
            same = (col.null_count == 0 and np.array_equal(
                col.to_numpy().astype(np.int64), exp[c]))
        if not same:
            raise AssertionError(f"{label}: column {c} differs from the "
                                 f"oracle")


def check_launches(label, counts, want, required) -> None:
    """Each kernel launched as often as ``want`` predicts, and each of
    ``required`` at least once."""
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, predicted {want}")
    for k in required:
        if not counts[k]:
            raise AssertionError(f"{label}: {k} never launched")


def exchange_prediction(plans) -> tuple:
    """(radix calls, murmur3_words calls) the exchanges of ``plans`` must
    have launched: one partition step a partitioned batch, one string hash
    a string key of each."""
    from spark_rapids_tpu_torch import types as T
    exs = [e for p in plans for e in exchanges(p)]
    radix = sum(e.map_batches for e in exs)
    mm = sum(e.map_batches * sum(
        isinstance(k.dtype, T.StringType)
        for k in getattr(e.partitioner, "key_exprs", ())) for e in exs)
    return radix, mm, exs


def ds_windows_frame(spark, ss_files, item_dir):
    """ds-windows: store_sales joined to item, ``with_column`` /
    ``with_column_renamed`` / ``drop``, one ``window`` of five expressions
    over four specs, ``filter(rn <= 3)``."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    c = F.col
    ss = spark.read_parquet(ss_files).select(*DFAPI_SS_COLS)
    item = spark.read_parquet(item_dir).select(
        c("i_item_sk").alias("ss_item_sk"), c("i_category"))
    j = (ss.join(item, on="ss_item_sk")
         .with_column("ss_quantity", c("ss_quantity").cast(T.LONG))
         .with_column_renamed("ss_customer_sk", "customer")
         .drop("ss_hdemo_sk"))
    cust = list(DFAPI_CUST_ORDER)
    return j.window([
        F.alias(F.over(F.row_number(), ["customer"], cust), "rn"),
        F.alias(F.over(F.lag("ss_net_paid"), ["customer"], cust),
                "prev_paid"),
        F.alias(F.over(F.rank(), ["i_category"],
                       [("ss_net_paid", False, False)]), "cat_rank"),
        F.alias(F.over(F.sum("ss_quantity"), ["ss_item_sk"]),
                "item_qty"),
        F.alias(F.over(F.dense_rank(), [], ["ss_store_sk"]),
                "store_rank")]).filter(c("rn") <= 3)


def dfapi_paths(spark, dev, name, ds_paths, counted_ds_run, counting,
                agg_batches, scan_chunks, reps: int, counts_by_path: dict,
                peak_by_path: dict) -> dict:
    """dfapi-sf1: the DataFrame API's remainder and windows over several
    specs at SF1. ds-windows (store_sales from its 4 files as 4 partitions,
    joined to item, ``with_column``/``with_column_renamed``/``drop``, one
    ``window`` of five expressions over four specs, ``filter(rn <= 3)``)
    and its SQL text; ``spark.range`` of 2^27 rows in 8 slices (count, a
    4,096-key group-by count, ``sort_within_partitions`` with the row and
    partition ids, checked on a sample and on keyless aggregates);
    ``group_by(input_file_name())`` over the 4 files, and after a
    repartition. Each path is counted once (``counted_ds_run`` for the
    TPC-DS ones, which checks their scans, routes and exchange launches),
    timed ``reps`` times and traced once; each path's launches and peak
    device memory go into ``counts_by_path`` and ``peak_by_path``. Returns
    ds-windows' oracle."""
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    c = F.col
    ss_dir = ds_paths["store_sales"]
    ss_files = data_files(ss_dir, ".parquet")
    t0 = time.perf_counter()
    exp_w = ds_windows_oracle(ss_files, ds_paths["item"])
    print(f"dfapi-sf1 oracles: ds-windows over {exp_w['n_rows_in']} "
          f"store_sales rows in {len(ss_files)} files, "
          f"{len(exp_w['rn'])} rows with rn <= 3, in "
          f"{time.perf_counter() - t0:.1f} s (numpy, outside every timed "
          f"window)")

    def ds_windows():
        return ds_windows_frame(spark, ss_files, ds_paths["item"])
    spark.create_or_replace_temp_view("ss_files",
                                      spark.read_parquet(ss_files))
    spark.create_or_replace_temp_view("item_dir",
                                      spark.read_parquet(ds_paths["item"]))
    cust_sql = ", ".join(DFAPI_CUST_ORDER)
    text = (
        "select * from (select ss_item_sk, ss_sold_date_sk, "
        "ss_sold_time_sk, ss_customer_sk as customer, ss_cdemo_sk, "
        "ss_store_sk, ss_ticket_number, cast(ss_quantity as bigint) as "
        "ss_quantity, ss_net_paid, i_category, row_number() over "
        f"(partition by ss_customer_sk order by {cust_sql}) as rn, "
        f"lag(ss_net_paid) over (partition by ss_customer_sk order by "
        f"{cust_sql}) as prev_paid, rank() over (partition by i_category "
        "order by ss_net_paid desc) as cat_rank, sum(cast(ss_quantity as "
        "bigint)) over (partition by ss_item_sk) as item_qty, dense_rank() "
        "over (order by ss_store_sk) as store_rank from ss_files join "
        "item_dir on ss_item_sk = i_item_sk) w where rn <= 3")
    named = set(DFAPI_SS_COLS) | {"i_item_sk", "i_category"}
    windows_kernels = ("bitunpack128", "radix_ranks", "murmur3_words")
    window_paths = {"dfapi-sf1/ds-windows": ds_windows,
                    "dfapi-sf1/sql-ds-windows": lambda: spark.sql(text)}
    from spark_rapids_tpu_torch.exec.window import WindowExec
    for label, make in window_paths.items():
        plan, _extra = counted_ds_run(
            label, make, named, windows_kernels,
            lambda res, label=label: check_ds_windows(res, exp_w, label))
        wins = of_type(plan, WindowExec)
        if len(wins) != 4 or counts_by_path[label]["hash_join_build"]:
            raise AssertionError(
                f"{label}: {len(wins)} window execs (want 4, one a spec), "
                f"{counts_by_path[label]['hash_join_build']} hash builds "
                f"(want 0: item's keys take the direct table)")
        shape = [ln.strip().split(" ")[0]
                 for ln in plan.tree_string().splitlines()]
        print(f"{label} plan: {' <- '.join(shape)}")
    for label, make in window_paths.items():
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = make().collect()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check_ds_windows(res, exp_w, label)
        idle = sql_idle_share(lambda: make().collect())
        print(f"{label} sf=1 on {name}: median {statistics.median(ts):.4f} "
              f"s, min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
              f"runs: {[round(x, 4) for x in ts]}; {res.num_rows} rows "
              f"equal to the oracle; {idle}; peak device memory "
              f"{peak_by_path[label]} B; launches "
              f"{ {k: v for k, v in counts_by_path[label].items() if v} }")

    # -- range ---------------------------------------------------------------
    # the key as a string: the dense aggregate (and its count kernel) takes
    # keys of a static domain, a string's dictionary or a boolean, of at
    # most 4,096 codes with the null one; an integer key takes the segment
    # group-by
    n_rng, k_mod = DFAPI_RANGE_ROWS, 4000
    per_slice = n_rng // DFAPI_RANGE_SLICES

    def rng():
        return spark.range(0, n_rng, num_slices=DFAPI_RANGE_SLICES)

    def sorted_ids():
        return rng().sort_within_partitions(
            c("id") % 1000, "id", ascending=[False, True]).with_column(
            "mid", F.monotonically_increasing_id()).with_column(
            "pid", F.spark_partition_id())

    def mid_of(ids):
        """The row id ``(slice << 33) + position`` of each id in its sorted
        slice, in closed form: the ids of larger ``id % 1000`` first, then
        the smaller ids of the same residue."""
        ids = np.asarray(ids, np.int64)
        p = ids // per_slice
        lo, r = p * per_slice, ids % 1000
        hi = lo + per_slice

        def n_res_below(bound, res):      # ids in [0, bound) with residue
            return (bound - res + 999) // 1000
        before = np.zeros(len(ids), np.int64)
        for q in range(1000):
            cnt = n_res_below(hi, q) - n_res_below(lo, q)
            before += np.where(q > r, cnt, 0)
        same_below = n_res_below(ids, r) - n_res_below(lo, r)
        return (p << 33) + before + same_below, p

    sample_ids = np.arange(0, n_rng, DFAPI_SAMPLE_MOD, dtype=np.int64)
    s_mid, s_pid = mid_of(sample_ids)
    slices = np.arange(DFAPI_RANGE_SLICES, dtype=np.int64)
    # sum of mid over all rows: each slice's base times its rows, plus
    # 0 + 1 + ... + per_slice - 1 in each
    want_sum_mid = int(((slices << 33) * per_slice).sum()
                       + DFAPI_RANGE_SLICES * per_slice * (per_slice - 1)
                       // 2)
    want_agg = {"mx": ((DFAPI_RANGE_SLICES - 1) << 33) + per_slice - 1,
                "sm": want_sum_mid,
                "sp": int((slices * per_slice).sum()), "n": n_rng}

    def check_count(res):
        if res != n_rng:
            raise AssertionError(f"range count {res}, want {n_rng}")

    def check_groups(res):
        got = sorted(zip(map(int, res.column("k").to_pylist()),
                         res.column("count").to_pylist()))
        want = [(k, n_rng // k_mod + (k < n_rng % k_mod))
                for k in range(k_mod)]
        if got != want:
            raise AssertionError("range group-by count differs")

    def check_sample(res):
        rows = sorted(zip(*(res.column(x).to_pylist()
                            for x in ("id", "mid", "pid"))))
        want = list(zip(sample_ids.tolist(), s_mid.tolist(),
                        s_pid.tolist()))
        if rows != want:
            raise AssertionError(f"range sample: {rows[:3]}..., want "
                                 f"{want[:3]}...")

    def check_aggs(res):
        got = res.to_pylist()[0]
        if got != want_agg:
            raise AssertionError(f"range keyless aggregates {got}, want "
                                 f"{want_agg}")

    other = {
        "dfapi-sf1/range-count": (lambda: rng(), "count", check_count),
        "dfapi-sf1/range-group-count": (
            lambda: rng().with_column(
                "k", (c("id") % k_mod).cast(T.STRING)).group_by(
                "k").count(), "collect", check_groups),
        "dfapi-sf1/range-sorted-sample": (
            lambda: sorted_ids().filter(
                c("id") % DFAPI_SAMPLE_MOD == 0).select("id", "mid", "pid"),
            "collect", check_sample),
        "dfapi-sf1/range-sorted-aggregates": (
            lambda: sorted_ids().agg(
                F.max("mid").alias("mx"), F.sum("mid").alias("sm"),
                F.sum("pid").alias("sp"), F.count().alias("n")),
            "collect", check_aggs),
    }
    # -- the input files -------------------------------------------------------
    footer_rows = {f: pq.ParquetFile(f).metadata.num_rows for f in ss_files}

    def check_files(res):
        got = dict(zip(res.column("f").to_pylist(),
                       res.column("count").to_pylist()))
        if got != footer_rows:
            raise AssertionError(f"input files {got}, want {footer_rows}")

    def check_no_file(res):
        got = res.to_pylist()
        if got != [{"f": "", "count": sum(footer_rows.values())}]:
            raise AssertionError(f"input files after a repartition {got}")
    other["dfapi-sf1/input-files"] = (
        lambda: spark.read_parquet(ss_files).group_by(
            F.input_file_name().alias("f")).count(), "collect", check_files)
    other["dfapi-sf1/input-files-repartition"] = (
        lambda: spark.read_parquet(ss_files).repartition(4).group_by(
            F.input_file_name().alias("f")).count(), "collect",
        check_no_file)
    kernels = {"dfapi-sf1/range-count": (),
               "dfapi-sf1/range-group-count": ("onehot_sum_f32",
                                               "radix_ranks",
                                               "murmur3_words"),
               "dfapi-sf1/range-sorted-sample": (),
               "dfapi-sf1/range-sorted-aggregates": (),
               "dfapi-sf1/input-files": ("bitunpack128", "onehot_sum_f32",
                                         "radix_ranks", "murmur3_words"),
               "dfapi-sf1/input-files-repartition": (
                   "bitunpack128", "onehot_sum_f32", "radix_ranks",
                   "murmur3_words")}

    def act(make, how):
        df = make()
        return df.count() if how == "count" else df.collect()

    for label, (make, how, check) in other.items():
        with counting():
            t0 = time.perf_counter()
            if how == "count":       # DataFrame.count(): a keyless count
                plan, res = None, make().count()
            else:
                plan = make().physical_plan()
                res = plan.execute_collect()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            count_batches = [k for k in agg_batches if k]
        check(res)
        plans = [plan] if plan is not None else []
        radix, mm, exs = exchange_prediction(plans)
        want_chunks = sum(scan_chunks(d, ex.node._data_columns())[0]
                          for p in plans for d, ex in scans(p))
        want = {"bitunpack128": want_chunks,
                "onehot_sum_f32": len(count_batches), "radix_ranks": radix,
                "murmur3_words": mm, "hash_join_build": 0,
                "hash_join_probe": 0}
        check_launches(label, counts, want, kernels[label])
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = act(make, how)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check(r)
        idle = sql_idle_share(lambda: act(make, how))
        counts_by_path[label] = counts
        peak_by_path[label] = peak
        ex_line = "; ".join(
            f"{type(e.partitioner).__name__} {e.child.num_partitions} -> "
            f"{e.num_partitions}, {e.map_batches} partitioned batches"
            for e in exs)
        print(f"{label} on {name}: median {statistics.median(ts):.4f} s, "
              f"min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
              f"runs: {[round(x, 4) for x in ts]} (first {first:.3f} s); "
              f"equal to the oracle; {idle}; peak device memory {peak} B; "
              f"launches { {k: v for k, v in counts.items() if v} } "
              f"(predicted {want}); {len(count_batches)} aggregate batches "
              f"with count-like requests; exchanges: {ex_line or 'none'}")
    return exp_w


NESTED_REPS = 1   # timed runs of each nested-sf1 path after its counted run
NESTED_WORD = " "


def nested_oracle(li_dir: str) -> dict:
    """numpy/pyarrow answers of the collect paths from the lineitem files
    (sorted by l_orderkey, read in file order as the scan reads them)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    cols = ["l_orderkey", "l_suppkey", "l_returnflag", "l_linestatus",
            "l_shipdate", "l_quantity"]
    t = pq.read_table(li_dir, columns=cols)
    key = t.column("l_orderkey").to_numpy()
    if np.any(key[1:] < key[:-1]):
        raise AssertionError("lineitem is not sorted by l_orderkey")
    keys, start, counts = np.unique(key, return_index=True,
                                    return_counts=True)
    def codes(name, values):
        """The column as indices into ``values`` (sorted), via arrow."""
        enc = t.column(name).combine_chunks().dictionary_encode()
        d = enc.dictionary.to_pylist()
        if not set(d) <= set(values):
            raise AssertionError(f"{name}: values {d}")
        remap = np.array([values.index(v) for v in d], np.int64)
        return remap[enc.indices.to_numpy(zero_copy_only=False)]
    fcode = codes("l_returnflag", ["A", "N", "R"])
    ship = t.column("l_shipdate").cast(pa.int32()).to_numpy()
    supp = t.column("l_suppkey").to_numpy()
    # the distinct (order, flag) pairs in (order, flag) order
    pair = np.unique(key.astype(np.int64) * 4 + fcode)
    set_counts = np.bincount(np.searchsorted(keys, pair >> 2),
                             minlength=len(keys))
    scode = codes("l_linestatus", ["F", "O"])
    return {"keys": keys, "counts": counts, "start": start, "supp": supp,
            "ship": ship, "set_key": pair >> 2,
            "set_flag": np.array(["A", "N", "R"], dtype=object)[pair & 3],
            "set_counts": set_counts,
            "has_r": np.bincount(np.searchsorted(keys, key[fcode == 2]),
                                 minlength=len(keys)) > 0,
            "fcode": fcode, "scode": scode,
            "qty": t.column("l_quantity").to_numpy(), "n_rows": len(key)}


def _flat(col):
    """A list column's (lengths, flattened values) as numpy."""
    import pyarrow.compute as pc
    col = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    return (pc.list_value_length(col).fill_null(-1).to_numpy(
        zero_copy_only=False), pc.list_flatten(col))


def check_orders(res, exp, label, extractions: bool = True) -> None:
    """The collect-orders frame against the oracle: lists element for
    element, sets sorted, and the extractions."""
    import pyarrow as pa
    import pyarrow.compute as pc
    res = res.take(pc.sort_indices(res.column("l_orderkey")))
    keys = res.column("l_orderkey").to_numpy()
    if not np.array_equal(keys, exp["keys"]):
        raise AssertionError(f"{label}: the order keys differ")
    if not np.array_equal(res.column("n").to_numpy(), exp["counts"]):
        raise AssertionError(f"{label}: count(*) differs")
    for name, want in (("supps", exp["supp"]), ("ships", exp["ship"])):
        lens, flat = _flat(res.column(name))
        vals = (flat.cast(pa.int32()) if name == "ships" else flat).to_numpy(
            zero_copy_only=False)
        if not (np.array_equal(lens, exp["counts"])
                and np.array_equal(vals, want)):
            raise AssertionError(f"{label}: collect_list({name}) differs")
    lens, flat = _flat(res.column("flags"))
    row = np.repeat(keys, lens)
    vals = np.asarray(flat.to_pylist(), dtype=object)
    order = np.lexsort((vals, row))
    if not (np.array_equal(lens, exp["set_counts"])
            and np.array_equal(row[order], exp["set_key"])
            and np.array_equal(vals[order], exp["set_flag"])):
        raise AssertionError(f"{label}: collect_set(l_returnflag) differs")
    if not extractions:
        return
    start, cnt = exp["start"], exp["counts"]
    want = {"n_supps": cnt, "first_supp": exp["supp"][start],
            "last_ship": exp["ship"][start + cnt - 1],
            "has_r": exp["has_r"]}
    for name, w in want.items():
        col = res.column(name)
        if name == "last_ship":
            col = col.cast(pa.int32())
        if col.null_count or not np.array_equal(col.to_numpy(), w):
            raise AssertionError(f"{label}: {name} differs")
    st = res.column("st").combine_chunks()
    if not (np.array_equal(st.field("n").to_numpy(), cnt)
            and np.array_equal(st.field("k").to_numpy(), keys)):
        raise AssertionError(f"{label}: struct(n, l_orderkey) differs")


def volume(res) -> tuple:
    """(rows, list and map elements at every level) of a path's result
    tables (``res`` a table or a tuple holding some)."""
    import pyarrow as pa
    tables = [x for x in (res if isinstance(res, tuple) else (res,))
              if isinstance(x, pa.Table)]
    elems = 0
    for t in tables:
        for col in t.columns:
            arr = col.combine_chunks()
            while pa.types.is_list(arr.type) or pa.types.is_map(arr.type):
                if pa.types.is_map(arr.type):     # its values, as a list
                    arr = pa.ListArray.from_arrays(arr.offsets, arr.items,
                                                   mask=arr.is_null())
                arr = arr.flatten()     # the elements of the non-null lists
                elems += len(arr)
    return sum(t.num_rows for t in tables), elems


def nested_paths(spark, dev, name, li_dir, ds_paths, root, counting,
                 agg_batches, scan_chunks, exp_q1, reps: int,
                 counts_by_path: dict, peak_by_path: dict) -> None:
    """nested-sf1: arrays, structs and maps as device columns at SF1.
    collect-orders (lineitem's 6.0M rows → a collect_list, a collect_set,
    a collect_list of dates and a count per order, 1.5M groups, then
    size, element_at, array_contains and a struct over them);
    collect-repartition-explode and -posexplode (that frame through
    ``repartition(8, l_orderkey)``, then explode and a group-by count);
    split-words (store_sales ⋈ item, ``split(i_item_desc, ' ')``, size,
    an item, explode and a string group-by count); struct-map (a struct, a
    map and an array over store_sales, extracted fused and from the
    materialized columns); nested-write (the collect-orders frame to
    parquet through the arrow writer, read back and exploded); pivot and
    pivot-first (lineitem by l_returnflag pivoted on l_linestatus); and
    row-buffer (lineitem through the packed row format both ways, then
    q1). Each path: one counted run (launches predicted), ``reps`` more
    timed runs, one traced run; each is held to a numpy/pyarrow oracle
    computed from the source files."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.exec.generate import GenerateExec
    from spark_rapids_tpu_torch.expr.aggregates import PivotFirst
    from spark_rapids_tpu_torch.expr.strings import java_split
    from spark_rapids_tpu_torch.io import writer as W
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    c = F.col
    t0 = time.perf_counter()
    exp = nested_oracle(li_dir)
    ss_files = data_files(ds_paths["store_sales"], ".parquet")
    ss = pq.read_table(ss_files, columns=["ss_item_sk", "ss_customer_sk",
                                          "ss_store_sk", "ss_quantity"])
    item = pq.read_table(ds_paths["item"], columns=["i_item_sk",
                                                    "i_item_desc"])
    words = [java_split(d, NESTED_WORD, -1)
             for d in item.column("i_item_desc").to_pylist()]
    isk = item.column("i_item_sk").to_numpy()
    ss_item = ss.column("ss_item_sk").to_numpy()
    sales = np.bincount(np.searchsorted(isk, ss_item), minlength=len(isk))
    word_counts: dict = {}
    for ws, n in zip(words, sales.tolist()):
        for w in ws:
            word_counts[w] = word_counts.get(w, 0) + n
    n_words = int(sum(len(ws) * n for ws, n in zip(words, sales.tolist())))
    item_size = np.array([len(ws) for ws in words], np.int32)
    item_w1 = np.array([ws[1] if len(ws) > 1 else None for ws in words],
                       dtype=object)
    supp_counts = np.bincount(exp["supp"])
    pos_counts = np.array([(exp["counts"] > p).sum()
                           for p in range(int(exp["counts"].max()))])
    print(f"nested-sf1 oracles: {exp['n_rows']} lineitem rows in "
          f"{len(exp['keys'])} orders, {ss.num_rows} store_sales rows, "
          f"{n_words} words of {len(words)} item descriptions, in "
          f"{time.perf_counter() - t0:.1f} s (numpy and pyarrow, outside "
          "every timed window)")

    def orders():
        return spark.read_parquet(li_dir).group_by("l_orderkey").agg(
            F.collect_list("l_suppkey").alias("supps"),
            F.collect_set("l_returnflag").alias("flags"),
            F.collect_list("l_shipdate").alias("ships"),
            F.count().alias("n"))

    def collect_orders():
        return orders().select(
            "l_orderkey", "supps", "flags", "ships", "n",
            F.size("supps").alias("n_supps"),
            F.element_at("supps", 1).alias("first_supp"),
            F.element_at("ships", -1).alias("last_ship"),
            F.array_contains("flags", "R").alias("has_r"),
            F.struct("n", "n", "k", "l_orderkey").alias("st"))

    def check_counts(res, key, want, label):
        k = res.column(key).to_numpy()
        got = np.zeros(len(want), np.int64)
        got[k] = res.column("count").to_numpy()
        if len(k) != int((want > 0).sum()) or not np.array_equal(got, want):
            raise AssertionError(f"{label}: group counts differ")

    def exploded(pos):
        return orders().repartition(8, "l_orderkey").explode(
            "supps", pos=pos).group_by("pos" if pos else "col").count()

    def ss_items():
        s = spark.read_parquet(ss_files).select("ss_item_sk")
        it = spark.read_parquet(ds_paths["item"]).select(
            c("i_item_sk").alias("ss_item_sk"), c("i_item_desc"))
        return s.join(it, on="ss_item_sk").select(
            "ss_item_sk", F.split("i_item_desc", NESTED_WORD).alias("w"))

    def check_words(res, label):
        got = dict(zip(res.column("col").to_pylist(),
                       res.column("count").to_pylist()))
        if got != word_counts:
            raise AssertionError(f"{label}: word counts differ")

    def check_split(res, label):
        k = np.searchsorted(isk, res.column("ss_item_sk").to_numpy())
        if not (np.array_equal(res.column("n").to_numpy(), item_size[k])
                and res.column("w1").to_pylist() == item_w1[k].tolist()):
            raise AssertionError(f"{label}: size or element_at0 differs")

    def struct_map():
        s = spark.read_parquet(ss_files).select(
            "ss_item_sk", "ss_customer_sk", "ss_store_sk", "ss_quantity")
        st = F.struct("q", "ss_quantity", "c", "ss_customer_sk")
        mp = F.create_map(F.lit("item"), c("ss_item_sk"), F.lit("cust"),
                          c("ss_customer_sk"))
        ar = F.array("ss_item_sk", "ss_customer_sk", "ss_store_sk")
        m = s.select(st.alias("st"), mp.alias("m"), ar.alias("a"),
                     F.get_field(st, "q").alias("fq"),
                     F.map_value(mp, F.lit("cust")).alias("fc"),
                     F.element_at0(ar, 2).alias("fs"),
                     F.size(ar).alias("fn"))
        return m.select("st", "m", "a", "fq", "fc", "fs", "fn",
                        F.get_field("st", "c").alias("mc"),
                        F.map_value("m", F.lit("item")).alias("mi"),
                        F.element_at("a", -1).alias("ms"),
                        F.size("a").alias("mn"),
                        F.array_contains("a", c("fs")).alias("mhas"))
    q = ss.column("ss_quantity").combine_chunks()
    cu = ss.column("ss_customer_sk").combine_chunks()
    it_ = ss.column("ss_item_sk").combine_chunks()
    st_ = ss.column("ss_store_sk").combine_chunks()
    n_ss = ss.num_rows
    off3 = pa.array(np.arange(0, 3 * n_ss + 1, 3, dtype=np.int32))
    off2 = pa.array(np.arange(0, 2 * n_ss + 1, 2, dtype=np.int32))

    def interleave(*arrs):
        idx = np.arange(len(arrs) * n_ss)
        return pa.concat_arrays(list(arrs)).take(
            pa.array((idx % len(arrs)) * n_ss + idx // len(arrs)))
    want_sm = {
        "st": pa.StructArray.from_arrays([q, cu], names=["q", "c"]),
        "m": pa.MapArray.from_arrays(
            off2, pa.array(["item", "cust"] * n_ss), interleave(it_, cu)),
        "a": pa.ListArray.from_arrays(off3, interleave(it_, cu, st_)),
        "fq": q, "fc": cu, "fs": st_, "mc": cu, "mi": it_, "ms": st_,
        "fn": pa.array(np.full(n_ss, 3, np.int32)),
        "mn": pa.array(np.full(n_ss, 3, np.int32)),
        "mhas": pa.array(np.ones(n_ss, bool), mask=np.asarray(
            st_.is_null()))}

    def check_struct_map(res, label):
        for k, w in want_sm.items():
            got = res.column(k).combine_chunks()
            if k == "st":
                same = all(got.field(i).equals(w.field(i)) for i in range(2))
                same = same and got.null_count == 0
            elif k == "m":
                same = (got.keys.equals(w.keys) and got.items.equals(w.items)
                        and got.offsets.equals(w.offsets)
                        and got.null_count == 0)
            elif k == "a":
                same = (pc.list_flatten(got).equals(pc.list_flatten(w))
                        and got.offsets.equals(w.offsets)
                        and got.null_count == 0)
            else:
                same = got.cast(w.type).equals(w)
            if not same:
                raise AssertionError(f"{label}: column {k} differs")

    out_dir = os.path.join(root, "orders_parquet")

    def write_orders():
        W.reset_routes()
        orders().select("l_orderkey", "supps", "flags", "ships", "n",
                        F.struct("n", "n", "k", "l_orderkey").alias("st")
                        ).write_parquet(out_dir, mode="overwrite")
        back = spark.read_parquet(out_dir)
        return (dict(W.routes), back.explode("supps").collect(),
                pq.read_table(out_dir))

    def check_write(res, label):
        routes, ex, written = res
        if routes != {"native_files": 0, "arrow_files": 1}:
            raise AssertionError(f"{label}: writer routes {routes}")
        check_orders(written, exp, label, extractions=False)
        if not (np.array_equal(ex.column("col").to_numpy(), exp["supp"])
                and np.array_equal(ex.column("l_orderkey").to_numpy(),
                                   np.repeat(exp["keys"], exp["counts"]))):
            raise AssertionError(f"{label}: the explode of the read-back "
                                 "files differs from lineitem")

    def rows_of(f, s):
        """lineitem rows with returnflag ``f`` and linestatus ``s``."""
        return (exp["fcode"] == "ANR".index(f)) & (exp["scode"] == "FO".index(s))

    def check_pivot(res, label):
        rows = {r["l_returnflag"]: r for r in res.to_pylist()}
        for f in ("A", "N", "R"):
            for s in ("F", "O"):
                m = rows_of(f, s)
                r = rows.get(f)
                want_n, want_q = int(m.sum()), float(exp["qty"][m].sum())
                got_n = r[f"{s}_count"] if r else 0
                got_q = r[f"{s}_sum"] if r else None
                if got_n != want_n or (want_n and abs(got_q - want_q)
                                       > 1e-9 * abs(want_q)):
                    raise AssertionError(f"{label}: {f}/{s} differs")

    def check_pivot_first(res, label):
        got = {r["l_returnflag"]: r["pf"] for r in res.to_pylist()}
        import datetime
        for f in ("A", "N", "R"):
            want = []
            for s in ("F", "O"):
                hit = np.flatnonzero(rows_of(f, s))
                want.append(None if not len(hit) else datetime.date(
                    1970, 1, 1) + datetime.timedelta(
                        int(exp["ship"][hit[0]])))
            if got.get(f) != want:
                raise AssertionError(f"{label}: {f}: {got.get(f)} != {want}")

    fixed_cols = ["l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice",
                  "l_discount", "l_tax", "l_shipdate"]
    q1_cols = ["l_returnflag", "l_linestatus", "l_quantity",
               "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]

    # host seconds of each step of the last row-buffer run
    row_steps: dict = {}

    def row_buffer():
        li = spark.read_parquet(li_dir)
        t0 = time.perf_counter()
        rows, schema = li.select(*fixed_cols).collect_row_buffer()
        t1 = time.perf_counter()
        back = spark.create_dataframe_from_rows(rows, schema).collect()
        t2 = time.perf_counter()
        (words_, offs), schema2 = li.select(*q1_cols).collect_row_buffer()
        t3 = time.perf_counter()
        q1 = tpch.q1({"lineitem": spark.create_dataframe_from_rows(
            (words_, offs), schema2)}).collect()
        t4 = time.perf_counter()
        row_steps.update({"fixed_pack_s": round(t1 - t0, 4),
                          "fixed_unpack_s": round(t2 - t1, 4),
                          "var_pack_s": round(t3 - t2, 4),
                          "var_unpack_q1_s": round(t4 - t3, 4)})
        return rows.shape, back, q1

    src_fixed = pq.read_table(li_dir, columns=fixed_cols)

    def check_rows(res, label):
        shape, back, q1 = res
        if shape != (exp["n_rows"], 8):
            raise AssertionError(f"{label}: row buffer {shape}")
        for k in fixed_cols:
            if not back.column(k).combine_chunks().equals(
                    src_fixed.column(k).combine_chunks()):
                raise AssertionError(f"{label}: the fixed-width round trip "
                                     f"of {k} differs from lineitem")
        check_q1(q1.to_pylist(), exp_q1)

    paths = {
        "nested-sf1/collect-orders": (
            collect_orders, "collect",
            lambda r, lb: check_orders(r, exp, lb)),
        "nested-sf1/collect-repartition-explode": (
            lambda: exploded(False), "collect",
            lambda r, lb: check_counts(r, "col", supp_counts, lb)),
        "nested-sf1/collect-repartition-posexplode": (
            lambda: exploded(True), "collect",
            lambda r, lb: check_counts(r, "pos", pos_counts, lb)),
        "nested-sf1/split-words": (
            lambda: ss_items().select(
                "ss_item_sk", F.size("w").alias("n"),
                F.element_at0("w", 1).alias("w1")), "collect", check_split),
        "nested-sf1/split-words-explode": (
            lambda: ss_items().explode("w").group_by("col").count(),
            "collect", check_words),
        "nested-sf1/struct-map": (struct_map, "collect", check_struct_map),
        "nested-sf1/nested-write": (None, write_orders, check_write),
        "nested-sf1/pivot": (
            lambda: spark.read_parquet(li_dir).group_by(
                "l_returnflag").pivot("l_linestatus", ["F", "O"]).agg(
                F.sum("l_quantity"), F.count()), "collect", check_pivot),
        "nested-sf1/pivot-first": (
            lambda: spark.read_parquet(li_dir).group_by("l_returnflag").agg(
                F.alias(PivotFirst(c("l_shipdate"), c("l_linestatus"),
                                   ["F", "O"]), "pf")),
            "collect", check_pivot_first),
        "nested-sf1/row-buffer": (None, row_buffer, check_rows),
    }
    # the kernels each path must launch (the rest predicted, maybe 0)
    required = {
        "nested-sf1/collect-orders": ("bitunpack128",),
        "nested-sf1/collect-repartition-explode": ("bitunpack128",
                                                   "radix_ranks"),
        "nested-sf1/collect-repartition-posexplode": ("bitunpack128",
                                                      "radix_ranks"),
        "nested-sf1/split-words": ("bitunpack128",),
        # 18,002 distinct words: past the dense domain, the segment path
        "nested-sf1/split-words-explode": ("bitunpack128", "radix_ranks",
                                           "murmur3_words"),
        "nested-sf1/struct-map": ("bitunpack128",),
        "nested-sf1/nested-write": ("bitunpack128",),
        "nested-sf1/pivot": ("bitunpack128", "onehot_sum_f32"),
        "nested-sf1/pivot-first": ("bitunpack128",),
        "nested-sf1/row-buffer": ("bitunpack128", "onehot_sum_f32"),
    }
    several_scans = {
        "nested-sf1/nested-write": [["l_orderkey", "l_suppkey",
                                     "l_returnflag", "l_shipdate"]],
        "nested-sf1/row-buffer": [fixed_cols, q1_cols]}
    rows_out = {"nested-sf1/collect-repartition-explode": exp["n_rows"],
                "nested-sf1/collect-repartition-posexplode": exp["n_rows"],
                "nested-sf1/split-words-explode": n_words}
    # the rows each path reads (row-buffer scans lineitem twice)
    rows_in = {label: exp["n_rows"] for label in paths}
    for label in ("split-words", "split-words-explode", "struct-map"):
        rows_in[f"nested-sf1/{label}"] = n_ss
    rows_in["nested-sf1/row-buffer"] = 2 * exp["n_rows"]

    os.makedirs(root, exist_ok=True)
    for label, (make, how, check) in paths.items():
        if make is None:          # a run of several plans: ``how`` runs it
            def act(how=how):
                return how()
        else:
            def act(make=make):
                return make().collect()
        plans = []
        with counting():
            t0 = time.perf_counter()
            if make is None:
                res = act()
            else:
                plan = make().physical_plan()
                plans.append(plan)
                res = plan.execute_collect()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            count_batches = [k for k in agg_batches if k]
        check(res, label)
        radix, mm, exs = exchange_prediction(plans)
        if make is None:
            # a run of several plans: its lineitem scans' columns (the
            # read-back of the nested files takes the arrow reader, which
            # launches no chunk decode)
            want_chunks = sum(scan_chunks(li_dir, cols)[0]
                              for cols in several_scans[label])
        else:
            want_chunks = sum(scan_chunks(d, ex.node._data_columns())[0]
                              for p in plans for d, ex in scans(p))
        gens = [g for p in plans for g in of_type(p, GenerateExec)]
        gen_line = "; ".join(
            f"{g.args_string()}: {g.stats['rows_in']} rows and "
            f"{g.stats['elements_in']} elements in, {g.stats['rows_out']} "
            "rows out" for g in gens)
        want = {"bitunpack128": want_chunks,
                "onehot_sum_f32": len(count_batches), "radix_ranks": radix,
                "murmur3_words": mm, "hash_join_build": 0,
                "hash_join_probe": 0}
        check_launches(label, counts, want, required[label])
        if label in rows_out and sum(g.stats["rows_out"]
                                     for g in gens) != rows_out[label]:
            raise AssertionError(f"{label}: {gen_line}; want "
                                 f"{rows_out[label]} rows out")
        ts = [first]
        for _ in range(reps):
            t0 = time.perf_counter()
            r = act()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check(r, label)
        idle = sql_idle_share(act)
        counts_by_path[label] = counts
        peak_by_path[label] = peak
        ex_line = "; ".join(
            f"{type(e.partitioner).__name__} {e.child.num_partitions} -> "
            f"{e.num_partitions}, {e.map_batches} partitioned batches"
            for e in exs)
        n_out, e_out = volume(res)
        print(f"{label} on {name}: median {statistics.median(ts):.4f} s, "
              f"min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
              f"runs: {[round(x, 4) for x in ts]}; equal to the oracle; "
              f"rows in {rows_in[label]}, rows out {n_out}, list elements "
              f"out {e_out}; {idle}; peak device memory {peak} B; launches "
              f"{ {k: v for k, v in counts.items() if v} } (predicted "
              f"{want}); {len(count_batches)} aggregate batches with "
              f"count-like requests; explodes: {gen_line or 'none'}; "
              f"exchanges: {ex_line or 'none'}"
              + (f"; steps of the last run {row_steps}"
                 if label.endswith("row-buffer") else ""))
    shutil.rmtree(root, ignore_errors=True)


DEEP_REPS = 1   # timed runs of each deep-nested-sf1 path after its counted run
DEEP_LINE_FIELDS = ("l_suppkey", "l_quantity", "l_extendedprice",
                    "l_shipdate", "l_returnflag")
DEEP_SUPP_MOD = 1000
DEEP_BIG = 4      # when(size(lines) > DEEP_BIG, lines)


def _lines_equal(col, exp, rows, label, what) -> None:
    """A list<struct> column (the orders in key order) against lineitem:
    each order's lines element for element in file order; ``rows`` (a
    mask over the orders) says which orders hold a list, the others must
    be null."""
    import pyarrow as pa
    import pyarrow.compute as pc
    col = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    valid = col.is_valid().to_numpy(zero_copy_only=False)
    if not np.array_equal(valid, rows):
        raise AssertionError(f"{label}: {what}: null lists differ")
    lens = pc.list_value_length(col).to_numpy(zero_copy_only=False)
    if not np.array_equal(lens[rows], exp["counts"][rows]):
        raise AssertionError(f"{label}: {what}: list lengths differ")
    flat = pc.list_flatten(col)
    keep = np.repeat(rows, exp["counts"])
    want = {"l_suppkey": exp["supp"], "l_quantity": exp["qty"],
            "l_extendedprice": exp["price"], "l_shipdate": exp["ship"]}
    for f, w in want.items():
        got = flat.field(f)
        if f == "l_shipdate":
            got = got.cast(pa.int32())
        if got.null_count or not np.array_equal(
                got.to_numpy(zero_copy_only=False), w[keep]):
            raise AssertionError(f"{label}: {what}: field {f} differs")
    flags = pa.array(np.array(["A", "N", "R"])[exp["fcode"][keep]])
    if not flat.field("l_returnflag").equals(flags):
        raise AssertionError(f"{label}: {what}: field l_returnflag differs")


def deep_nested_paths(spark, dev, name, li_dir, ds_paths, root, counting,
                      agg_batches, scan_chunks, reps: int,
                      counts_by_path: dict, peak_by_path: dict) -> str:
    """deep-nested-sf1: nested elements and fields at SF1, and rand().
    nested-orders (lineitem grouped by l_orderkey: ``first`` of the flag and
    the status and ``collect_list(struct(l_suppkey, l_quantity,
    l_extendedprice, l_shipdate, l_returnflag))`` as ``lines``, 1.5M
    orders and 6.0M structs, through ``repartition(4, l_orderkey)`` into
    parquet by the arrow writer and read back); nested-orders-explode (the
    four read-back files as four partitions, ``explode(lines)``,
    ``col.l_extendedprice`` summed by
    ``col.l_suppkey % 1000``); nested-orders-extract (``lines[0].l_suppkey``,
    ``size(lines)``, ``when(size(lines) > 4, lines)``, its ``coalesce``
    with ``lines`` and its equality with ``lines``, under a filter of
    ``lines == lines``); nested-orders-rollup (ROLLUP over (flag, status)
    of ``count(*)`` and ``collect_list(lines)``: ``lines`` crosses the
    ExpandExec); ds-word-lists (store_sales ⋈ item grouped by customer,
    ``collect_list(split(i_item_desc, ' '))``, exploded twice, words
    counted per customer); sample-rand (lineitem with ``rand(42)``, and
    ``filter(rand(7) < 0.01)`` counted, bit for bit a CPU session's on
    the same files). Each path: one counted run (launches predicted),
    ``reps`` more timed runs, one traced run; each held to a numpy/pyarrow
    oracle computed from the source files. Returns the directory of the
    read-back nested-orders files, which ordered-nested-sf1 reads."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.exec.generate import GenerateExec
    from spark_rapids_tpu_torch.expr.strings import java_split
    from spark_rapids_tpu_torch.io import writer as W
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    from spark_rapids_tpu_torch.session import TorchSession
    c = F.col
    t0 = time.perf_counter()
    exp = nested_oracle(li_dir)
    exp["price"] = pq.read_table(
        li_dir, columns=["l_extendedprice"]).column(0).to_numpy()
    start, counts = exp["start"], exp["counts"]
    n_orders = len(exp["keys"])
    supp_sums = np.bincount(exp["supp"] % DEEP_SUPP_MOD, weights=exp["price"],
                            minlength=DEEP_SUPP_MOD)
    supp_n = np.bincount(exp["supp"] % DEEP_SUPP_MOD, minlength=DEEP_SUPP_MOD)
    # the rollup's groups: (flag, status) of each order's first line
    of, os_ = exp["fcode"][start], exp["scode"][start]
    order_qty = np.add.reduceat(exp["qty"], start)
    rollup_want = {}
    for f in range(3):
        for s in range(2):
            m = (of == f) & (os_ == s)
            if m.any():
                rollup_want[("ANR"[f], "FO"[s])] = m
        m = of == f
        if m.any():
            rollup_want[("ANR"[f], None)] = m
    rollup_want[(None, None)] = np.ones(n_orders, bool)
    rollup_want = {k: (int(m.sum()), int(counts[m].sum()),
                       float(order_qty[m].sum()))
                   for k, m in rollup_want.items()}
    # the word lists: words a sale, summed by customer (nulls as -1)
    ss_files = data_files(ds_paths["store_sales"], ".parquet")
    ss = pq.read_table(ss_files, columns=["ss_item_sk", "ss_customer_sk"])
    item = pq.read_table(ds_paths["item"], columns=["i_item_sk",
                                                    "i_item_desc"])
    descs = item.column("i_item_desc").to_pylist()
    n_words_item = np.array([len(java_split(d, NESTED_WORD, -1))
                             if d is not None else 0 for d in descs],
                            np.int64)
    isk = item.column("i_item_sk").to_numpy()
    ss_item = ss.column("ss_item_sk").fill_null(-1).to_numpy()
    pos = np.searchsorted(isk, ss_item).clip(0, len(isk) - 1)
    hit = isk[pos] == ss_item
    cust = ss.column("ss_customer_sk").fill_null(-1).to_numpy()
    cust_k, cust_i = np.unique(cust[hit], return_inverse=True)
    cust_words = np.bincount(cust_i, weights=n_words_item[pos[hit]],
                             minlength=len(cust_k)).astype(np.int64)
    words_want = {int(k): int(w) for k, w in zip(cust_k, cust_words) if w}
    n_words = int(cust_words.sum())
    # rand: the CPU session's columns on the same files (bit for bit)
    cpu = TorchSession(device="cpu")

    def rand_frames(s):
        li = s.read_parquet(li_dir)
        return (li.select("l_orderkey", F.alias(F.rand(42), "r")),
                li.select("l_orderkey").filter(F.rand(7) < 0.01).agg(
                    F.alias(F.count(), "n")))
    cpu_r, cpu_n = (f.collect() for f in rand_frames(cpu))
    cpu_r = cpu_r.column("r").to_numpy()
    cpu_n = cpu_n.column("n")[0].as_py()
    print(f"deep-nested-sf1 oracles: {exp['n_rows']} lineitem rows in "
          f"{n_orders} orders, {ss.num_rows} store_sales rows, {n_words} "
          f"words in {len(words_want)} customers' lists, the CPU session's "
          f"rand columns ({len(cpu_r)} rows, {cpu_n} sampled), in "
          f"{time.perf_counter() - t0:.1f} s (numpy, pyarrow and a CPU "
          "session, outside every timed window)")

    out_dir = os.path.join(root, "orders_parquet")

    def run(df, plans):
        plan = df.physical_plan()
        plans.append(plan)
        return plan.execute_collect()

    def orders():
        line = F.struct(*[x for f in DEEP_LINE_FIELDS for x in (f, c(f))])
        return spark.read_parquet(li_dir).group_by("l_orderkey").agg(
            F.alias(F.first("l_returnflag"), "flag"),
            F.alias(F.first("l_linestatus"), "status"),
            F.alias(F.collect_list(line), "lines"))

    def nested_orders(plans):
        W.reset_routes()
        plan = orders().repartition(4, "l_orderkey").physical_plan()
        plans.append(plan)
        W.write_columnar(plan, out_dir, "parquet", mode="overwrite",
                         conf=spark.conf)
        back = run(spark.read_parquet(data_files(out_dir, ".parquet")),
                   plans)
        return dict(W.routes), back

    def by_key(t):
        return t.take(pc.sort_indices(t.column("l_orderkey")))

    def check_orders(res, label):
        routes, back = res
        if routes != {"native_files": 0, "arrow_files": 4}:
            raise AssertionError(f"{label}: writer routes {routes}")
        back = by_key(back)
        if not np.array_equal(back.column("l_orderkey").to_numpy(),
                              exp["keys"]):
            raise AssertionError(f"{label}: the order keys differ")
        for k, codes, vals in (("flag", exp["fcode"], "ANR"),
                               ("status", exp["scode"], "FO")):
            want = pa.array(np.array(list(vals))[codes[start]])
            if not back.column(k).combine_chunks().equals(want):
                raise AssertionError(f"{label}: first(...) as {k} differs")
        _lines_equal(back.column("lines"), exp, np.ones(n_orders, bool),
                     label, "lines")

    def exploded(plans):
        line = c("col")
        return run(spark.read_parquet(data_files(
            out_dir, ".parquet")).explode("lines").group_by(
            F.alias(F.get_field(line, "l_suppkey") % DEEP_SUPP_MOD, "k")).agg(
            F.alias(F.sum(F.get_field(line, "l_extendedprice")), "s"),
            F.alias(F.count(), "n")), plans)

    def check_exploded(res, label):
        k = res.column("k").to_numpy()
        got_s = np.zeros(DEEP_SUPP_MOD)
        got_n = np.zeros(DEEP_SUPP_MOD, np.int64)
        got_s[k] = res.column("s").to_numpy()
        got_n[k] = res.column("n").to_numpy()
        if (len(k) != int((supp_n > 0).sum())
                or not np.array_equal(got_n, supp_n)
                or np.max(np.abs(got_s - supp_sums)
                          / np.maximum(np.abs(supp_sums), 1e-300)) > 1e-9):
            raise AssertionError(f"{label}: sums by l_suppkey % "
                                 f"{DEEP_SUPP_MOD} differ")

    def extract(plans):
        lines = c("lines")
        big = F.when(F.size(lines) > DEEP_BIG, lines)
        return run(orders().filter(lines == lines).select(
            "l_orderkey",
            F.alias(F.get_field(F.element_at0(lines, 0), "l_suppkey"),
                    "first_supp"),
            F.alias(F.size(lines), "n"), F.alias(big, "big"),
            F.alias(F.coalesce(big, lines), "co"),
            F.alias(big == lines, "same")), plans)

    def check_extract(res, label):
        res = by_key(res)
        if not np.array_equal(res.column("l_orderkey").to_numpy(),
                              exp["keys"]):
            raise AssertionError(f"{label}: the filter of lines == lines "
                                 "dropped or kept wrong rows")
        if not (np.array_equal(res.column("first_supp").to_numpy(),
                               exp["supp"][start])
                and np.array_equal(res.column("n").to_numpy(), counts)):
            raise AssertionError(f"{label}: lines[0].l_suppkey or size "
                                 "differs")
        many = counts > DEEP_BIG
        _lines_equal(res.column("big"), exp, many, label, "when(...)")
        _lines_equal(res.column("co"), exp, np.ones(n_orders, bool), label,
                     "coalesce(...)")
        same = res.column("same").combine_chunks()
        if not (np.array_equal(same.is_valid().to_numpy(
                zero_copy_only=False), many)
                and pc.all(same.drop_null()).as_py() in (True, None)):
            raise AssertionError(f"{label}: when(...) == lines differs")

    def rollup(plans):
        return run(orders().rollup("flag", "status").agg(
            F.alias(F.count(), "n"),
            F.alias(F.collect_list("lines"), "ll")), plans)

    def check_rollup(res, label):
        got = {}
        for i in range(res.num_rows):
            ll = res.column("ll")[i].values        # the group's lists
            inner = pc.list_flatten(ll)
            got[(res.column("flag")[i].as_py(),
                 res.column("status")[i].as_py())] = (
                res.column("n")[i].as_py(), len(ll), len(inner),
                float(pc.sum(inner.field("l_quantity")).as_py() or 0.0))
        want = {k: (n, n, e, q) for k, (n, e, q) in rollup_want.items()}
        if got.keys() != want.keys():
            raise AssertionError(f"{label}: groups {sorted(got, key=str)}")
        for k, w in want.items():
            g = got[k]
            if g[:3] != w[:3] or abs(g[3] - w[3]) > 1e-9 * abs(w[3]):
                raise AssertionError(f"{label}: group {k}: {g} != {w}")

    def word_lists(plans):
        s = spark.read_parquet(ss_files).select("ss_item_sk",
                                                "ss_customer_sk")
        it = spark.read_parquet(ds_paths["item"]).select(
            c("i_item_sk").alias("ss_item_sk"), c("i_item_desc"))
        wl = s.join(it, on="ss_item_sk").select(
            "ss_customer_sk", F.split("i_item_desc", NESTED_WORD).alias(
                "w")).group_by("ss_customer_sk").agg(
            F.alias(F.collect_list("w"), "wl"))
        return run(wl.explode("wl").explode("col").group_by(
            "ss_customer_sk").count(), plans)

    def check_words(res, label):
        k = res.column("ss_customer_sk").fill_null(-1).to_pylist()
        got = dict(zip(k, res.column("count").to_pylist()))
        if got != words_want:
            raise AssertionError(f"{label}: words per customer differ")

    def sample(plans):
        r, n = rand_frames(spark)
        return run(r, plans), run(n, plans)

    def check_sample(res, label):
        r, n = res
        got = r.column("r").to_numpy()
        if not np.array_equal(got.view(np.int64), cpu_r.view(np.int64)):
            raise AssertionError(f"{label}: rand(42) differs from the CPU "
                                 "session's")
        if abs(float(got.mean()) - 0.5) > 1e-3:
            raise AssertionError(f"{label}: rand(42)'s mean {got.mean()}")
        got_n = n.column("n")[0].as_py()
        if got_n != cpu_n or abs(got_n / len(got) - 0.01) > 1e-3:
            raise AssertionError(f"{label}: {got_n} rows sampled, the CPU "
                                 f"session {cpu_n}")

    paths = {
        "deep-nested-sf1/nested-orders": (nested_orders, check_orders),
        "deep-nested-sf1/nested-orders-explode": (exploded, check_exploded),
        "deep-nested-sf1/nested-orders-extract": (extract, check_extract),
        "deep-nested-sf1/nested-orders-rollup": (rollup, check_rollup),
        "deep-nested-sf1/ds-word-lists": (word_lists, check_words),
        "deep-nested-sf1/sample-rand": (sample, check_sample),
    }
    # the kernels each path must launch (the rest predicted, maybe 0)
    required = {
        "deep-nested-sf1/nested-orders": ("bitunpack128", "radix_ranks"),
        "deep-nested-sf1/nested-orders-explode": ("radix_ranks",),
        "deep-nested-sf1/nested-orders-extract": ("bitunpack128",),
        "deep-nested-sf1/nested-orders-rollup": ("bitunpack128",),
        "deep-nested-sf1/ds-word-lists": ("bitunpack128", "radix_ranks"),
        "deep-nested-sf1/sample-rand": ("bitunpack128",),
    }
    rows_in = {label: exp["n_rows"] for label in paths}
    rows_in["deep-nested-sf1/nested-orders-explode"] = n_orders
    rows_in["deep-nested-sf1/ds-word-lists"] = ss.num_rows
    rows_in["deep-nested-sf1/sample-rand"] = 2 * exp["n_rows"]
    # the list elements the path reads (the read-back files' structs; the
    # other paths read flat columns)
    elems_in = {label: 0 for label in paths}
    elems_in["deep-nested-sf1/nested-orders-explode"] = exp["n_rows"]
    # the rows out of each path's outermost explode
    explode_rows = {"deep-nested-sf1/nested-orders-explode": exp["n_rows"],
                    "deep-nested-sf1/ds-word-lists": n_words}

    os.makedirs(root, exist_ok=True)
    t_phase = time.perf_counter()
    for label, (act, check) in paths.items():
        plans = []
        with counting():
            t0 = time.perf_counter()
            res = act(plans)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts_now = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            count_batches = [k for k in agg_batches if k]
        check(res, label)
        radix, mm, exs = exchange_prediction(plans)
        # the read-back of the nested files takes the arrow reader, which
        # launches no chunk decode
        want_chunks = sum(scan_chunks(d, ex.node._data_columns())[0]
                          for p in plans for d, ex in scans(p)
                          if os.path.normpath(d) != os.path.normpath(out_dir))
        gens = [g for p in plans for g in of_type(p, GenerateExec)]
        gen_line = "; ".join(
            f"{g.args_string()}: {g.stats['rows_in']} rows and "
            f"{g.stats['elements_in']} elements in, {g.stats['rows_out']} "
            "rows out" for g in gens)
        want = {"bitunpack128": want_chunks,
                "onehot_sum_f32": len(count_batches), "radix_ranks": radix,
                "murmur3_words": mm, "hash_join_build": 0,
                "hash_join_probe": 0}
        check_launches(label, counts_now, want, required[label])
        if label in explode_rows and (
                not gens or gens[0].stats["rows_out"] != explode_rows[label]):
            raise AssertionError(f"{label}: {gen_line}; want "
                                 f"{explode_rows[label]} rows out")
        ts = [first]
        for _ in range(reps):
            t0 = time.perf_counter()
            r = act([])
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check(r, label)
        idle = sql_idle_share(lambda: act([]))
        counts_by_path[label] = counts_now
        peak_by_path[label] = peak
        ex_line = "; ".join(
            f"{type(e.partitioner).__name__} {e.child.num_partitions} -> "
            f"{e.num_partitions}, {e.map_batches} partitioned batches"
            for e in exs)
        n_out, e_out = volume(res)
        print(f"{label} on {name}: median {statistics.median(ts):.4f} s, "
              f"min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
              f"runs: {[round(x, 4) for x in ts]}; equal to the oracle; "
              f"rows in {rows_in[label]}, rows out {n_out}, list elements "
              f"in {elems_in[label]}, out {e_out}; {idle}; peak device "
              f"memory {peak} B; launches "
              f"{ {k: v for k, v in counts_now.items() if v} } (predicted "
              f"{want}); {len(count_batches)} aggregate batches with "
              f"count-like requests; explodes: {gen_line or 'none'}; "
              f"exchanges: {ex_line or 'none'}")
    print(f"deep-nested-sf1: {time.perf_counter() - t_phase:.1f} s")
    # the read-back files feed ordered-nested-sf1; main removes root after
    return out_dir


ORDERED_REPS = 1   # timed runs of each ordered-nested-sf1 path after its counted run
ORDERED_GROUPS = 10_000     # max/min of the supplier lists by l_orderkey % 10000


def ship_years(days: np.ndarray) -> np.ndarray:
    """The calendar year of each day number since 1970-01-01."""
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _padded(lists_start, counts, values, width: int, pad) -> np.ndarray:
    """Each list (``counts[i]`` values from ``lists_start[i]``) as a row of
    ``width`` slots, ``pad`` after its end."""
    out = np.full((len(counts), width), pad, dtype=values.dtype)
    within = np.arange(len(values)) - np.repeat(lists_start, counts)
    out[np.repeat(np.arange(len(counts)), counts), within] = values
    return out


def _lex_increasing(rows: np.ndarray) -> bool:
    """Whether each row of ``rows`` is lexicographically greater than the
    one before it."""
    if len(rows) < 2:
        return True
    diff = rows[1:] != rows[:-1]
    first = diff.argmax(axis=1)
    i = np.arange(len(first))
    return bool(diff.any(axis=1).all()
                and (rows[1:][i, first] > rows[:-1][i, first]).all())


def aggregate_line(label: str, a) -> str:
    """One aggregate's batches, sort tiers, probes, chain and host syncs."""
    st = a.stats
    tiers = ", ".join(f"{k} {v}" for k, v in st["tiers"].items())
    return (f"{label} aggregate mode={a.mode} keys={len(a.group_exprs)}: "
            f"{st['updates']} update and {st['merges']} merge batches, "
            f"{st['segment']} on the segment path, {st['presorted']} "
            f"presorted ({st['probes']} probes, {st['hinted']} with a range "
            f"hint); sort tiers {tiers}; {st['chained']} chained, "
            f"{st['mispredicted']} mispredicted; host syncs {st['syncs']}; "
            f"groups {st['groups'][-8:]}; {st['seconds']:.4f} s host"
            + ("; HAVING fused" if a.postfilter is not None else ""))


def ordered_nested_paths(spark, dev, name, li_dir, orders_dir, counting,
                         agg_batches, scan_chunks, reps: int,
                         counts_by_path: dict, peak_by_path: dict) -> None:
    """ordered-nested-sf1: the order over whole nested values at SF1.
    nested-max-min (lineitem grouped by l_orderkey into ``supps =
    collect_list(l_suppkey)``, 1.5M ``array<int>`` of 6.0M elements, then
    ``max(supps)`` and ``min(supps)`` by ``l_orderkey % 10000``, 10,000
    groups of about 150 arrays); nested-sort (the same 1.5M rows as a global
    ``order_by(desc(supps), l_orderkey)``); nested-collect-set (lineitem by
    l_suppkey, 10,000 groups of about 600 rows: ``collect_set(struct(
    l_returnflag, l_linestatus, year(l_shipdate)))`` and
    ``collect_set(array(l_returnflag, l_linestatus))``; the generator's
    lineitem has no l_shipmode, so the ship year, seven values, stands in
    for it: at most 42 and 6 distinct values a group); nested-set-of-lines (deep-nested-sf1's
    four read-back nested-orders files, ``collect_set(lines)`` by
    ``size(lines)``: 7 groups, 1.5M distinct ``array<struct>`` of five
    fields). Each path: one counted run (launches predicted), ``reps`` more
    timed runs, one traced run; each held to a numpy/pyarrow oracle from
    the source files. Its line gives the rank passes of
    ``ops/nested.order_ranks`` in the counted run."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    from spark_rapids_tpu_torch.ops import nested as NO
    c = F.col
    t0 = time.perf_counter()
    exp = nested_oracle(li_dir)
    exp["price"] = pq.read_table(
        li_dir, columns=["l_extendedprice"]).column(0).to_numpy()
    keys, start, counts = exp["keys"], exp["start"], exp["counts"]
    n_orders, width = len(keys), int(counts.max())
    # nested-max-min: supplier lists padded with -1 (below every key, so a
    # prefix sorts first), the first and last of each group in lex order
    pad = _padded(start, counts, exp["supp"].astype(np.int64), width, -1)
    grp = keys % ORDERED_GROUPS
    order = np.lexsort(tuple(pad[:, j] for j in range(width - 1, -1, -1))
                       + (grp,))
    g_sorted = grp[order]
    first = np.r_[0, np.flatnonzero(np.diff(g_sorted)) + 1]
    last = np.r_[first[1:] - 1, len(order) - 1]
    mm_want = {"g": g_sorted[first], "lo": pad[order[first]],
               "hi": pad[order[last]]}
    # nested-sort: descending lists (negated, the padding then above every
    # element, so the longer list first), ties by ascending l_orderkey
    sort_want = keys[np.lexsort((keys,) + tuple(
        -pad[:, j] for j in range(width - 1, -1, -1)))]
    # nested-collect-set: (flag, status, ship year) codes by supplier
    supp = exp["supp"].astype(np.int64)
    years = ship_years(exp["ship"])
    year_set = np.unique(years)
    n_years = len(year_set)
    fs = exp["fcode"] * 2 + exp["scode"]
    triple = np.unique((supp * 6 + fs) * n_years
                       + np.searchsorted(year_set, years))
    pair = np.unique(supp * 8 + fs)
    supps = np.unique(supp)
    # nested-set-of-lines: each order's lines as one row (its five fields
    # a line), grouped by length; every group's rows distinct
    fields = [exp["supp"].astype(np.float64), exp["qty"], exp["price"],
              exp["ship"].astype(np.float64), exp["fcode"].astype(np.float64)]
    flat = np.stack(fields, axis=1).reshape(-1)
    lines = _padded(start * 5, counts * 5, flat, width * 5, np.nan)
    lines_want = {}
    for n in np.unique(counts):
        rows = lines[counts == n][:, :5 * n]
        rows = rows[np.lexsort(rows.T[::-1])]
        if not _lex_increasing(rows):
            raise AssertionError(f"nested-set-of-lines oracle: orders of "
                                 f"{n} lines hold equal lists")
        lines_want[int(n)] = rows
    del lines
    print(f"ordered-nested-sf1 oracles: {n_orders} supplier lists of at "
          f"most {width}, {len(mm_want['g'])} max/min groups, "
          f"{len(supps)} suppliers with {len(triple)} distinct (flag, "
          f"status, ship year) and {len(pair)} (flag, status), "
          f"{len(lines_want)} list lengths, in "
          f"{time.perf_counter() - t0:.1f} s (numpy and pyarrow, outside "
          "every timed window)")

    orders_files = data_files(orders_dir, ".parquet")

    def run(df, plans):
        plan = df.physical_plan()
        plans.append(plan)
        return plan.execute_collect()

    def supp_lists():
        return spark.read_parquet(li_dir).group_by("l_orderkey").agg(
            F.alias(F.collect_list("l_suppkey"), "supps"))

    def max_min(plans):
        return run(supp_lists().group_by(F.alias(
            c("l_orderkey") % ORDERED_GROUPS, "g")).agg(
            F.alias(F.max("supps"), "hi"), F.alias(F.min("supps"), "lo")),
            plans)

    def as_padded(col):
        lens, fl = _flat(col)
        vals = fl.to_numpy(zero_copy_only=False).astype(np.int64)
        st = np.r_[0, np.cumsum(lens)[:-1]]
        return _padded(st, lens, vals, width, -1)

    def check_max_min(res, label):
        res = res.take(pc.sort_indices(res.column("g")))
        if not np.array_equal(res.column("g").to_numpy(), mm_want["g"]):
            raise AssertionError(f"{label}: the groups differ")
        for k in ("hi", "lo"):
            if not np.array_equal(as_padded(res.column(k)), mm_want[k]):
                raise AssertionError(f"{label}: {k} differs")

    def nested_sort(plans):
        return run(supp_lists().order_by("supps", "l_orderkey",
                                         ascending=[False, True]), plans)

    def check_sort(res, label):
        if not np.array_equal(res.column("l_orderkey").to_numpy(),
                              sort_want):
            raise AssertionError(f"{label}: the order differs")
        got = as_padded(res.column("supps"))
        if not np.array_equal(got, pad[np.searchsorted(keys, sort_want)]):
            raise AssertionError(f"{label}: the lists differ")

    def collect_set(plans):
        return run(spark.read_parquet(li_dir).group_by("l_suppkey").agg(
            F.alias(F.collect_set(F.struct(
                "f", c("l_returnflag"), "s", c("l_linestatus"), "y",
                F.year("l_shipdate"))), "fsy"),
            F.alias(F.collect_set(F.array("l_returnflag", "l_linestatus")),
                    "fs")), plans)

    def codes_of(arr, values):
        enc = arr.dictionary_encode()
        m = np.array([values.index(v) for v in enc.dictionary.to_pylist()]
                     or [0])
        return m[enc.indices.to_numpy(zero_copy_only=False)]

    def check_set(res, label):
        res = res.take(pc.sort_indices(res.column("l_suppkey")))
        k = res.column("l_suppkey").to_numpy().astype(np.int64)
        if not np.array_equal(k, supps):
            raise AssertionError(f"{label}: the suppliers differ")
        lens, fl = _flat(res.column("fsy"))
        got = ((np.repeat(k, lens) * 6
                + codes_of(fl.field("f"), ["A", "N", "R"]) * 2
                + codes_of(fl.field("s"), ["F", "O"])) * n_years
               + np.searchsorted(year_set, fl.field("y").to_numpy(
                   zero_copy_only=False)))
        if not np.array_equal(got, triple):
            raise AssertionError(f"{label}: collect_set(struct) differs")
        lens, fl = _flat(res.column("fs"))
        inner_lens, inner = _flat(fl)
        if not (inner_lens == 2).all():
            raise AssertionError(f"{label}: collect_set(array): lengths")
        fl_codes = codes_of(inner, ["A", "N", "R", "F", "O"]).reshape(-1, 2)
        got = np.repeat(k, lens) * 8 + fl_codes[:, 0] * 2 + fl_codes[:, 1] - 3
        if not np.array_equal(got, pair):
            raise AssertionError(f"{label}: collect_set(array) differs")

    def set_of_lines(plans):
        return run(spark.read_parquet(orders_files).group_by(F.alias(
            F.size("lines"), "n")).agg(F.alias(F.collect_set("lines"),
                                               "ls")), plans)

    def check_lines(res, label):
        got_n = sorted(res.column("n").to_pylist())
        if got_n != sorted(lines_want):
            raise AssertionError(f"{label}: sizes {got_n}")
        for i in range(res.num_rows):
            n = res.column("n")[i].as_py()
            ls = pa.array(res.column("ls")[i].values)     # n-line lists
            fl = pc.list_flatten(ls)
            cols = [fl.field(f).cast(pa.float64()).to_numpy(
                zero_copy_only=False) if f != "l_shipdate" else
                fl.field(f).cast(pa.int32()).to_numpy(
                    zero_copy_only=False).astype(np.float64)
                for f in DEEP_LINE_FIELDS[:4]]
            cols.append(codes_of(fl.field("l_returnflag"),
                                 ["A", "N", "R"]).astype(np.float64))
            rows = np.stack(cols, axis=1).reshape(len(ls), 5 * n)
            if not np.array_equal(rows, lines_want[n]):
                raise AssertionError(f"{label}: the set of {n}-line lists "
                                     "differs (or is not in Spark's order)")

    paths = {
        "ordered-nested-sf1/nested-max-min": (max_min, check_max_min),
        "ordered-nested-sf1/nested-sort": (nested_sort, check_sort),
        "ordered-nested-sf1/nested-collect-set": (collect_set, check_set),
        "ordered-nested-sf1/nested-set-of-lines": (set_of_lines,
                                                   check_lines),
    }
    required = {
        "ordered-nested-sf1/nested-max-min": ("bitunpack128",),
        "ordered-nested-sf1/nested-sort": ("bitunpack128",),
        "ordered-nested-sf1/nested-collect-set": ("bitunpack128",),
        "ordered-nested-sf1/nested-set-of-lines": ("radix_ranks",),
    }
    elems = len(exp["supp"])
    rows_in = {label: exp["n_rows"] for label in paths}
    rows_in["ordered-nested-sf1/nested-set-of-lines"] = n_orders
    elems_in = {label: 0 for label in paths}
    elems_in["ordered-nested-sf1/nested-set-of-lines"] = elems
    t_phase = time.perf_counter()
    for label, (act, check) in paths.items():
        plans = []
        with counting():
            NO.rank_stats.update(calls=0, passes=0)
            t0 = time.perf_counter()
            res = act(plans)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts_now = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            count_batches = [k for k in agg_batches if k]
            ranks = dict(NO.rank_stats)
        check(res, label)
        radix, mm, exs = exchange_prediction(plans)
        want_chunks = sum(scan_chunks(d, ex.node._data_columns())[0]
                          for p in plans for d, ex in scans(p)
                          if os.path.normpath(d) != os.path.normpath(
                              orders_dir))
        want = {"bitunpack128": want_chunks,
                "onehot_sum_f32": len(count_batches), "radix_ranks": radix,
                "murmur3_words": mm, "hash_join_build": 0,
                "hash_join_probe": 0}
        check_launches(label, counts_now, want, required[label])
        for p in plans:
            for a in aggregates(p):
                print(aggregate_line(label, a))
        ts = [first_s]
        for _ in range(reps):
            t0 = time.perf_counter()
            r = act([])
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            check(r, label)
        idle = sql_idle_share(lambda: act([]))
        counts_by_path[label] = counts_now
        peak_by_path[label] = peak
        n_out, e_out = volume(res)
        print(f"{label} on {name}: median {statistics.median(ts):.4f} s, "
              f"min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
              f"runs: {[round(x, 4) for x in ts]}; equal to the oracle; "
              f"rows in {rows_in[label]}, rows out {n_out}, list elements "
              f"in {elems_in[label]}, out {e_out}; rank passes "
              f"{ranks['passes']} in {ranks['calls']} order_ranks calls; "
              f"{idle}; peak device memory {peak} B; launches "
              f"{ {k: v for k, v in counts_now.items() if v} } (predicted "
              f"{want}); {len(count_batches)} aggregate batches with "
              f"count-like requests")
    print(f"ordered-nested-sf1: {time.perf_counter() - t_phase:.1f} s")


def sort_device_ms(run) -> tuple:
    """(device ms of the sort kernels, device ms of every record, traced
    wall s) of one run(), from a whole trace (taken again when short, at
    most three times; a short one is marked)."""
    for _ in range(3):
        census, device, wall = traced(run)
        why = trace_check(census)[3]
        if not why:
            break
    sort_us = sum(us for n, us in device if "sort" in n.lower())
    all_us = sum(us for _n, us in device)
    return sort_us / 1e3, all_us / 1e3, wall, why


def groupby_rest_compare(name, card, frames_on: dict, frames_off: dict,
                         checks: dict) -> None:
    """The group-by remainder (the packed key with its range hint, the
    right-sizing, the chain and the fused HAVING) against the unchained,
    unpacked route of ``stageFusion.enabled=false``, in turns (on, off, off,
    on) on the same card: each path's walls, its aggregates' host syncs and
    tiers, and the device time of its sorts from one trace each. The
    results of both are held equal. Recorded; nothing is claimed from it."""
    for label in frames_on:
        walls = {"on": [], "off": []}
        syncs, shape = {}, {}
        res = {}
        for route in ("on", "off", "off", "on"):
            make = (frames_on if route == "on" else frames_off)[label]
            t0 = time.perf_counter()
            plan = make().physical_plan()
            out = plan.execute_collect()
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
            aggs = aggregates(plan)
            syncs[route] = sum(a.stats["syncs"] for a in aggs)
            shape[route] = "; ".join(
                f"{a.mode} chained {a.stats['chained']} mispredicted "
                f"{a.stats['mispredicted']} tiers "
                f"{ {k: v for k, v in a.stats['tiers'].items() if v} } "
                f"presorted {a.stats['presorted']} hinted "
                f"{a.stats['hinted']}" for a in aggs)
            res[route] = out
        checks[label](res["on"])
        if (sorted(map(repr, res["on"].to_pylist()))
                != sorted(map(repr, res["off"].to_pylist()))):
            raise AssertionError(f"group-by remainder {label}: "
                                 "stageFusion.enabled=false gives other rows")
        dev = {r: sort_device_ms(lambda r=r: (
            frames_on if r == "on" else frames_off)[label]().collect())
               for r in ("on", "off")}
        print(f"group-by remainder {label} on {card}: stageFusion on: walls "
              f"{[round(x, 4) for x in walls['on']]} s, aggregate host "
              f"syncs {syncs['on']}, sort device {dev['on'][0]:.4f} ms of "
              f"{dev['on'][1]:.4f} ms device{' SHORT ' + dev['on'][3] if dev['on'][3] else ''} "
              f"[{shape['on']}]; off (unchained, unpacked): walls "
              f"{[round(x, 4) for x in walls['off']]} s, aggregate host "
              f"syncs {syncs['off']}, sort device {dev['off'][0]:.4f} ms of "
              f"{dev['off'][1]:.4f} ms device{' SHORT ' + dev['off'][3] if dev['off'][3] else ''} "
              f"[{shape['off']}]; same rows")


JOIN_FUSION_REPS = 1   # timed runs of each join-fusion-sf1 path after its counted run
CHAIN_PARTS = 200_000      # TPC-H part rows at SF1
CHAIN_PS_PER_PART = 4      # TPC-H partsupp rows a part
CHAIN_SHIP_CUTOFF = datetime.date(1998, 9, 2)
Q6_FROM, Q6_TO = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)


def write_part_tables(root: str, sf: float) -> dict:
    """TPC-H's part (``p_partkey`` 1..200,000 x sf, unique; ``p_brand``
    'Brand#MN', M and N in 1..5) and partsupp (four rows a part:
    ``ps_partkey``, ``ps_suppkey``, ``ps_supplycost`` in [1.00, 1000.00])
    from a seed, as parquet under ``root``: the generator's TPC-H subset has
    neither table."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.benchmarks.common import write_partitioned
    rng = np.random.default_rng(20261018)
    n = max(int(CHAIN_PARTS * sf), 1)
    brands = np.array([f"Brand#{m}{k}" for m in range(1, 6)
                       for k in range(1, 6)])
    out = {}
    write_partitioned(root, "part", pa.table({
        "p_partkey": pa.array(np.arange(1, n + 1, dtype=np.int64)),
        "p_brand": pa.array(brands[rng.integers(0, 25, n)])}), 1, out)
    pk = np.repeat(np.arange(1, n + 1, dtype=np.int64), CHAIN_PS_PER_PART)
    write_partitioned(root, "partsupp", pa.table({
        "ps_partkey": pa.array(pk),
        "ps_suppkey": pa.array(rng.integers(1, max(int(10_000 * sf), 1) + 1,
                                            len(pk)).astype(np.int64)),
        "ps_supplycost": pa.array(np.round(rng.uniform(1.0, 1000.0,
                                                       len(pk)), 2))}),
        1, out)
    return out


def _days(d) -> int:
    return (d - datetime.date(1970, 1, 1)).days


@contextlib.contextmanager
def decoded_at_scan():
    """Every parquet chunk decoded as the scan yields its batch: the dense
    route that the lazy ``EncodedColumnVector`` replaces, for a
    comparison."""
    from spark_rapids_tpu_torch.columnar.encoded import EncodedColumnVector
    from spark_rapids_tpu_torch.io import parquet_native as PN
    read = PN.read_row_group_device

    def at_scan(*args, **kw):
        batch = read(*args, **kw)
        for c in batch.columns:
            if isinstance(c, EncodedColumnVector):
                c.decode()
        return batch
    PN.read_row_group_device = at_scan
    try:
        yield
    finally:
        PN.read_row_group_device = read


def join_fusion_paths(spark, off, dev, name, card, paths, root,
                      sf, check, exp_q1, counting, agg_batches, scan_chunks,
                      reps: int, counts_by_path: dict,
                      peak_by_path: dict) -> None:
    """join-fusion-sf1: the joins' stream hoist and probe chain, encoded
    upload and the pushed scan filter, on the SF1 files.

    - ladder-fusion: q3, q5, q5-sparse and q18 beside ``stageFusion.enabled
      =false`` (``off``), in turns on, off, off, on, each turn a counted run
      with launches predicted; the rows the same (both routes also held to
      the oracle); each query's chains with their hops' probe modes, the
      hoisted prefilters and preprojects, the joins' host syncs, the joins'
      device time (one trace a route, ``join_device_ms``) and the walls;
    - chain-3hop: lineitem where ``l_shipdate <= 1998-09-02`` (a
      prefilter), ``l_orderkey`` and ``l_extendedprice * (1 - l_discount)
      AS rev`` (a preproject), joined to orders, customer and nation (one
      chain of three unique-keyed hops), then by ``n_name``: ``sum(rev)``,
      ``count(*)``;
    - chain-dup-build: ``l_partkey`` (computed: TPC-H's lineitem column is
      not generated) joined to part (unique), then to partsupp (four rows a
      key: probe mode two), so every batch runs the hops one after another;
      then by ``p_brand``: ``count(*)``, ``sum(ps_supplycost)``;
    - q1-encoded and q1-dense: q1 with each chunk decoded at its first read
      (the port's one route), and with every chunk decoded as the scan
      yields it (``decoded_at_scan``), the rows bit for bit, 48 chunk
      decodes a scan either way, each of an encoded vector decoded once;
    - scan-pushed-filter: TPC-H q6's predicate pushed into the lineitem
      scan (the date conjuncts to arrow, the double ones the residual, on
      the device), then ``sum(l_extendedprice * l_discount)``.

    Each path: a counted run (launches predicted), ``reps`` more timed runs
    and one traced run, held to numpy/pyarrow oracles (floats within 1e-6
    relative, as the ladder's oracles hold them)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import encoded as EN
    from spark_rapids_tpu_torch.exec.joins import \
        BroadcastHashJoinChainExec as Chain
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    c = F.col
    t_phase = time.perf_counter()
    li_dir = paths["lineitem"]
    parts = write_part_tables(root, sf)

    def col(d, name_, cast=None):
        a = pq.read_table(d, columns=[name_]).column(0)
        return (a.cast(cast) if cast is not None else a).to_numpy()

    def close(got, want) -> bool:
        return abs(got - want) <= 1e-6 * max(1.0, abs(want))

    # -- the oracles, from the files, outside every timed window ----------
    t0 = time.perf_counter()
    l_ok = col(li_dir, "l_orderkey")
    l_price = col(li_dir, "l_extendedprice")
    l_disc = col(li_dir, "l_discount")
    l_ship = col(li_dir, "l_shipdate", pa.int32())
    o_key, o_cust = col(paths["orders"], "o_orderkey"), \
        col(paths["orders"], "o_custkey")
    c_key = col(paths["customer"], "c_custkey")
    c_nat = col(paths["customer"], "c_nationkey")
    n_names = col(paths["nation"], "n_name")
    n_keys = col(paths["nation"], "n_nationkey")
    cust_of = np.zeros(o_key.max() + 1, np.int64)
    cust_of[o_key] = o_cust
    nat_of = np.zeros(c_key.max() + 1, np.int64)
    nat_of[c_key] = c_nat
    keep = l_ship <= _days(CHAIN_SHIP_CUTOFF)
    nk = nat_of[cust_of[l_ok[keep]]]
    rev = l_price[keep] * (1.0 - l_disc[keep])
    three_want = {str(n_names[list(n_keys).index(k)]): (
        float(np.bincount(nk, weights=rev, minlength=25)[k]),
        int(np.bincount(nk, minlength=25)[k]))
        for k in np.unique(nk)}
    n_parts = max(int(CHAIN_PARTS * sf), 1)
    l_supp = col(li_dir, "l_suppkey")
    l_part = (l_ok * 7 + l_supp) % n_parts + 1
    p_key, p_brand = col(parts["part"], "p_partkey"), \
        col(parts["part"], "p_brand")
    ps_key = col(parts["partsupp"], "ps_partkey")
    ps_cost = col(parts["partsupp"], "ps_supplycost")
    brands, brand_code = np.unique(p_brand, return_inverse=True)
    brand_of = np.zeros(n_parts + 1, np.int64)
    brand_of[p_key] = brand_code
    cost_of = np.bincount(ps_key, weights=ps_cost, minlength=n_parts + 1)
    per_of = np.bincount(ps_key, minlength=n_parts + 1)
    lb = brand_of[l_part]
    dup_want = {str(brands[b]): (
        int(np.bincount(lb, weights=per_of[l_part],
                        minlength=len(brands))[b]),
        float(np.bincount(lb, weights=cost_of[l_part],
                          minlength=len(brands))[b]))
        for b in np.unique(lb)}
    dup_pairs = int(per_of[l_part].sum())
    l_qty = col(li_dir, "l_quantity")
    in_year = (l_ship >= _days(Q6_FROM)) & (l_ship < _days(Q6_TO))
    q6 = in_year & (l_qty < 24) & (l_disc >= 0.05) & (l_disc <= 0.07)
    q6_want = float((l_price[q6] * l_disc[q6]).sum())
    q6_rows = (int(in_year.sum()), int(q6.sum()))
    n_li = len(l_ok)
    del l_ok, l_price, l_disc, l_ship, l_supp, l_part, l_qty
    print(f"join-fusion-sf1 oracles: chain-3hop {len(three_want)} nations "
          f"over {int(keep.sum())} lineitem rows; chain-dup-build "
          f"{len(dup_want)} brands over {dup_pairs} pairs ({n_parts} parts, "
          f"{len(ps_key)} partsupp rows); q6 {q6_rows[1]} of "
          f"{q6_rows[0]} rows in 1994; in "
          f"{time.perf_counter() - t0:.1f} s (numpy and pyarrow)")

    # -- the frames --------------------------------------------------------
    def three_hop(s):
        li = (s.read_parquet(li_dir)
              .filter(c("l_shipdate") <= F.lit(_days(CHAIN_SHIP_CUTOFF),
                                               T.DATE))
              .select(c("l_orderkey"), F.alias(
                  c("l_extendedprice") * (F.lit(1.0) - c("l_discount")),
                  "rev")))
        orders = s.read_parquet(paths["orders"]).select(
            F.alias(c("o_orderkey"), "l_orderkey"), c("o_custkey"))
        cust = s.read_parquet(paths["customer"]).select(
            F.alias(c("c_custkey"), "o_custkey"), c("c_nationkey"))
        nation = s.read_parquet(paths["nation"]).select(
            F.alias(c("n_nationkey"), "c_nationkey"), c("n_name"))
        return (li.join(orders, on="l_orderkey").join(cust, on="o_custkey")
                .join(nation, on="c_nationkey").group_by("n_name")
                .agg(F.alias(F.sum("rev"), "rev"), F.alias(F.count(), "n")))

    def dup_build(s):
        li = s.read_parquet(li_dir).select(F.alias(
            (c("l_orderkey") * F.lit(7) + c("l_suppkey")) % F.lit(n_parts)
            + F.lit(1), "l_partkey"))
        part = s.read_parquet(parts["part"]).select(
            F.alias(c("p_partkey"), "l_partkey"), c("p_brand"))
        ps = s.read_parquet(parts["partsupp"]).select(
            F.alias(c("ps_partkey"), "l_partkey"), c("ps_supplycost"))
        return (li.join(part, on="l_partkey").join(ps, on="l_partkey")
                .group_by("p_brand").agg(F.alias(F.count(), "n"),
                                         F.alias(F.sum("ps_supplycost"),
                                                 "cost")))

    def pushed(s):
        pred = ((c("l_shipdate") >= F.lit(Q6_FROM, T.DATE))
                & (c("l_shipdate") < F.lit(Q6_TO, T.DATE))
                & (c("l_quantity") < F.lit(24.0))
                & (c("l_discount") >= F.lit(0.05))
                & (c("l_discount") <= F.lit(0.07)))
        return s.read_parquet(li_dir, pushed_filter=pred).agg(F.alias(
            F.sum(c("l_extendedprice") * c("l_discount")), "revenue"))

    def check_three(res, label):
        got = {r["n_name"]: (r["rev"], r["n"]) for r in res.to_pylist()}
        if got.keys() != three_want.keys() or any(
                got[k][1] != n or not close(got[k][0], v)
                for k, (v, n) in three_want.items()):
            raise AssertionError(f"{label}: {got} != oracle {three_want}")

    def check_dup(res, label):
        got = {r["p_brand"]: (r["n"], r["cost"]) for r in res.to_pylist()}
        if got.keys() != dup_want.keys() or any(
                got[k][0] != n or not close(got[k][1], v)
                for k, (n, v) in dup_want.items()):
            raise AssertionError(f"{label}: {got} != oracle {dup_want}")

    def check_q6(res, label):
        got = res.column("revenue")[0].as_py()
        if not close(got, q6_want):
            raise AssertionError(f"{label}: revenue {got} != {q6_want}")

    def rows_in(plan) -> int:
        return sum(pq.ParquetFile(f).metadata.num_rows
                   for _d, ex in scans(plan)
                   for part in ex.node.partitions for f in part.paths)

    def predicted(plan, count_batches, decoded: bool = True) -> dict:
        js = joins(plan)
        hashed = [j for j in js if j.stats["probe_mode"] == "hash"]
        return {
            "bitunpack128": sum(scan_chunks(d, ex.node._data_columns())[0]
                                for d, ex in scans(plan)
                                if ex.node.pushed_filter is None)
            if decoded else 0,
            "onehot_sum_f32": len(count_batches), "radix_ranks": 0,
            "murmur3_words": 0,
            "hash_join_build": len(hashed) + sum(j.stats["hash_refused"]
                                                 for j in js),
            "hash_join_probe": sum(j.stats["stream_batches"]
                                   for j in hashed)}

    def counted(label, make, chk, required=("bitunpack128",)):
        """One counted run: (plan, result, wall s, launches, peak B)."""
        with counting():
            t0 = time.perf_counter()
            plan = make().physical_plan()
            res = plan.execute_collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            batches = [k for k in agg_batches if k]
        chk(res, label)
        check_launches(label, got, predicted(plan, batches), required)
        return plan, res, wall, got, peak

    def syncs(plan) -> int:
        return sum(x.stats["syncs"] for x in join_execs(plan))

    def chain_counts(plan) -> tuple:
        chains = of_type(plan, Chain)
        return (sum(x.stats["chained_batches"] for x in chains),
                sum(x.stats["degraded_batches"] for x in chains))

    # -- ladder-fusion -----------------------------------------------------
    ladder = {"q3": tpch.q3, "q5": tpch.q5, "q5-sparse": tpch.q5_sparse,
              "q18": tpch.q18}
    for q, frame in ladder.items():
        label = f"join-fusion-sf1/ladder-fusion/{q}"
        sessions = {"on": spark, "off": off}
        walls, sy, shape, res, plans = {"on": [], "off": []}, {}, {}, {}, {}
        for route in ("on", "off", "off", "on"):
            plan, out, wall, got, peak = counted(
                f"{label} ({route})",
                lambda r=route: frame(tpch.load(sessions[r], paths)),
                lambda r_, _l: check(q, r_),
                ("bitunpack128",) + (("hash_join_probe",)
                                     if q == "q5-sparse" else ()))
            walls[route].append(wall)
            sy[route], shape[route] = syncs(plan), fusion_shape(plan)
            res[route], plans[route] = out, plan
            if route == "on":
                counts_by_path[label] = got
                peak_by_path[label] = peak
        # both routes held to the oracle (counted); the rows bit for bit,
        # or else within the oracle's tolerance
        exact = res["on"].equals(res["off"])
        if res["on"].num_rows != res["off"].num_rows:
            raise AssertionError(f"{label}: the routes give other row counts")
        if of_type(plans["off"], Chain):
            raise AssertionError(f"{label}: a chain with fusion off")
        dev_ms = {r: join_device_ms(lambda r=r: frame(
            tpch.load(sessions[r], paths)).collect()) for r in ("on", "off")}
        cb, db = chain_counts(plans["on"])
        print(f"{label} on {card}: on: {shape['on']}; joins' host syncs "
              f"{sy['on']}, joins' device {dev_ms['on'][0]:.4f} ms of "
              f"{dev_ms['on'][1]:.4f} ms device"
              f"{' SHORT ' + dev_ms['on'][3] if dev_ms['on'][3] else ''}, "
              f"walls {[round(x, 4) for x in walls['on']]} s, chained "
              f"batches {cb}, degraded {db}; off: {shape['off']}; joins' "
              f"host syncs {sy['off']}, joins' device "
              f"{dev_ms['off'][0]:.4f} ms of {dev_ms['off'][1]:.4f} ms "
              f"device{' SHORT ' + dev_ms['off'][3] if dev_ms['off'][3] else ''}"
              f", walls {[round(x, 4) for x in walls['off']]} s; rows in "
              f"{rows_in(plans['on'])}, out {res['on'].num_rows}, "
              + ("bit for bit the same" if exact else
                 "the same within the oracle's tolerance")
              + f"; idle share on "
              f"{1 - dev_ms['on'][1] / 1e3 / dev_ms['on'][2]:.4f}, off "
              f"{1 - dev_ms['off'][1] / 1e3 / dev_ms['off'][2]:.4f}; peak "
              f"device memory {peak_by_path[label]} B; launches "
              f"{ {k: v for k, v in counts_by_path[label].items() if v} }")

    # -- chain-3hop, chain-dup-build, q1-encoded, scan-pushed-filter -------
    def q1_frame(s):
        return tpch.q1(tpch.load(s, {"lineitem": li_dir}))

    def q1_check(res, label):
        check_q1(res.to_pylist(), exp_q1)

    paths_ = {
        "join-fusion-sf1/chain-3hop": (lambda: three_hop(spark), check_three,
                                       ("bitunpack128",)),
        "join-fusion-sf1/chain-dup-build": (lambda: dup_build(spark),
                                            check_dup, ("bitunpack128",)),
        "join-fusion-sf1/q1-encoded": (lambda: q1_frame(spark), q1_check,
                                       ("bitunpack128", "onehot_sum_f32")),
        "join-fusion-sf1/q1-dense": (lambda: q1_frame(spark), q1_check,
                                     ("bitunpack128", "onehot_sum_f32")),
        "join-fusion-sf1/scan-pushed-filter": (lambda: pushed(spark),
                                               check_q6, ()),
    }
    results = {}
    for label, (make, chk, required) in paths_.items():
        scope = (decoded_at_scan() if label.endswith("q1-dense")
                 else contextlib.nullcontext())
        with scope:
            EN.reset_counts()
            plan, res, first_s, got, peak = counted(label, make, chk, required)
            vectors = dict(EN.counts)
            results[label] = res
            counts_by_path[label] = got
            peak_by_path[label] = peak
            ts = [first_s]
            for _ in range(reps):
                t0 = time.perf_counter()
                r = make().collect()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
                chk(r, label)
            jd = join_device_ms(lambda: make().collect())
            cb, db = chain_counts(plan)
            extra = ""
            if label.endswith("chain-3hop") and (cb == 0 or db):
                raise AssertionError(f"{label}: {cb} chained and {db} degraded "
                                     f"batches (want every batch chained)")
            if label.endswith("chain-dup-build") and (db == 0 or cb):
                raise AssertionError(f"{label}: {cb} chained and {db} degraded "
                                     f"batches (want every batch degraded)")
            if "q1-" in label:
                # the chunk decodes are the census's either way (counted: 48
                # a q1 scan at SF1), each of an encoded vector the scan
                # yielded, decoded once: at its first read (q1's aggregate
                # reads the scan) or as the scan yields it
                made = sum(ex.stats["encoded_vectors"]
                           for _d, ex in scans(plan))
                chunks = predicted(plan, [])["bitunpack128"]
                if made != chunks or vectors != {"made": chunks,
                                                 "decoded": chunks}:
                    raise AssertionError(
                        f"{label}: the scan yielded {made} encoded vectors, "
                        f"{vectors} made and decoded, {chunks} dictionary "
                        f"chunks")
                extra = (f"; encoded vectors the scan yielded {made}, "
                         f"decoded {vectors['decoded']} "
                         + ("as the scan yielded them"
                            if label.endswith("dense")
                            else "at their first read"))
            if label.endswith("scan-pushed-filter"):
                (ex,) = [ex for _d, ex in scans(plan)]
                st = ex.stats
                if ((st["residual_rows_in"], st["residual_rows_out"]) != q6_rows
                        or st["device_batches"] or got["bitunpack128"]):
                    raise AssertionError(f"{label}: scan {st}, want the arrow "
                                         f"reader and residual rows {q6_rows}")
                extra = (f"; arrow reader {st['strategy']} {st['arrow_batches']} "
                         f"batches, the date conjuncts in arrow "
                         f"({st['residual_rows_in']} rows), the double residual "
                         f"on the device ({st['residual_rows_out']} rows kept, "
                         f"{st['syncs']} host syncs)")
            print(f"{label} on {card}: median {statistics.median(ts):.4f} s, "
                  f"min {min(ts):.4f} s, max {max(ts):.4f} s over {len(ts)} "
                  f"runs: {[round(x, 4) for x in ts]}; equal to the oracle; "
                  f"rows in {rows_in(plan)}, out {res.num_rows}; "
                  f"{fusion_shape(plan)}; joins' host syncs {syncs(plan)}, "
                  f"joins' device {jd[0]:.4f} ms of {jd[1]:.4f} ms device"
                  f"{' SHORT ' + jd[3] if jd[3] else ''}; device idle share "
                  f"{1 - jd[1] / 1e3 / jd[2]:.4f} (traced wall {jd[2]:.4f} s); "
                  f"chained batches {cb}, degraded {db}; peak device memory "
                  f"{peak} B; launches { {k: v for k, v in got.items() if v} }"
                  + extra)
    if not results["join-fusion-sf1/q1-encoded"].equals(
            results["join-fusion-sf1/q1-dense"]):
        raise AssertionError("q1-encoded: the decode at first read gives "
                             "other rows than every chunk decoded at the "
                             "scan")
    print("join-fusion-sf1/q1-encoded: bit for bit the rows of every chunk "
          "decoded at the scan")
    shutil.rmtree(root, ignore_errors=True)
    print(f"join-fusion-sf1: {time.perf_counter() - t_phase:.1f} s "
          f"({n_li} lineitem rows)")


#: bench.py:172-175's session confs (the pipeline set per run)
BENCH_CONF = {"spark.rapids.tpu.sql.format.parquet.reader.type": "COALESCING",
              "spark.rapids.tpu.sql.stageFusion.enabled": True}
#: two split-OOMs at the exchange's map side and one OOM at the
#: aggregate's merge; with the group-by chain on (the default) one more at
#: the chain's step, since at SF1 the chain takes every merge of q5's and
#: q1's aggregates (the merge site is reached only by a batch the chain
#: leaves, or with the chain off)
MERGE_FAULTS = "splitoom:exchange.map:2,oom:agg.merge:1"
RUNTIME_FAULTS = MERGE_FAULTS + ",oom:agg.chain:1"
#: turns of q1-repartition unspilled and under the spill budget: the whole
#: card's peak moves with the map threads' timing from run to run
SPILL_TURNS = 3
RANGE_PARTS = 8


def reorder_distance(label, got, clean, terms) -> tuple:
    """Two runs whose float sums may add their terms in other orders (an
    atomic ``index_add_`` on the card, a retry's split): every other column
    equal, and each float within ``2 n u |clean|`` of the clean run's, ``n``
    the row's summed terms and ``u`` = 2^-53 (a sum of ``n`` terms of one
    sign, added in any order, is off by at most ``(n - 1) u`` of the exact
    sum; a mean by one rounding more). Returns the largest distance and
    the largest bound, in units in the last place of the clean value."""
    import numpy as np
    import pyarrow as pa
    if got.num_rows != clean.num_rows or got.schema != clean.schema:
        raise AssertionError(f"{label}: rows or schema differ from the "
                             "clean run")
    n = np.asarray(terms, dtype=np.float64)
    worst = bound = 0.0
    for name in clean.column_names:
        a, b = got.column(name), clean.column(name)
        if not pa.types.is_floating(b.type):
            if not a.equals(b):
                raise AssertionError(f"{label}: {name} differs from the "
                                     "clean run")
            continue
        x = a.to_numpy(zero_copy_only=False).astype(np.float64)
        y = b.to_numpy(zero_copy_only=False).astype(np.float64)
        ulp = np.spacing(np.abs(y))
        tol = 2.0 * n * 2.0 ** -53 * np.abs(y)
        if (np.abs(x - y) > tol).any():
            raise AssertionError(f"{label}: {name} {x.tolist()} is beyond "
                                 f"the reordering bound of {y.tolist()}")
        worst = max(worst, float((np.abs(x - y) / ulp).max()))
        bound = max(bound, float((tol / ulp).max()))
    return worst, bound


def first_chunk_decodes(files, column: str) -> int:
    """Chunk decodes of the range exchange's sample pass: the first batch
    (row group 0) of each file's partition is read, and its key column's
    chunk decoded once if the decode takes it (a dictionary chunk)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io import parquet_native as PN
    n = 0
    for f in files:
        md = pq.ParquetFile(f).metadata
        ci = [md.schema.column(i).path
              for i in range(md.num_columns)].index(column)
        try:
            PN.read_chunk_pages(f, 0, ci, md=md)
        except NotImplementedError:
            continue
        n += 1
    return n


def scan_decodes(plan, scan_chunks, runs: int = 1) -> int:
    """The chunk decodes the scans under ``plan`` launch: each scan's
    dictionary chunks (the pruned census), once for every time the map
    stage above it ran (a recompute runs it again)."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    if isinstance(plan, FileSourceScanExec):
        if plan.node.pushed_filter is not None:
            return 0
        (d, _), = scans(plan)
        return runs * scan_chunks(d, plan.node._data_columns())[0]
    if isinstance(plan, ShuffleExchangeExec):
        runs *= max(plan.map_runs, 1)
    return sum(scan_decodes(c, scan_chunks, runs) for c in plan.children)


def runtime_prediction(plan, count_batches, scan_chunks,
                       sampled: int = 0) -> dict:
    """Every kernel's launches on one run of ``plan``: the chunk decodes of
    its scans (and of a range exchange's sample), one count launch an
    aggregate batch with count-like requests, one partition step (radix) a
    partitioned batch or split piece, one string hash a string key of each,
    and the hash joins' builds and probes."""
    js = joins(plan)
    hashed = [j for j in js if j.stats["probe_mode"] == "hash"]
    radix, mm, _exs = exchange_prediction([plan])
    return {"bitunpack128": scan_decodes(plan, scan_chunks) + sampled,
            "onehot_sum_f32": len(count_batches), "radix_ranks": radix,
            "murmur3_words": mm,
            "hash_join_build": len(hashed) + sum(j.stats["hash_refused"]
                                                 for j in js),
            "hash_join_probe": sum(j.stats["stream_batches"]
                                   for j in hashed)}


def runtime_paths(dev, name, card, paths, li_files, root, check_query,
                  counting, agg_batches, scan_chunks, counts_by_path: dict,
                  peak_by_path: dict, threads: dict,
                  q5_terms: dict) -> None:
    """runtime-sf1: the memory runtime, the pipelined stages and the
    exchange's remainder, on the SF1 files; each path once (its counted
    run), then one traced run for its device idle share.

    - ladder-bench-conf: q1/q3/q5/q18 through ``TorchSession`` with
      ``bench.py``'s own confs (COALESCING, stage fusion, and the pipeline
      on and off in turns: on, off, off, on), loaded as ``bench.py`` loads
      them; q3 and q18 bit for bit across the routes, q1 and q5 within the
      oracle's tolerance, all four held to the oracle;
    - q1-repartition-spill: q1-repartition with ``memory.hbm.limitBytes``
      half of its shuffle blocks' bytes (``partition_sizes`` of an unspilled
      run) and ``host.spillStorageSize`` a quarter, the disk tier through
      the direct store, in ``SPILL_TURNS`` turns with the unspilled run;
      the buffers and bytes that moved device → host, host → disk and back,
      ``direct_active``, the catalog's registered device high-water (held
      to the budget spilled, to at least the block bytes unspilled), the
      whole card's peaks of every turn beside it, and the rows bit for bit
      the unspilled run's;
    - q1-serialized: q1-files with ``shuffle.enabled=false``, bit for bit
      q1-files;
    - q1-retry: q1-files and q5 under ``RUNTIME_FAULTS``, and q5 with the
      group-by chain off under ``MERGE_FAULTS`` (its merge site fires),
      bit for bit their clean runs where two clean runs are (q5's one
      float sum is an atomic ``index_add_`` on the card; then its keys
      exactly and its sums within ``reorder_distance``'s bound), with
      ``faults.injected_log()``;
    - q1-recompute: q1-repartition-spill with the spill checksum on and one
      spill payload corrupted after its CRC: the exchange recomputes its
      map outputs, bit for bit;
    - range-sort: ``l_extendedprice`` of lineitem (one partition per file)
      through a range exchange of ``RANGE_PARTS`` partitions, then a local
      sort; read in partition order it equals numpy's sort.

    Each path's launches are held to ``runtime_prediction``, and
    murmur3_words, the radix partition step, the chunk decode and the
    count kernel must each launch somewhere in the phase."""
    import numpy as np
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    from spark_rapids_tpu_torch.plan import nodes as NN
    from spark_rapids_tpu_torch.runtime import faults as FI
    from spark_rapids_tpu_torch.runtime import memory as MEM
    from spark_rapids_tpu_torch.runtime import retry as RT
    from spark_rapids_tpu_torch.session import DataFrame, TorchSession
    import spark_rapids_tpu_torch.functions as F
    t_phase = time.perf_counter()
    li_dir = paths["lineitem"]
    phase_counts = {}
    walls = {}
    #: each counted run's peak above what was allocated when it started
    own_peaks = {}

    def counted(label, make, chk, sampled=0):
        """One counted run: (plan, result, wall s, launches, peak B)."""
        with counting():
            before = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            plan = make().physical_plan()
            res = plan.execute_collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(CK.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            batches = [k for k in agg_batches if k]
        chk(res)
        want = runtime_prediction(plan, batches, scan_chunks, sampled)
        check_launches(label, got, want, ())
        counts_by_path[label] = got
        peak_by_path[label] = peak
        own_peaks[label] = peak - before
        for k, v in got.items():
            phase_counts[k] = phase_counts.get(k, 0) + v
        walls[label] = wall
        return plan, res, wall, got, peak

    def line(label, plan, wall, got, peak, extra="", run=None):
        idle = sql_idle_share(run) if run is not None else "not traced"
        print(f"{label} on {card}: wall {wall:.4f} s, {idle}, peak device "
              f"memory {peak} B; launches "
              f"{ {k: v for k, v in got.items() if v} } as predicted"
              f"{'; ' + extra if extra else ''}")

    def bit_for_bit(label, a, b, what):
        if not a.equals(b):
            raise AssertionError(f"{label}: rows differ from {what}")

    # -- ladder-bench-conf ---------------------------------------------------
    sessions = {pipe: TorchSession({**threads, **BENCH_CONF,
                                    "spark.rapids.tpu.pipeline.enabled":
                                    pipe}) for pipe in (True, False)}
    for q in ("q1", "q3", "q5", "q18"):
        label = f"runtime-sf1/ladder-bench-conf/{q}"
        frame = tpch.QUERIES[q]
        res, tw = {}, {True: [], False: []}
        for pipe in (True, False, False, True):
            s = sessions[pipe]
            plan, out, wall, got, peak = counted(
                f"{label} (pipeline {'on' if pipe else 'off'})",
                lambda s=s: frame(tpch.load(s, paths, files_per_partition=4)),
                lambda r, q=q: check_query(q, r))
            tw[pipe].append(wall)
            if pipe in res and q in ("q3", "q18"):
                bit_for_bit(label, out, res[pipe], "the same route's")
            res[pipe] = out
        if q in ("q3", "q18"):
            bit_for_bit(label, res[True], res[False], "the pipeline off")
        s = sessions[True]
        line(label + " (pipeline on)", plan, min(tw[True]), got, peak,
             f"walls pipeline on {[round(x, 4) for x in tw[True]]} s, off "
             f"{[round(x, 4) for x in tw[False]]} s in this call; "
             + ("bit for bit across the routes" if q in ("q3", "q18")
                else "both routes within the oracle's tolerance"),
             run=lambda s=s, frame=frame: frame(tpch.load(
                 s, paths, files_per_partition=4)).collect())

    # -- q1-repartition, unspilled, then under a budget of half its blocks,
    # in turns ----------------------------------------------------------------
    def q1_rep(s):
        return tpch.q1({"lineitem": s.read_parquet(li_dir).repartition(
            8, "l_returnflag", "l_linestatus")})

    def q1_files(s):
        return tpch.q1({"lineitem": s.read_parquet(li_files)})

    def fresh(conf):
        """A session and the fresh catalog it set up under its budget."""
        s = TorchSession(conf)
        return s, MEM.DeviceManager.get().catalog

    rep, spl = "runtime-sf1/q1-repartition", "runtime-sf1/q1-repartition-spill"
    turns = {"unspilled": [], "spilled": []}
    for turn in range(SPILL_TURNS):
        base, cat = fresh(threads)
        u = f"{rep} (unspilled{'' if turn == 0 else f', turn {turn + 1}'})"
        plan, res, wall, got, peak = counted(
            u, lambda: q1_rep(base), lambda r: check_query("q1", r))
        if turn == 0:
            clean_rep, w_rep, peak_rep = res, wall, peak
            rep_ex = [e for e in exchanges(plan)
                      if e.child.num_partitions == 1][0]
            block_bytes = sum(rep_ex.partition_sizes)
            budget = block_bytes // 2
            spill_dir = os.path.join(root, "spill")
            spill_conf = {
                **threads,
                "spark.rapids.tpu.memory.hbm.limitBytes": str(budget),
                "spark.rapids.tpu.memory.host.spillStorageSize":
                str(block_bytes // 4),
                "spark.rapids.tpu.memory.spill.dirs": spill_dir,
                "spark.rapids.tpu.memory.direct.storage.spill.enabled":
                "true"}
        # unspilled, the catalog holds every block on the device until the
        # last reduce partition is read
        wm = cat.spill_counts()["device_watermark_bytes"]
        if wm < block_bytes:
            raise AssertionError(f"{u} registered {wm} B on the device, "
                                 f"below its blocks' {block_bytes} B")
        turns["unspilled"].append((peak, own_peaks[u], wm))
        spilled, cat = fresh(spill_conf)
        s_ = spl if turn == 0 else f"{spl} (turn {turn + 1})"
        plan, res, wall, got, peak = counted(
            s_, lambda: q1_rep(spilled), lambda r: check_query("q1", r))
        bit_for_bit(s_, res, clean_rep, "the unspilled run")
        sc = cat.spill_counts()
        if not (sc["to_host_buffers"] and sc["to_disk_buffers"]):
            raise AssertionError(f"{s_} spilled {sc}: want buffers to the "
                                 "host and to disk")
        # the deterministic peak: what the catalog held on the device
        if sc["device_watermark_bytes"] > budget:
            raise AssertionError(
                f"{s_} registered {sc['device_watermark_bytes']} B on the "
                f"device, over its {budget} B budget")
        if cat.num_buffers:
            raise AssertionError(f"{s_} left {cat.num_buffers} buffers "
                                 "registered")
        turns["spilled"].append((peak, own_peaks[s_],
                                 sc["device_watermark_bytes"]))
        if turn == 0:
            first = (plan, wall, got, peak, sc, cat.direct_active)
        shutil.rmtree(spill_dir, ignore_errors=True)
    plan, wall, got, peak, sc, direct = first

    def peaks(kind):
        whole, own, wms = zip(*turns[kind])
        return (f"whole-card peaks {list(whole)} B (above the run's start "
                f"{list(own)} B), registered device high-water "
                f"{list(wms)} B")
    line(spl, plan, wall, got, peak,
         f"unspilled q1-repartition: wall {w_rep:.4f} s, peak {peak_rep} B, "
         f"shuffle blocks {block_bytes} B; budget {budget} B "
         f"device, {block_bytes // 4} B host; moved device->host "
         f"{sc['to_host_buffers']} buffers / {sc['to_host_bytes']} B, "
         f"host->disk {sc['to_disk_buffers']} buffers / "
         f"{sc['to_disk_bytes']} B, back from host {sc['from_host_buffers']}"
         f" and from disk {sc['from_disk_buffers']} buffers; direct_active "
         f"{direct}; {SPILL_TURNS} turns in this call, unspilled: "
         f"{peaks('unspilled')}; spilled: {peaks('spilled')}; rows bit for "
         f"bit the unspilled run",
         run=lambda: q1_rep(TorchSession(spill_conf)).collect())
    shutil.rmtree(spill_dir, ignore_errors=True)
    base, cat = fresh(threads)

    # -- q1-serialized -------------------------------------------------------
    plan, clean_files, w_files, got, peak_files = counted(
        "runtime-sf1/q1-files", lambda: q1_files(base),
        lambda r: check_query("q1", r))
    ser = TorchSession({**threads, "spark.rapids.tpu.shuffle.enabled":
                        "false"})
    plan, res, wall, got, peak = counted(
        "runtime-sf1/q1-serialized", lambda: q1_files(ser),
        lambda r: check_query("q1", r))
    bit_for_bit("q1-serialized", res, clean_files, "q1-files")
    line("runtime-sf1/q1-serialized", plan, wall, got, peak,
         f"q1-files (device blocks): wall {w_files:.4f} s, peak "
         f"{peak_files} B; frames {sum(exchanges(plan)[0].partition_sizes)} B"
         f"; rows bit for bit q1-files", run=lambda: q1_files(ser).collect())

    # -- q1-retry: q1-files and q5 under the fault spec ----------------------
    def q5(s):
        return tpch.q5(tpch.load(s, paths))

    plan, clean_q5, w_q5, _g, _p = counted(
        "runtime-sf1/q5 (clean)", lambda: q5(base),
        lambda r: check_query("q5", r))
    unchained = {**threads, "spark.rapids.tpu.sql.stageFusion.groupBy."
                 "chain.enabled": "false"}
    q5u = "runtime-sf1/q1-retry/q5-unchained"
    plan, clean_q5u, w_q5u, _g, _p = counted(
        q5u + " (clean)", lambda: q5(TorchSession(unchained)),
        lambda r: check_query("q5", r))
    for label, make, clean, w_clean, conf, spec in (
            ("runtime-sf1/q1-retry/q1-files", q1_files, clean_files,
             w_files, threads, RUNTIME_FAULTS),
            ("runtime-sf1/q1-retry/q5", q5, clean_q5, w_q5, threads,
             RUNTIME_FAULTS),
            # the chain off, so that the aggregate's merge site fires
            (q5u, q5, clean_q5u, w_q5u, unchained, MERGE_FAULTS)):
        q = "q1" if "q1-files" in label else "q5"
        # a float sum the card adds with atomics (q5's one revenue sum is an
        # index_add_) need not come out bit for bit in two clean runs: then
        # the run under the faults is held to the clean run's keys exactly
        # and to its sums within the reordering bound
        again = make(TorchSession(conf)).collect()
        exact = again.equals(clean)
        chaos = TorchSession({**conf, "spark.rapids.tpu.test.faults": spec,
                              "spark.rapids.tpu.memory.retry."
                              "splitFloorBytes": "1b"})   # arms it afresh
        RT.reset_counts()
        plan, res, wall, got, peak = counted(
            label, lambda: make(chaos), lambda r, q=q: check_query(q, r))
        log = FI.injected_log()
        if exact:
            bit_for_bit(label, res, clean, "the clean run")
            how = "rows bit for bit the clean run"
        else:
            terms = (clean.column("count_order").to_pylist() if q == "q1"
                     else [q5_terms[n] for n in
                           clean.column("n_name").to_pylist()])
            noise, _b = reorder_distance(label + " (clean)", again, clean,
                                         terms)
            worst, bound = reorder_distance(label, res, clean, terms)
            how = (f"two clean runs differ in their float sums (atomic adds "
                   f"on the card), by up to {noise:.0f} ulp; every other "
                   f"column bit for bit the clean run, the sums up to "
                   f"{worst:.0f} ulp from it, within the reordering bound "
                   f"of {bound:.0f} ulp")
        # the exchange's two split-OOMs on q1-files; on q5 an OOM in the
        # aggregate's chained step or its merge (q1-files' partial
        # aggregates may have a single batch each, which neither chains
        # nor merges); with the chain off, in the merge
        want_maps = 2 if q == "q1" else 0
        agg = [e for e in log if e[1] in ("agg.chain", "agg.merge")]
        if (log.count(("splitoom", "exchange.map")) != want_maps
                or (q == "q5" and not agg)
                or (label == q5u and ("oom", "agg.merge") not in log)
                or len(log) != want_maps + len(agg)):
            raise AssertionError(f"{label}: injected {log}")
        FI.reset()
        line(label, plan, wall, got, peak,
             f"spec {spec}; clean run wall {w_clean:.4f} s; injected {log}; "
             f"retry counts {dict(RT.counts)}; {how}",
             run=lambda make=make, conf=conf: make(
                 TorchSession(conf)).collect())

    # -- q1-recompute --------------------------------------------------------
    shutil.rmtree(spill_dir, ignore_errors=True)
    # one map thread: a reader racing the recompute could have emitted rows
    # of the lost generation, which the ladder cannot take back
    recomp = TorchSession({**spill_conf,
                           "spark.rapids.tpu.sql.localScheduler.numThreads":
                           "1",
                           "spark.rapids.tpu.memory.spill.checksum.enabled":
                           "true",
                           "spark.rapids.tpu.test.faults":
                           "corrupt:spill.write:1"})
    cat = MEM.DeviceManager.get().catalog
    plan, res, wall, got, peak = counted(
        "runtime-sf1/q1-recompute", lambda: q1_rep(recomp),
        lambda r: check_query("q1", r))
    log = FI.injected_log()
    FI.reset()
    bit_for_bit("q1-recompute", res, clean_rep, "the unspilled run")
    recomputes = sum(e.recomputes for e in exchanges(plan))
    if log != [("corrupt", "spill.write")] or recomputes < 1:
        raise AssertionError(f"q1-recompute: injected {log}, recomputes "
                             f"{recomputes}: want one corruption caught")
    counts_ = cat.spill_counts()
    shutil.rmtree(spill_dir, ignore_errors=True)
    again = TorchSession(recomp.conf)      # arms the corruption afresh
    w_spill = walls[spl]
    line("runtime-sf1/q1-recompute", plan, wall, got, peak,
         f"q1-repartition-spill's wall {w_spill:.4f} s; injected {log}; "
         f"fetch failures recomputed "
         f"{recomputes}, map stage runs {[e.map_runs for e in exchanges(plan)]}"
         f"; spill {counts_}; rows bit for bit the unspilled run",
         run=lambda: q1_rep(again).collect())
    FI.reset()

    # -- range-sort ----------------------------------------------------------
    prices = np.sort(pq.read_table(li_dir, columns=["l_extendedprice"])
                     .column(0).to_numpy())

    def ranged(s):
        df = s.read_parquet(li_files).select("l_extendedprice")
        ex = DataFrame(NN.ExchangeNode(df._plan, "range", RANGE_PARTS,
                                       keys=[F.col("l_extendedprice")]), s)
        return ex.sort_within_partitions("l_extendedprice")

    def check_sorted(r):
        got_ = r.column("l_extendedprice").to_numpy()
        if not np.array_equal(got_, prices):
            raise AssertionError("range-sort: not numpy's sort")

    sampled = first_chunk_decodes(li_files, "l_extendedprice")
    plan, res, wall, got, peak = counted(
        "runtime-sf1/range-sort", lambda: ranged(base), check_sorted,
        sampled)
    (rex,) = exchanges(plan)
    sizes = [int(x) for x in rex.partition_sizes]
    t0 = time.perf_counter()
    whole = base.read_parquet(li_files).select("l_extendedprice").sort(
        "l_extendedprice").collect()
    torch.cuda.synchronize()
    w_global = time.perf_counter() - t0
    check_sorted(whole)
    line("runtime-sf1/range-sort", plan, wall, got, peak,
         f"{RANGE_PARTS} partitions of {sizes} B; sample pass decoded "
         f"{sampled} chunks; a global sort of the same column: wall "
         f"{w_global:.4f} s; equal to numpy's sort",
         run=lambda: ranged(base).collect())

    for k in ("murmur3_words", "radix_ranks", "bitunpack128",
              "onehot_sum_f32"):
        if not phase_counts.get(k):
            raise AssertionError(f"runtime-sf1: {k} never launched")
    shutil.rmtree(root, ignore_errors=True)
    MEM.DeviceManager.initialize(base.conf, dev)
    print(f"runtime-sf1 on {card}: {time.perf_counter() - t_phase:.1f} s; "
          f"launches over the phase {phase_counts}")


def decode_call_bound_ms(words, pages, defs, dictionary, n_rows, capacity,
                         want, default) -> float:
    """Least time for one recorded chunk decode call: read its words, its
    page table, its def levels and its dictionary once, write the values
    and the validity bytes once, over the card's memory rate."""
    size = torch.empty((), dtype=want).element_size()
    read = (words.numel() * 4
            + (pages.numel() * 4 if isinstance(pages, torch.Tensor) else 32)
            + (defs.numel() if defs is not None else 0)
            + dictionary.numel() * size)
    return (read + (size + 1) * capacity) / HBM_BYTES_PER_S * 1e3


def sweep_kernel_times(calls, name, bincount_calls, bincount) -> dict:
    """The three kernels on sweep-sf1's own inputs (the calls one more run
    of its statements handed them): each held against its plain version,
    then timed beside it, its bound and, where one exists, the one PyTorch
    call computing the same function. The chunk decode per value width:
    1 (tinyint), 2 (smallint) and 4-float (float)."""
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK

    def each(fn, cs):
        def run():
            for a in cs:
                fn(*a)
        return run
    out = {}
    widths = {}
    for dt, key in ((torch.int8, "1"), (torch.int16, "2"),
                    (torch.float32, "4-float")):
        cs = [a for a in calls["chunk_decode"] if a[6] == dt]
        if not cs:
            raise AssertionError(f"sweep-sf1: no chunk decode at width {key}")
        for a in cs:
            got, want = CK.chunk_decode(*a), CK.chunk_decode_plain(*a)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"sweep-sf1: chunk_decode != plain at "
                                     f"width {key}")
        widths[key] = {
            "calls": len(cs), "max_abs_err": 0,
            "ms": device_ms(each(CK.chunk_decode, cs), 3, KERNEL_NAME),
            "plain_ms": device_ms(each(CK.chunk_decode_plain, cs), 2),
            "bound_ms": sum(decode_call_bound_ms(*a) for a in cs),
            "bound_by": "bytes", "library_ms": None}
        print(f"sweep-sf1 chunk_decode width {key} on {name}: {len(cs)} "
              f"launches (one a chunk of the column); kernel "
              f"{widths[key]['ms']:.4f} ms, plain "
              f"{widths[key]['plain_ms']:.4f} ms, bound "
              f"{widths[key]['bound_ms']:.6f} ms (bytes); equal to the plain "
              f"version")
    out["chunk_decode"] = {"err": 0, "value_widths": widths}
    mm = calls["murmur3_words"]
    err = max(murmur3_check(*a) for a in mm)
    b, o = (sum(x) for x in zip(*(murmur3_bound_ms(w, ln)
                                   for w, ln, _s in mm)))
    out["murmur3_words"] = {
        "err": err, "calls": len(mm),
        "shapes": sorted({tuple(w.shape) for w, _l, _s in mm}),
        "ms": device_ms(each(CK.murmur3_words, mm), 5,
                        "murmur3_words_kernel"),
        "plain_ms": device_ms(each(CK.murmur3_words_plain, mm), 3),
        "bound_ms": max(b, o), "bound_by": "bytes" if b >= o
        else "operations", "library_ms": None}
    oh = calls["onehot_sums_f32"]
    err = max(counts_check(*a) for a in oh)
    b, o = (sum(x) for x in zip(*(counts_bound_ms(*a) for a in oh)))
    out["onehot_sums_f32"] = {
        "err": err, "calls": len(oh),
        "shapes": sorted({(c.numel(), dom, len(r)) for c, r, dom in oh}),
        "ms": device_ms(each(CK.onehot_sums_f32, oh), 5,
                        "onehot_sums_kernel"),
        "plain_ms": device_ms(each(CK.onehot_sums_f32_plain, oh), 3),
        "bound_ms": max(b, o), "bound_by": "bytes" if b >= o
        else "operations",
        "library_ms": device_ms(each(bincount, bincount_calls(oh)), 5)}
    for k in ("murmur3_words", "onehot_sums_f32"):
        e = out[k]
        print(f"sweep-sf1 {k} on {name}: {e['calls']} launches at "
              f"{e['shapes']}; kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.6f} ms "
              f"({e['bound_by']}), library "
              f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)}"
              f" ms; equal to the plain version")
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the q1 run (default 1.0)")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed runs of each path after the first (default "
                         "1 since deep-nested-sf1, 2 before; at most "
                         "Q1_REPS for the q1 paths)")
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
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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
    # the column's first read launches its decode
    fused = routes(lambda chunk, cap: PN.chunk_to_device(chunk, None, cap,
                                                         dev).data)
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
    q5_terms = tpch.np_q5_terms(tb)
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
        if label in FUSION_SHAPES:
            if fusion_signature(plan) != FUSION_SHAPES[label]:
                raise AssertionError(
                    f"{label}: chains and hoists {fusion_signature(plan)}, "
                    f"want {FUSION_SHAPES[label]}\n{plan}")
            print(f"{label} chains and hoists: {fusion_shape(plan)}")
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
            # host syncs: a group count a call, one a probe, one a
            # compaction of prefiltered rows on the segment path, one a
            # chained step
            print(aggregate_line(label, a))
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

    # the keys the unchained route hands hash_join_probe in one q5-sparse
    # run: the compacted output of the hop before it (the chain hands the
    # kernel every slot of its stream batch, dead rows included)
    unchained_keys = []
    probe = launchers["hash_join_probe"]

    def count_keys(tk, tr, stream, nb):
        unchained_keys.append((stream.numel(), nb))
        return probe(tk, tr, stream, nb)
    CK.hash_join_probe = count_keys
    try:
        check("q5-sparse", tpch.q5_sparse(tpch.load(TorchSession(
            {**threads, "spark.rapids.tpu.sql.stageFusion.enabled":
             "false"}), paths)).collect())
    finally:
        CK.hash_join_probe = probe

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
    hj_live_bound_ms = sum(probe_bound_ms(n, nb) for n, nb in unchained_keys)
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
          f"{hj_bound_ms:.6f} ms (bytes) over the slots the chain hands it "
          f"(the kernel at {hj_bound_ms / hj_ms:.1%} of it), "
          f"{hj_live_bound_ms:.6f} ms over the "
          f"{sum(n for n, _nb in unchained_keys)} keys that the unchained "
          f"route hands it in {len(unchained_keys)} launches, the compacted "
          f"rows of the hop before (the kernel at "
          f"{hj_live_bound_ms / hj_ms:.1%} of it); no single PyTorch call "
          f"probes a hash table")

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
    from spark_rapids_tpu_torch.exec.basic import UnionExec
    from spark_rapids_tpu_torch.exec.expand import ExpandExec
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
    sql_twins = {q for q in tpcds.SQL_PORTED
                 if sql_oracles[q][0] is tpcds.NP_QUERIES.get(q)}
    exp_sql = {q: (exp_ds[q] if q in sql_twins
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
    def counted_ds_run(label, make_df, named, kernels, check):
        """The counted run of one TPC-DS path (a DataFrame query or an SQL
        text): the launch and route counts reset just before ``make_df``
        builds the frame (an SQL text's eager subqueries run there, while
        it is lowered) and read after its plan ran, the result held by
        ``check``; every kernel of ``kernels`` launched, and the exchange's
        kernels on a path with a hash exchange (the radix partition step
        once per partitioned batch, ``murmur3_words`` once per string key
        of each), the count kernel once per aggregate batch with
        count-like requests; every scan (those of the eager subqueries
        too) pruned to names the query's text quotes (``named``), its
        dictionary chunks native and one chunk decode each, every decimal
        chunk refused by the decode and read through arrow, none parsed in
        Python. Prints the scans, aggregates, expands, unions, window
        execs, exchanges and nested-loop joins; returns the plan and the
        lines the path's timing line repeats (each nested-loop and full
        outer join's stats, each exchange's keys, partitions and
        launches)."""
        torch.cuda.reset_peak_memory_stats(dev)
        agg_batches.clear()
        G.resolve_dense_group_sums = counting_resolve
        CK.reset_launches()
        PN.reset_routes()
        t0 = time.perf_counter()
        try:
            df = make_df()
            plan = df.physical_plan()
            res = plan.execute_collect()
        finally:
            G.resolve_dense_group_sums = resolve
        first_s = time.perf_counter() - t0
        plans = [plan] + list(df.subquery_plans)
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
        for d, ex in [se for p in plans for se in scans(p)]:
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
            print(aggregate_line(label, a))
        for w in of_type(plan, WindowExec):
            print(f"{label} window exec: {w.stats['input_rows']} rows in "
                  f"{w.stats['partitions']} partitions, "
                  f"{w.stats['output_rows']} rows out")
        for x in of_type(plan, ExpandExec):
            print(f"{label} expand exec: {len(x.projections)} projections, "
                  f"{x.stats['input_rows']} rows in, "
                  f"{x.stats['output_rows']} rows out")
        for u in of_type(plan, UnionExec):
            print(f"{label} union exec: {len(u.children)} children, "
                  f"{u.num_partitions} partitions")
        if df.subquery_plans:
            print(f"{label}: {len(df.subquery_plans)} subqueries ran while "
                  f"the text was lowered; their scans and launches are "
                  f"counted with the path's")
        extra = []
        exs = [e for p in plans for e in exchanges(p)]
        batches = sum(e.map_batches for e in exs)
        string_keyed = sum(
            e.map_batches * sum(isinstance(k.dtype, T.StringType)
                                for k in e.partitioner.key_exprs)
            for e in exs)
        if (counts["radix_ranks"] != batches
                or counts["murmur3_words"] != string_keyed):
            raise AssertionError(
                f"{label}: {batches} partitioned batches ({string_keyed} "
                f"string keys in all) but radix_ranks launched "
                f"{counts['radix_ranks']} and murmur3_words "
                f"{counts['murmur3_words']} times")
        for e in exs:
            keys = [type(k.dtype).__name__
                    for k in e.partitioner.key_exprs]
            extra.append(
                f"hash exchange on {len(keys)} keys {keys}: "
                f"{e.child.num_partitions} map partitions into "
                f"{e.num_partitions}, {e.map_batches} partitioned batches, "
                f"so {e.map_batches} radix and "
                f"{e.map_batches * keys.count('StringType')} murmur3_words "
                f"launches of its own; the path's totals (every exchange, "
                f"the subqueries' too): murmur3_words "
                f"{counts['murmur3_words']}, radix {counts['radix_ranks']}")
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
        return plan, extra

    for label in ds_labels:
        q = ds_query[label]
        counted_ds_run(label, lambda q=q: ds_run(q), ds_named(q),
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
    # the 40 texts, on the same SF1 files, as paths sql-ds-q3 ... : each
    # lowered and planned once with the counts reset just before and read
    # just after its run, then the timed runs in turns (lowering, and so
    # the eager subqueries, inside each), then one traced run for the
    # device idle share
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
    # the union-fed exchanges (the counted run also checks one radix launch
    # per partitioned batch and one murmur3_words per string key of each):
    # q14's ROLLUP over three channels (a string key, the channel), q56's
    # group-by on i_item_id, q33's on i_manufact_id
    sql_kernels["sql-ds-q14"] = sql_kernels["sql-ds-q56"] = (
        "bitunpack128", "murmur3_words", "radix_ranks")
    sql_kernels["sql-ds-q33"] = ("bitunpack128", "radix_ranks")
    sql_lines = {}
    for label in sql_labels:
        q = sql_query[label]
        plan, sql_lines[label] = counted_ds_run(
            label, lambda q=q: sql_run(q), set(re.findall(r"\w+", DS_SQL[q])),
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
                if q in sql_twins else "; no DataFrame twin")
        print(f"{label} sf={args.tpcds_sf:g} on {name}: median "
              f"{statistics.median(ts):.4f} s, min {min(ts):.4f} s, max "
              f"{max(ts):.4f} s over {len(ts)} runs: "
              f"{[round(t, 4) for t in ts]}{twin}; {idle}; peak device "
              f"memory {peak_by_path[label]} B; scan routes "
              f"{routes_by_path[label]}; chunk decode launches "
              f"{counts_by_path[label]['bitunpack128']}"
              + "".join(f"; {e}" for e in sql_lines[label]))

    # the two DISTINCT rewrites on sql-ds-q28, in turns in this call: the
    # two-aggregate form the lowering takes for q28's one distinct argument
    # beside its avg and count, and the general Expand form (taken when
    # the first is refused), each run held against the oracle
    from unittest import mock
    from spark_rapids_tpu_torch.sql.lower import _Lowerer

    def expand_form():
        with mock.patch.object(_Lowerer, "_fast_distinct_ok",
                               staticmethod(lambda aggs, grouping: False)):
            return sql_run("q28")
    forms = {"two-aggregate": lambda: sql_run("q28"), "expand": expand_form}
    form_times = {f: [] for f in forms}
    form_peak = {}
    for f, make in forms.items():
        torch.cuda.reset_peak_memory_stats(dev)
        plan = make().physical_plan()
        has_expand = bool(of_type(plan, ExpandExec))
        if has_expand != (f == "expand"):
            raise AssertionError(f"sql-ds-q28 {f} form: Expand exec "
                                 f"{has_expand}")
        sql_check("q28", plan.execute_collect())
        form_peak[f] = torch.cuda.max_memory_allocated(dev)
    for rep in range(4):
        for f in (list(forms) if rep % 2 == 0 else list(forms)[::-1]):
            t0 = time.perf_counter()
            res = forms[f]().collect()
            torch.cuda.synchronize()
            form_times[f].append(time.perf_counter() - t0)
            sql_check("q28", res)
    med = {f: statistics.median(ts) for f, ts in form_times.items()}
    print(f"sql-ds-q28 distinct rewrites on {name}: "
          + "; ".join(f"{f} form median {med[f]:.4f} s, min "
                      f"{min(ts):.4f} s, max {max(ts):.4f} s over "
                      f"{len(ts)} runs, peak device memory {form_peak[f]} B"
                      for f, ts in form_times.items())
          + f"; expand / two-aggregate "
            f"{med['expand'] / med['two-aggregate']:.3f}")

    # -- 4d. the read-write paths: the writers, the ORC and CSV scans -------
    @contextlib.contextmanager
    def counting():
        """The launch and route counts set to 0, and the count kernel's
        batches recorded, for one path's counted run."""
        torch.cuda.reset_peak_memory_stats(dev)
        agg_batches.clear()
        G.resolve_dense_group_sums = counting_resolve
        CK.reset_launches()
        PN.reset_routes()
        try:
            yield
        finally:
            G.resolve_dense_group_sums = resolve
    etl_results, etl_lines = etl_paths(
        spark, dev, name, li_files,
        [os.path.join(ds_paths["store_sales"], f) for f in sorted(
            os.listdir(ds_paths["store_sales"])) if f.endswith(".parquet")],
        exp_q1, os.path.join(repo, "build", f"etl_sf{args.sf:g}"), counting,
        agg_batches, scan_chunks, Q1_REPS, args.sf)
    for label, (counts, peak) in etl_results.items():
        counts_by_path[label] = counts
        peak_by_path[label] = peak

    # -- 4e. sweep-sf1: the expression slice's statements over qa -----------
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"before sweep-sf1")
    sweep_results, sweep_calls, _sweep_lines = sweep_path(
        spark, dev, name, li_files, os.path.join(repo, "build",
                                                 f"sweep_sf{args.sf:g}"),
        counting, agg_batches, scan_chunks, SWEEP_REPS)
    for label, (counts, peak) in sweep_results.items():
        counts_by_path[label] = counts
        peak_by_path[label] = peak
    sweep_kernels = sweep_kernel_times(sweep_calls, name, bincount_calls,
                                       bincount)

    # -- 4f. dfapi-sf1: the DataFrame API's remainder, several window specs
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"before dfapi-sf1")
    exp_w = dfapi_paths(spark, dev, name, ds_paths, counted_ds_run,
                        counting, agg_batches, scan_chunks, args.reps,
                        counts_by_path, peak_by_path)

    # -- 4g. nested-sf1: arrays, structs and maps as device columns ---------
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"before nested-sf1")
    nested_paths(spark, dev, name, li_dir, ds_paths,
                 os.path.join(repo, "build", f"nested_sf{args.sf:g}"),
                 counting, agg_batches, scan_chunks, exp_q1,
                 min(args.reps, NESTED_REPS), counts_by_path, peak_by_path)

    # -- 4h. deep-nested-sf1: nested elements and fields, and rand() --------
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"before deep-nested-sf1")
    deep_root = os.path.join(repo, "build", f"deep_nested_sf{args.sf:g}")
    orders_dir = deep_nested_paths(
        spark, dev, name, li_dir, ds_paths, deep_root, counting, agg_batches,
        scan_chunks, min(args.reps, DEEP_REPS), counts_by_path, peak_by_path)

    # -- 4i. ordered-nested-sf1: the order over whole nested values ---------
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"before ordered-nested-sf1")
    ordered_nested_paths(spark, dev, name, li_dir, orders_dir, counting,
                         agg_batches, scan_chunks,
                         min(args.reps, ORDERED_REPS), counts_by_path,
                         peak_by_path)
    shutil.rmtree(deep_root, ignore_errors=True)

    # -- 4j. the group-by remainder against stageFusion.enabled=false ------
    off = TorchSession({**threads, "spark.rapids.tpu.sql.stageFusion."
                        "enabled": "false"})
    tpcds.load(off, ds_paths)          # registers the temp views
    ss_files = data_files(ds_paths["store_sales"], ".parquet")

    def rest_frames(s):
        return {"q3": lambda: tpch.q3(tpch.load(s, paths)),
                "q18": lambda: tpch.q18(tpch.load(s, paths)),
                "ds-windows": lambda: ds_windows_frame(s, ss_files,
                                                       ds_paths["item"]),
                "sql-ds-q14": lambda: s.sql(DS_SQL["q14"])}
    groupby_rest_compare(name, card, rest_frames(spark), rest_frames(off), {
        "q3": lambda res: check("q3", res),
        "q18": lambda res: check("q18", res),
        "ds-windows": lambda res: check_ds_windows(res, exp_w, "ds-windows"),
        "sql-ds-q14": lambda res: sql_check("q14", res)})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"after the group-by remainder")

    # -- 4k. join-fusion-sf1: the joins' hoist and chain, the scan's rest --
    join_fusion_paths(spark, off, dev, name, card, paths,
                      os.path.join(repo, "build", f"join_fusion_sf{args.sf:g}"),
                      args.sf, check, exp_q1, counting, agg_batches,
                      scan_chunks, min(args.reps, JOIN_FUSION_REPS),
                      counts_by_path, peak_by_path)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"after join-fusion-sf1")

    # -- 4l. runtime-sf1: the memory runtime, the pipeline, the exchange's
    # remainder
    def check_query(q, res):
        if q == "q1":
            check_q1(res.to_pylist(), exp_q1)
        elif q == "q5":
            check_q5(res.to_pylist(), exp_q5)
        else:
            (check_q3 if q == "q3" else check_q18)(res.to_pylist(),
                                                    exp_ladder[q])
    runtime_paths(dev, name, card, paths, li_files,
                  os.path.join(repo, "build", f"runtime_sf{args.sf:g}"),
                  check_query, counting, agg_batches, scan_chunks,
                  counts_by_path, peak_by_path, threads, q5_terms)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start, "
          f"after runtime-sf1")

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
    # "launches" sums every path's counted run, under the counter each
    # kernel counts on, and launches_by_path has each path's;
    # "timed_paths_launches" counts the runs whose inputs the times cover:
    # the q1 path's for bitunpack128 (the chunk decode) and onehot_sum_f32
    # (the fused count launch), q1-files plus q1-repartition for
    # murmur3_words and radix_partition_permutation, q5-sparse for
    # hash_join_build and hash_join_probe. radix_ranks is called by no
    # main path: the radix kernels run there only inside the permutation,
    # whose entry carries their launches (counted under radix_ranks) and
    # their times, so its own entry is timed off the paths, on q5-sparse's
    # build bucket ids, with no launches
    exchange_paths = ("q1-files", "q1-repartition")

    def entry(kname, source, line, launch_paths, err, ms, plain_ms, bound,
              bound_by, library_ms, counter=None):
        counter = counter or kname
        return {
            "name": kname, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{source}",
            "replaces": f"spark_rapids_tpu/ops/pallas_kernels.py:{line}",
            "launches": sum(c[counter] for c in counts_by_path.values()),
            "timed_paths_launches": sum(counts_by_path[p][counter]
                                        for p in launch_paths),
            "launches_by_path": {p: c[counter]
                                 for p, c in counts_by_path.items()},
            "paths": [p for p, c in counts_by_path.items() if c[counter]],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}
    kernels = [
        # the fused chunk decode: times over every dictionary chunk of one
        # q1 scan; per_page_route_ms is every device op of the per-page
        # route it replaced, fused_route_ms the fused route's (copy + kernel)
        dict(entry("bitunpack128", "chunkdecode.cu", 221, ("q1",),
                   max(max_err, sweep_kernels["chunk_decode"]["err"]),
                   chunk_ms, chunk_plain_ms, chunk_bound, "bytes", None),
             sweep_sf1=sweep_kernels["chunk_decode"],
             chunks=len(census), pages=census_pages,
             host_scan_native_s=native_s, host_scan_plain_s=plain_s,
             scan_routes_by_path=routes_by_path,
             fused_route_ms=fused_ms, per_page_route_ms=per_page_ms,
             fused_route_host_s=fused_s, per_page_route_host_s=per_page_s),
        # the fused count launch over one q1 run's batches; library_ms is
        # torch.bincount once per request; fused_route_ms is every device op
        # of the route; per_request_chain_new_kernel_ms the replaced route's
        # per-request chain (where, cast, call, cast) over this kernel's
        # one-request launch, not the replaced kernel; float_sums_ms the
        # same batches' stacked f64 float sums
        dict(entry("onehot_sum_f32", "onehot.cu", 289, ("q1",),
                   max(oh_err, sweep_kernels["onehot_sums_f32"]["err"]),
                   oh_ms, oh_plain_ms, oh_bound_ms, oh_bound_by, oh_lib_ms),
             sweep_sf1=sweep_kernels["onehot_sums_f32"],
             aggregate_batches=len(batches_by_path["q1"]),
             fused_route_ms=oh_route_ms,
             per_request_chain_new_kernel_ms=oh_chain_ms,
             per_request_bound_ms=oh_old_bound_ms, float_sums_ms=float_ms),
        dict(entry("murmur3_words", "murmur3.cu", 169, exchange_paths,
                   max(mm_err, sweep_kernels["murmur3_words"]["err"]),
                   mm_ms, mm_plain_ms, mm_bound_ms, mm_bound_by, None),
             sweep_sf1=sweep_kernels["murmur3_words"]),
        # timed off the main paths, on q5-sparse's hash build bucket ids;
        # no main path calls it (see above)
        dict(entry("radix_ranks", "radix.cu", 359, (), max(rx_err, rb_err),
                   rb_ms, rb_plain_ms, rb_bound_ms, rb_bound_by,
                   rb_argsort_ms), launches=0, launches_by_path={},
             paths=[],
             on_main_path=False,
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
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"peak_device_bytes_by_path": peak_by_path}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
