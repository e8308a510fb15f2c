"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py [--sf 1.0] [--reps 5] [--profile]

It imports the port (``spark_rapids_tpu_torch``) and nothing of JAX, then:

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds every CUDA kernel from ``spark_rapids_tpu_torch/csrc`` with nvcc
   (one process per source, all started together) and prints the build time
   and ptxas' register/shared-memory lines;
3. holds each kernel against its plain PyTorch version on the card:
   bitunpack128 exactly, at every bit width 1..32 for n = 20,000 (a parquet
   page) and n = 2^20, and on every real page of the TPC-H q1 scan;
   onehot_sum_f32 exactly on 0/1 values and within 1e-5 of each bucket's
   sum of magnitudes on other float32 values (atomics add in a changing
   order), at q1's batch shape and at the largest dense domain;
4. runs TPC-H q1 at scale factor ``--sf`` (data generated from the fixed
   seed into build/) through ``TorchSession()`` on the card: one run with
   the launch counts reset just before and read just after (every kernel of
   the path must have launched, bitunpack128 as often as the scan has pages
   for it), then ``--reps`` timed runs; every result is held against the
   NumPy oracle. One more run records the inputs the aggregate hands to
   onehot_sum_f32, and the kernel is held against its plain version on them;
5. times each kernel, its plain version and, where one exists, the PyTorch
   call that computes the same function, on the main path's inputs, beside
   the least time the card could take (bytes over 3.35 TB/s, operations
   over the float32 peak);
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
# the CUDA kernel's symbol, as the profiler names its launches
KERNEL_NAME = "bitunpack_kernel"


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


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Mean device time of one fn() call: the summed durations of the device
    activities (kernels, copies, memsets) it ran, traced by torch.profiler
    over reps calls; ``match`` keeps only activities whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a trace can come back without its device records (seen once on the
    # first trace of a process), so a trace that saw nothing is taken again
    for _ in range(3):
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
    # no device records at all: CUDA events around back-to-back calls, an
    # upper bound on the device time (it includes the host's enqueue gaps)
    print(f"device_ms: 3 traces saw no device activity ({match}); "
          "timed with CUDA events instead")
    return call_ms(fn, reps, 1)


def unpack_bound_ms(n: int, bw: int, capacity: int) -> float:
    """Least time for one bitunpack128 call: read n*bw/8 packed bytes once,
    write 4*capacity output bytes once, over the card's memory rate."""
    return (n * bw / 8 + 4 * capacity) / HBM_BYTES_PER_S * 1e3


def onehot_bound_ms(n: int, n_domain: int) -> tuple:
    """(bytes ms, operations ms) of one onehot_sum_f32 call: read n codes
    and n values once and write n_domain sums; n float32 adds."""
    return ((8 * n + 4 * n_domain) / HBM_BYTES_PER_S * 1e3,
            n / F32_OPS_PER_S * 1e3)


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


def page_census(lineitem_dir: str):
    """Every data page of the q1 scan that reaches bitunpack128, read on the
    host exactly as the scan reads it: [(words int32 np, bw, n, pcap)], plus
    the count of dictionary data pages decoded (kernel or host RLE)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
    from spark_rapids_tpu_torch.io import parquet_native as PN
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    pages, dict_pages = [], 0
    for f in sorted(os.listdir(lineitem_dir)):
        if not f.endswith(".parquet"):
            continue
        path = os.path.join(lineitem_dir, f)
        md = pq.ParquetFile(path).metadata
        for rg in range(md.num_row_groups):
            for ci in range(md.num_columns):
                try:
                    chunk = PN.read_chunk_pages(path, rg, ci, md=md)
                except NotImplementedError:
                    continue      # arrow fallback column: no kernel
                for (nv, dl, bw, page_bytes, _off, segs) in \
                        chunk.index_segments:
                    dict_pages += 1
                    if not PN._all_packed(segs):
                        continue  # RLE runs: indices decode on the host
                    n = int(dl.sum())
                    words = CK.bytes_to_words_u32(np.frombuffer(
                        PN._packed_bytes(page_bytes, segs), np.uint8))
                    pages.append((words, bw, n,
                                  max(bucket_capacity(max(n, 1)), 8)))
    return pages, dict_pages


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the q1 run (default 1.0)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed q1 runs after the first (default 5)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one q1 run with torch.profiler")
    args = ap.parse_args()
    # progress must survive a kill at a time limit, so flush every line
    sys.stdout.reconfigure(line_buffering=True)

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

    # -- 3. q1 data and its page census --------------------------------------
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.session import TorchSession
    data_dir = os.path.join(repo, "build", f"tpch_sf{args.sf:g}")
    t0 = time.perf_counter()
    paths = tpch.generate(args.sf, data_dir)
    print(f"data: sf={args.sf:g} at {data_dir} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    census, dict_pages = page_census(paths["lineitem"])
    print(f"census: {dict_pages} dictionary data pages, {len(census)} all "
          f"bit-packed (kernel) pages, {time.perf_counter() - t0:.1f} s")
    if not census:
        raise AssertionError("the q1 scan has no page for bitunpack128")
    dev_pages = [(torch.from_numpy(w).to(dev), bw, n, pcap)
                 for (w, bw, n, pcap) in census]
    for w, bw, n, pcap in dev_pages:
        got = CK.bitunpack128(w, bw, n, pcap)
        want = CK.bitunpack128_plain(w, bw, n, pcap)
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(
                f"bitunpack128 != plain on a q1 page bw={bw} n={n}")
    torch.cuda.synchronize()

    def all_pages(fn):
        def run():
            for w, bw, n, pcap in dev_pages:
                fn(w, bw, n, pcap)
        return run
    page_ms = device_ms(all_pages(CK.bitunpack128), 3, KERNEL_NAME)
    page_plain_ms = device_ms(all_pages(CK.bitunpack128_plain), 2)
    page_call_ms = call_ms(all_pages(CK.bitunpack128), 5, 1)
    page_bound_ms = sum(unpack_bound_ms(n, bw, pcap)
                        for (_w, bw, n, pcap) in dev_pages)
    bws = sorted({bw for (_w, bw, _n, _p) in dev_pages})
    print(f"q1 pages: {len(dev_pages)} launches, bit widths {bws}; "
          f"kernel {page_ms:.4f} ms device ({page_call_ms:.4f} ms enqueued "
          f"back to back), plain {page_plain_ms:.4f} ms device, "
          f"bound {page_bound_ms:.6f} ms per q1 scan")
    del dev_pages

    # -- 4. the main path: q1 through the session on the card ----------------
    spark = TorchSession()
    dfs = tpch.load(spark, paths)
    exp = tpch.np_q1(tpch.load_np({"lineitem": paths["lineitem"]}))
    torch.cuda.reset_peak_memory_stats(dev)
    CK.reset_launches()
    t0 = time.perf_counter()
    res = tpch.q1(dfs).collect()
    first_s = time.perf_counter() - t0
    counts = dict(CK.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    check_q1(res.to_pylist(), exp)
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the q1 path")
    if counts["bitunpack128"] != len(census):
        raise AssertionError(
            f"bitunpack128 launched {counts['bitunpack128']} times, the scan "
            f"has {len(census)} bit-packed pages")
    print(f"q1 first run: {first_s:.3f} s; launches {counts}; "
          f"{dict_pages} dictionary pages decoded; peak device memory "
          f"{peak} B")
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = tpch.q1(dfs).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_q1(res.to_pylist(), exp)
    print(f"q1 sf={args.sf:g} on {name}: median {statistics.median(times):.4f}"
          f" s, min {min(times):.4f} s, max {max(times):.4f} s over "
          f"{len(times)} runs: {[round(t, 4) for t in times]}")

    # the inputs the aggregate hands to onehot_sum_f32 in one q1 run
    recorded = []
    launch_onehot = CK.onehot_sum_f32

    def recorder(vals, codes, n_domain):
        recorded.append((vals.clone(), codes.clone(), n_domain))
        return launch_onehot(vals, codes, n_domain)
    CK.onehot_sum_f32 = recorder
    try:
        tpch.q1(dfs).collect()
    finally:
        CK.onehot_sum_f32 = launch_onehot
    if len(recorded) != counts["onehot_sum_f32"]:
        raise AssertionError(
            f"recorded {len(recorded)} onehot_sum_f32 calls, the counted "
            f"run launched {counts['onehot_sum_f32']}")
    for vals, codes, dom in recorded:
        oh_err = max(oh_err, onehot_check(vals, codes, dom, True))

    def all_sums(fn):
        def run():
            for vals, codes, dom in recorded:
                fn(vals, codes, dom)
        return run

    def bincount(vals, codes, dom):
        # codes of dropped rows are dom (the pad bucket), never negative
        return torch.bincount(codes, weights=vals, minlength=dom)[:dom]
    oh_ms = device_ms(all_sums(CK.onehot_sum_f32), 5)
    oh_plain_ms = device_ms(all_sums(CK.onehot_sum_f32_plain), 5)
    oh_lib_ms = device_ms(all_sums(bincount), 5)
    oh_call_ms = call_ms(all_sums(CK.onehot_sum_f32), 5, 1)
    oh_bytes_ms, oh_ops_ms = (sum(x) for x in zip(*(
        onehot_bound_ms(v.numel(), dom) for v, _c, dom in recorded)))
    oh_bound_ms = max(oh_bytes_ms, oh_ops_ms)
    oh_bound_by = "bytes" if oh_bytes_ms >= oh_ops_ms else "operations"
    shapes = sorted({(v.numel(), dom) for v, _c, dom in recorded})
    print(f"q1 onehot_sum_f32: {len(recorded)} launches at (n, D) {shapes}; "
          f"kernel {oh_ms:.4f} ms device ({oh_call_ms:.4f} ms enqueued back "
          f"to back), plain {oh_plain_ms:.4f} ms, torch.bincount "
          f"{oh_lib_ms:.4f} ms, bound {oh_bound_ms:.6f} ms per q1 run")
    del recorded

    if args.profile:
        import collections
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tpch.q1(dfs).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_kernel = collections.Counter()
        launched = collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_kernel[e.name] += e.time_range.elapsed_us()
                launched[e.name] += 1
        dev_s = sum(by_kernel.values()) / 1e6
        print(f"profile: wall {wall:.4f} s, device kernel time {dev_s:.4f} s,"
              f" device idle share {1 - dev_s / wall:.4f}, "
              f"{sum(launched.values())} kernel launches")
        for kname, us in by_kernel.most_common(12):
            print(f"  {us / 1e3:10.3f} ms {launched[kname]:6d}x {kname[:90]}")
        import cProfile
        import io
        import pstats
        prof_host = cProfile.Profile()
        prof_host.enable()
        tpch.q1(dfs).collect()
        torch.cuda.synchronize()
        prof_host.disable()
        buf = io.StringIO()
        pstats.Stats(prof_host, stream=buf).sort_stats("cumulative") \
            .print_stats("spark_rapids_tpu_torch", 18)
        print("host profile (cProfile, cumulative s, port functions):")
        for ln in buf.getvalue().splitlines():
            if "spark_rapids_tpu_torch" in ln or "ncalls" in ln:
                print("  " + ln.replace(repo + os.sep, ""))

    # -- 5. the kernels line, the card, the verdict --------------------------
    kernels = [{
        "name": "bitunpack128",
        "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/bitunpack.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:221",
        "launches": counts["bitunpack128"],
        "max_abs_err": max_err,
        "ms": page_ms,
        "plain_ms": page_plain_ms,
        "bound_ms": page_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "onehot_sum_f32",
        "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/onehot.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:289",
        "launches": counts["onehot_sum_f32"],
        "max_abs_err": oh_err,
        "ms": oh_ms,
        "plain_ms": oh_plain_ms,
        "bound_ms": oh_bound_ms,
        "bound_by": oh_bound_by,
        "library_ms": oh_lib_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
