"""The port's pipelined stages (``spark_rapids_tpu_torch/runtime/pipeline.py``)
against the reference's (``spark_rapids_tpu/runtime/pipeline.py``), the cases
of ``tests/test_pipeline.py``.

The queue's depth and byte bounds, order, the producer's original exception
re-raised at the consumer, early close releasing the producer and its
spillable registrations; then whole queries with the pipeline on and off
through ``TorchSession(device="cpu")``, against each other (bit for bit) and
against ``TpuSession`` on the same inputs (bit for bit where the arithmetic
is the same; q1/q5's float sums, added in other orders by the two packages,
within ``rel=1e-9``), an OOM split inside a pipelined segment, and injected
faults at the queues failing the query cleanly. Finally
``TorchSession`` with ``bench.py``'s own three confs runs the TPC-H ladder
q1/q3/q5/q18, each equal to its numpy oracle.
"""

import collections
import gc
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu_torch.functions as F_
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.runtime import faults as F
from spark_rapids_tpu_torch.runtime import pipeline as P
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.memory import DeviceManager
from spark_rapids_tpu_torch.session import TorchSession

#: bench.py:172-175's session confs, with the pipeline and stage fusion on
BENCH_CONF = {"spark.rapids.tpu.sql.format.parquet.reader.type": "COALESCING",
              "spark.rapids.tpu.pipeline.enabled": True,
              "spark.rapids.tpu.sql.stageFusion.enabled": True}


@pytest.fixture(autouse=True)
def _clean_chaos_state():
    F.reset()
    R.reset_counts()
    yield
    F.reset()
    R.reset_counts()


@pytest.fixture(scope="module")
def tpch_paths(tmp_path_factory):
    return tpch.generate(0.005, str(tmp_path_factory.mktemp("tpch_pipe")))


def _pipe_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("srt-pipe-")]


def _await_no_pipe_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _pipe_threads():
            return True
        time.sleep(0.05)
    return not _pipe_threads()


# -- BoundedBatchQueue --------------------------------------------------------

def test_queue_byte_budget_respected():
    """With a slow consumer the buffered bytes never pass the cap (one
    oversized item excepted: the progress guarantee)."""
    item_bytes, budget = 1000, 2500

    def gen():
        for i in range(20):
            yield pa.table({"v": pa.array(np.full(125, i, np.int64))})

    qbox = []
    got = []
    for t in P.stage_iterator(gen(), edge="t.budget", depth=100,
                              max_bytes=budget, _queue_cb=qbox.append):
        time.sleep(0.01)
        got.append(t)
    assert [t.column("v")[0].as_py() for t in got] == list(range(20))
    (q,) = qbox
    assert q.peak_bytes <= max(budget, item_bytes), q.peak_bytes
    assert q.peak_depth <= budget // item_bytes + 1


def test_queue_depth_respected_and_oversized_progress():
    def gen():
        yield pa.table({"v": pa.array(np.zeros(1 << 16))})   # >> budget
        yield pa.table({"v": pa.array([1.0])})

    qbox = []
    got = list(P.stage_iterator(gen(), edge="t.oversized", depth=4,
                                max_bytes=16, _queue_cb=qbox.append))
    assert len(got) == 2
    assert qbox[0].peak_depth <= 4


def test_stage_preserves_order_and_objects():
    tabs = [pa.table({"i": [k]}) for k in range(9)]
    got = list(P.stage_iterator(iter(tabs), edge="t.order", depth=3))
    assert all(a is b for a, b in zip(got, tabs)) and len(got) == 9


def test_stage_propagates_original_error_and_joins_thread():
    err = ValueError("decode exploded mid-stream")

    def gen():
        yield pa.table({"i": [1]})
        raise err

    it = P.stage_iterator(gen(), edge="t.err", depth=2)
    next(it)
    with pytest.raises(ValueError) as ei:
        next(it)
    assert ei.value is err
    assert _await_no_pipe_threads()


def test_stage_early_close_releases_producer_and_spillables():
    DeviceManager.initialize(device="cpu")
    cat = DeviceManager.get().catalog
    base = cat.num_buffers
    t = pa.table({"v": pa.array(np.arange(256, dtype=np.int64))})

    def gen():
        for _ in range(50):
            yield ColumnarBatch.from_arrow(t, "cpu")

    it = P.stage_iterator(gen(), edge="t.close", depth=4, spillable=True)
    b = next(it)
    assert b.to_arrow().equals(t)
    it.close()
    assert _await_no_pipe_threads()
    assert cat.num_buffers == base


def test_spillable_stage_batches_come_back_from_the_host(tmp_path):
    """Queued batches registered spillable: under a budget of one batch the
    catalog spills them while queued, and the consumer still gets every
    batch, in order."""
    from spark_rapids_tpu_torch.config import RapidsConf
    one = ColumnarBatch.from_arrow(
        pa.table({"v": pa.array(np.arange(256, dtype=np.int64))}), "cpu")
    conf = RapidsConf({"spark.rapids.tpu.memory.hbm.limitBytes":
                       str(one.device_memory_size() + 1),
                       "spark.rapids.tpu.memory.spill.dirs": str(tmp_path)})
    DeviceManager.initialize(conf, "cpu")

    def gen():
        for i in range(12):
            yield ColumnarBatch.from_arrow(
                pa.table({"v": pa.array(np.arange(256, dtype=np.int64) + i)}),
                "cpu")

    got = []
    for b in P.stage_iterator(gen(), edge="t.spill", depth=8,
                              spillable=True):
        time.sleep(0.005)
        got.append(b.to_arrow().column("v")[0].as_py())
    cat = DeviceManager.get().catalog
    assert got == list(range(12))
    assert cat.spilled_to_host_bytes > 0 and cat.num_buffers == 0
    DeviceManager.initialize(device="cpu")


# -- whole queries, pipeline on against off and against TpuSession ----------

def _edges(monkeypatch):
    seen = collections.Counter()
    real = P.stage_iterator

    def spy(gen, *, edge, **kw):
        seen[edge] += 1
        return real(gen, edge=edge, **kw)

    monkeypatch.setattr(P, "stage_iterator", spy)
    return seen


def _ladder(spark, paths, name):
    dfs = tpch.load(spark, paths, files_per_partition=2)
    return getattr(tpch, name)(dfs).collect().to_pylist()


def _approx_rows(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert list(g) == list(e)
        for a, b in zip(g.values(), e.values()):
            if isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b


@pytest.mark.parametrize("name", ["q3", "q18"])
def test_q3_q18_bit_identical_pipeline_on_off(tpch_paths, name,
                                              monkeypatch):
    from spark_rapids_tpu.benchmarks import tpch as jtpch
    from spark_rapids_tpu.session import TpuSession
    seen = _edges(monkeypatch)
    on = _ladder(TorchSession({"spark.rapids.tpu.pipeline.enabled": True},
                              device="cpu"), tpch_paths, name)
    assert seen["collect"] >= 1 and seen["scan.device"] >= 1, seen
    off = _ladder(TorchSession({"spark.rapids.tpu.pipeline.enabled": False},
                               device="cpu"), tpch_paths, name)
    assert on == off
    if name == "q3":
        assert on        # non-vacuous: q3 returns rows at this scale
    ref = jtpch.load(TpuSession({"spark.rapids.tpu.pipeline.enabled": True}),
                     tpch_paths, files_per_partition=2)
    assert on == getattr(jtpch, name)(ref).collect().to_pylist()


def test_exchange_edges_and_results(monkeypatch):
    seen = _edges(monkeypatch)
    rng = np.random.default_rng(5)
    t = pa.table({"k": pa.array(rng.integers(0, 16, 6000).astype(np.int64)),
                  "v": pa.array(rng.integers(0, 99, 6000).astype(np.int64))})
    spark = TorchSession({"spark.rapids.tpu.pipeline.enabled": True},
                         device="cpu")
    df = (spark.create_dataframe(t, num_partitions=3)
          .repartition(4, "k")
          .group_by("k").agg(F_.alias(F_.sum(F_.col("v")), "sv")))
    rows = {r["k"]: r["sv"] for r in df.collect().to_pylist()}
    exp = collections.defaultdict(int)
    for k, v in zip(t["k"].to_pylist(), t["v"].to_pylist()):
        exp[k] += v
    assert rows == dict(exp)
    assert seen["exchange.map"] >= 3 and seen["exchange.reduce"] >= 1, seen


def test_join_sort_bit_identical_tiny_queue_bytes():
    """A tiny pipeline.maxQueueBytes (the producer blocks at every batch)
    gives the same rows, equal to TpuSession's."""
    import spark_rapids_tpu.functions as RF_
    from spark_rapids_tpu.session import TpuSession
    rng = np.random.default_rng(7)
    t1 = pa.table({"k": pa.array(rng.integers(0, 40, 4000).astype(np.int64)),
                   "v": pa.array(rng.integers(0, 1000, 4000).astype(np.int64))})
    t2 = pa.table({"k": pa.array(np.arange(40, dtype=np.int64)),
                   "w": pa.array(rng.normal(size=40))})

    def run(spark, fns):
        a = spark.create_dataframe(t1, num_partitions=3)
        b = spark.create_dataframe(t2)
        q = (a.join(b, on="k")
             .group_by("k").agg(fns.alias(fns.sum(fns.col("v")), "sv"),
                                fns.alias(fns.max(fns.col("w")), "mw"))
             .sort("k"))
        return q.collect().to_pylist()

    on = run(TorchSession({"spark.rapids.tpu.pipeline.enabled": True,
                           "spark.rapids.tpu.pipeline.maxQueueBytes": 64,
                           "spark.rapids.tpu.pipeline.queueDepth": 1},
                          device="cpu"), F_)
    off = run(TorchSession({"spark.rapids.tpu.pipeline.enabled": False},
                           device="cpu"), F_)
    assert on == off
    assert on == run(TpuSession({"spark.rapids.tpu.pipeline.enabled": True}),
                     RF_)


def test_oom_split_retry_inside_pipeline_segment():
    """An injected split-OOM at the exchange's map writer recovers bit for
    bit while the map segment runs behind pipeline queues."""
    rng = np.random.default_rng(11)
    t = pa.table({"k": pa.array(rng.integers(0, 8, 5000).astype(np.int64)),
                  "v": pa.array(rng.integers(0, 500, 5000).astype(np.int64))})

    def run(extra):
        conf = {"spark.rapids.tpu.pipeline.enabled": True,
                "spark.rapids.tpu.memory.retry.splitFloorBytes": "1k"}
        conf.update(extra)
        spark = TorchSession(conf, device="cpu")
        df = (spark.create_dataframe(t, num_partitions=2)
              .repartition(3, "k")
              .group_by("k").agg(F_.alias(F_.sum(F_.col("v")), "sv"))
              .sort("k"))
        return df.collect().to_pylist()

    clean = run({})
    chaotic = run({"spark.rapids.tpu.test.faults": "splitoom:exchange.map:1"})
    assert chaotic == clean
    assert R.counts["split_retries"] >= 1
    assert ("splitoom", "exchange.map") in F.injected_log()


# -- chaos: a fault at a queue fails the whole query cleanly -----------------

def _parquet_dir(tmp_path, n=3000):
    rng = np.random.default_rng(3)
    t = pa.table({"k": pa.array(rng.integers(0, 9, n).astype(np.int64)),
                  "v": pa.array(rng.normal(size=n))})
    for i in range(3):
        pq.write_table(t.slice(i * (n // 3), n // 3),
                       tmp_path / f"p{i}.parquet")
    return str(tmp_path)


@pytest.mark.parametrize("site", ["pipeline.put.scan.device",
                                  "pipeline.get.collect"])
def test_chaos_queue_fault_fails_clean(tmp_path, site):
    d = _parquet_dir(tmp_path)
    spark = TorchSession({"spark.rapids.tpu.pipeline.enabled": True,
                          "spark.rapids.tpu.test.faults": f"error:{site}:1"},
                         device="cpu")
    cat = DeviceManager.get().catalog
    df = (spark.read_parquet(d)
          .group_by("k").agg(F_.alias(F_.sum(F_.col("v")), "sv")))
    with pytest.raises(RuntimeError, match="fault-injection"):
        df.collect()
    assert F.injected_log() == [("error", site)]
    F.reset()
    gc.collect()
    assert _await_no_pipe_threads(), _pipe_threads()
    assert cat.num_buffers == 0
    assert spark.read_parquet(d).collect().num_rows == 3000


def test_leak_check_is_clean_with_the_pipeline_on(tpch_paths):
    """memory.leak.strict: a query whose pipelined stages and exchange are
    drained leaves no buffer registered."""
    spark = TorchSession({"spark.rapids.tpu.pipeline.enabled": True,
                          "spark.rapids.tpu.memory.leak.strict": True},
                         device="cpu")
    li = spark.read_parquet(tpch_paths["lineitem"]).repartition(
        3, "l_returnflag")
    tpch.q1({"lineitem": li}).collect()
    assert DeviceManager.get().catalog.num_buffers == 0


def test_leak_strict_raises_on_an_injected_leak():
    from spark_rapids_tpu_torch.runtime.memory import MemoryLeakError
    t = pa.table({"k": pa.array(np.arange(100, dtype=np.int64) % 7)})
    spark = TorchSession({"spark.rapids.tpu.memory.leak.strict": True,
                          "spark.rapids.tpu.pipeline.enabled": False,
                          "spark.rapids.tpu.test.faults":
                          "leak:exchange.write:1"}, device="cpu")
    df = spark.create_dataframe(t, num_partitions=2).repartition(3, "k")
    with pytest.raises(MemoryLeakError, match="exchange.write"):
        df.collect()
    assert DeviceManager.get().catalog.num_buffers == 0


# -- bench.py's own session conf ---------------------------------------------

@pytest.fixture(scope="module")
def ladder_paths(tmp_path_factory):
    return tpch.generate(0.02, str(tmp_path_factory.mktemp("tpch_bench")))


@pytest.mark.parametrize("name", ["q1", "q3", "q5", "q18"])
def test_bench_session_conf_runs_the_ladder(ladder_paths, name):
    """TorchSession(bench.py's three confs) plans and runs the ladder, with
    the pipeline on and off, each equal to its numpy oracle (bit for bit on
    q3 and q18, ``rel=1e-9`` on q1's and q5's float sums)."""
    exp = getattr(tpch, f"np_{name}")(tpch.load_np(ladder_paths))
    outs = []
    for pipe in (True, False):
        spark = TorchSession({**BENCH_CONF,
                              "spark.rapids.tpu.pipeline.enabled": pipe},
                             device="cpu")
        dfs = tpch.load(spark, ladder_paths, files_per_partition=4)
        outs.append(getattr(tpch, name)(dfs).collect())
    on, off = outs
    if name in ("q3", "q18"):
        assert on.equals(off)
    else:
        _approx_rows(on.to_pylist(), off.to_pylist())
    _check_oracle(on, exp)


def _check_oracle(table, exp):
    import datetime
    epoch = datetime.date(1970, 1, 1)
    rows = [tuple(r.values()) for r in table.to_pylist()]
    assert len(rows) == len(exp)
    for got, want in zip(rows, exp):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, datetime.date):
                a = (a - epoch).days
            if isinstance(a, float):
                assert a == pytest.approx(float(b), rel=1e-9)
            else:
                assert a == (b.item() if hasattr(b, "item") else b)


# -- the device semaphore ------------------------------------------------------

def test_semaphore_gates_tasks_only():
    """A permit is held by a task (``TaskContext``) and released at its
    exit; a thread outside every task is not gated (nothing would release
    its permit)."""
    from spark_rapids_tpu_torch.runtime.semaphore import (DeviceSemaphore,
                                                          TaskContext)
    DeviceSemaphore.initialize(1)
    sem = DeviceSemaphore.get()
    sem.acquire_if_necessary()           # outside a task: a no-op
    assert sem._sem._value == 1
    with TaskContext():
        sem.acquire_if_necessary()
        sem.acquire_if_necessary()       # re-entrant per task
        assert sem._sem._value == 0
    assert sem._sem._value == 1          # released at the task's exit
    DeviceSemaphore.initialize(2)


def test_writer_tasks_release_their_permits(tmp_path):
    """Four write tasks on four threads under one permit finish: each task
    releases its permit when it ends (a thread that kept its permit after
    its task would block the next task forever)."""
    t = pa.table({"k": pa.array(np.arange(4000, dtype=np.int64) % 13),
                  "v": pa.array(np.arange(4000, dtype=np.int64))})
    spark = TorchSession({"spark.rapids.tpu.sql.concurrentTpuTasks": 1,
                          "spark.rapids.tpu.sql.localScheduler.numThreads":
                          4,
                          # four reduce partitions, four write tasks
                          "spark.rapids.tpu.sql.adaptive.coalescePartitions."
                          "enabled": False}, device="cpu")
    df = (spark.create_dataframe(t, num_partitions=4).repartition(4, "k")
          .group_by("k").agg(F_.sum(F_.col("v")).alias("s")))
    done = []
    th = threading.Thread(target=lambda: done.append(
        df.write_parquet(str(tmp_path / "out"), mode="overwrite")),
        daemon=True)
    th.start()
    th.join(120)
    assert done, "the write did not finish: a permit was never released"
    back = spark.read_parquet(str(tmp_path / "out")).collect()
    assert sorted(back.column("s").to_pylist()) == sorted(
        sum(range(k, 4000, 13)) for k in range(13))
