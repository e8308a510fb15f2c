"""The port's OOM retry ladder and fault injection
(``spark_rapids_tpu_torch/runtime/retry.py``, ``faults.py``) against the
reference's (``spark_rapids_tpu/runtime``), the cases of
``tests/test_retry_faults.py`` that need no transport, heartbeat or cluster.

Unit cases run the same spec and inputs through both packages' injectors and
ladders: the schedules, the split pieces (bit for bit: values, validity and
capacities) and the attempt counts must be equal. The operator cases set the
same ``spark.rapids.tpu.test.faults`` spec in ``TorchSession(device="cpu")``
and ``TpuSession()`` over one numpy-seeded parquet table, a join, a sort, a
group-by chain and TPC-H q1 over one partition per file: each chaos run is
bit for bit its package's clean run, and the port's rows equal the
reference's (bit for bit, but q1's float sums, which the packages add in
other orders: ``rel=1e-9``). The fault kinds that need the transport, the
cluster or the scheduler are refused.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.runtime import faults as RF
from spark_rapids_tpu.runtime import memory as RM
from spark_rapids_tpu.runtime import retry as RR
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.runtime import faults as F
from spark_rapids_tpu_torch.runtime import memory as PM
from spark_rapids_tpu_torch.runtime import retry as R
from spark_rapids_tpu_torch.runtime.retry import (DeviceOomError,
                                                  SplitAndRetryOom)


@pytest.fixture(autouse=True)
def _clean_chaos_state():
    F.reset()
    RF.reset()
    R.reset_counts()
    yield
    F.reset()
    RF.reset()
    R.reset_counts()


def make_table(n=100, seed=0):
    r = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array([None if x % 7 == 0 else int(x)
                       for x in r.integers(0, 1000, n)], pa.int64()),
        "d": pa.array(r.normal(size=n)),
        "s": pa.array([f"w{i % 13}" for i in range(n)]),
    })


def both(n=100, seed=0):
    t = make_table(n, seed)
    return RBatch.from_arrow(t), PBatch.from_arrow(t, "cpu"), t


def same_buffers(rb, pb):
    """Bit for bit: the capacity, the row count and every column's padded
    values and validity."""
    assert (rb.num_rows, rb.capacity) == (pb.num_rows, pb.capacity)
    for rc, pc in zip(rb.columns, pb.columns):
        assert np.array_equal(np.asarray(rc.data), pc.data.numpy(),
                              equal_nan=True)
        assert np.array_equal(np.asarray(rc.validity), pc.validity.numpy())


# -- fault spec / injector ----------------------------------------------------

def test_fault_spec_grammar():
    spec = "oom:joins.build:2,transport:fetch:1@3,splitoom:agg.update:p0.5"
    got = [(e.kind, e.site, e.count, e.skip, e.prob)
           for e in F.parse_spec(spec)]
    assert got == [(e.kind, e.site, e.count, e.skip, e.prob)
                   for e in RF.parse_spec(spec)]
    assert got == [("oom", "joins.build", 2, 0, None),
                   ("transport", "fetch", 1, 3, None),
                   ("splitoom", "agg.update", 0, 0, 0.5)]
    for bad in ("oom:x", "nuke:x:1", "oom:x:y", "oom:x:1@"):
        with pytest.raises(ValueError):
            F.parse_spec(bad)


@pytest.mark.parametrize("kind", ["transport", "exec_kill", "hang",
                                  "cancel"])
def test_unported_kinds_are_refused(kind):
    with pytest.raises(NotImplementedError):
        F.configure(f"{kind}:x:1")
    assert not F.is_active()
    from spark_rapids_tpu_torch.session import TorchSession
    with pytest.raises(NotImplementedError):
        TorchSession({"spark.rapids.tpu.test.faults": f"{kind}:fetch:1"},
                     device="cpu")


def test_injector_counts_and_skip():
    F.configure("oom:x:2@1,error:y:1", seed=0)
    F.maybe_inject("oom", "x")                  # skipped (the @1)
    for _ in range(2):
        with pytest.raises(DeviceOomError):
            F.maybe_inject("oom", "x")
    F.maybe_inject("oom", "x")                  # exhausted
    F.maybe_inject("oom", "other-site")         # never armed
    F.maybe_inject("error", "x")                # kind mismatch
    with pytest.raises(RuntimeError):
        F.maybe_inject("error", "y")
    assert F.injected_log() == [("oom", "x"), ("oom", "x"), ("error", "y")]


def test_injector_seeded_probability_matches_the_reference():
    def schedule(mod, exc, seed, hits=50):
        mod.configure("oom:p.site:p0.3", seed=seed)
        fired = []
        for _ in range(hits):
            try:
                mod.maybe_inject("oom", "p.site")
                fired.append(False)
            except exc:
                fired.append(True)
        return fired

    a = schedule(F, DeviceOomError, 11)
    assert a == schedule(F, DeviceOomError, 11)
    assert a == schedule(RF, RR.DeviceOomError, 11)
    assert any(a) and not all(a)
    assert schedule(F, DeviceOomError, 12) != a


def test_disk_full_and_slow_kinds():
    F.configure("disk_full:spill.write:1,slow:s:1")
    with pytest.raises(R.SpillCapacityError) as ei:
        F.maybe_inject("disk_full", "spill.write")
    assert ei.value.retryable and ei.value.injected
    F.maybe_inject("oom", "s")                  # slow: sleeps, no raise
    assert F.injected_log() == [("disk_full", "spill.write"), ("slow", "s")]


# -- split / retry framework --------------------------------------------------

@pytest.mark.parametrize("n", [2, 17, 101, 256])
def test_split_batch_bit_for_bit(n):
    rb, pb, t = both(n, seed=n)
    rh, ph = RR.split_batch(rb), R.split_batch(pb)
    assert [h.num_rows for h in ph] == [n // 2, n - n // 2]
    for a, b in zip(rh, ph):
        same_buffers(a, b)
    got = pa.concat_tables([h.to_arrow() for h in ph])
    assert got.to_pylist() == t.to_pylist()


def test_split_batch_floors():
    _, b, _ = both(101)
    assert R.split_batch(b, floor_bytes=b.device_memory_size()) is None
    assert R.split_batch(both(1)[1]) is None
    # a nested column refuses to split, as the reference's list vectors do
    nested = PBatch.from_arrow(pa.table({"l": pa.array([[1], [2, 3]])}),
                               "cpu")
    assert R.split_batch(nested) is None


def test_with_retry_splits_then_recovers():
    rb, pb, t = both(64, seed=3)
    F.configure("oom:site.z:2", seed=0)
    RF.configure("oom:site.z:2", seed=0)
    pieces = list(R.with_retry([pb], lambda x: x, scope="site.z",
                               split_floor_bytes=1))
    rpieces = list(RR.with_retry([rb], lambda x: x, scope="site.z",
                                 split_floor_bytes=1))
    assert [p.num_rows for p in pieces] == [16, 16, 32]
    for a, b in zip(rpieces, pieces):
        same_buffers(a, b)
    got = pa.concat_tables([p.to_arrow() for p in pieces])
    assert got.to_pylist() == t.to_pylist()
    assert R.counts["oom_retries"] == 2 and R.counts["split_retries"] == 2


def test_with_retry_floor_allows_one_spill_retry_then_raises():
    _, b, _ = both(64)
    F.configure("oom:site.w:99", seed=0)
    with pytest.raises(DeviceOomError):
        list(R.with_retry([b], lambda x: x, scope="site.w",
                          split_floor_bytes=1 << 30))
    assert R.counts["split_retries"] == 0 and R.counts["oom_retries"] == 2


def test_split_and_retry_oom_skips_spill_only_retry():
    _, b, _ = both(64)
    F.configure("splitoom:site.v:99", seed=0)
    with pytest.raises(SplitAndRetryOom):
        list(R.with_retry([b], lambda x: x, scope="site.v",
                          splittable=False))
    assert R.counts["oom_retries"] == 1


def test_with_retry_max_splits_bound():
    _, b, _ = both(64)
    F.configure("oom:site.m:99", seed=0)
    with pytest.raises(DeviceOomError):
        list(R.with_retry([b], lambda x: x, scope="site.m",
                          max_splits=2, split_floor_bytes=1))
    assert R.counts["split_retries"] == 2


def test_with_restore_on_retry_rolls_back():
    class Acc:
        def __init__(self):
            self.vals = []
            self._ckpt = None

        def checkpoint(self):
            self._ckpt = list(self.vals)

        def restore(self):
            self.vals = list(self._ckpt)

    acc = Acc()
    F.configure("oom:site.r:1", seed=0)
    _, b, _ = both(16)

    def fn(x):
        with R.with_restore_on_retry(acc):
            acc.vals.append(x.num_rows)   # a side effect before the OOM
            F.maybe_inject("oom", "site.r")
            return x.num_rows

    out = list(R.with_retry([b], fn, split_floor_bytes=1))
    assert acc.vals == [8, 8] and sum(out) == 16


def test_call_with_retry_spill_only():
    F.configure("oom:site.c:2", seed=0)
    calls = []

    def thunk():
        calls.append(1)
        F.maybe_inject("oom", "site.c")
        return "ok"

    assert R.call_with_retry(thunk) == "ok"
    assert len(calls) == 3 and R.counts["oom_retries"] == 2


def test_torch_out_of_memory_becomes_a_split():
    """An allocation failure inside the attempt (``torch.cuda.
    OutOfMemoryError``) is mapped to a retryable DeviceOomError there and
    nowhere else: the batch splits and the halves run clean."""
    _, b, t = both(64, seed=4)
    failed = []

    def fn(x):
        if not failed:
            failed.append(x.num_rows)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return x

    pieces = list(R.with_retry([b], fn, split_floor_bytes=1))
    assert failed == [64] and [p.num_rows for p in pieces] == [32, 32]
    assert pa.concat_tables([p.to_arrow() for p in pieces]).equals(t)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        raise torch.cuda.OutOfMemoryError("outside any attempt")


def test_register_with_retry_splits_oversized_batch():
    rb, pb, t = both(256, seed=5)
    kw = dict(device_budget=int(pb.device_memory_size() * 0.6),
              host_budget=1 << 30)
    pieces = R.register_with_retry(pb, 100.0, catalog=PM.BufferCatalog(**kw),
                                   split_floor_bytes=1)
    rpieces = RR.register_with_retry(rb, 100.0,
                                     catalog=RM.BufferCatalog(**kw),
                                     split_floor_bytes=1)
    assert [p.num_rows for p in pieces] == [p.num_rows for p in rpieces]
    assert len(pieces) >= 2
    got = pa.concat_tables([p.get_batch().to_arrow() for p in pieces])
    assert got.to_pylist() == t.to_pylist()
    assert R.counts["split_retries"] >= 1
    cat = pieces[0].catalog
    for p in pieces + rpieces:
        p.close()
    assert cat.num_buffers == 0


def test_spill_for_retry_frees_lower_priority_buffers(tmp_path):
    _, b0, _ = both(128, seed=1)
    cat = PM.BufferCatalog(device_budget=b0.device_memory_size(),
                           host_budget=1 << 30, spill_dir=str(tmp_path))
    bid = cat.add_batch(b0, PM.OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY)
    assert cat.get_tier(bid) == "DEVICE"
    R._spill_for_retry(cat)
    assert cat.get_tier(bid) != "DEVICE"
    assert R.counts["spill_bytes"] == b0.device_memory_size()


# -- operator-level recovery through both sessions ---------------------------

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Numpy-seeded parquet files with 64-row row groups and no
    dictionaries, so every operator sees several plain batches."""
    d = tmp_path_factory.mktemp("retry_tables")
    r = np.random.default_rng(7)
    n = 600
    fact = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64) % 40),
        "g": pa.array(r.integers(0, 23, n), pa.int64()),
        "v": pa.array(r.integers(-1000, 1000, n), pa.int64()),
        "x": pa.array(np.arange(n, dtype=np.float64)),
    })
    dim = pa.table({"k": pa.array(np.arange(40, dtype=np.int64)),
                    "w": pa.array(np.arange(40, dtype=np.int64) * 10)})
    out = {}
    for name, t in (("fact", fact), ("dim", dim)):
        p = str(d / f"{name}.parquet")
        pq.write_table(t, p, row_group_size=64, use_dictionary=False)
        out[name] = p
    return out


def _sessions(extra=None):
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import TorchSession
    conf = {"spark.rapids.tpu.memory.retry.splitFloorBytes": "1b"}
    conf.update(extra or {})
    port = TorchSession(conf, device="cpu")
    ref = TpuSession(conf)
    return port, ref


def _rows(table):
    return table.to_pylist()


def _join(spark, tables):
    f = spark.read_parquet(tables["fact"])
    d = spark.read_parquet(tables["dim"])
    return f.join(d, on="k").select("k", "g", "v", "w")


def _group(spark, tables):
    import importlib
    F_ = importlib.import_module(type(spark).__module__.rsplit(".", 1)[0]
                                 + ".functions")
    f = spark.read_parquet(tables["fact"])
    return (f.group_by("g").agg(F_.sum(F_.col("v")).alias("sv"),
                                F_.count(F_.col("v")).alias("n"))
            .sort("g"))


def _sort(spark, tables):
    return spark.read_parquet(tables["fact"]).select("v", "k").sort("v", "k")


CASES = {
    "join": (_join, "oom:joins.build:1,oom:joins.gather:2",
             [("oom", "joins.build"), ("oom", "joins.gather"),
              ("oom", "joins.gather")]),
    "group-by": (_group, "oom:agg.update:2,oom:agg.merge:1",
                 [("oom", "agg.update"), ("oom", "agg.update"),
                  ("oom", "agg.merge")]),
    "sort": (_sort, "oom:sort.sort:1", [("oom", "sort.sort")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_chaos_bit_identical(tables, case):
    build, spec, fired = CASES[case]
    port, ref = _sessions()
    clean = _rows(build(port, tables).collect())
    ref_clean = _rows(build(ref, tables).collect())
    key = (lambda r: tuple(r.values())) if case == "join" else None
    if key is not None:
        assert sorted(clean, key=key) == sorted(ref_clean, key=key)
    else:
        assert clean == ref_clean
    port, ref = _sessions({"spark.rapids.tpu.test.faults": spec})
    got = _rows(build(port, tables).collect())
    assert F.injected_log() == fired
    ref_got = _rows(build(ref, tables).collect())
    assert RF.injected_log() == fired
    assert got == clean
    assert ref_got == ref_clean
    assert R.counts["oom_retries"] == len(fired)


def test_group_by_chain_oom_falls_back_and_stays_bit_identical(tables):
    """oom:agg.chain fires in the chained step; its DeviceOomError sends the
    batch to the splittable update loop, with the same rows."""
    port, _ = _sessions()
    clean = _rows(_group(port, tables).collect())
    spec = "splitoom:agg.chain:2"
    port, _ = _sessions({"spark.rapids.tpu.test.faults": spec,
                         "spark.rapids.tpu.sql.stageFusion.groupBy.chain."
                         "enabled": "true"})
    got = _rows(_group(port, tables).collect())
    assert got == clean
    assert F.injected_log() == [("splitoom", "agg.chain")] * 2


# -- the exchange: map OOM splits, block writes retry -------------------------

SF = 0.002


@pytest.fixture(scope="module")
def tpch_paths(tmp_path_factory):
    from spark_rapids_tpu.benchmarks import tpch as jtpch
    return jtpch.generate(SF, str(tmp_path_factory.mktemp("tpch_retry")))


def _files(paths):
    d = paths["lineitem"]
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".parquet"))


def _q1_files(spark, paths, q1):
    return q1({"lineitem": spark.read_parquet(_files(paths))})


def test_q1_files_chaos_bit_identical(tpch_paths):
    """q1 over one partition per file under
    ``splitoom:exchange.map:2,oom:agg.merge:1,oom:exchange.write:1``: the
    port's rows bit for bit its clean run's, the reference's the same with
    the same schedule, and the two packages within q1's float tolerance."""
    from spark_rapids_tpu.benchmarks import tpch as jtpch
    from spark_rapids_tpu_torch.benchmarks import tpch
    extra = {"spark.rapids.tpu.sql.localScheduler.numThreads": "1"}
    port, ref = _sessions(extra)
    clean = _rows(_q1_files(port, tpch_paths, tpch.q1).collect())
    ref_clean = _rows(_q1_files(ref, tpch_paths, jtpch.q1).collect())
    spec = "splitoom:exchange.map:2,oom:agg.merge:1,oom:exchange.write:1"
    port, ref = _sessions({**extra, "spark.rapids.tpu.test.faults": spec})
    got = _rows(_q1_files(port, tpch_paths, tpch.q1).collect())
    ref_got = _rows(_q1_files(ref, tpch_paths, jtpch.q1).collect())
    assert got == clean and ref_got == ref_clean
    assert sorted(F.injected_log()) == sorted(RF.injected_log())
    assert F.injected_log().count(("splitoom", "exchange.map")) == 2
    assert R.counts["split_retries"] == 2
    assert len(got) == len(ref_got) == 4
    for g, e in zip(got, ref_got):
        for (kg, a), (ke, b) in zip(g.items(), e.items()):
            assert kg == ke
            if isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b
