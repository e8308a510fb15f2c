"""The exchange's remainder in the port, held against the reference on the
CPU: the serializing shuffle's frame (``shuffle/serialization.py``), the
block store's remainder (``shuffle/manager.py``), the range exchange
(``shuffle/partitioning.RangePartitioner``, ``range_part_ids``) and the
fetch-failure recompute of ``exec/exchange.py``.

- ``serialize_batch`` is byte for byte the reference's for every flat type
  with nulls and a string dictionary, and a frame written by either
  package reads back in the other to the same arrow table;
- the serializing shuffle's q1 over one partition per file is bit for bit
  the device shuffle's;
- the range partitioner's bounds and part ids are bit for bit the
  reference's, and a range exchange followed by a local sort, read in
  partition order, equals a global sort and ``TpuSession``'s;
- a block lost before the first batch (a spill file whose CRC fails, an
  unregistered shuffle) recomputes the map outputs, bit for bit; the
  ladder is bounded by ``shuffle.fetch.maxRetries``.

Inputs are numpy-seeded. Tolerance: exact everywhere (q1 compared within one
package).
"""

import decimal
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.shuffle import serialization as RS
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.runtime import faults as F
from spark_rapids_tpu_torch.runtime import memory as PM
from spark_rapids_tpu_torch.shuffle import serialization as S
from spark_rapids_tpu_torch.shuffle.manager import ShuffleBlockStore


@pytest.fixture(autouse=True)
def _clean():
    F.reset()
    yield
    F.reset()


def flat_table(n=77, seed=0):
    r = np.random.default_rng(seed)

    def nulls(values, typ):
        mask = r.random(n) < 0.2
        return pa.array(values, typ, mask=mask)

    return pa.table({
        "bo": nulls(r.random(n) < 0.5, pa.bool_()),
        "i8": nulls(r.integers(-100, 100, n).astype(np.int8), pa.int8()),
        "i16": nulls(r.integers(-3000, 3000, n).astype(np.int16),
                     pa.int16()),
        "i32": nulls(r.integers(-10**9, 10**9, n).astype(np.int32),
                     pa.int32()),
        "i64": nulls(r.integers(-10**15, 10**15, n), pa.int64()),
        "f32": nulls(r.normal(size=n).astype(np.float32), pa.float32()),
        "f64": nulls(r.normal(size=n), pa.float64()),
        "s": pa.array([None if i % 6 == 0 else ["ab", "é", "日本", ""][i % 4]
                       for i in range(n)]),
        "d": nulls(r.integers(-10**5, 10**5, n).astype(np.int32),
                   pa.int32()).cast(pa.date32()),
        "ts": nulls(r.integers(-10**15, 10**15, n),
                    pa.int64()).cast(pa.timestamp("us", tz="UTC")),
        "dec": pa.array([None if v % 9 == 0 else
                         decimal.Decimal(int(v)).scaleb(-3)
                         for v in r.integers(-10**12, 10**12, n)],
                        pa.decimal128(18, 3)),
    })


@pytest.mark.parametrize("n", [0, 1, 77, 1000])
def test_serialize_batch_byte_for_byte(n):
    t = flat_table(n, seed=n)
    blob = S.serialize_batch(PBatch.from_arrow(t, "cpu"))
    assert blob == RS.serialize_batch(RBatch.from_arrow(t))


def test_frames_read_back_across_packages():
    t = flat_table(300, seed=4)
    pblob = S.serialize_batch(PBatch.from_arrow(t, "cpu"))
    rblob = RS.serialize_batch(RBatch.from_arrow(t))
    assert S.deserialize_batch(rblob).to_arrow().equals(t)
    assert RS.deserialize_batch(pblob).to_arrow().equals(t)
    back = S.deserialize_batch(pblob)
    ref = RS.deserialize_batch(rblob)
    assert back.capacity == ref.capacity
    for a, b in zip(back.columns, ref.columns):
        assert np.array_equal(a.data.numpy(), np.asarray(b.data),
                              equal_nan=True)
        assert np.array_equal(a.validity.numpy(), np.asarray(b.validity))


def test_type_codes_are_the_reference():
    from spark_rapids_tpu import types as RT
    from spark_rapids_tpu_torch import types as PT
    for p, r in ((PT.BOOLEAN, RT.BOOLEAN), (PT.LONG, RT.LONG),
                 (PT.STRING, RT.STRING), (PT.TIMESTAMP, RT.TIMESTAMP),
                 (PT.DecimalType(18, 3), RT.DecimalType(18, 3))):
        assert S.type_code(p) == RT.type_code(r)
        assert S.type_from_code(S.type_code(p)) == p
    with pytest.raises(NotImplementedError):
        S.type_code(PT.ArrayType(PT.LONG))


# -- the block store's remainder ---------------------------------------------

def _batch(vals):
    return PBatch.from_arrow(pa.table({"v": pa.array(vals, pa.int64())}),
                             "cpu")


@pytest.mark.parametrize("serialized", [False, True])
def test_block_store_keys_sizes_and_drops(serialized):
    PM.DeviceManager.initialize(device="cpu")
    cat = PM.DeviceManager.get().catalog
    store = ShuffleBlockStore()
    sid = store.register_shuffle(serialized=serialized)
    blocks = {(0, 2): [1, 2], (1, 1): [3], (0, 1): [4, 5, 6], (1, 2): [7]}
    for (split, seq), vals in blocks.items():
        store.write_block(sid, 0, _batch(vals), seq=(split, seq))
    store.write_block(sid, 1, _batch([9]), seq=(1, 1))
    assert store.partition_keys(sid, 0) == [(0, 1), (0, 2), (1, 1), (1, 2)]
    got = [b.to_arrow()["v"].to_pylist()
           for b in store.read_partition(sid, 0)]
    assert got == [[4, 5, 6], [1, 2], [3], [7]]
    sizes = store.partition_sizes(sid, 2)
    if serialized:
        assert sizes[1] == len(S.serialize_batch(_batch([9])))
        assert cat.num_buffers == 0
    else:
        assert sizes[1] == _batch([9]).device_memory_size()
        assert cat.num_buffers == 5
    by_split = [store.split_partition_sizes(sid, 2, s) for s in (0, 1)]
    assert [a + b for a, b in zip(*by_split)] == sizes
    assert store.drop_map_output(sid, 1) == 3
    assert store.partition_keys(sid, 0) == [(0, 1), (0, 2)]
    assert store.partition_keys(sid, 1) == []
    store.unregister_shuffle(sid)
    assert cat.num_buffers == 0 and store.num_shuffles() == 0
    sid2 = store.register_shuffle(serialized=serialized)
    store.write_block(sid2, 0, _batch([1]), seq=(0, 1))
    store.clear_all()
    assert cat.num_buffers == 0


def test_blocks_are_spillable_shuffle_output(tmp_path):
    """A block is registered at OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY under
    "exchange.block": it spills before an on-deck batch."""
    cat = PM.BufferCatalog(device_budget=1 << 30, host_budget=1 << 30,
                           spill_dir=str(tmp_path))
    dm = PM.DeviceManager.initialize(device="cpu")
    dm.catalog = cat
    try:
        store = ShuffleBlockStore()
        sid = store.register_shuffle()
        store.write_block(sid, 0, _batch(list(range(100))), seq=(0, 1))
        deck = cat.add_batch(_batch(list(range(100))))
        (blk,) = [b for b in cat._buffers.values() if b.buffer_id != deck]
        assert blk.site == "exchange.block"
        assert blk.priority == PM.OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY
        cat.synchronous_spill(cat.device_bytes - 1)
        assert cat.get_tier(blk.buffer_id) == "HOST"
        assert cat.get_tier(deck) == "DEVICE"
        assert [b.to_arrow()["v"].to_pylist() for b in
                store.read_partition(sid, 0)] == [list(range(100))]
        store.unregister_shuffle(sid)
        cat.remove(deck)
        assert cat.num_buffers == 0
    finally:
        PM.DeviceManager.reset()


# -- the serializing shuffle --------------------------------------------------

SF = 0.002


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    from spark_rapids_tpu_torch.benchmarks import tpch
    return tpch.generate(SF, str(tmp_path_factory.mktemp("tpch_shuffle")))


def _files(paths):
    d = paths["lineitem"]
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".parquet"))


def _exchanges(plan):
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    out = [plan] if isinstance(plan, ShuffleExchangeExec) else []
    for c in plan.children:
        out += _exchanges(c)
    return out


@pytest.mark.parametrize("pipeline", [False, True])
def test_serializing_shuffle_q1_bit_for_bit(paths, pipeline):
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.session import TorchSession
    base = {"spark.rapids.tpu.pipeline.enabled": pipeline}
    dev = TorchSession(base, device="cpu")
    clean = tpch.q1({"lineitem": dev.read_parquet(_files(paths))}).collect()
    ser = TorchSession({**base, "spark.rapids.tpu.shuffle.enabled": "false"},
                       device="cpu")
    df = tpch.q1({"lineitem": ser.read_parquet(_files(paths))})
    plan = df.physical_plan()
    got = plan.execute_collect()
    assert got.equals(clean)
    (ex,) = _exchanges(plan)
    assert ex.map_batches >= 1 and sum(ex.partition_sizes) > 0
    assert PM.DeviceManager.get().catalog.num_buffers == 0


# -- the range exchange -------------------------------------------------------

def _range_table(n=3000, seed=1):
    r = np.random.default_rng(seed)
    return pa.table({
        "x": pa.array(np.where(r.random(n) < 0.05, np.nan,
                               np.round(r.normal(size=n), 3))),
        "k": pa.array(r.integers(0, 50, n), pa.int64(),
                      mask=r.random(n) < 0.1),
        "s": pa.array([f"name{int(v)}" for v in r.integers(0, 300, n)]),
    })


@pytest.mark.parametrize("keys,orders", [
    (["x"], [(True, None)]),
    (["k", "x"], [(True, None), (False, None)]),
    (["s"], [(True, None)]),
    (["k"], [(False, True)]),
])
@pytest.mark.parametrize("nparts", [2, 8])
def test_range_bounds_and_part_ids_bit_for_bit(keys, orders, nparts):
    from spark_rapids_tpu import types as RT
    from spark_rapids_tpu.expr import core as RE
    from spark_rapids_tpu.ops.sorting import SortOrder as RSO
    from spark_rapids_tpu.shuffle import partitioning as RP
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.ops.sorting import SortOrder
    from spark_rapids_tpu_torch.shuffle import partitioning as SP
    t = _range_table()
    samples = [t.slice(0, 700), t.slice(700, 900)]
    pt = SP.RangePartitioner([E.col(k) for k in keys],
                             [SortOrder(a, nf) for a, nf in orders], nparts)
    rt = RP.RangePartitioner([RE.col(k) for k in keys],
                             [RSO(a, nf) for a, nf in orders], nparts)
    schema_p = PBatch.from_arrow(t, "cpu").schema
    schema_r = RBatch.from_arrow(t).schema
    pt.bind(schema_p)
    rt.bind(schema_r)
    pt.set_bounds_from_sample([PBatch.from_arrow(s, "cpu") for s in samples])
    rt.set_bounds_from_sample([RBatch.from_arrow(s) for s in samples])
    for pb, rb in zip(pt._bounds, rt._bounds):
        assert np.array_equal(pb.values.numpy(), np.asarray(rb.values),
                              equal_nan=True)
        assert np.array_equal(pb.validity.numpy(), np.asarray(rb.validity))
    whole_p = PBatch.from_arrow(t, "cpu")
    ids = pt.part_ids(whole_p).numpy()[:t.num_rows]
    rids = np.asarray(rt.part_ids(RBatch.from_arrow(t)))[:t.num_rows]
    assert np.array_equal(ids, rids)
    assert ids.min() >= 0 and ids.max() < nparts
    assert len(set(ids.tolist())) > 1
    del RT


def _range_sorted(spark, fns, t, nparts, ascending=True):
    from importlib import import_module
    pkg = type(spark).__module__.rsplit(".", 1)[0]
    NN = import_module(pkg + ".plan.nodes")
    DataFrame = import_module(pkg + ".session").DataFrame
    df = spark.create_dataframe(t, num_partitions=3)
    ranged = DataFrame(NN.ExchangeNode(df._plan, "range", nparts,
                                       keys=[fns.col("x")]), spark)
    return ranged.sort_within_partitions("x", "k")


def test_range_exchange_then_local_sort_is_a_global_sort():
    import spark_rapids_tpu.functions as RF_
    import spark_rapids_tpu_torch.functions as F_
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import TorchSession
    t = _range_table(4000, seed=6).drop_columns(["s"])
    df = _range_sorted(TorchSession(device="cpu"), F_, t, 8)
    plan = df.physical_plan()
    got = plan.execute_collect()
    (ex,) = _exchanges(plan)
    assert ex.num_partitions == 8 and ex.map_batches >= 3
    # Spark's order: nulls first, NaN above every number
    xs = np.asarray(got["x"].to_pylist(), dtype=np.float64)
    finite = xs[~np.isnan(xs)]
    assert np.all(np.diff(finite) >= 0)
    assert np.all(np.isnan(xs[len(finite):]))
    whole = TorchSession(device="cpu").create_dataframe(t).sort("x", "k")
    # repr: NaN equals NaN, and -0.0 differs from 0.0
    assert repr(got.to_pylist()) == repr(whole.collect().to_pylist())
    ref = _range_sorted(TpuSession(), RF_, t, 8).collect()
    assert repr(got.to_pylist()) == repr(ref.to_pylist())
    assert PM.DeviceManager.get().catalog.num_buffers == 0


# -- fetch failure → recompute ----------------------------------------------

def _q1_spill_session(tmp, limit, extra=None):
    from spark_rapids_tpu_torch.session import TorchSession
    conf = {"spark.rapids.tpu.memory.hbm.limitBytes": str(limit),
            "spark.rapids.tpu.memory.host.spillStorageSize": "0",
            "spark.rapids.tpu.memory.spill.dirs": str(tmp),
            "spark.rapids.tpu.sql.localScheduler.numThreads": "1"}
    conf.update(extra or {})
    return TorchSession(conf, device="cpu")


def _q1_repartition(spark, paths):
    from spark_rapids_tpu_torch.benchmarks import tpch
    li = spark.read_parquet(paths["lineitem"]).repartition(
        8, "l_returnflag", "l_linestatus")
    return tpch.q1({"lineitem": li})


def test_spill_to_disk_and_corrupt_block_recomputes(paths, tmp_path):
    """q1-repartition's blocks spill to disk under a small budget; one spill
    payload is corrupted after its CRC, the reduce read detects it before
    its first batch, and the exchange recomputes the map outputs: the rows
    are bit for bit the unspilled run's."""
    from spark_rapids_tpu_torch.session import TorchSession
    clean = _q1_repartition(TorchSession(device="cpu"), paths).collect()
    # the pipeline off: its queued batches would spill too, and the first
    # payload written to disk must be a block
    spark = _q1_spill_session(tmp_path, 1, {
        "spark.rapids.tpu.memory.hbm.strictBudget": "false",
        "spark.rapids.tpu.pipeline.enabled": "false",
        "spark.rapids.tpu.test.faults": "corrupt:spill.write:1"})
    df = _q1_repartition(spark, paths)
    plan = df.physical_plan()
    got = plan.execute_collect()
    assert got.equals(clean)
    assert F.injected_log() == [("corrupt", "spill.write")]
    repart = [e for e in _exchanges(plan) if e.child.num_partitions == 1]
    assert sum(e.recomputes for e in _exchanges(plan)) == 1
    assert sum(e.map_runs for e in _exchanges(plan)) == 3
    counts = PM.DeviceManager.get().catalog.spill_counts()
    assert counts["to_disk_buffers"] > 0 and counts["from_disk_buffers"] > 0
    assert repart and PM.DeviceManager.get().catalog.num_buffers == 0


def test_lost_shuffle_recomputes_and_the_ladder_is_bounded(paths):
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.shuffle.transport import TransportError
    spark = TorchSession({"spark.rapids.tpu.shuffle.fetch.maxRetries": "1",
                          "spark.rapids.tpu.pipeline.enabled": "false",
                          "spark.rapids.tpu.sql.localScheduler.numThreads":
                          "1"}, device="cpu")
    clean = _q1_repartition(spark, paths).collect()
    plan = _q1_repartition(spark, paths).physical_plan()
    ex = [e for e in _exchanges(plan) if e.child.num_partitions == 1][0]
    store = ShuffleBlockStore.get()
    real = store.read_partition
    lost = {"n": 0}

    def flaky(sid, pid, limit=1):
        if lost["n"] < limit:
            lost["n"] += 1
            store.unregister_shuffle(sid)      # every block lost
        return real(sid, pid)

    store.read_partition = flaky
    try:
        assert plan.execute_collect().equals(clean)
        assert ex.recomputes == 1 and ex.map_runs == 2
        plan = _q1_repartition(spark, paths).physical_plan()
        ex = [e for e in _exchanges(plan) if e.child.num_partitions == 1][0]
        lost["n"] = -5                         # more losses than retries
        with pytest.raises(RuntimeError) as ei:
            plan.execute_collect()
        # raised in the upper exchange's map task, which wraps it
        err = ei.value
        while err is not None and not isinstance(err, TransportError):
            err = err.__cause__
        assert isinstance(err, TransportError), ei.value
        assert ex.map_runs == 2
    finally:
        store.read_partition = real
