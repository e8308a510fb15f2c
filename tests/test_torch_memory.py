"""The port's memory runtime (``spark_rapids_tpu_torch/runtime/memory.py``,
``direct_spill.py``) against the reference's (``spark_rapids_tpu/runtime``).

The cases of the reference's ``tests/test_memory.py`` run through both
catalogs with the same budgets on the same numpy-seeded batches: the tier
of every buffer, the bytes in each tier and the bytes spilled must be
equal, and every batch read back from any tier equal to the one
registered, bit for bit (arrow ``equals``). The port's own cases send
nested, encoded and decimal columns through all three tiers, drive the
direct store, and show the spill checksum catching a flipped byte in both
packages.
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
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.runtime import faults as PF
from spark_rapids_tpu_torch.runtime import memory as PM
from spark_rapids_tpu_torch.runtime.retry import DeviceOomError


@pytest.fixture(autouse=True)
def _clean_faults():
    PF.reset()
    RF.reset()
    yield
    PF.reset()
    RF.reset()


def make_table(n=100, seed=0):
    r = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(r.integers(0, 1000, n), type=pa.int64()),
        "b": pa.array(r.normal(size=n)),
        "s": pa.array([["x", "yy", "zzz"][i % 3] for i in range(n)]),
    })


def both(n=100, seed=0):
    t = make_table(n, seed)
    return RBatch.from_arrow(t), PBatch.from_arrow(t, "cpu"), t


def catalogs(**kw):
    return RM.BufferCatalog(**kw), PM.BufferCatalog(**kw)


def same_state(rc, pc):
    assert (rc.device_bytes, rc.host_bytes, rc.spilled_to_host_bytes,
            rc.spilled_to_disk_bytes) == (pc.device_bytes, pc.host_bytes,
                                          pc.spilled_to_host_bytes,
                                          pc.spilled_to_disk_bytes)


def test_device_sizes_equal_the_reference():
    rb, pb, _ = both()
    assert rb.device_memory_size() == pb.device_memory_size()
    assert RM.batch_to_host(rb).nbytes() == PM.batch_to_host(pb).nbytes()


def test_add_and_acquire_roundtrip(tmp_path):
    rb, pb, t = both()
    for cat, b in zip(catalogs(device_budget=1 << 30, host_budget=1 << 30,
                               spill_dir=str(tmp_path)), (rb, pb)):
        bid = cat.add_batch(b)
        assert cat.get_tier(bid) == "DEVICE"
        assert cat.acquire_batch(bid).to_arrow().equals(t)
        cat.remove(bid)
        assert cat.num_buffers == 0 and cat.device_bytes == 0


def test_budget_spills_to_host_then_disk(tmp_path):
    one = both()[1].device_memory_size()
    kw = dict(device_budget=int(one * 2.5), host_budget=int(one * 1.2))
    rc = RM.BufferCatalog(spill_dir=str(tmp_path / "r"), **kw)
    pc = PM.BufferCatalog(spill_dir=str(tmp_path / "p"), **kw)
    rids = [rc.add_batch(both(seed=i)[0]) for i in range(4)]
    pids = [pc.add_batch(both(seed=i)[1]) for i in range(4)]
    tiers = [pc.get_tier(i) for i in pids]
    assert tiers == [rc.get_tier(i) for i in rids]
    assert tiers.count("DEVICE") <= 2 and "DISK" in tiers
    assert pc.device_bytes <= pc.device_budget
    assert pc.host_bytes <= pc.host_budget
    same_state(rc, pc)
    for i, bid in enumerate(pids):
        assert pc.acquire_batch(bid).to_arrow().equals(both(seed=i)[2])
    assert pc.spilled_to_host_bytes > 0


def test_spill_priority_order(tmp_path):
    one = both()[1].device_memory_size()
    for cat, k, mod in zip(catalogs(device_budget=one * 10,
                                    host_budget=one * 10,
                                    spill_dir=str(tmp_path)), (0, 1),
                           (RM, PM)):
        sid = cat.add_batch(both(seed=1)[k],
                            priority=mod.OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY)
        aid = cat.add_batch(both(seed=2)[k],
                            priority=mod.ACTIVE_ON_DECK_PRIORITY)
        assert cat.synchronous_spill(int(one * 1.5)) == one
        assert cat.get_tier(sid) != "DEVICE"
        assert cat.get_tier(aid) == "DEVICE"


def test_unspill_promotes_back(tmp_path):
    rb, pb, t = both()
    one = pb.device_memory_size()
    rc, pc = catalogs(device_budget=one * 10, host_budget=one * 10,
                      spill_dir=str(tmp_path), unspill=True)
    for cat, b in ((rc, rb), (pc, pb)):
        bid = cat.add_batch(b)
        cat.synchronous_spill(0)
        assert cat.get_tier(bid) == "HOST"
        assert cat.acquire_batch(bid).to_arrow().equals(t)
        assert cat.get_tier(bid) == "DEVICE"
    same_state(rc, pc)


def test_spillable_columnar_batch_lifecycle():
    PM.DeviceManager.reset()
    _, pb, t = both()
    scb = PM.SpillableColumnarBatch(pb)
    try:
        assert scb.num_rows == 100
        assert scb.size == pb.device_memory_size()
        assert scb.get_batch().to_arrow().equals(t)
    finally:
        scb.close()
    with pytest.raises(PM.BufferClosedError):
        scb.get_batch()


def test_spill_callback_feeds_metrics(tmp_path):
    rb, pb, _ = both()
    one = pb.device_memory_size()
    seen = {}
    for name, cat, b in zip("rp", catalogs(device_budget=one * 10,
                                           host_budget=one * 10,
                                           spill_dir=str(tmp_path)),
                            (rb, pb)):
        seen[name] = []
        cat.add_batch(b, spill_callback=seen[name].append)
        cat.synchronous_spill(0)
    assert seen["p"] == seen["r"] == [one]


def test_oom_dump_dir_and_strict_raise(tmp_path):
    """A registration that cannot spill back under budget dumps the
    allocator state and raises a retryable DeviceOomError (strictBudget),
    rolling the registration back, in both packages."""
    from spark_rapids_tpu.runtime.retry import DeviceOomError as RDeviceOom
    for pkg, mod, exc, b in (("r", RM, RDeviceOom, both(64)[0]),
                             ("p", PM, DeviceOomError, both(64)[1])):
        d = tmp_path / pkg
        cat = mod.BufferCatalog(device_budget=1, host_budget=1 << 30,
                                oom_dump_dir=str(d))
        with pytest.raises(exc) as ei:
            cat.add_batch(b, mod.ACTIVE_ON_DECK_PRIORITY)
        assert ei.value.retryable and ei.value.budget == 1
        assert ei.value.requested == b.device_memory_size()
        assert "spillable" in str(ei.value)
        assert cat.num_buffers == 0 and cat.device_bytes == 0
        (dump,) = list(d.glob("hbm-oom-*.txt"))
        txt = dump.read_text()
        assert "device_bytes=" in txt and "buffer_id" in txt
        assert "tier=DEVICE spillable_bytes=" in txt


def test_lenient_budget_keeps_legacy_over_budget(tmp_path):
    rb, pb, t = both(64)
    for cat, b in zip(catalogs(device_budget=1, host_budget=1 << 30,
                               strict_budget=False,
                               oom_dump_dir=str(tmp_path)), (rb, pb)):
        bid = cat.add_batch(b)
        assert cat.get_tier(bid) == "DEVICE"
        assert cat.device_bytes > cat.device_budget
        assert cat.acquire_batch(bid).to_arrow().equals(t)


def test_direct_spill_store_roundtrip(tmp_path):
    """The batched aligned store: the same handles as the reference's for
    the same payloads, aligned offsets, shared batch files, refcounted
    deletion."""
    from spark_rapids_tpu.runtime.direct_spill import \
        DirectSpillStore as RStore
    from spark_rapids_tpu_torch.runtime.direct_spill import (ALIGN,
                                                             DirectSpillStore)
    payloads = [bytes([i]) * (100 + 1000 * i) for i in range(8)]
    st = DirectSpillStore(str(tmp_path / "p"), batch_bytes=1 << 14)
    rst = RStore(str(tmp_path / "r"), batch_bytes=1 << 14)
    handles = [st.write(p) for p in payloads]
    assert handles == [rst.write(p) for p in payloads]
    assert st.direct_active == rst.direct_active
    for h, p in zip(handles, payloads):
        assert h[1] % ALIGN == 0
        assert st.read(h) == p
    assert len({h[0] for h in handles}) < len(handles)
    for h in handles:
        st.delete(h)
    assert len(os.listdir(tmp_path / "p")) <= 1
    st.close()
    rst.close()


def test_direct_spill_through_catalog(tmp_path):
    one = both()[1].device_memory_size()
    kw = dict(device_budget=int(one * 1.2), host_budget=int(one * 0.5),
              direct_spill=True, direct_batch_bytes=1 << 16)
    rc = RM.BufferCatalog(spill_dir=str(tmp_path / "r"), **kw)
    pc = PM.BufferCatalog(spill_dir=str(tmp_path / "p"), **kw)
    rids = [rc.add_batch(both(seed=i)[0]) for i in range(4)]
    pids = [pc.add_batch(both(seed=i)[1]) for i in range(4)]
    tiers = [pc.get_tier(i) for i in pids]
    assert tiers == [rc.get_tier(i) for i in rids]
    assert "DISK" in tiers
    same_state(rc, pc)
    for i, bid in enumerate(pids):
        assert pc.acquire_batch(bid).to_arrow().equals(both(seed=i)[2])
    for bid in pids:
        pc.remove(bid)
    assert pc.num_buffers == 0 and pc.disk_bytes == 0


def test_direct_spill_with_unspill(tmp_path):
    one = both()[1].device_memory_size()
    pc = PM.BufferCatalog(device_budget=int(one * 1.2),
                          host_budget=int(one * 0.5), spill_dir=str(tmp_path),
                          direct_spill=True, unspill=True,
                          direct_batch_bytes=1 << 16)
    ids = [pc.add_batch(both(seed=i)[1]) for i in range(4)]
    disk = [bid for bid in ids if pc.get_tier(bid) == "DISK"]
    assert disk
    bid = disk[0]
    got = pc.acquire_batch(bid)
    assert pc.get_tier(bid) == "DEVICE"
    assert got.to_arrow().equals(both(seed=ids.index(bid))[2])
    for b in ids:
        pc.remove(b)


class _Tables:
    """A child exec over arrow tables, a batch each: the port's stand-in
    for the reference test's ArrowScanExec(batch_rows=...)."""

    def __new__(cls, tables):
        from spark_rapids_tpu_torch.exec.base import TorchExec

        class TablesExec(TorchExec):
            def __init__(self):
                super().__init__(device="cpu")

            @property
            def output(self):
                return PT.StructType([PT.StructField("v", PT.LONG)])

            @property
            def num_partitions(self):
                return len(tables)

            def execute_partition(self, split):
                t = tables[split]
                for off in range(0, t.num_rows, 250):
                    yield PBatch.from_arrow(t.slice(off, 250), "cpu",
                                            schema=self.output)
        return TablesExec()


def test_sort_spills_accumulated_inputs(tmp_path):
    """SortExec holds its input batches in the spill catalog while they
    accumulate: a budget of about one batch spills mid-sort, and each
    partition still comes out sorted."""
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.expr.core import col
    from spark_rapids_tpu_torch.ops.sorting import SortOrder
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 10000, 4000)
    tables = [pa.table({"v": pa.array(vals[i::4])}) for i in range(4)]
    scan = _Tables(tables)
    dm = PM.DeviceManager.initialize(device="cpu")
    dm.catalog = PM.BufferCatalog(device_budget=3000, host_budget=20000,
                                  spill_dir=str(tmp_path))
    try:
        ex = SortExec([col("v")], [SortOrder()], scan, global_sort=False)
        out = []
        for split in range(scan.num_partitions):
            for b in ex.execute_partition(split):
                out.extend(b.to_arrow()["v"].to_pylist())
        assert dm.catalog.spilled_to_host_bytes > 0
        assert dm.catalog.num_buffers == 0
        at = 0
        for t in tables:
            n = t.num_rows
            assert out[at:at + n] == sorted(t["v"].to_pylist())
            at += n
    finally:
        PM.DeviceManager.reset()


# -- the port's own extension of the tiers ----------------------------------

def _kinds_table(n=200, seed=3):
    r = np.random.default_rng(seed)
    lists = [None if i % 11 == 0 else
             [int(x) for x in r.integers(-50, 50, i % 4)] for i in range(n)]
    nested = [None if i % 13 == 0 else
              [[float(x) for x in r.normal(size=i % 3)]] for i in range(n)]
    return pa.table({
        "dec": pa.array([None if i % 7 == 0 else
                         (int(r.integers(-10**9, 10**9)) / 100)
                         for i in range(n)]).cast(pa.decimal128(12, 2)),
        "i8": pa.array(r.integers(-100, 100, n), pa.int8()),
        "i16": pa.array(r.integers(-3000, 3000, n), pa.int16()),
        "f32": pa.array(r.normal(size=n).astype(np.float32)),
        "ts": pa.array(r.integers(0, 10**15, n), pa.timestamp("us", tz="UTC")),
        "d": pa.array(r.integers(-10**4, 10**4, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        "s": pa.array([None if i % 5 == 0 else f"w{i % 17}"
                       for i in range(n)]),
        "arr": pa.array(lists, pa.list_(pa.int64())),
        "deep": pa.array(nested, pa.list_(pa.list_(pa.float64()))),
        "st": pa.array([{"x": i, "y": f"v{i % 3}"} if i % 6 else None
                        for i in range(n)],
                       pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "m": pa.array([[("k", i), ("j", -i)] if i % 4 else None
                       for i in range(n)], pa.map_(pa.string(), pa.int64())),
    })


@pytest.mark.parametrize("direct", [False, True])
def test_every_column_kind_through_three_tiers(tmp_path, direct):
    """Decimals, bytes, shorts, floats, dates, timestamps, dictionary
    strings and arrays, arrays of arrays, structs and maps: device → host →
    disk → back, the batch equal to the one registered."""
    t = _kinds_table()
    b = PBatch.from_arrow(t, "cpu")
    cat = PM.BufferCatalog(device_budget=1 << 30, host_budget=0,
                           spill_dir=str(tmp_path), direct_spill=direct)
    bid = cat.add_batch(b)
    size = b.device_memory_size()
    assert cat.synchronous_spill(0) == size
    assert cat.get_tier(bid) == "DISK"
    assert cat.spill_counts()["to_disk_buffers"] == 1
    back = cat.acquire_batch(bid)
    assert back.to_arrow().equals(t)
    assert [type(c) for c in back.columns] == [type(c) for c in b.columns]
    for c, d in zip(b.columns, back.columns):
        assert torch.equal(c.data, d.data)
        assert torch.equal(c.validity, d.validity)
    cat.remove(bid)
    assert (cat.device_bytes, cat.host_bytes, cat.disk_bytes) == (0, 0, 0)


def test_host_tier_keeps_every_kind(tmp_path):
    t = _kinds_table(seed=5)
    b = PBatch.from_arrow(t, "cpu")
    cat = PM.BufferCatalog(device_budget=1 << 30, host_budget=1 << 30,
                           spill_dir=str(tmp_path))
    bid = cat.add_batch(b)
    cat.synchronous_spill(0)
    assert cat.get_tier(bid) == "HOST"
    assert cat.acquire_batch(bid).to_arrow().equals(t)


@pytest.fixture
def encoded_file(tmp_path):
    r = np.random.default_rng(9)
    n = 3000
    t = pa.table({
        "k": pa.array(r.integers(0, 40, n), pa.int64()),
        "s": pa.array([f"name{i % 23}" for i in range(n)]),
        "x": pa.array(np.round(r.normal(size=n), 2)),
    })
    path = str(tmp_path / "enc.parquet")
    pq.write_table(t, path, use_dictionary=True, row_group_size=1000)
    return path, t


def test_encoded_vectors_spill_packed_and_decode_once(tmp_path,
                                                      encoded_file):
    """A still-encoded parquet chunk keeps its packed buffer through the
    host and disk tiers and is decoded once, at its first read after it
    comes back; a decoded one spills its dense arrays."""
    from spark_rapids_tpu_torch.columnar import encoded as EN
    from spark_rapids_tpu_torch.session import TorchSession
    path, t = encoded_file
    plan = TorchSession(device="cpu").read_parquet(path).physical_plan()
    batches = list(plan.execute_partition(0))
    enc = [c for b in batches for c in b.columns
           if isinstance(c, EN.EncodedColumnVector)]
    assert enc and all(c._mat is None for c in enc)
    cat = PM.BufferCatalog(device_budget=1 << 30, host_budget=0,
                           spill_dir=str(tmp_path))
    ids = [cat.add_batch(b) for b in batches]
    sizes = sum(b.device_memory_size() for b in batches)
    assert cat.synchronous_spill(0) == sizes
    assert all(cat.get_tier(i) == "DISK" for i in ids)
    want = pa.concat_tables([b.to_arrow() for b in batches])
    EN.reset_counts()
    back = [cat.acquire_batch(i) for i in ids]
    n_enc = sum(isinstance(c, EN.EncodedColumnVector) and c._mat is None
                for b in back for c in b.columns)
    assert n_enc == len(enc)
    assert EN.counts["decoded"] == 0
    got = pa.concat_tables([b.to_arrow() for b in back])
    assert got.equals(want)
    assert EN.counts["decoded"] == n_enc          # once each
    for b in back:                                 # a second read decodes
        b.to_arrow()                               # nothing again
    assert EN.counts["decoded"] == n_enc
    # the decoded vectors spill dense and come back plain
    ids2 = [cat.add_batch(b) for b in back]
    cat.synchronous_spill(0)
    again = [cat.acquire_batch(i) for i in ids2]
    assert not any(isinstance(c, EN.EncodedColumnVector)
                   for b in again for c in b.columns)
    assert pa.concat_tables([b.to_arrow() for b in again]).equals(got)
    assert got.sort_by("k").column("k").to_pylist() == sorted(
        t.column("k").to_pylist())


def test_checksum_catches_a_flipped_byte(tmp_path):
    """corrupt:spill.write flips a byte of the disk payload after its CRC:
    both packages raise SpillCorruptionError on unspill, and a clean spill
    reads back."""
    rb, pb, t = both()
    for pkg, mod, faults, b in (("r", RM, RF, rb), ("p", PM, PF, pb)):
        cat = mod.BufferCatalog(device_budget=1 << 30, host_budget=0,
                                spill_dir=str(tmp_path / pkg))
        faults.configure("corrupt:spill.write:1")
        bad = cat.add_batch(b)
        cat.synchronous_spill(0)
        assert faults.injected_log() == [("corrupt", "spill.write")]
        with pytest.raises(mod.SpillCorruptionError):
            cat.acquire_batch(bad)
        good = cat.add_batch(b)
        cat.synchronous_spill(0)
        assert cat.acquire_batch(good).to_arrow().equals(t)
        faults.reset()


def test_device_budget_from_conf():
    """limitBytes wins; else allocFraction of the CPU stand-in size, the
    reference's 16 GiB, so both packages' CPU tests compare equal
    budgets."""
    from spark_rapids_tpu import config as RC
    from spark_rapids_tpu_torch.config import RapidsConf
    assert PM.device_budget_bytes(RapidsConf(), "cpu") == int(
        (16 << 30) * 0.9)
    RM.DeviceManager.reset()
    try:
        ref = RM.DeviceManager.initialize(RC.RapidsConf()).catalog
        assert ref.device_budget == PM.device_budget_bytes(RapidsConf(),
                                                           "cpu")
    finally:
        RM.DeviceManager.reset()
    conf = RapidsConf({"spark.rapids.tpu.memory.hbm.limitBytes": "1m",
                       "spark.rapids.tpu.memory.host.spillStorageSize": "2k"})
    dm = PM.DeviceManager.initialize(conf, "cpu")
    assert (dm.catalog.device_budget, dm.catalog.host_budget) == (
        1 << 20, 2048)
    PM.DeviceManager.reset()


def test_finish_query_reclaims_a_leak():
    """leak:<site>:1 skips one release; the end-of-query check reports the
    buffer by its site and reclaims it."""
    _, pb, _ = both()
    cat = PM.BufferCatalog(device_budget=1 << 30, host_budget=1 << 30)
    PF.configure("leak:exchange.block:1")
    with PM.query_context("q-test"), PM.alloc_site("exchange.block"):
        a = PM.SpillableColumnarBatch(pb, catalog=cat)
        b = PM.SpillableColumnarBatch(pb, catalog=cat)
    a.close()
    b.close()
    assert cat.num_buffers == 1
    leak = cat.finish_query("q-test")
    assert leak == {"bytes": pb.device_memory_size(), "buffers": 1,
                    "sites": {"exchange.block": pb.device_memory_size()}}
    assert cat.num_buffers == 0 and cat.device_bytes == 0
    assert cat.finish_query("q-test") is None
