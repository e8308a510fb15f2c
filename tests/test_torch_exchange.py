"""The port's hash exchange held against the JAX package's on the CPU:

- ``HashPartitioner.part_ids``, bit for bit, over int, long, double, date,
  boolean and string keys (ASCII and multi-byte UTF-8) with nulls, one key
  at a time and chained;
- ``slice_into_partitions`` gives every partition the same rows in the same
  order, with canonical padding;
- TPC-H q1 over one partition per file (q1-files) and over
  ``repartition(8, "l_returnflag", "l_linestatus")`` (q1-repartition),
  through ``TorchSession(device="cpu")``, equals ``TpuSession`` on the same
  file list and the NumPy oracle ``np_q1``, and plans PARTIAL → exchange →
  FINAL.

Inputs come from a numpy seed and cross between the packages as Arrow
tables. Tolerance: partition ids, rows and q1's keys and counts exact; q1's
seven f64 columns within ``rel=1e-9`` (tests/test_tpch.py's bound), because
the two packages add per-group sums in different orders.
"""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle import partitioning as JP
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.exchange import (AdaptiveShuffleReaderExec,
                                                  ShuffleExchangeExec)
from spark_rapids_tpu_torch.exec.sort import SortExec
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle import partitioning as SP

SF = 0.002

_WORDS = ["", "a", "N", "O", "abcd", "hello world", "é", "日本", "日本語です",
          "ünïcødé tail", "x" * 37, "padded to sixteen"]


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(values, typ):
        mask = rng.random(n) < 0.15
        return pa.array([None if m else v for v, m in zip(values, mask)],
                        type=typ)
    doubles = rng.normal(0, 1e3, n)
    doubles[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324][:min(6, n)]
    return pa.table({
        "i": nulls(rng.integers(-2**31, 2**31, n).tolist(), pa.int32()),
        "l": nulls(rng.integers(-2**63, 2**63, n, dtype=np.int64).tolist(),
                   pa.int64()),
        "d": nulls(doubles.tolist(), pa.float64()),
        "t": nulls(rng.integers(0, 20000, n).tolist(), pa.date32()),
        "b": nulls(rng.random(n) < 0.5, pa.bool_()),
        "s": nulls([_WORDS[k] for k in rng.integers(0, len(_WORDS), n)],
                   pa.string()),
    })


KEY_SETS = [["i"], ["l"], ["d"], ["t"], ["b"], ["s"], ["s", "i"],
            ["l", "s", "d", "b"]]


@pytest.mark.parametrize("keys", KEY_SETS, ids="+".join)
@pytest.mark.parametrize("nparts", [1, 4, 7])
def test_hash_part_ids_match_jax(keys, nparts):
    table = _table(300, seed=len(keys) * 10 + nparts)
    jb = JBatch.from_arrow(table)
    tb = ColumnarBatch.from_arrow(table, "cpu")
    want = np.asarray(JP.HashPartitioner([JE.col(k) for k in keys], nparts)
                      .bind(jb.schema).part_ids(jb))
    got = SP.HashPartitioner([E.col(k) for k in keys], nparts) \
        .bind(tb.schema).part_ids(tb).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < nparts)).all()


def test_string_hash_ignores_the_dictionary():
    """Equal strings in batches with different dictionaries (as two map
    tasks' files have) land in the same partition."""
    a = ColumnarBatch.from_arrow(pa.table({"s": ["日本", "b", "é"]}), "cpu")
    b = ColumnarBatch.from_arrow(pa.table({"s": ["é", "zz", "b", "日本"]}),
                                 "cpu")
    assert a.column(0).dictionary != b.column(0).dictionary
    p = SP.HashPartitioner([E.col("s")], 5)
    ids_a = p.bind(a.schema).part_ids(a).tolist()
    ids_b = p.part_ids(b).tolist()
    assert ids_a[:3] == [ids_b[3], ids_b[1], ids_b[0]]


def _rows(batch, n):
    """The first n rows as dicts, NaN spelled out so that rows compare."""
    return [{k: "NaN" if isinstance(v, float) and v != v else v
             for k, v in r.items()}
            for r in batch.to_arrow().slice(0, n).to_pylist()]


@pytest.mark.parametrize("nparts", [1, 3, 8])
def test_slice_into_partitions_matches_jax(nparts):
    table = _table(257, seed=nparts)
    keys = ["s", "l"]
    jb = JBatch.from_arrow(table)
    tb = ColumnarBatch.from_arrow(table, "cpu")
    jp = JP.HashPartitioner([JE.col(k) for k in keys], nparts).bind(jb.schema)
    tp = SP.HashPartitioner([E.col(k) for k in keys], nparts).bind(tb.schema)
    want = jp.partition(jb)
    got = tp.partition(tb)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert sum(b.num_rows for _, b in got) == 257
    for (_, g), (_, w) in zip(got, want):
        assert g.num_rows == w.num_rows and g.capacity == w.capacity
        assert _rows(g, g.num_rows) == _rows(w, w.num_rows)
        for c in g.columns:   # padding: invalid, canonical default
            assert not c.validity[g.num_rows:].any()
            pad = c.data[g.num_rows:]
            assert bool((pad == torch.zeros_like(pad)).all())


def test_slice_past_capacity_pads():
    """A partition whose power-of-two capacity reaches past the batch's end
    is padded with invalid default slots."""
    table = pa.table({"k": pa.array([1, 1, 1, 1, 1, 2], pa.int32())})
    tb = ColumnarBatch.from_arrow(table, "cpu")
    ids = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.int32)
    pieces = SP.slice_into_partitions(tb, ids, 2)
    assert [(p, b.num_rows, b.capacity) for p, b in pieces] == [(0, 1, 8),
                                                                (1, 5, 8)]
    first = pieces[0][1].column(0)
    assert first.data.tolist() == [2, 0, 0, 0, 0, 0, 0, 0]
    assert first.validity.tolist() == [True] + [False] * 7


def test_round_robin_and_single_partitioners():
    tb = ColumnarBatch.from_arrow(pa.table({"k": list(range(10))}), "cpu")
    rr = SP.RoundRobinPartitioner(3).partition(tb, split=1)
    assert [(p, _rows(b, b.num_rows)) for p, b in rr] == [
        (0, [{"k": 2}, {"k": 5}, {"k": 8}]),
        (1, [{"k": 0}, {"k": 3}, {"k": 6}, {"k": 9}]),
        (2, [{"k": 1}, {"k": 4}, {"k": 7}])]
    assert SP.SinglePartitioner().partition(tb) == [(0, tb)]


# -- q1 over several partitions ---------------------------------------------

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return jtpch.generate(SF, str(tmp_path_factory.mktemp("tpch_exchange")))


def _files(paths):
    d = paths["lineitem"]
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".parquet"))


def _q1_files(spark, paths, q1):
    return q1({"lineitem": spark.read_parquet(_files(paths))})


def _q1_repartition(spark, paths, q1):
    li = spark.read_parquet(paths["lineitem"])
    return q1({"lineitem": li.repartition(8, "l_returnflag", "l_linestatus")})


PATHS = {"q1-files": _q1_files, "q1-repartition": _q1_repartition}


def _assert_q1_equal(got, exp):
    assert len(got) == len(exp) == 4
    for g, e in zip(got, exp):
        g, e = list(g), list(e)
        assert g[0] == e[0] and g[1] == e[1]   # returnflag, linestatus
        assert g[9] == e[9]                    # count_order
        for a, b in zip(g[2:9], e[2:9]):
            assert a == pytest.approx(b, rel=1e-9)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_q1_paths_match_tpu_session_and_oracle(paths, path):
    build = PATHS[path]
    port = build(TorchSession(device="cpu"), paths, tpch.q1).collect()
    ref = build(TpuSession(), paths, jtpch.q1).collect()
    port, ref = port.to_pylist(), ref.to_pylist()
    assert [list(r) for r in port] == [list(r) for r in ref]  # names
    _assert_q1_equal([list(r.values()) for r in port],
                     [list(r.values()) for r in ref])
    exp = tpch.np_q1(tpch.load_np({"lineitem": paths["lineitem"]}))
    _assert_q1_equal([list(r.values()) for r in port], exp)


def _exchanges(plan):
    out = [plan] if isinstance(plan, ShuffleExchangeExec) else []
    for c in plan.children:
        out += _exchanges(c)
    return out


def test_q1_files_plan_is_partial_exchange_final(paths):
    plan = _q1_files(TorchSession(device="cpu"), paths,
                     tpch.q1).physical_plan()
    assert isinstance(plan, SortExec)
    final = plan.child.child          # through the gather of all partitions
    assert isinstance(final, HashAggregateExec) and final.mode == "final"
    reader = final.child
    assert isinstance(reader, AdaptiveShuffleReaderExec)
    ex = reader.child
    assert isinstance(ex.partitioner, SP.HashPartitioner)
    assert ex.num_partitions == 4
    partial = ex.child
    assert isinstance(partial, HashAggregateExec) and partial.mode == "partial"
    assert partial.prefilter is not None and partial.preproject is not None
    assert isinstance(partial.child, FileSourceScanExec)
    assert partial.child.num_partitions == 4


def test_q1_repartition_plan_and_map_batches(paths):
    plan = _q1_repartition(TorchSession(device="cpu"), paths,
                           tpch.q1).physical_plan()
    agg_ex, repart = _exchanges(plan)
    assert agg_ex.child.mode == "partial"
    assert repart.num_partitions == agg_ex.num_partitions == 8
    assert isinstance(repart.child, FileSourceScanExec)
    assert [e.name for e in repart.partitioner.key_exprs] == [
        "l_returnflag", "l_linestatus"]
    plan.execute_collect()
    # one scan batch per row group; four keys fill at most four partitions
    assert repart.map_batches >= 1
    assert 1 <= agg_ex.map_batches <= 4


def test_blocks_are_freed_after_the_query(paths):
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleBlockStore
    plan = _q1_files(TorchSession(device="cpu"), paths,
                     tpch.q1).physical_plan()
    plan.execute_collect()
    sid = _exchanges(plan)[0]._shuffle_id
    assert sid is not None
    assert sid not in ShuffleBlockStore.get()._blocks


def test_exchange_without_aqe_reader(paths):
    spark = TorchSession({
        "spark.rapids.tpu.sql.adaptive.coalescePartitions.enabled": "false",
        "spark.rapids.tpu.sql.localScheduler.numThreads": "1"}, device="cpu")
    df = _q1_files(spark, paths, tpch.q1)
    final = df.physical_plan().child.child
    assert isinstance(final.child, ShuffleExchangeExec)
    exp = tpch.np_q1(tpch.load_np({"lineitem": paths["lineitem"]}))
    _assert_q1_equal([list(r.values()) for r in df.collect().to_pylist()],
                     exp)


def test_block_order_and_launch_counts_under_threads():
    """Map tasks on a thread pool: every block is kept, a partition reads
    back in (map split, piece seq) order whatever order the threads wrote
    in, and the kernels' launch counts lose no update. More threads than
    cores, with a short switch interval to force interleaving."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleBlockStore
    store = ShuffleBlockStore()
    sid = store.register_shuffle()
    splits, pieces = 32, 40
    blocks = {(s, q): ColumnarBatch.from_arrow(
        pa.table({"k": [s * 1000 + q]}), "cpu")
        for s in range(splits) for q in range(1, pieces + 1)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    CK.reset_launches()
    try:
        def task(split):
            for seq in reversed(range(1, pieces + 1)):
                store.write_block(sid, split % 3, blocks[(split, seq)],
                                  seq=(split, seq))
                CK._count("radix_ranks")
        with ThreadPoolExecutor(max_workers=2 * (os.cpu_count() or 1) + 8) \
                as pool:
            list(pool.map(task, reversed(range(splits))))
    finally:
        sys.setswitchinterval(old)
    assert CK.launches["radix_ranks"] == splits * pieces
    CK.reset_launches()
    for rid in range(3):
        got = [b.to_arrow().column(0)[0].as_py()
               for b in store.read_partition(sid, rid)]
        assert got == [s * 1000 + q for s in range(splits) if s % 3 == rid
                       for q in range(1, pieces + 1)]
