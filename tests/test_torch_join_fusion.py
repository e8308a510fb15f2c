"""The broadcast joins' stream hoist and probe chain in the PyTorch port on
the CPU, held against the JAX package and against the port's own unfused
route (``spark.rapids.tpu.sql.stageFusion.enabled=false``).

- plan parity: on TPC-H q3, q5 and q18 at SF 0.01 the port's
  ``physical_plan()`` forms the same chains, with the same hops, and hoists
  a prefilter and a preproject into the same joins as the reference's
  ``TpuOverrides(conf).apply``; with fusion off neither forms a chain;
- chain against unchained, bit for bit, and the rows against
  ``TpuSession``: the reference's ``_chain_pair_query`` shape with a
  unique and a duplicate-keyed build, null keys, int32 against int64
  keys, a date key, string, decimal and nested payloads, a key computed in
  the hoisted projection, a prefilter that empties whole batches, several
  stream partitions, a hash-mode hop (sparse int64 keys) and a ``limit``
  above the chain, which still releases every build;
- a timestamp-keyed and a decimal-keyed stack, which the reference chains
  and the port keeps unchained on its rank path, with the same rows.

The inputs come from a numpy seed, written as parquet files of several row
groups that both packages read. Tolerance: none (rows compared exactly,
floats included, in the order each route emits them).
"""

from __future__ import annotations

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.session import TorchSession

FUSION = "spark.rapids.tpu.sql.stageFusion.enabled"
N_STREAM = 3000
ROW_GROUP = 500


# -- plan parity on the ladder -------------------------------------------------

@pytest.fixture(scope="module")
def tpch_paths(tmp_path_factory):
    return jtpch.generate(0.01, str(tmp_path_factory.mktemp("tpch_fusion")))


def _shape(plan) -> list:
    """Top down: each chain as ("chain", its hops' hoists) and each other
    hash join as ("join", its hoists); a hoist is (prefilter?, preproject?)."""
    def hoists(j):
        return (j.stream_prefilter is not None,
                j.stream_preproject is not None)
    out = []
    name = type(plan).__name__
    if name == "BroadcastHashJoinChainExec":
        out.append(("chain", tuple(hoists(h) for h in plan.hops)))
    elif name in ("BroadcastHashJoinExec", "HashJoinExec"):
        out.append(("join", hoists(plan)))
    for c in plan.children:
        out += _shape(c)
    return out


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", ["q3", "q5", "q18"])
def test_plan_parity_with_the_reference(tpch_paths, query, fusion):
    ref = TpuSession({FUSION: fusion})
    want = _shape(TpuOverrides(ref.conf).apply(
        jtpch.QUERIES[query](jtpch.load(ref, tpch_paths))._plan))
    port = TorchSession({FUSION: str(fusion).lower()}, device="cpu")
    got = _shape(tpch.QUERIES[query](tpch.load(port, tpch_paths))
                 .physical_plan())
    assert got == want
    chains = [s for s in got if s[0] == "chain"]
    if not fusion:
        assert not chains
    elif query in ("q5", "q18"):
        # the reference's own test holds one two-hop chain on each
        assert [len(c[1]) for c in chains] == [2]
    else:
        assert not chains and all(h == (True, True) for _k, h in got)


# -- the shapes -----------------------------------------------------------------

def _write(path, tbl, row_group=ROW_GROUP):
    pq.write_table(tbl, path, row_group_size=row_group)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("join_fusion")
    rng = np.random.default_rng(20)
    n = N_STREAM
    k = (np.arange(n) % 400).astype(np.int64)
    k_null = rng.random(n) < 0.05
    epoch = datetime.date(1970, 1, 1)
    sparse_b = (rng.permutation(3000).astype(np.int64) + 1) * 9_999_991_337
    sparse_b[::3] *= -1
    sp = np.where(rng.random(n) < 0.7, rng.choice(sparse_b, n),
                  rng.integers(-2**60, 2**60, n))
    ts0 = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
    stream = pa.table({
        "k": pa.array(k, pa.int64(), mask=k_null),
        "g": pa.array(np.arange(n) // ROW_GROUP, pa.int64()),
        "d": pa.array([epoch + datetime.timedelta(days=int(x) + 9000)
                       for x in k % 300], pa.date32()),
        "sp": pa.array(sp, pa.int64()),
        "ts": pa.array([ts0 + datetime.timedelta(seconds=int(x))
                        for x in k % 350], pa.timestamp("us", tz="UTC")),
        "dk": pa.array([decimal.Decimal(int(x)) / 4 for x in k % 350],
                       pa.decimal128(10, 2)),
        "v": pa.array(rng.normal(0, 10, n).round(3)),
        "s": pa.array([None if i % 17 == 0 else f"s{i % 23}"
                       for i in range(n)]),
        "dec": pa.array([decimal.Decimal(int(x)) / 100
                         for x in rng.integers(-10**6, 10**6, n)],
                        pa.decimal128(12, 2)),
        "arr": pa.array([None if i % 13 == 0 else list(range(i % 4))
                         for i in range(n)], pa.list_(pa.int64())),
    })
    paths = {"stream": _write(str(d / "stream.parquet"), stream)}
    # the same stream in three files: three partitions
    for i in range(3):
        paths[f"part{i}"] = _write(str(d / f"part{i}.parquet"),
                                   stream.slice(i * 1000, 1000))
    # the stream with an int32 key, nulls kept
    paths["stream32"] = _write(str(d / "stream32.parquet"), stream.set_column(
        0, "k", stream.column("k").cast(pa.int32())))

    def build(name, tbl):
        paths[name] = _write(str(d / f"{name}.parquet"), tbl, 4096)

    keys = np.arange(300, dtype=np.int64)
    keys_null = np.zeros(300, bool)
    keys_null[7] = True
    build("b1", pa.table({"k": pa.array(keys, pa.int64(), mask=keys_null),
                          "j": pa.array(keys * 2, pa.int64()),
                          "bs": pa.array([f"b{x % 11}" for x in keys])}))
    build("b1dup", pa.table({"k": pa.array(np.repeat(keys, 2), pa.int64()),
                             "j": pa.array(np.repeat(keys, 2) * 2,
                                           pa.int64()),
                             "bs": pa.array([f"b{x % 11}"
                                             for x in np.repeat(keys, 2)])}))
    jk = np.arange(0, 600, 3, dtype=np.int64)
    build("b2", pa.table({"j": pa.array(jk, pa.int64()),
                          "w": pa.array(jk.astype(np.float64) / 8)}))
    build("bkk", pa.table({"kk": pa.array(keys + 1, pa.int64()),
                           "j": pa.array(keys * 2, pa.int64())}))
    build("bdate", pa.table({
        "d": pa.array([epoch + datetime.timedelta(days=int(x) + 9000)
                       for x in range(0, 300, 2)], pa.date32()),
        "j": pa.array(np.arange(0, 300, 2, dtype=np.int64) * 3)}))
    build("bsparse", pa.table({"sp": pa.array(sparse_b, pa.int64()),
                               "j": pa.array(np.arange(3000, dtype=np.int64)
                                             % 600)}))
    build("bts", pa.table({
        "ts": pa.array([ts0 + datetime.timedelta(seconds=int(x))
                        for x in range(0, 350, 2)],
                       pa.timestamp("us", tz="UTC")),
        "j": pa.array(np.arange(0, 350, 2, dtype=np.int64) * 2)}))
    build("bdk", pa.table({
        "dk": pa.array([decimal.Decimal(int(x)) / 4
                        for x in range(0, 350, 2)], pa.decimal128(10, 2)),
        "j": pa.array(np.arange(0, 350, 2, dtype=np.int64) * 2)}))
    return paths


PAYLOAD = ("v", "s", "dec", "arr")


def _query(Fm, spark, paths, shape):
    """The frame of ``shape`` through one package's session and functions
    module."""
    def rd(name, **kw):
        return spark.read_parquet(paths[name], **kw)
    c = Fm.col
    stream = rd("stream")
    if shape == "pair_unique":
        # the reference's _chain_pair_query: two stacked int-key joins
        return (stream.join(rd("b1"), on="k").join(rd("b2"), on="j")
                .select(c("k"), c("v"), c("j"), c("w")))
    if shape == "pair_dup":
        return (stream.join(rd("b1dup"), on="k").join(rd("b2"), on="j")
                .select(c("k"), c("v"), c("j"), c("w")))
    if shape == "int32_nulls":
        return (rd("stream32").join(rd("b1"), on="k")
                .join(rd("b2"), on="j")
                .select(c("k"), c("j"), c("bs"), c("w"), *map(c, PAYLOAD)))
    if shape == "date_key":
        return (stream.join(rd("bdate"), on="d").join(rd("b2"), on="j")
                .select(c("d"), c("j"), c("w"), *map(c, PAYLOAD)))
    if shape == "payloads":
        return (stream.filter(c("g") != Fm.lit(1))
                .select(c("k"), *map(c, PAYLOAD))
                .join(rd("b1"), on="k").join(rd("b2"), on="j"))
    if shape == "computed_key":
        return (stream.select((c("k") + Fm.lit(1)).alias("kk"), c("v"),
                              c("s"))
                .join(rd("bkk"), on="kk").join(rd("b2"), on="j"))
    if shape == "empty_batches":
        # rows of batches 1, 2 and 4 all fail the filter
        return (stream.filter((c("g") == Fm.lit(0)) | (c("g") == Fm.lit(3))
                              | (c("g") == Fm.lit(5)))
                .join(rd("b1"), on="k").join(rd("b2"), on="j")
                .select(c("g"), c("k"), c("j"), c("bs"), c("w")))
    if shape == "partitions":
        parts = spark.read_parquet([paths[f"part{i}"] for i in range(3)],
                                   files_per_partition=1)
        return (parts.join(rd("b1"), on="k").join(rd("b2"), on="j")
                .select(c("k"), c("j"), c("s"), c("w")))
    if shape == "hash_hop":
        return (stream.join(rd("bsparse"), on="sp").join(rd("b2"), on="j")
                .select(c("sp"), c("j"), c("v"), c("w")))
    if shape == "timestamp_key":
        return (stream.join(rd("bts"), on="ts").join(rd("b2"), on="j")
                .select(c("ts"), c("j"), c("v"), c("w")))
    if shape == "decimal_key":
        return (stream.join(rd("bdk"), on="dk").join(rd("b2"), on="j")
                .select(c("dk"), c("j"), c("v"), c("w")))
    raise ValueError(shape)


CHAINED = ("pair_unique", "int32_nulls", "date_key", "payloads",
           "computed_key", "empty_batches", "partitions", "hash_hop")
DEGRADED = ("pair_dup",)
UNCHAINED = ("timestamp_key", "decimal_key")


def _rows(tbl):
    return list(zip(*[c.to_pylist() for c in tbl.columns]))


def _port(paths, shape, fusion: bool):
    spark = TorchSession({FUSION: str(fusion).lower()}, device="cpu")
    plan = _query(F, spark, paths, shape).physical_plan()
    return plan, _rows(plan.execute_collect())


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


@pytest.mark.parametrize("shape", CHAINED + DEGRADED + UNCHAINED)
def test_chain_against_unchained_and_the_reference(files, shape):
    plan, on = _port(files, shape, True)
    off_plan, off = _port(files, shape, False)
    assert on == off                      # bit for bit, in emit order
    assert len(on) > 0
    ref = _rows(_query(JF, TpuSession(), files, shape).collect())
    assert sorted(on, key=repr) == sorted(ref, key=repr)
    chains = [p for p in _walk(plan)
              if isinstance(p, XJ.BroadcastHashJoinChainExec)]
    assert not [p for p in _walk(off_plan)
                if isinstance(p, XJ.BroadcastHashJoinChainExec)]
    if shape in UNCHAINED:
        # the port's _int_backed keeps a timestamp or decimal key on the
        # rank path, unhoisted and unchained (the reference chains it)
        assert not chains
        joins = [p for p in _walk(plan) if isinstance(p, XJ.HashJoinExec)]
        assert "rank" in [j.stats["probe_mode"] for j in joins]
        return
    (chain,) = chains
    st = chain.stats
    assert len(chain.hops) == 2
    assert st["stream_batches"] == st["chained_batches"] + \
        st["degraded_batches"] > 0
    assert st["output_rows"] == len(on)
    if shape in DEGRADED:
        assert st["chained_batches"] == 0
        assert [h.stats["probe_mode"] for h in chain.hops] == ["two",
                                                               "dense"]
    else:
        assert st["degraded_batches"] == 0
        # one host sync a stream batch, beside the builds' own
        builds = sum(h.stats["syncs"] for h in chain.hops)
        assert st["syncs"] == builds + st["stream_batches"]
        for h in chain.hops:
            assert h.stats["stream_batches"] == st["stream_batches"]
    if shape == "hash_hop":
        assert chain.hops[0].stats["probe_mode"] == "hash"
    if shape == "partitions":
        assert st["stream_partitions"] == 3
    if shape in ("payloads", "empty_batches"):
        assert chain.hops[0].stream_prefilter is not None
    if shape in ("payloads", "computed_key"):
        assert chain.hops[0].stream_preproject is not None
    # every build released by the last reader
    assert all(h.exchange._batch is None for h in chain.hops)


def test_empty_batches_yield_nothing(files):
    plan, rows = _port(files, "empty_batches", True)
    (chain,) = [p for p in _walk(plan)
                if isinstance(p, XJ.BroadcastHashJoinChainExec)]
    assert chain.stats["stream_batches"] == N_STREAM // ROW_GROUP
    assert sorted({r[0] for r in rows}) == [0, 3, 5]


def test_limit_above_the_chain_releases_every_build(files):
    spark = TorchSession(device="cpu")
    df = _query(F, spark, files, "pair_unique").limit(5)
    plan = df.physical_plan()
    (chain,) = [p for p in _walk(plan)
                if isinstance(p, XJ.BroadcastHashJoinChainExec)]
    got = plan.execute_collect()
    assert got.num_rows == 5
    assert chain.stats["stream_batches"] < N_STREAM // ROW_GROUP
    assert all(h.exchange._batch is None for h in chain.hops)
    # the plan runs again, and the rows are the unfused route's first five
    _p, off = _port(files, "pair_unique", False)
    assert _rows(plan.execute_collect()) == off[:5]


def test_hoist_without_fusion_keeps_a_filter_only(files):
    """With fusion off a stream-side filter (or a projection over one) is
    still hoisted, as in the reference; a bare projection is not."""
    spark = TorchSession({FUSION: "false"}, device="cpu")
    plan = _query(F, spark, files, "payloads").physical_plan()
    hops = [p for p in _walk(plan) if isinstance(p, XJ.HashJoinExec)]
    assert any(j.stream_prefilter is not None
               and j.stream_preproject is not None for j in hops)
    plan = _query(F, spark, files, "computed_key").physical_plan()
    hops = [p for p in _walk(plan) if isinstance(p, XJ.HashJoinExec)]
    assert all(j.stream_preproject is None for j in hops)


def test_outer_and_semi_joins_keep_their_filter(files):
    from spark_rapids_tpu_torch.exec import basic as XB
    spark = TorchSession(device="cpu")
    c = F.col
    for how in ("left", "leftsemi", "leftanti"):
        df = (spark.read_parquet(files["stream"])
              .filter(c("g") != F.lit(1)).join(
                  spark.read_parquet(files["b1"]), on="k", how=how))
        plan = df.physical_plan()
        joins = [p for p in _walk(plan) if isinstance(p, XJ.HashJoinExec)]
        assert all(j.stream_prefilter is None for j in joins)
        assert [p for p in _walk(plan) if isinstance(p, XB.FilterExec)]


def test_prefilter_on_the_rank_path_is_refused():
    """The planner hoists a filter only on the single fixed-point key path;
    the core refuses one anywhere else (the reference asserts it)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu_torch.expr.core import BoundReference, Literal
    from spark_rapids_tpu_torch.expr.predicates import GreaterThan
    col = TorchColumnVector(T.DOUBLE, torch.zeros(8, dtype=torch.float64),
                            torch.ones(8, dtype=torch.bool))
    build = ColumnarBatch([col], 8)
    key = BoundReference(0, T.DOUBLE)
    with pytest.raises(ValueError):
        XJ._JoinCore(build, [key], [key], "inner", "cpu",
                     stream_prefilter=GreaterThan(key, Literal(0.0)))
