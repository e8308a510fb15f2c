"""``rand()`` of the PyTorch port on the CPU, held against the JAX package.

- ``ops/random.py`` (threefry2x32 in torch, int64 lanes masked to 32 bits)
  against ``jax.random`` directly: the hash itself (``threefry_2x32``),
  ``PRNGKey`` of 32- and 64-bit and negative seeds, ``fold_in``, 64-bit
  ``bits`` and float64 ``uniform``;
- ``F.rand(seed)`` through ``TorchSession(device="cpu")`` and
  ``TpuSession`` over the same frames: three seeds, two partitions, batches
  of two capacities, and files of several row groups (several batches a
  partition), in a projection, under a filter, and below an aggregate;
- where the reference differs from Spark's structure, the gap tests show
  both: a filter draws every batch of a partition from one key in the
  reference (the same numbers again at every batch), and an aggregate's
  ``rand`` draws with partition 0 and row offset 0 in every partition.

The numpy inputs come from a seed. Tolerance: none (the doubles are
compared bit for bit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from jax._src import prng

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.ops import random as R
from spark_rapids_tpu_torch.session import TorchSession

SEEDS = [0, 7, 42, -3, (1 << 40) + 5, 0x9E3779B9 * 3 ^ 11]


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int64)


def test_threefry_hash_matches_jax():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    t = torch.from_numpy(x.astype(np.int64))
    y0, y1 = R.threefry2x32(int(k[0]), int(k[1]), t[:500], t[500:])
    got = torch.cat([y0, y1]).numpy().astype(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_bits_and_uniform_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in key) == R.prng_key(seed)
    for data in (0, 1, 4096, (1 << 31) + 3):
        folded = jax.random.fold_in(key, data)
        mine = R.fold_in(R.prng_key(seed), data)
        assert tuple(int(v) for v in folded) == mine
        for n in (1, 8, 1000):
            bits = jax.random.bits(folded, (n,), dtype=jnp.uint64)
            assert np.array_equal(_bits(bits),
                                  R.random_bits64(mine, n, "cpu").numpy())
            u = jax.random.uniform(folded, (n,), dtype=jnp.float64)
            got = R.uniform(mine, n, "cpu").numpy()
            assert np.array_equal(_bits(u), got.view(np.int64))
            assert ((got >= 0) & (got < 1)).all()


def test_a_seed_past_64_bits_raises():
    with pytest.raises(OverflowError):
        R.prng_key(1 << 64)


def _table(n: int, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 5, n), pa.int64()),
                     "v": pa.array(rng.random(n))})


@pytest.fixture(scope="module")
def sessions():
    return TorchSession(device="cpu"), TpuSession()


def _r_bits(t: pa.Table, name: str = "r") -> np.ndarray:
    return t.column(name).to_numpy().view(np.int64)


@pytest.mark.parametrize("rows", [100, 3000])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_rand_equals_reference_bit_for_bit(sessions, rows, seed):
    """Two partitions of one batch each, at two capacities (128 and 2048
    rows a partition): a projection, a filter on ``rand`` and an aggregate
    above a projection of it."""
    port, ref = sessions
    t = _table(rows)
    p, r = port.create_dataframe(t, 2), ref.create_dataframe(t, 2)
    got = p.select("k", F.rand(seed).alias("r")).collect()
    exp = r.select("k", JF.rand(seed).alias("r")).collect()
    assert np.array_equal(_r_bits(got), _r_bits(exp))
    assert got.column("k").equals(exp.column("k"))
    got = p.filter(F.rand(seed) < 0.3).collect()
    exp = r.filter(JF.rand(seed) < 0.3).collect()
    assert got.equals(exp) and 0 < got.num_rows < rows
    got = p.select("k", F.rand(seed).alias("r")).group_by("k").agg(
        F.sum("r").alias("s"), F.count().alias("n")).order_by("k").collect()
    exp = r.select("k", JF.rand(seed).alias("r")).group_by("k").agg(
        JF.sum("r").alias("s"), JF.count().alias("n")).collect()
    exp = exp.take(pa.compute.sort_indices(exp.column("k")))
    assert got.column("n").equals(exp.column("n"))
    assert np.allclose(got.column("s").to_numpy(), exp.column("s").to_numpy(),
                       rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def row_group_files(tmp_path_factory):
    """Two files of 700 rows in row groups of 256 (three batches each)."""
    d = tmp_path_factory.mktemp("rand")
    paths = []
    for i in range(2):
        p = str(d / f"part-{i}.parquet")
        pq.write_table(_table(700, seed=10 + i), p, row_group_size=256)
        paths.append(p)
    return paths


def test_rand_over_several_batches_a_partition(sessions, row_group_files):
    """A projection counts the rows of the partition's earlier batches into
    the key (``row_offset``), in both."""
    port, ref = sessions
    for seed in (1, 42):
        got = port.read_parquet(row_group_files).select(
            "k", F.rand(seed).alias("r")).collect()
        exp = ref.read_parquet(row_group_files).select(
            "k", JF.rand(seed).alias("r")).collect()
        assert np.array_equal(_r_bits(got), _r_bits(exp))
        # the batches differ: no row group repeats the first's draws
        r = got.column("r").to_numpy()
        assert not np.array_equal(r[:256], r[256:512])


def test_rand_on_the_cpu_stays_on_the_cpu_and_is_repeatable(sessions):
    port, _ = sessions
    df = port.create_dataframe(_table(500), 2)
    a = df.select(F.rand(5).alias("r")).collect()
    b = df.select(F.rand(5).alias("r")).collect()
    c = df.select(F.rand(6).alias("r")).collect()
    assert np.array_equal(_r_bits(a), _r_bits(b))
    assert not np.array_equal(_r_bits(a), _r_bits(c))


def test_gap_filter_on_rand_draws_fresh_numbers_every_batch(
        sessions, row_group_files):
    """Spark draws a new number for every row. The reference's filter
    keys every batch of a partition alike (row offset 0), so each 256-row
    batch keeps the rows at the same positions; the port keys each batch
    by its row offset, as its projection does, and its filter keeps the
    rows whose projected ``rand`` passes."""
    port, ref = sessions
    exp = ref.read_parquet(row_group_files[:1]).filter(
        JF.rand(9) < 0.5).collect()
    got = port.read_parquet(row_group_files[:1]).filter(
        F.rand(9) < 0.5).collect()
    v = pq.read_table(row_group_files[0]).column("v").to_numpy()
    draws = R.uniform(R.fold_in(R.prng_key(9), 0), 256, "cpu").numpy()
    same_spots = np.concatenate([v[b:b + 256][draws[:min(256, 700 - b)]
                                              < 0.5] for b in (0, 256, 512)])
    assert np.array_equal(exp.column("v").to_numpy(), same_spots)
    proj = port.read_parquet(row_group_files[:1]).select(
        "v", F.rand(9).alias("r")).collect()
    keep = proj.column("r").to_numpy() < 0.5
    assert np.array_equal(got.column("v").to_numpy(), v[keep])
    assert not got.equals(exp)


def test_gap_rand_in_an_aggregate_reads_its_partition(sessions):
    """Spark computes an aggregate's ``rand`` below it, in each partition
    (PullOutNondeterministic); so does the port. The reference evaluates
    it inside the aggregate with partition 0 and row offset 0 in both
    partitions, so both sum partition 0's draws."""
    port, ref = sessions
    t = _table(200)
    got = port.create_dataframe(t, 2).agg(
        F.sum(F.rand(4)).alias("s")).collect().column("s")[0].as_py()
    want = port.create_dataframe(t, 2).select(
        F.rand(4).alias("r")).agg(F.sum("r").alias("s")).collect()
    assert got == want.column("s")[0].as_py()
    exp = ref.create_dataframe(t, 2).agg(
        JF.sum(JF.rand(4)).alias("s")).collect().column("s")[0].as_py()
    draws = R.uniform(R.fold_in(R.prng_key(4), 0), 128, "cpu").numpy()
    assert exp == pytest.approx(2 * draws[:100].sum(), rel=1e-12)
    assert got != pytest.approx(exp, rel=1e-12)
