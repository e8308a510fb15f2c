"""Device-side partitioning: hash, range, round-robin and single — counterpart of
``spark_rapids_tpu/shuffle/partitioning.py``.

Partition ids are computed on the device, rows are grouped by partition id
with one stable permutation (the radix kernels of
``radix_partition_permutation``, through
``ops/sorting.partition_permutation``) and sliced into per-partition
batches. The per-partition counts come to the host in one sync per batch,
the one sync the reference also needs to cut its slices
(GpuPartitioning.sliceInternalOnGpu).

The hash partitioner is bit-exact with Spark's ``HashPartitioning``:
``pmod(murmur3(keys, 42), n)``. A string key hashes its UTF-8 bytes, never
its dictionary code, so equal strings land in the same partition whatever
dictionary their batch carries. The range partitioner places rows by
bounds sampled from its input (``RangePartitioner``).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.expr.core import Col, EvalContext, bind_references
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops.filtering import gather_cols

SPARK_HASH_SEED = 42  # HashPartitioning's Murmur3Hash seed


def murmur3_row_hash(cols: list, capacity: int, seed: int = SPARK_HASH_SEED,
                     dict_words: dict | None = None) -> torch.Tensor:
    """Per-row Spark Murmur3Hash over ``cols``, each column's hash seeding
    the next; a null cell leaves the running hash unchanged (Spark
    HashExpression.eval). ``dict_words[i]`` holds string column i's packed
    dictionary (``TorchColumnVector.dictionary_words``)."""
    dev = cols[0].values.device if cols else None
    h = torch.full((capacity,), seed, dtype=torch.int32, device=dev)
    for ci, c in enumerate(cols):
        dt = c.dtype
        if isinstance(dt, T.StringType):
            words, lens = dict_words[ci]
            codes = c.values.long()
            nh = H.hash_string_words(words[codes], lens[codes], h)
        elif isinstance(dt, (T.LongType, T.DecimalType, T.TimestampType)):
            # a decimal of precision <= 18 hashes its unscaled long (Spark)
            nh = H.hash_long(c.values, h)
        elif isinstance(dt, T.DoubleType):
            nh = H.hash_double(c.values, h)
        elif isinstance(dt, T.FloatType):
            nh = H.hash_float(c.values, h)
        elif isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                             T.IntegerType, T.DateType)):
            nh = H.hash_int(c.values.to(torch.int32), h)
        else:
            raise NotImplementedError(f"hashing {dt} is not ported yet")
        h = torch.where(c.validity, nh, h)
    return h


def slice_into_partitions(batch: ColumnarBatch, part_ids: torch.Tensor,
                          num_partitions: int) -> list:
    """Group rows by partition id (stable) and slice them into per-partition
    batches: ``[(part, ColumnarBatch)]`` for the non-empty partitions. A
    slice that runs past the batch's capacity is padded; every padding slot
    holds the type's default and is invalid."""
    from spark_rapids_tpu_torch.ops.sorting import partition_permutation
    cap = batch.capacity
    n = batch.num_rows
    dev = part_ids.device
    live = torch.arange(cap, device=dev) < n
    ids = torch.where(live, part_ids.to(torch.int32),
                      torch.full((cap,), num_partitions, dtype=torch.int32,
                                 device=dev))
    perm = partition_permutation(part_ids, num_partitions, n, cap)
    cols = [Col.from_vector(c) for c in batch.columns]
    sorted_cols = gather_cols(cols, perm, live[perm])
    # the one device-to-host sync per batch: the slice offsets
    counts = torch.bincount(ids.long(), minlength=num_partitions + 1)[
        :num_partitions].tolist()
    out = []
    lo = 0
    for p, cnt in enumerate(counts):
        if cnt == 0:
            continue
        pcap = bucket_capacity(cnt)
        idx = torch.arange(pcap, device=dev) < cnt
        pcols = []
        for c in sorted_cols:
            if c.nested is not None:
                from spark_rapids_tpu_torch.ops import nested as N
                pcols.append(N.take_rows(c.nested, lo, cnt, pcap))
                continue
            vals = c.values[lo:lo + pcap]
            valid = c.validity[lo:lo + pcap]
            if vals.shape[0] < pcap:   # the slice ran past the capacity
                pad = pcap - vals.shape[0]
                vals = torch.cat([vals, torch.zeros(
                    (pad,), dtype=vals.dtype, device=dev)])
                valid = torch.cat([valid, torch.zeros(
                    (pad,), dtype=torch.bool, device=dev)])
            valid = valid & idx
            default = torch.tensor(c.dtype.default_value(), dtype=vals.dtype,
                                   device=dev)
            pcols.append(TorchColumnVector(
                c.dtype, torch.where(valid, vals, default), valid,
                c.dictionary))
        out.append((p, ColumnarBatch(pcols, cnt, batch.schema)))
        lo += cnt
    return out


class Partitioner:
    """Base: ``partition(batch, split) -> [(part_id, ColumnarBatch)]``."""

    num_partitions: int

    def bind(self, schema):
        return self

    def partition(self, batch: ColumnarBatch, split: int = 0):
        raise NotImplementedError


class SinglePartitioner(Partitioner):
    """Reference GpuSinglePartitioning."""

    num_partitions = 1

    def partition(self, batch, split=0):
        return [(0, batch)] if batch.num_rows else []


class HashPartitioner(Partitioner):
    """Reference GpuHashPartitioning: bit-exact with Spark's
    ``HashPartitioning(pmod(murmur3(keys, 42), n))``."""

    def __init__(self, key_exprs: list, num_partitions: int):
        self.key_exprs = list(key_exprs)
        self.num_partitions = num_partitions

    def bind(self, schema):
        self.key_exprs = [bind_references(e, schema) for e in self.key_exprs]
        return self

    def part_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        from spark_rapids_tpu_torch.expr.core import BoundReference
        dev = batch.columns[0].data.device
        ctx = EvalContext.from_batch(batch, dev)
        keys = [e.eval(ctx) for e in self.key_exprs]
        dict_words = {}
        for i, (e, k) in enumerate(zip(self.key_exprs, keys)):
            if not k.is_string:
                continue
            if isinstance(e, BoundReference):
                # the batch vector caches its dictionary's packing
                dict_words[i] = batch.column(e.ordinal).dictionary_words()
            else:
                dict_words[i] = k.to_vector().dictionary_words()
        h = murmur3_row_hash(keys, batch.capacity, dict_words=dict_words)
        return H.pmod(h, self.num_partitions)

    def partition(self, batch, split=0):
        return slice_into_partitions(batch, self.part_ids(batch),
                                     self.num_partitions)


class RoundRobinPartitioner(Partitioner):
    """Reference GpuRoundRobinPartitioning: rows dealt onto partitions in
    order, from a start derived from the input split."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def partition(self, batch, split=0):
        cap = batch.capacity
        dev = batch.columns[0].data.device
        start = split % self.num_partitions
        ids = ((torch.arange(cap, dtype=torch.int32, device=dev) + start)
               % self.num_partitions)
        return slice_into_partitions(batch, ids, self.num_partitions)


class RangePartitioner(Partitioner):
    """Reference GpuRangePartitioner + GpuRangePartitioning: sample rows,
    sort the sample to choose ``n - 1`` bounds, then place each row by a
    lexicographic comparison against the bounds on the device. The
    reference computes both in jnp outside any Pallas kernel, so here they
    are plain torch; the exchange takes the sample (the first batch of
    every input partition, ``exec/exchange.py``). The partition step slices
    by these ids as the hash partitioner's does, so the radix kernels run
    under it."""

    def __init__(self, sort_exprs: list, orders: list, num_partitions: int):
        self.sort_exprs = list(sort_exprs)
        self.orders = list(orders)
        self.num_partitions = num_partitions
        self._bounds: list | None = None

    def bind(self, schema):
        self.sort_exprs = [bind_references(e, schema)
                           for e in self.sort_exprs]
        return self

    def set_bounds_from_sample(self, sample_batches: list):
        """Compute the bounds from the sampled batches (reference
        GpuRangePartitioner.createRangeBounds)."""
        from spark_rapids_tpu_torch.ops.concat import concat_batches
        from spark_rapids_tpu_torch.ops.sorting import sort_permutation
        sample = concat_batches(sample_batches)
        dev = sample.columns[0].data.device
        ctx = EvalContext.from_batch(sample, dev)
        keys = [e.eval(ctx) for e in self.sort_exprs]
        perm = sort_permutation(keys, self.orders, sample.num_rows,
                                sample.capacity)
        n = sample.num_rows
        live = torch.arange(sample.capacity, device=dev) < n
        skeys = gather_cols(keys, perm, live[perm])
        nb = self.num_partitions - 1
        if n == 0 or nb == 0:
            self._bounds = None
            return
        # n - 1 evenly spaced bound rows
        pos = torch.as_tensor(np.minimum(
            (np.arange(1, nb + 1) * n) // self.num_partitions,
            max(n - 1, 0)).astype(np.int64), device=dev)
        self._bounds = [Col(c.values[pos], c.validity[pos], c.dtype,
                            c.dictionary) for c in skeys]

    def part_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        dev = batch.columns[0].data.device
        if self._bounds is None:
            return torch.zeros((batch.capacity,), dtype=torch.int32,
                               device=dev)
        ctx = EvalContext.from_batch(batch, dev)
        keys = [e.eval(ctx) for e in self.sort_exprs]
        return range_part_ids(keys, self._bounds, self.orders,
                              batch.capacity)

    def partition(self, batch, split=0):
        return slice_into_partitions(batch, self.part_ids(batch),
                                     self.num_partitions)


def range_part_ids(keys: list, bounds: list, orders, capacity: int):
    """Partition id per row given ``n - 1`` sorted bound rows: the number
    of bounds the row compares strictly greater than (lexicographic, with
    Spark's null and NaN order through ``ops/sorting._key_arrays``)."""
    from spark_rapids_tpu_torch.ops.sorting import _key_arrays
    keys = list(keys)
    bounds = list(bounds)
    # string keys and bounds compare as codes of one dictionary
    for i, (k, b) in enumerate(zip(keys, bounds)):
        if k.is_string and k.dictionary is not b.dictionary:
            from spark_rapids_tpu_torch.ops.strings import union_dictionaries
            keys[i], bounds[i] = union_dictionaries(k, b)
    dev = keys[0].values.device
    nb = bounds[0].values.shape[0]
    row_keys = [ka for k, o in zip(keys, orders) for ka in _key_arrays(k, o)]
    bound_keys = [ka for b, o in zip(bounds, orders)
                  for ka in _key_arrays(b, o)]
    ids = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    for j in range(nb):
        gt = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        tie = torch.ones((capacity,), dtype=torch.bool, device=dev)
        for rk, bk in zip(row_keys, bound_keys):
            bj = bk[j]
            gt = gt | (tie & (rk > bj))
            tie = tie & (rk == bj)
        ids = ids + gt.to(torch.int32)
    return ids
