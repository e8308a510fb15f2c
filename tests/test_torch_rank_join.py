"""The multi-key rank join of the port held against the JAX package on the
same numpy-seeded inputs, on the CPU:

- ``ops/joining.join_ranks`` and ``probe``: the ranks, the build
  permutation and each stream row's ``[lo, hi)`` bit for bit the
  reference's, over two and three int keys, string keys whose two sides'
  dictionaries differ (through each package's ``_align_string_keys``), and
  double keys with NaN, -0.0 and nulls. Tolerance: exact;
- the rank path of ``_JoinCore``: the same ``(build_perm, lo, hi, counts,
  total)`` as the reference's ``_probe_batch_eager``. Tolerance: exact;
- joins through ``TorchSession(device="cpu")`` and ``TpuSession`` on the
  same parquet files, inner, left, left-semi and left-anti, on two and
  three keys, a string key and a double key: the same rows in the same
  order (both emit in stream order). Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exec import joins as JJ
from spark_rapids_tpu.expr.core import BoundReference as JBound
from spark_rapids_tpu.expr.core import Col as JCol
from spark_rapids_tpu.ops import joining as JJO
from spark_rapids_tpu.session import TpuSession

import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.expr.core import BoundReference, Col
from spark_rapids_tpu_torch.ops import joining as J
from spark_rapids_tpu_torch.session import TorchSession

BUILD_CAP, N_BUILD = 64, 50
STREAM_CAP, N_STREAM = 128, 100
WORDS = ["apple", "fig", "kiwi", "lime", "pear", "plum"]


def _key(rng, kind, cap, n, side):
    """(numpy values, validity, dictionary) of one key column: ints in a
    small range (many repeats), strings from a side-specific dictionary, or
    doubles with NaN, -0.0, 0.0 and nulls; padding canonical."""
    valid = rng.random(cap) < 0.9
    dictionary = None
    if kind == "int":
        vals = rng.integers(0, 6, cap).astype(np.int64)
    elif kind == "int32":
        vals = rng.integers(0, 4, cap).astype(np.int32)
    elif kind == "str":
        # the two sides hold different (overlapping) sorted dictionaries
        words = WORDS[:4] if side == "build" else WORDS[2:]
        dictionary = pa.array(sorted(words), pa.string())
        vals = rng.integers(0, len(words), cap).astype(np.int32)
    else:
        vals = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.nan]),
                          cap).astype(np.float64)
    live = np.arange(cap) < n
    valid &= live
    vals = np.where(valid, vals, np.zeros_like(vals))
    return vals, valid, dictionary


_KIND_TYPES = {"int": (T.LONG, JT.LONG), "int32": (T.INT, JT.INT),
               "str": (T.STRING, JT.STRING), "double": (T.DOUBLE, JT.DOUBLE)}


def _cols(keys, kinds):
    port, ref = [], []
    for (vals, valid, d), kind in zip(keys, kinds):
        pt, rt = _KIND_TYPES[kind]
        port.append(Col(torch.from_numpy(vals), torch.from_numpy(valid), pt,
                        d))
        ref.append(JCol(jnp.asarray(vals), jnp.asarray(valid), rt, d))
    return port, ref


KINDS = {"two ints": ("int", "int32"), "three ints": ("int", "int32", "int"),
         "string": ("str",), "string and int": ("str", "int"),
         "double": ("double",), "double and int": ("double", "int32")}


def _sides(name, seed):
    rng = np.random.default_rng(seed)
    kinds = KINDS[name]
    b = [_key(rng, k, BUILD_CAP, N_BUILD, "build") for k in kinds]
    s = [_key(rng, k, STREAM_CAP, N_STREAM, "stream") for k in kinds]
    return kinds, _cols(b, kinds), _cols(s, kinds)


@pytest.mark.parametrize("name", list(KINDS))
def test_join_ranks_and_probe_match_the_reference(name):
    kinds, (pb, rb), (ps, rs) = _sides(name, 11 + len(name))
    pb, ps = XJ._align_string_keys(pb, ps)
    rb, rs = JJ._align_string_keys(rb, rs)
    got_b, got_s = J.join_ranks(pb, N_BUILD, BUILD_CAP, ps, N_STREAM,
                                STREAM_CAP)
    want_b, want_s = JJO.join_ranks(rb, N_BUILD, BUILD_CAP, rs, N_STREAM,
                                    STREAM_CAP)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    perm, lo, hi = J.probe(got_b, got_s)
    wperm, wlo, whi = JJO.probe(want_b, want_s)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    # the sentinels: null-keyed and padding rows never match
    matched = (hi - lo).numpy() > 0
    s_valid = np.logical_and.reduce([c.validity.numpy() for c in ps])
    assert not matched[~s_valid].any()
    assert not matched[N_STREAM:].any()
    assert matched.any()


def test_float_keys_follow_spark_equality():
    """NaN matches NaN, -0.0 matches 0.0, a null matches nothing."""
    b = Col(torch.tensor([float("nan"), -0.0, 1.0, 0.0]),
            torch.tensor([True, True, True, False]), T.DOUBLE)
    s = Col(torch.tensor([0.0, float("nan"), 2.0, 0.0, 1.0, 0.0, 0.0, 0.0]),
            torch.tensor([True, True, True, False, True, True, True, True]),
            T.DOUBLE)
    rb, rs = J.join_ranks([b], 4, 4, [s], 6, 8)
    _, lo, hi = J.probe(rb, rs)
    assert (hi - lo).tolist() == [1, 1, 0, 0, 1, 1, 0, 0]


def _batches(keys, kinds, cap, n):
    """Port and reference batches holding the key columns."""
    port_cols, ref_cols = _cols(keys, kinds)
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu.columnar.vector import TpuColumnVector
    pb = ColumnarBatch([TorchColumnVector(c.dtype, c.values, c.validity,
                                          c.dictionary) for c in port_cols],
                       n)
    rb = JBatch([TpuColumnVector(c.dtype, c.values, c.validity,
                                 c.dictionary) for c in ref_cols], n)
    return pb, rb, port_cols


@pytest.mark.parametrize("join_type", [J.INNER, J.LEFT_OUTER, J.LEFT_SEMI,
                                       J.LEFT_ANTI])
@pytest.mark.parametrize("name", ["three ints", "string and int", "double"])
def test_rank_core_matches_the_reference(name, join_type):
    rng = np.random.default_rng(7 + len(name) + len(join_type))
    kinds = KINDS[name]
    bkeys = [_key(rng, k, BUILD_CAP, N_BUILD, "build") for k in kinds]
    skeys = [_key(rng, k, STREAM_CAP, N_STREAM, "stream") for k in kinds]
    pbb, rbb, pcols = _batches(bkeys, kinds, BUILD_CAP, N_BUILD)
    psb, rsb, _ = _batches(skeys, kinds, STREAM_CAP, N_STREAM)
    pexprs = [BoundReference(i, c.dtype) for i, c in enumerate(pcols)]
    rexprs = [JBound(i, _KIND_TYPES[k][1]) for i, k in enumerate(kinds)]
    core = XJ._JoinCore(pbb, pexprs, pexprs, join_type, "cpu")
    assert core.probe_mode == "rank" and not core.fast
    ref = JJ._JoinCore(rbb, rexprs, rexprs, join_type)
    assert not ref.fast
    got = core.probe_batch(psb)
    want = ref.probe_batch(rsb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- joins through both sessions ----------------------------------------------

def _rows(table):
    """Rows as tuples, NaN as a string so that equal rows compare equal."""
    return [tuple("NaN" if isinstance(v, float) and v != v else v
                  for v in r.values()) for r in table.to_pylist()]


@pytest.fixture(scope="module")
def multi_key_tables(tmp_path_factory):
    """Two tables with repeated key tuples over int, string and double
    columns, nulls among them."""
    d = tmp_path_factory.mktemp("rank_join")
    rng = np.random.default_rng(20260729)

    def table(n, words, tag):
        def nulls(arr, p=0.08):
            mask = rng.random(n) < p
            return pa.array(arr, mask=mask)
        return pa.table({
            "k": nulls(rng.integers(0, 5, n).astype(np.int64)),
            "j": nulls(rng.integers(0, 3, n).astype(np.int32)),
            "m": nulls(rng.integers(0, 2, n).astype(np.int64)),
            "s": nulls(np.array(words)[rng.integers(0, len(words), n)]),
            "x": nulls(rng.choice(np.array([0.0, -0.0, 0.5, np.nan]), n)),
            tag: pa.array(np.arange(n, dtype=np.int64)),
        })
    paths = {}
    for name, n, words in (("a", 300, WORDS[:4]), ("b", 200, WORDS[2:])):
        p = str(d / f"{name}.parquet")
        pq.write_table(table(n, words, name + "_id"), p)
        paths[name] = p
    return paths


JOIN_ON = {"two keys": ["k", "j"], "three keys": ["k", "j", "m"],
           "string key": "s", "double key": "x",
           "string and int keys": ["s", "k"]}


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
@pytest.mark.parametrize("on", list(JOIN_ON))
def test_rank_joins_match_tpu_session(multi_key_tables, on, how):
    def run(spark):
        a = spark.read_parquet(multi_key_tables["a"])
        b = spark.read_parquet(multi_key_tables["b"])
        return a.join(b, on=JOIN_ON[on], how=how)
    plan = run(TorchSession(device="cpu")).physical_plan()
    join = plan
    while not isinstance(join, XJ.HashJoinExec):
        join = join.children[0]
    got = plan.execute_collect()
    assert join.stats["probe_mode"] == "rank"
    want = run(TpuSession()).collect()
    assert got.schema.names == want.schema.names
    assert _rows(got) == _rows(want)
    if how == "inner":
        assert got.num_rows > 0
