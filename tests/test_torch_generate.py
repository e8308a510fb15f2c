"""explode and posexplode, plain and ``outer``, in the PyTorch port on the
CPU, held against the JAX package.

The same numpy-seeded frame (list columns with null rows, empty lists and
null elements; a string list; a payload list) goes through
``TorchSession(device="cpu")`` and ``TpuSession``, over one and several
partitions and batches; the explode mapping (``ops/nested.explode_mapping``)
is held against the reference ``GenerateExec``'s output batch by batch;
pruning through a generate node, and the refusals. Tolerance: none (every
value is compared exactly).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.session import TorchSession

from test_torch_nested_types import nested_table


@pytest.fixture(scope="module")
def frames():
    t = nested_table(23, 300)
    return t, TorchSession(device="cpu"), TpuSession()


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("col", ["a", "b"])
@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("pos", [False, True])
def test_explode_as_the_reference(frames, parts, col, outer, pos):
    t, port, ref = frames
    got = port.create_dataframe(t, parts).explode(col, outer=outer,
                                                  pos=pos).collect()
    want = ref.create_dataframe(t, parts).explode(col, outer=outer,
                                                  pos=pos).collect()
    assert got.column_names == want.column_names
    assert got.to_pylist() == want.to_pylist()


def test_explode_semantics():
    """A null or empty list emits no row; explode_outer emits one row with a
    null element; posexplode_outer gives it a null position."""
    t = pa.table({"k": [1, 2, 3, 4],
                  "a": pa.array([[7, None], None, [], [8]],
                                pa.list_(pa.int64()))})
    df = TorchSession(device="cpu").create_dataframe(t)
    assert df.explode("a").collect().to_pylist() == [
        {"k": 1, "col": 7}, {"k": 1, "col": None}, {"k": 4, "col": 8}]
    assert df.explode("a", outer=True, pos=True).collect().to_pylist() == [
        {"k": 1, "pos": 0, "col": 7}, {"k": 1, "pos": 1, "col": None},
        {"k": 2, "pos": None, "col": None}, {"k": 3, "pos": None, "col": None},
        {"k": 4, "pos": 0, "col": 8}]
    assert df.filter(E.col("k") == 2).explode("a").collect().num_rows == 0


def test_explode_batches_as_the_reference_exec():
    """The exec's output batch against the reference GenerateExec's over
    the same list column: the live values, validity, capacity and the row
    count."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.exec.basic import ArrowScanExec
    from spark_rapids_tpu.exec.generate import GenerateExec as JGen
    t = nested_table(29, 64).select(["k", "a"])
    port = TorchSession(device="cpu").create_dataframe(t)
    for outer in (False, True):
        for pos in (False, True):
            plan = port.explode("a", outer=outer, pos=pos).physical_plan()
            out, = list(plan.execute_partition(0))
            ref = JGen("a", ArrowScanExec([t]), outer=outer,
                       element_type=JT.LONG, pos=pos)
            jout, = list(ref.execute_partition(0))
            assert out.num_rows == int(jout.num_rows)
            assert out.capacity == jout.capacity
            n = out.num_rows
            for c, jc in zip(out.columns, jout.columns):
                # the live rows' values; the reference leaves gathered
                # values in its padding slots, the port their default
                assert np.array_equal(c.data.numpy()[:n],
                                      np.asarray(jc.data)[:n])
                assert np.array_equal(c.validity.numpy(),
                                      np.asarray(jc.validity))
                assert not c.data.numpy()[n:].any()


def test_pruning_through_a_generate_node(tmp_path):
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io.filescan import FileScanNode
    from spark_rapids_tpu_torch.plan.pruning import prune_columns
    t = nested_table(31, 50)
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path)
    spark = TorchSession(device="cpu")
    df = spark.read_parquet(path).explode("a").select("k", "col")
    pruned = prune_columns(df._plan)

    def scan(n):
        return n if isinstance(n, FileScanNode) else scan(n.children[0])
    assert scan(pruned).output.names == ["k", "a"]
    want = TpuSession().read_parquet(path).explode("a").select(
        "k", "col").collect()
    assert df.collect().to_pylist() == want.to_pylist()


def test_a_map_generator_is_refused():
    from spark_rapids_tpu_torch.plan import nodes as NN
    from spark_rapids_tpu_torch.session import DataFrame
    from spark_rapids_tpu_torch import types as T
    t = pa.table({"m": pa.array([[("a", 1)]], pa.map_(pa.string(),
                                                      pa.int64()))})
    df = TorchSession(device="cpu").create_dataframe(t)
    with pytest.raises(TypeError):
        df.explode("m")
    node = NN.GenerateNode("m", df._plan, element_type=T.LONG)
    with pytest.raises(NotImplementedError, match="maps"):
        DataFrame(node, df.session).physical_plan()


def test_explode_of_a_collected_and_split_column():
    t = pa.table({"k": pa.array([1, 2, 1, 3], pa.int64()),
                  "w": ["a b", "c", None, "d e f"]})
    spark = TorchSession(device="cpu")
    df = spark.create_dataframe(t, 2)
    words = df.select("k", F.split("w", " ").alias("ws")).explode(
        "ws").collect()
    ref = TpuSession().create_dataframe(t, 2)
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.expr import core as JE
    want = ref.select("k", JE.Alias(JF.split("w", " "), "ws")).explode(
        "ws").collect()
    assert words.to_pylist() == want.to_pylist()
