"""TPC-H q1 through the port's session API on the CPU, held against the JAX
package's ``TpuSession`` on the same files and against the NumPy oracle
``np_q1``; and the port's data generator against the JAX package's.

Tolerance: group keys and ``count_order`` exact; the seven f64 columns within
``rel=1e-9`` (tests/test_tpch.py's bound), because per-group sums may be
taken in another order.
"""

import os

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.002


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return jtpch.generate(SF, str(tmp_path_factory.mktemp("tpch_jax")))


@pytest.fixture(scope="module")
def q1_results(paths):
    port = tpch.q1(tpch.load(TorchSession(device="cpu"), paths)).collect()
    ref = jtpch.q1(jtpch.load(TpuSession(), paths)).collect()
    return port.to_pylist(), ref.to_pylist(), tpch.np_q1(tpch.load_np(paths))


def test_generate_writes_the_reference_tables(paths, tmp_path):
    mine = tpch.generate(SF, str(tmp_path / "tpch_port"))
    assert sorted(mine) == sorted(paths)
    for table, d in paths.items():
        files = sorted(f for f in os.listdir(d) if f.endswith(".parquet"))
        assert files == sorted(f for f in os.listdir(mine[table])
                               if f.endswith(".parquet"))
        for f in files:
            assert pq.read_table(os.path.join(mine[table], f)).equals(
                pq.read_table(os.path.join(d, f))), (table, f)


def _assert_q1_equal(got, exp):
    assert len(got) == len(exp) == 4
    for g, e in zip(got, exp):
        g, e = list(g), list(e)
        assert g[0] == e[0] and g[1] == e[1]   # returnflag, linestatus
        assert g[9] == e[9]                    # count_order
        for a, b in zip(g[2:9], e[2:9]):
            assert a == pytest.approx(b, rel=1e-9)


def test_q1_matches_tpu_session(q1_results):
    port, ref, _ = q1_results
    assert [list(r) for r in port] == [list(r) for r in ref]  # column names
    _assert_q1_equal([list(r.values()) for r in port],
                     [list(r.values()) for r in ref])


def test_q1_matches_numpy_oracle(q1_results):
    port, ref, exp = q1_results
    _assert_q1_equal([list(r.values()) for r in port], exp)
    _assert_q1_equal([list(r.values()) for r in ref], exp)


def test_q1_plan_is_scan_aggregate_sort(paths):
    """No exchange: a table directory is one partition, so the aggregate is
    COMPLETE with the Filter and Project hoisted into it."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    df = tpch.q1(tpch.load(TorchSession(device="cpu"), paths))
    plan = df.physical_plan()
    assert isinstance(plan, SortExec)
    agg = plan.child
    assert isinstance(agg, HashAggregateExec) and agg.mode == "complete"
    assert agg.prefilter is not None and agg.preproject is not None
    assert isinstance(agg.child, FileSourceScanExec)
