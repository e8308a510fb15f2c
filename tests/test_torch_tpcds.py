"""The TPC-DS DataFrame queries through the PyTorch port on the CPU.

- The port's generator writes tables equal to the JAX package's
  (``pa.Table.equals``, schemas included) at SF 0.003, its vectorized
  ``decimal(7,2)`` columns among them.
- Each of the reference's 22 DataFrame queries (q3, q42, q52, q55, q7, q19,
  q6, q27, q34, q43, q46, q48, q65, q68, q73, q79, q96, the window queries
  q53, q63, q89 and q98, and q88's cross-joined counts) through
  ``TorchSession(device="cpu")`` at SF 0.012 (``tests/test_tpcds.py``'s size) equals the
  reference's NumPy oracle (``spark_rapids_tpu.benchmarks.tpcds.NP_QUERIES``)
  and the reference's ``TpuSession`` result on the same files.
- The paths they take: q43's seven conditional sums on the dense
  aggregate's stacked float route, q48 and q96 keyless, and the decimal
  column chunks through the arrow route (never the Python parser).

Tolerance: the reference's ``check_rows`` with its ``FLOAT_COLS``: keys,
counts, integer sums and decimals (q48's ``total``, q79's ``profit``)
exact, float slots within rel 1e-9.
"""

import os

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.benchmarks import tpcds as R
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpcds
from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.io import parquet_native as PN
from spark_rapids_tpu_torch.ops import grouping as G
from spark_rapids_tpu_torch.session import TorchSession

PORTED = sorted(tpcds.QUERIES)
TABLES = ["date_dim", "time_dim", "household_demographics", "item",
          "customer_demographics", "promotion", "customer_address", "store",
          "customer", "store_sales", "catalog_sales", "web_sales",
          "inventory"]


def _rows(tbl):
    return [tuple(r.values()) for r in tbl.to_pylist()]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    base = tmp_path_factory.mktemp("tpcds_gen")
    return (tpcds.generate(0.003, str(base / "port")),
            R.generate(0.003, str(base / "ref")))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    paths = tpcds.generate(0.012, str(tmp_path_factory.mktemp("tpcds")))
    spark = TorchSession(device="cpu")
    got = {q: _rows(tpcds.QUERIES[q](tpcds.load(spark, paths)).collect())
           for q in PORTED}
    return paths, got


def test_ported_queries_are_the_reference_set_but_five():
    """All 22: the five the name counts (q53, q63, q89, q98, q88) are
    ported now."""
    assert set(R.QUERIES) == set(tpcds.QUERIES)
    assert len(tpcds.QUERIES) == 22
    assert set(tpcds.NP_QUERIES) == set(tpcds.QUERIES)
    assert all(tpcds.FLOAT_COLS[q] == R.FLOAT_COLS[q] for q in PORTED)


@pytest.mark.parametrize("table", TABLES)
def test_generator_matches_reference(small, table):
    port, ref = small
    assert sorted(port) == sorted(ref) == sorted(TABLES)
    files = sorted(os.listdir(port[table]))
    assert files == sorted(os.listdir(ref[table])) and files
    for f in files:
        a = pq.read_table(os.path.join(port[table], f))
        b = pq.read_table(os.path.join(ref[table], f))
        assert a.schema.equals(b.schema, check_metadata=True)
        assert a.equals(b), (table, f)


@pytest.mark.parametrize("name", PORTED)
def test_query_matches_reference_oracle(data, name):
    paths, got = data
    exp = [tuple(r) for r in R.NP_QUERIES[name](R.load_np(paths))]
    assert exp, "vacuous test: oracle returned no rows"
    R.check_rows(got[name], exp, R.FLOAT_COLS[name])
    # the port's own copy of the oracle gives the same rows
    R.check_rows([tuple(r) for r in tpcds.NP_QUERIES[name](
        tpcds.load_np(paths))], exp, R.FLOAT_COLS[name])


@pytest.mark.parametrize("name", PORTED)
def test_query_matches_tpu_session(data, name):
    paths, got = data
    want = _rows(R.QUERIES[name](R.load(TpuSession(), paths)).collect())
    assert want
    R.check_rows(got[name], want, R.FLOAT_COLS[name])


def _aggs(plan):
    out = [plan] if isinstance(plan, XA.HashAggregateExec) else []
    for c in plan.children:
        out += _aggs(c)
    return out


def test_q43_conditional_sums_take_the_stacked_float_route(data,
                                                           monkeypatch):
    """q43's seven sum(when(d_dow = i, price)) land in one dense aggregate
    batch as masked float sums: the stacked matvec route (two or more
    float requests at a domain of at most 64)."""
    paths, _ = data
    seen = []
    resolve = G.resolve_dense_group_sums

    def record(reqs, codes, n_domain, live):
        seen.append((n_domain, [r for r in reqs
                                if not r[3] and r[2].is_floating_point]))
        return resolve(reqs, codes, n_domain, live)
    monkeypatch.setattr(G, "resolve_dense_group_sums", record)
    plan = tpcds.q43(tpcds.load(TorchSession(device="cpu"),
                                paths)).physical_plan()
    plan.execute_collect()
    (agg,) = _aggs(plan)
    assert agg.stats["segment"] == 0          # the dense path
    assert seen and all(d <= G._STACK_MAX_DOMAIN and len(f) >= 7
                        for d, f in seen)


@pytest.mark.parametrize("name", ["q48", "q96"])
def test_keyless_queries_plan_one_complete_aggregate(data, name):
    paths, got = data
    plan = tpcds.QUERIES[name](tpcds.load(TorchSession(device="cpu"),
                                          paths)).physical_plan()
    (agg,) = _aggs(plan)
    assert not agg.group_exprs and agg.mode == XA.COMPLETE
    assert len(got[name]) == 1


@pytest.mark.parametrize("name", ["q48", "q79"])
def test_decimal_chunks_take_the_arrow_route(data, name):
    """ss_net_profit is FIXED_LEN_BYTE_ARRAY in the files: the device decode
    refuses its chunks and reads them through arrow; no chunk is parsed in
    Python."""
    paths, _ = data
    ss = paths["store_sales"]
    n_files = len([f for f in os.listdir(ss) if f.endswith(".parquet")])
    PN.reset_routes()
    tpcds.QUERIES[name](tpcds.load(TorchSession(device="cpu"),
                                   paths)).collect()
    assert PN.routes["python"] == 0
    assert PN.routes["arrow"] >= n_files          # one decimal chunk a file
    assert PN.routes["native_pages"] > 0


def _find(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        out += _find(c, cls)
    return out


@pytest.mark.parametrize("name", ["q53", "q63", "q89", "q98"])
def test_window_queries_plan_one_window_over_the_aggregate(data, name):
    """The window sits over the group-by's one partition: no exchange below
    it, and it sees every aggregated row."""
    from spark_rapids_tpu_torch.exec.window import WindowExec
    paths, _ = data
    plan = tpcds.QUERIES[name](tpcds.load(TorchSession(device="cpu"),
                                          paths)).physical_plan()
    plan.execute_collect()
    (win,) = _find(plan, WindowExec)
    (agg,) = _aggs(win)
    assert win.child is agg and agg.num_partitions == 1
    assert win.stats["partitions"] == 1
    assert win.stats["input_rows"] == win.stats["output_rows"] > 0


def test_q88_cross_joins_eight_counts(data):
    """Seven nested-loop joins over eight keyless counts, one row each."""
    from spark_rapids_tpu_torch.exec.joins import NestedLoopJoinExec
    paths, got = data
    plan = tpcds.q88(tpcds.load(TorchSession(device="cpu"),
                                paths)).physical_plan()
    plan.execute_collect()
    nljs = _find(plan, NestedLoopJoinExec)
    assert len(nljs) == 7 and len(_aggs(plan)) == 8
    assert all(j.stats["stream_rows"] == j.stats["build_rows"]
               == j.stats["output_rows"] == 1 for j in nljs)
    assert len(got["q88"]) == 1 and len(got["q88"][0]) == 8
