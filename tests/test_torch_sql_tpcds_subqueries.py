"""Four of the official TPC-DS texts lowered last, through
``TorchSession.sql()`` and the reference's ``TpuSession.sql()`` on the same
SF 0.012 files, each also against its NumPy oracle: q14 (INTERSECT of three
channels, UNION ALL, IN (subquery) as a semi join, a scalar subquery in
HAVING, and a ROLLUP over the union), q36 (ROLLUP with ``grouping()`` in a
window's partition), q28 (``count(distinct x)`` beside ``avg(x)`` and
``count(x)``) and q69 (EXISTS and two NOT EXISTS); and the plans the
lowering builds for them. The fixture and helpers are
``test_torch_sql_tpcds.py``'s.

Tolerance: ``check_rows``: exact on keys, integers, strings and decimals,
rel 1e-9 on the float columns (q28's averages are ``sum(x*cnt)/sum(cnt)``
after the DISTINCT rewrite, in both packages).
"""

import pytest

from spark_rapids_tpu_torch.exec import aggregate as XA
from spark_rapids_tpu_torch.exec import exchange as XE
from spark_rapids_tpu_torch.exec.basic import UnionExec
from spark_rapids_tpu_torch.exec.expand import ExpandExec
from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.sql.tpcds_queries import SQL_QUERIES
from test_torch_sql_tpcds import data, matches_the_reference_session  # noqa: F401


def _nodes(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        out += _nodes(c, cls)
    return out


@pytest.mark.parametrize("name", ["q14", "q36", "q28", "q69"])
def test_last_texts_match_the_reference_session(data, name):
    matches_the_reference_session(data, name)


def test_q14_plans_a_union_fed_exchange_and_runs_its_subquery_once(data):
    """q14's outer ROLLUP reads a union of three channel aggregates: the
    Expand over the union has three partitions, so the rollup aggregate
    plans PARTIAL → hash exchange → FINAL. Its scalar subquery, read by the
    HAVING of all three arms, runs once while the text is lowered."""
    spark = data[0]
    df = spark.sql(SQL_QUERIES["q14"])
    assert len(df.subquery_plans) == 1
    plan = df.physical_plan()
    (expand,) = _nodes(plan, ExpandExec)
    assert isinstance(expand.child, UnionExec)
    assert expand.num_partitions == 3
    modes = [a.mode for a in _nodes(plan, XA.HashAggregateExec)
             if a.children[0] is expand
             or isinstance(a.children[0], (XE.ShuffleExchangeExec,
                                           XE.AdaptiveShuffleReaderExec))]
    assert XA.PARTIAL in modes and XA.FINAL in modes
    plan.execute_collect()
    assert expand.stats["output_rows"] == 5 * expand.stats["input_rows"] > 0


def test_q28_takes_the_two_aggregate_distinct_rewrite(data):
    """q28's buckets (avg, count and count distinct of one column) take
    ``_rewrite_distinct``: no Expand, an aggregate over (x) under one over
    no keys."""
    spark = data[0]
    plan = spark.sql(SQL_QUERIES["q28"])._plan
    assert not _nodes(plan, NN.ExpandNode)
    inner = [a for a in _nodes(plan, NN.AggregateNode) if a.group_exprs]
    assert len(inner) == 6


def test_q69_plans_its_exists_as_semi_and_anti_joins(data):
    spark = data[0]
    plan = spark.sql(SQL_QUERIES["q69"])._plan
    kinds = sorted(j.join_type for j in _nodes(plan, NN.JoinNode)
                   if j.join_type in ("leftsemi", "leftanti"))
    assert kinds == ["leftanti", "leftanti", "leftsemi"]
