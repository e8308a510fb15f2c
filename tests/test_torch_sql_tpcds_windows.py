"""The official TPC-DS texts with a window over an aggregate (q53, q63, q89,
q98: ``avg(sum(x)) over (...)`` and ``sum(sum(x)) over (...)``) through
``TorchSession.sql()`` and the reference's ``TpuSession.sql()`` on the same
SF 0.012 files, each also against its NumPy oracle; and the WindowNode the
lowering plans for them. The fixture and helpers are
``test_torch_sql_tpcds.py``'s.

Tolerance: ``check_rows``: exact on keys, integers and strings, rel 1e-9
on the float columns.
"""

import pytest

from spark_rapids_tpu_torch.plan import nodes as NN
from spark_rapids_tpu_torch.sql.tpcds_queries import SQL_QUERIES
from test_torch_sql_tpcds import data, matches_the_reference_session  # noqa: F401


def _nodes(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        out += _nodes(c, cls)
    return out


@pytest.mark.parametrize("name", ["q53", "q63", "q89", "q98"])
def test_window_texts_match_the_reference_session(data, name):
    matches_the_reference_session(data, name)
    spark = data[0]
    plan = spark.sql(SQL_QUERIES[name])._plan
    (win,) = _nodes(plan, NN.WindowNode)
    # the window reads the aggregate's output
    assert isinstance(win.child, NN.AggregateNode)
