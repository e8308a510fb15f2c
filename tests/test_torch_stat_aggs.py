"""stddev/variance of the PyTorch port on the CPU, held against the JAX
package.

``StddevSamp``, ``StddevPop``, ``VarianceSamp`` and ``VariancePop`` over a
double, a float, a smallint and a tinyint column of the small ``qa`` table,
through each route of the aggregate exec: grouped by a dictionary string
(the port's dense group-by; the reference sorts), grouped by an integer
(the sort-based segment group-by in both), keyless, over one partition
(COMPLETE) and two (PARTIAL → exchange → FINAL, the states merged), and
through SQL. The reference's buffers (count, sum, sum of squares) are the
port's, so the results agree to rounding, a null exactly where the
reference has one. Tolerance, on the variance (a stddev squared): 1e-9
relative, or 1e-13 of the column's largest square absolute — the
cancellation in ``s2 - s * mean`` leaves noise of that size, which the
two packages' summation orders make differently (a group of equal doubles
near 1e5 has a variance of 0 or of about 1e-6).
"""

from __future__ import annotations

import math

import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.session import TorchSession

from test_torch_sweep import qa_table  # noqa: E402  (tests/ is on sys.path)

REL = 1e-9
FNS = ["stddev_samp", "stddev_pop", "var_samp", "var_pop"]
COLS = ["doubleF", "floatF", "shortF", "byteF"]


@pytest.fixture(scope="module")
def tables():
    return qa_table(2500, seed=33)


def _frames(t, parts):
    return (TorchSession(device="cpu").create_dataframe(t, parts),
            TpuSession().create_dataframe(t, parts))


def _aggs(mod):
    return [getattr(mod, fn)(c).alias(f"{fn}_{c}") for fn in FNS
            for c in COLS]


SCALE = {"doubleF": 105000.0 ** 2, "floatF": 0.1 ** 2,
         "shortF": 32768.0 ** 2, "byteF": 50.0 ** 2}


def _close(g, e, name=""):
    if g is None or e is None:
        return g is None and e is None
    if isinstance(g, float) and math.isnan(e):
        return math.isnan(g)
    col = next((c for c in SCALE if name.endswith(c)), None)
    if col is None or not isinstance(e, float):
        return g == pytest.approx(e, rel=REL, abs=1e-12)
    if "stddev" in name:
        g, e = g * g, e * e
    return abs(g - e) <= REL * abs(e) + 1e-13 * SCALE[col]


def _same(got, exp, key=None):
    g, e = got.to_pylist(), exp.to_pylist()
    if key is not None:
        g = sorted(g, key=lambda r: (r[key] is None, str(r[key])))
        e = sorted(e, key=lambda r: (r[key] is None, str(r[key])))
    assert len(g) == len(e) and e
    for rg, re_ in zip(g, e):
        assert rg.keys() == re_.keys()
        for k in rg:
            assert _close(rg[k], re_[k], k), (k, rg[k], re_[k])


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("key", ["strF", "booleanF", "intF"])
def test_grouped_moments_match_reference(tables, key, parts):
    port, ref = _frames(tables, parts)
    _same(port.group_by(key).agg(*_aggs(F)).collect(),
          ref.group_by(key).agg(*_aggs(JF)).collect(), key)


@pytest.mark.parametrize("parts", [1, 2])
def test_keyless_moments_match_reference(tables, parts):
    port, ref = _frames(tables, parts)
    _same(port.agg(*_aggs(F)).collect(), ref.agg(*_aggs(JF)).collect())


def test_moments_beside_sums_share_the_dense_route(tables):
    """A stddev beside count/sum/avg of one child in one dense aggregate
    (the sweep's shape)."""
    port, ref = _frames(tables, 2)
    pa_ = [F.count().alias("n"), F.sum("doubleF").alias("s"),
           F.avg("shortF").alias("a"), F.stddev("doubleF").alias("sd"),
           F.var_pop("shortF").alias("vp")]
    ja = [JF.count().alias("n"), JF.sum("doubleF").alias("s"),
          JF.avg("shortF").alias("a"), JF.stddev("doubleF").alias("sd"),
          JF.var_pop("shortF").alias("vp")]
    _same(port.group_by("strF").agg(*pa_).collect(),
          ref.group_by("strF").agg(*ja).collect(), "strF")


@pytest.mark.parametrize("sql", [
    "select strF, stddev_samp(doubleF) a, var_pop(floatF) b, "
    "stddev(shortF) c, variance(byteF) d from qa group by strF",
    "select stddev_pop(doubleF) a, var_samp(shortF) b from qa",
    "select intF % 5 k, stddev(floatF) s from qa group by intF % 5",
])
def test_sql_moments_match_reference(tables, sql):
    port, ref = TorchSession(device="cpu"), TpuSession()
    port.create_or_replace_temp_view("qa", port.create_dataframe(tables, 2))
    ref.create_or_replace_temp_view("qa", ref.create_dataframe(tables, 2))
    key = "strF" if "strF" in sql else ("k" if " k," in sql else None)
    _same(port.sql(sql).collect(), ref.sql(sql).collect(), key)


def test_one_row_groups_and_constants():
    """A sample moment of one row is null, a population one 0; a constant
    group's variance is 0, never negative (the max(m2, 0) clamp)."""
    import pyarrow as pa
    t = pa.table({"g": ["a", "b", "b", "c", "c", "c"],
                  "x": [1.0, 2.0, 2.0, 0.1, 0.1, 0.1]})
    port, ref = _frames(t, 1)
    aggs = lambda m: [m.stddev("x").alias("s"),           # noqa: E731
                      m.var_pop("x").alias("v")]
    got = port.group_by("g").agg(*aggs(F)).collect()
    _same(got, ref.group_by("g").agg(*aggs(JF)).collect(), "g")
    rows = {r["g"]: r for r in got.to_pylist()}
    assert rows["a"]["s"] is None and rows["a"]["v"] == 0.0
    assert rows["b"]["s"] == 0.0 and rows["c"]["v"] >= 0.0
