"""Right and full outer joins, residual conditions on an inner equi-join and
the keyless full outer join of the PyTorch port on the CPU, held against
the JAX package.

The same parquet files (numpy seeds) go through
``TorchSession(device="cpu")`` and the reference ``TpuSession`` with the
DataFrame API:

- right and full outer joins on a single int key (the sorted single-key
  probe: the matched-build flags turn the direct, hash and unique modes
  off), a string key and two keys (the rank path), over null keys,
  duplicate build keys, an empty build and an empty stream; over one
  stream partition the rows come out in the reference's order;
- a stream of three partitions over a broadcast build: each unmatched
  build row comes out exactly once (the flags of every partition merged,
  the last partition emitting), counted against numpy;
- the keyless full outer join (the nested-loop join), with and without a
  condition, over one and three stream partitions;
- inner equi-joins with a residual condition, on either build side and
  on both probe paths;
- the key pairs of two types that the reference compares rightly (ints of
  two widths, decimals of one scale) through every outer type; the pairs
  it answers wrongly or not at all are refused at planning, each with the
  reference's answer that shows the gap;
- what the reference's ``tag_join`` refuses (a residual condition on an
  outer equi-join, a keyless right outer join) raises
  ``NotImplementedError`` at planning;
- ``ops/joining.matched_build`` against numpy on random ranges;
- a SQL outer join whose ON has no equality keeps its type (the
  reference makes it a cross join and drops the unmatched rows).

Tolerance: none. Keys, integers, strings, decimals and doubles are
compared exactly: a join moves values without arithmetic.
"""

import zlib
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.ops import joining as J
from spark_rapids_tpu_torch.session import TorchSession


def _table(rng, n, key_hi, prefix, null_p=0.15):
    """n rows: an int64 key with nulls and duplicates, a string key over a
    small domain with nulls, and a payload column per type."""
    k = rng.integers(0, key_hi, n)
    kn = rng.random(n) < null_p
    s = rng.integers(0, max(key_hi // 2, 1), n)
    sn = rng.random(n) < null_p
    return pa.table({
        "k": pa.array([None if m else int(v) for v, m in zip(k, kn)],
                      pa.int64()),
        "s": pa.array([None if m else f"v{v}" for v, m in zip(s, sn)],
                      pa.string()),
        f"{prefix}_id": pa.array(np.arange(n, dtype=np.int64)),
        f"{prefix}_x": pa.array(rng.normal(size=n)),
        f"{prefix}_d": pa.array([Decimal(int(v)).scaleb(-2) for v in
                                 rng.integers(-10**5, 10**5, n)],
                                pa.decimal128(9, 2)),
    })


def _write(tmp_path, name, table, n_files=1):
    paths = []
    step = -(-table.num_rows // n_files) if n_files > 1 else 0
    for i in range(n_files):
        p = str(tmp_path / f"{name}{i}.parquet")
        pq.write_table(table.slice(i * step, step) if step else table, p)
        paths.append(p)
    return paths if n_files > 1 else paths[0]


def _rows(tbl):
    """Row tuples by column position (a USING join keeps both sides'
    other columns, so names may repeat)."""
    return list(zip(*[c.to_pylist() for c in tbl.columns]))


def _both(lsrc, rsrc, **kw):
    """(port rows, reference rows, the port's plan, port schema names,
    reference schema names); ``condition`` builds from a functions
    module."""
    cond = kw.pop("condition", None)
    port, ref = TorchSession(device="cpu"), TpuSession()
    pj = port.read_parquet(lsrc).join(
        port.read_parquet(rsrc), condition=None if cond is None else cond(F),
        **kw)
    rj = ref.read_parquet(lsrc).join(
        ref.read_parquet(rsrc), condition=None if cond is None else cond(RF),
        **kw)
    plan = pj.physical_plan()
    got, want = plan.execute_collect(), rj.collect()
    return _rows(got), _rows(want), plan, got.schema.names, want.schema.names


def _hash_joins(plan):
    out = [plan] if isinstance(plan, XJ.HashJoinExec) else []
    for c in plan.children:
        out += _hash_joins(c)
    return out


def _nlj(plan):
    out = [plan] if isinstance(plan, XJ.NestedLoopJoinExec) else []
    for c in plan.children:
        out += _nlj(c)
    return out


ON = {"int": "k", "string": "s", "two": ["k", "s"]}
SHAPES = ["nulls_dups", "empty_build", "empty_stream"]


def _inputs(rng, shape, how):
    lt = _table(rng, 60, 12, "l")
    rt = _table(rng, 25, 12, "r")
    # a right outer join builds the left side, a full one the right side
    build_left = how == "right"
    if shape == "empty_build":
        lt, rt = (lt.slice(0, 0), rt) if build_left else (lt, rt.slice(0, 0))
    elif shape == "empty_stream":
        lt, rt = (lt, rt.slice(0, 0)) if build_left else (lt.slice(0, 0), rt)
    return lt, rt


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("on", list(ON))
@pytest.mark.parametrize("how", ["right", "full"])
def test_outer_joins_match_the_reference(tmp_path, how, on, shape):
    rng = np.random.default_rng(zlib.crc32(f"{how}/{on}/{shape}".encode()))
    lt, rt = _inputs(rng, shape, how)
    got, want, plan, gn, wn = _both(_write(tmp_path, "l", lt),
                                    _write(tmp_path, "r", rt), on=ON[on],
                                    how=how)
    assert gn == wn
    assert got == want                    # one stream partition: in order
    (join,) = _hash_joins(plan)
    assert join.join_type == {"right": J.RIGHT_OUTER,
                              "full": J.FULL_OUTER}[how]
    assert join.build_side == ("left" if how == "right" else "right")
    if on == "int":
        # the matched-build flags turn the direct, hash and unique modes
        # off; a right outer join keeps them
        if how == "full":
            assert join.stats["probe_mode"] == "two"
    else:
        assert join.stats["probe_mode"] == "rank"
    if how == "full" and shape == "nulls_dups":
        assert any(r[0] is None for r in got)   # coalesce(null, null) keys


def _unmatched_build_rows(lt, rt, on):
    """numpy: the right rows whose key tuple no left row has (a null key
    component never matches)."""
    cols = [on] if isinstance(on, str) else on
    lkeys = {tuple(r) for r in zip(*[lt.column(c).to_pylist() for c in cols])
             if None not in r}
    return sum(1 for r in zip(*[rt.column(c).to_pylist() for c in cols])
               if None in r or r not in lkeys)


@pytest.mark.parametrize("on", list(ON))
def test_full_outer_over_three_stream_partitions(tmp_path, on):
    """Each unmatched build row exactly once: the last stream partition
    emits them, after the flags of all three were merged."""
    rng = np.random.default_rng(31)
    lt, rt = _table(rng, 90, 16, "l"), _table(rng, 30, 16, "r")
    got, want, plan, gn, wn = _both(_write(tmp_path, "l", lt, 3),
                                    _write(tmp_path, "r", rt), on=ON[on],
                                    how="full")
    assert gn == wn
    assert sorted(got, key=repr) == sorted(want, key=repr)
    (join,) = _hash_joins(plan)
    assert join.num_partitions == 3
    assert join.stats["stream_partitions"] == 3
    n_unmatched = _unmatched_build_rows(lt, rt, ON[on])
    assert 0 < n_unmatched < rt.num_rows
    assert join.stats["unmatched_build_rows"] == n_unmatched
    # each build row's payload id comes out at least once, the unmatched
    # ones exactly once with a null left side
    ids = [r[gn.index("r_id")] for r in got if r[gn.index("l_id")] is None]
    assert len(ids) == len(set(ids)) == n_unmatched
    # the plan runs again with fresh flags
    again = _rows(plan.execute_collect())
    assert sorted(again, key=repr) == sorted(got, key=repr)


def test_right_outer_over_three_stream_partitions(tmp_path):
    rng = np.random.default_rng(32)
    lt, rt = _table(rng, 30, 16, "l"), _table(rng, 90, 16, "r")
    got, want, plan, _, _ = _both(_write(tmp_path, "l", lt),
                                  _write(tmp_path, "r", rt, 3), on="k",
                                  how="right")
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert _hash_joins(plan)[0].num_partitions == 3


def _gt(M):
    return M.col("l_x") > M.col("r_x")


@pytest.mark.parametrize("n_files", [1, 3])
@pytest.mark.parametrize("cond", [None, _gt], ids=["no_condition", "l_gt_r"])
def test_keyless_full_outer(tmp_path, cond, n_files):
    rng = np.random.default_rng(41)
    lt = _table(rng, 24, 8, "l").drop(["k", "s"])
    rt = _table(rng, 9, 8, "r").drop(["k", "s"])
    got, want, plan, gn, wn = _both(_write(tmp_path, "l", lt, n_files),
                                    _write(tmp_path, "r", rt), how="full",
                                    condition=cond)
    assert gn == wn
    if n_files == 1:
        assert got == want
    else:
        assert sorted(got, key=repr) == sorted(want, key=repr)
    (nlj,) = _nlj(plan)
    assert nlj.join_type == J.FULL_OUTER
    if cond is not None:
        lx, rx = lt.column("l_x").to_pylist(), rt.column("r_x").to_pylist()
        unmatched = sum(1 for b in rx if not any(a > b for a in lx))
        assert nlj.stats["unmatched_build_rows"] == unmatched


@pytest.mark.parametrize("empty", ["left", "right"])
def test_keyless_full_outer_with_an_empty_side(tmp_path, empty):
    rng = np.random.default_rng(42)
    lt = _table(rng, 12, 8, "l").drop(["k", "s"])
    rt = _table(rng, 5, 8, "r").drop(["k", "s"])
    if empty == "left":
        lt = lt.slice(0, 0)
    else:
        rt = rt.slice(0, 0)
    got, want, _, _, _ = _both(_write(tmp_path, "l", lt),
                               _write(tmp_path, "r", rt), how="full",
                               condition=_gt)
    assert got == want and len(got) == max(lt.num_rows, rt.num_rows)


def _l_lt_r(M):
    return M.col("l_x") < M.col("r_x")


@pytest.mark.parametrize("on", list(ON))
@pytest.mark.parametrize("build", ["left", "right"])
def test_inner_join_with_a_residual_condition(tmp_path, on, build):
    """The condition is evaluated on each chunk of expanded pairs; the
    smaller side builds (the CBO's row estimate), so ``build`` sizes the
    inputs."""
    rng = np.random.default_rng(51)
    small, big = _table(rng, 20, 10, "l"), _table(rng, 70, 10, "r")
    lt, rt = (small, big) if build == "left" else (big.rename_columns(
        [c.replace("r_", "l_") for c in big.column_names]),
        small.rename_columns([c.replace("l_", "r_")
                              for c in small.column_names]))
    got, want, plan, gn, wn = _both(_write(tmp_path, "l", lt),
                                    _write(tmp_path, "r", rt), on=ON[on],
                                    condition=_l_lt_r)
    assert gn == wn
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert got and all(r[gn.index("l_x")] < r[gn.index("r_x")] for r in got)
    (join,) = _hash_joins(plan)
    assert join.condition is not None and join.build_side == build
    # fewer rows than the join without the condition
    nocond, _, _, _, _ = _both(_write(tmp_path, "l", lt),
                               _write(tmp_path, "r", rt), on=ON[on])
    assert len(got) < len(nocond)


def _pair_tables(lk, rk):
    n_l, n_r = len(lk), len(rk)
    return (pa.table({"k": lk, "l_id": pa.array(np.arange(n_l))}),
            pa.table({"k": rk, "r_id": pa.array(np.arange(n_r))}))


D = Decimal
PROMOTED = {
    "int32_int64": (pa.array([1, 2, None, 7, 7, 2**31 - 1], pa.int32()),
                    pa.array([7, 2, 2**31 - 1, 2**32 + 7, None, 9],
                             pa.int64())),
    "int64_int32": (pa.array([2**32 + 1, 1, 5, None], pa.int64()),
                    pa.array([1, 1, 2, None, 5], pa.int32())),
    "dec72_dec92": (pa.array([D("1.50"), D("2.00"), None, D("3.25")],
                             pa.decimal128(7, 2)),
                    pa.array([D("2.00"), D("1.50"), D("9999.99"),
                              D("1.50")], pa.decimal128(9, 2))),
}


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("pair", list(PROMOTED))
def test_key_pairs_the_reference_promotes(tmp_path, pair, how):
    lt, rt = _pair_tables(*PROMOTED[pair])
    got, want, _, gn, wn = _both(_write(tmp_path, "l", lt),
                                 _write(tmp_path, "r", rt), on="k", how=how)
    assert gn == wn
    assert sorted(got, key=repr) == sorted(want, key=repr)


# key pairs the reference compares by their raw values where those mean
# different numbers, or cannot run: (left, right, a join type and the
# reference's wrong answer or error) - ROADMAP Queue 3
REFUSED = {
    # 1.50 (unscaled 150) meets 0.150 (unscaled 150)
    "dec72_dec73": (pa.array([D("1.50")], pa.decimal128(7, 2)),
                    pa.array([D("0.150")], pa.decimal128(7, 3)), "inner",
                    [(D("1.50"), 0, 0)]),
    # 0.01 (unscaled 1) meets the integer 1
    "dec72_int64": (pa.array([D("0.01")], pa.decimal128(7, 2)),
                    pa.array([1], pa.int64()), "inner",
                    [(D("0.01"), 0, 0)]),
    # the direct table truncates the double 2.5 to the integer 2
    "int64_double": (pa.array([2], pa.int64()), pa.array([2.5]), "right",
                     [(2.5, 0, 0)]),
    # a full outer join reads int bounds off the double stream key
    "double_int64": (pa.array([2.5]), pa.array([2], pa.int64()), "full",
                     ValueError),
    "date_int32": (pa.array([1], pa.int32()).cast(pa.date32()),
                   pa.array([1], pa.int32()), "full", ValueError),
}


@pytest.mark.parametrize("pair", list(REFUSED))
def test_key_pairs_the_reference_gets_wrong_are_refused(tmp_path, pair):
    lk, rk, how, ref_answer = REFUSED[pair]
    lt, rt = _pair_tables(lk, rk)
    lp, rp = _write(tmp_path, "l", lt), _write(tmp_path, "r", rt)
    port = TorchSession(device="cpu")
    for jt in ("inner", "left", "right", "full"):
        with pytest.raises(NotImplementedError):
            port.read_parquet(lp).join(port.read_parquet(rp), on="k",
                                       how=jt).physical_plan()
    ref = TpuSession()
    rj = ref.read_parquet(lp).join(ref.read_parquet(rp), on="k", how=how)
    if isinstance(ref_answer, type):
        with pytest.raises(ref_answer):
            rj.collect()
    else:
        assert _rows(rj.collect()) == ref_answer


def test_refused_outer_shapes_raise_at_planning(tmp_path):
    rng = np.random.default_rng(61)
    lp = _write(tmp_path, "l", _table(rng, 10, 4, "l"))
    rp = _write(tmp_path, "r", _table(rng, 10, 4, "r"))
    port = TorchSession(device="cpu")
    a, b = port.read_parquet(lp), port.read_parquet(rp)
    cond = F.col("l_x") < F.col("r_x")
    for how in ("left", "right", "full", "leftsemi", "leftanti"):
        with pytest.raises(NotImplementedError, match="residual condition"):
            a.join(b, on="k", how=how, condition=cond).physical_plan()
    for c in (None, cond):
        with pytest.raises(NotImplementedError, match="keyless right"):
            a.join(b, how="right", condition=c).physical_plan()
    # the exec refuses what the planner does
    scan_a, scan_b = a.physical_plan(), b.physical_plan()
    with pytest.raises(NotImplementedError):
        XJ.BroadcastHashJoinExec("fullouter", [F.col("k")], [F.col("k")],
                                 scan_a, scan_b, condition=cond)
    with pytest.raises(NotImplementedError):
        XJ.NestedLoopJoinExec("rightouter", scan_a, scan_b)


@pytest.mark.parametrize("seed", range(6))
def test_matched_build_against_numpy(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 40))
    n_stream = int(rng.integers(0, 50))
    perm = torch.from_numpy(rng.permutation(cap).astype(np.int32))
    lo = rng.integers(0, cap + 1, n_stream)
    width = rng.integers(0, 4, n_stream) * (rng.random(n_stream) < 0.7)
    hi = np.minimum(lo + width, cap)
    got = J.matched_build(perm, torch.from_numpy(lo),
                          torch.from_numpy(hi), cap).numpy()
    want = np.zeros(cap, bool)
    for a, b in zip(lo, hi):
        want[perm.numpy()[a:b]] = True
    np.testing.assert_array_equal(got, want)


def test_sql_outer_join_without_equi_keys_keeps_its_type(tmp_path):
    """``a LEFT JOIN b ON <no equality>`` keeps the left rows no pair
    matched (the nested-loop join, left outer). The reference lowers any
    join without equi keys as a cross join with the condition, which drops
    them (ROADMAP Queue 3); the port keeps the join type."""
    lp, rp = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"x": pa.array([1, 5, 9], pa.int64())}), lp)
    pq.write_table(pa.table({"y": pa.array([4, 6], pa.int64())}), rp)
    text = "select x, y from a left join b on x < y order by x, y"
    out = []
    for sess in (TorchSession(device="cpu"), TpuSession()):
        sess.create_or_replace_temp_view("a", sess.read_parquet(lp))
        sess.create_or_replace_temp_view("b", sess.read_parquet(rp))
        out.append(_rows(sess.sql(text).collect()))
    got, ref = out
    assert got == [(1, 4), (1, 6), (5, 6), (9, None)]
    assert ref == [(1, 4), (1, 6), (5, 6)]        # x = 9 dropped
