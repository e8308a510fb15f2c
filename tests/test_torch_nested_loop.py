"""The nested-loop join of the PyTorch port on the CPU, held against the
JAX package.

The same parquet files go through ``TorchSession(device="cpu")`` and the
reference ``TpuSession``, each joining with no keys (its planner's
``conv_join`` takes the nested-loop join there): the reference's cases of
``tests/test_joins.py`` (cross and conditional inner, left outer with a
condition, semi and anti), every ported join type with and without a
condition over one and several stream partitions and over an empty build
side, the pair expansion cut into many chunks, string columns on both
sides, and TPC-DS q88's shape (keyless aggregates cross-joined). The
refused shape (the keyless right outer join) raises at planning, and the
keyless full outer join, refused until the matched-build flags were
ported, equals the reference.

Tolerance: none. The rows are compared exactly: in order over one stream
partition (both packages expand the pairs left-major and emit the
unmatched rows after the pairs), as multisets over several (the
reference's session emits a left outer join's unmatched rows after every
partition's pairs, the port after each stream batch's, as the reference's
exec does).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.session import TorchSession

HOWS = ["cross", "inner", "left", "leftsemi", "leftanti"]


def _write(tmp_path, name, table, n_files=1):
    step = -(-table.num_rows // n_files) if table.num_rows else 0
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"{name}{i}.parquet")
        pq.write_table(table.slice(i * step, step) if step else table, p)
        paths.append(p)
    return paths if n_files > 1 else paths[0]


def _rows(tbl):
    return [tuple(r.values()) for r in tbl.to_pylist()]


def _run(lsrc, rsrc, how, cond):
    """(port rows, reference rows, the port's plan) for one join; ``cond``
    builds the condition from a functions module."""
    port = TorchSession(device="cpu")
    pj = port.read_parquet(lsrc).join(
        port.read_parquet(rsrc), how=how,
        condition=None if cond is None else cond(F))
    ref = TpuSession()
    rj = ref.read_parquet(lsrc).join(
        ref.read_parquet(rsrc), how=how,
        condition=None if cond is None else cond(RF))
    plan = pj.physical_plan()
    return _rows(plan.execute_collect()), _rows(rj.collect()), plan


def _same(got, want, n_files):
    if n_files > 1:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert got == want


def _nlj(plan):
    out = [plan] if isinstance(plan, XJ.NestedLoopJoinExec) else []
    for c in plan.children:
        out += _nlj(c)
    return out


def _gt(M):
    return M.col("a") > M.col("b")


def test_cross_and_condition(tmp_path):
    """The reference's test_nested_loop_cross_and_condition."""
    lt = _write(tmp_path, "l", pa.table({"a": pa.array([1, 2, 3], pa.int64())}))
    rt = _write(tmp_path, "r", pa.table({"b": pa.array([10, 2, 30, 1],
                                                       pa.int64())}))
    got, want, plan = _run(lt, rt, "cross", None)
    assert len(got) == 12 and got == want
    assert isinstance(plan, XJ.NestedLoopJoinExec)
    got, want, _ = _run(lt, rt, "inner", _gt)
    assert sorted(got) == [(2, 1), (3, 1), (3, 2)] and got == want


def test_left_outer_with_condition(tmp_path):
    lt = _write(tmp_path, "l", pa.table({"a": pa.array([1, 5, 7], pa.int64())}))
    rt = _write(tmp_path, "r", pa.table({"b": pa.array([6, 6], pa.int64())}))
    got, want, _ = _run(lt, rt, "left", _gt)
    assert sorted(got, key=str) == sorted(
        [(1, None), (5, None), (7, 6), (7, 6)], key=str)
    assert got == want


def test_semi_anti_with_condition(tmp_path):
    lt = _write(tmp_path, "l", pa.table({"a": pa.array([1, 5, 7], pa.int64())}))
    rt = _write(tmp_path, "r", pa.table({"b": pa.array([6, 6], pa.int64())}))
    got, want, _ = _run(lt, rt, "leftsemi", _gt)
    assert got == want == [(7,)]
    got, want, _ = _run(lt, rt, "leftanti", _gt)
    assert sorted(got) == [(1,), (5,)] and got == want


def _tables(rng, n_left, n_right):
    lt = pa.table({
        "a": pa.array([None if m else int(v) for v, m in zip(
            rng.integers(0, 20, n_left), rng.random(n_left) < 0.1)],
            pa.int64()),
        "ls": pa.array([["x", "y", None, "z"][i % 4] for i in range(n_left)]),
    })
    rt = pa.table({
        "b": pa.array([None if m else float(v) for v, m in zip(
            rng.integers(0, 20, n_right), rng.random(n_right) < 0.1)],
            pa.float64()),
        "rs": pa.array([["p", None, "q"][i % 3] for i in range(n_right)]),
    })
    return lt, rt


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("cond", [None, _gt], ids=["no_condition", "a_gt_b"])
@pytest.mark.parametrize("n_files", [1, 3])
def test_join_types_match_reference(tmp_path, how, cond, n_files):
    """Every ported type, with and without a condition, over one stream
    partition and three (one broadcast build shared by all three)."""
    rng = np.random.default_rng(len(how) * 7 + n_files)
    lt, rt = _tables(rng, 40, 13)
    got, want, plan = _run(_write(tmp_path, "l", lt, n_files),
                           _write(tmp_path, "r", rt), how, cond)
    _same(got, want, n_files)
    (nlj,) = _nlj(plan)
    assert nlj.stats["partitions"] == n_files
    assert nlj.stats["stream_rows"] == 40 and nlj.stats["build_rows"] == 13
    assert nlj.stats["output_rows"] == len(got)
    if how in ("cross", "inner") and cond is None:
        assert len(got) == 40 * 13


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("cond", [None, _gt], ids=["no_condition", "a_gt_b"])
def test_empty_build_side(tmp_path, how, cond):
    """The reference's special cases: semi keeps nothing, anti and left
    outer keep every left row (null-extended for the outer join)."""
    rng = np.random.default_rng(5)
    lt, rt = _tables(rng, 30, 4)
    got, want, _ = _run(_write(tmp_path, "l", lt, 2),
                        _write(tmp_path, "r", rt.slice(0, 0)), how, cond)
    _same(got, want, 2)
    n = {"cross": 0, "inner": 0, "left": 30, "leftsemi": 0,
         "leftanti": 30}[how]
    assert len(got) == n


@pytest.mark.parametrize("how", HOWS)
def test_empty_stream_side(tmp_path, how):
    rng = np.random.default_rng(6)
    lt, rt = _tables(rng, 10, 4)
    got, want, _ = _run(_write(tmp_path, "l", lt.slice(0, 0)),
                        _write(tmp_path, "r", rt), how, _gt)
    assert got == want == []


@pytest.mark.parametrize("chunk", [64, 48])
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("cond", [None, _gt], ids=["no_condition", "a_gt_b"])
def test_pairs_in_many_chunks(tmp_path, monkeypatch, how, cond, chunk):
    """With 64 (or 48, not a power of two) pairs a chunk, 40 x 13 pairs
    take several chunks: the same rows as the reference's single chunk,
    and the match counts summed across chunks."""
    rng = np.random.default_rng(11)
    lt, rt = _tables(rng, 40, 13)
    ls, rs = _write(tmp_path, "l", lt, 2), _write(tmp_path, "r", rt)
    whole, want, _ = _run(ls, rs, how, cond)
    monkeypatch.setattr(XJ, "_MAX_CHUNK_ROWS", chunk)
    got, _, _ = _run(ls, rs, how, cond)
    assert got == whole
    _same(got, want, 2)


@pytest.mark.parametrize("how", ["right", "full"])
def test_keyless_right_and_full_outer_refused(tmp_path, how):
    """A keyless right outer join is refused, at planning and by the exec
    (the reference's tag_join refuses it too). The keyless full outer join
    was refused as well until the matched-build flags were ported: under
    its old name it now plans and equals the reference
    (tests/test_torch_outer_joins.py covers it in full)."""
    rng = np.random.default_rng(3)
    lt, rt = _tables(rng, 10, 4)
    if how == "full":
        got, want, plan = _run(_write(tmp_path, "l", lt),
                               _write(tmp_path, "r", rt), how, _gt)
        assert [j.join_type for j in _nlj(plan)] == ["fullouter"]
        _same(got, want, 1)
        return
    spark = TorchSession(device="cpu")
    df = spark.read_parquet(_write(tmp_path, "l", lt)).join(
        spark.read_parquet(_write(tmp_path, "r", rt)), how=how,
        condition=F.col("a") > F.col("b"))
    with pytest.raises(NotImplementedError, match="keyless"):
        df.physical_plan()
    # the exec refuses the type as well
    scan = spark.read_parquet(_write(tmp_path, "l", lt)).physical_plan()
    with pytest.raises(NotImplementedError):
        XJ.NestedLoopJoinExec(f"{how}outer", scan, scan)


def test_keyless_aggregates_cross_joined(tmp_path):
    """TPC-DS q88's shape: one-row counts over several partitions, cross
    joined into one row."""
    rng = np.random.default_rng(8)
    lt, _ = _tables(rng, 200, 1)
    src = _write(tmp_path, "l", lt, 4)

    def build(spark, M):
        df = spark.read_parquet(src)
        out = None
        for i in range(4):
            cnt = df.filter(M.col("a") >= M.lit(5 * i)).agg(
                M.count().alias(f"h{i}"))
            out = cnt if out is None else out.join(cnt, how="cross")
        return out
    got = _rows(build(TorchSession(device="cpu"), F).collect())
    want = _rows(build(TpuSession(), RF).collect())
    assert got == want and len(got) == 1
    a = [v for v in lt.column("a").to_pylist() if v is not None]
    assert got[0] == tuple(sum(v >= 5 * i for v in a) for i in range(4))
