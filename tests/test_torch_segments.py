"""The sort-based segment group-by of the port (``ops/grouping.py``) against
the JAX package's ``spark_rapids_tpu.ops.grouping`` on the same numpy
inputs, made from a seed: ``group_segments``, ``segment_structure``,
``combine_compact_keys`` and every ``segment_*`` function, at capacities 8
to 4,096, over int32, int64, date, boolean, float64 and dictionary-string
keys and values with nulls, NaN, -0.0 and 0.0, all-null and all-NaN groups,
one group, every row its own group, ``num_rows == capacity`` and no rows.

Tolerance: none. Permutations, segment ids, counts, integer sums (which
wrap), extremes, first and last, and the float sums of the range-sum tree
match bit for bit, padding rows included. The port adds the tree's blocks
in the reference's order, and its stable sort ties -0.0 with 0.0 as
``jax.lax.sort`` does on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr.core import Col as JCol
from spark_rapids_tpu.ops import grouping as JG
from spark_rapids_tpu.ops import windowing as JW
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.ops import grouping as G
from spark_rapids_tpu_torch.ops import windowing as W

KINDS = ("int32", "int64", "date", "bool", "float64", "string")
CASES = ("mixed", "one_group", "all_unique", "full", "empty")
CAPS = (8, 64, 1024, 4096)
_NP = {"int32": np.int32, "int64": np.int64, "date": np.int32,
       "bool": np.bool_, "float64": np.float64, "string": np.int32}
_TYPES = {"int32": (T.INT, JT.INT), "int64": (T.LONG, JT.LONG),
          "date": (T.DATE, JT.DATE), "bool": (T.BOOLEAN, JT.BOOLEAN),
          "float64": (T.DOUBLE, JT.DOUBLE), "string": (T.STRING, JT.STRING)}
_DICT = pa.array(["", "BUILDING", "FURNITURE", "MACHINERY", "ÅSA"])


def _draw(rng, kind: str, n: int, domain: int):
    """n values of ``kind`` from about ``domain`` distinct ones; floats
    include NaN, -0.0 and 0.0."""
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "string":
        return rng.integers(0, min(domain, len(_DICT)), n).astype(np.int32)
    if kind == "float64":
        pool = np.concatenate([[np.nan, -0.0, 0.0, -1.5],
                               np.round(rng.normal(0, 100, max(domain, 1)),
                                        2)])
        return rng.choice(pool[:max(domain, 1)], n)
    lo = -5 if kind != "date" else 8000
    return (lo + rng.integers(0, max(domain, 1), n)).astype(_NP[kind])


def _keys(rng, kind: str, case: str, cap: int):
    """(values, validity, num_rows) of one key column, padded to cap with
    the canonical default."""
    n = {"full": cap, "empty": 0}.get(case, cap * 3 // 4)
    if case == "one_group":
        vals = np.repeat(_draw(rng, kind, 1, 1), n)
        valid = np.ones(n, bool)
    elif case == "all_unique":
        if kind in ("bool", "string"):
            n = min(n, 2 if kind == "bool" else len(_DICT))
            vals = (np.arange(n) % 2 == 1) if kind == "bool" else \
                np.arange(n, dtype=np.int32)
        elif kind == "float64":
            vals = rng.permutation(np.arange(n, dtype=np.float64) - n / 2)
        else:
            base = 8000 if kind == "date" else -(n // 2)
            vals = rng.permutation(np.arange(base, base + n)).astype(
                _NP[kind])
        valid = np.ones(n, bool)
        if n < cap:   # and one null row, a group of its own
            vals = np.concatenate([vals, vals[:1]])
            valid = np.concatenate([valid, [False]])
            n += 1
    else:
        vals = _draw(rng, kind, n, max(n // 4, 3))
        valid = rng.random(n) >= 0.1
    return _pad(vals, valid, cap, kind) + (n,)


def _pad(vals, valid, cap: int, kind: str):
    out = np.zeros(cap, dtype=_NP[kind])
    out[:len(vals)] = vals
    v = np.zeros(cap, bool)
    v[:len(valid)] = valid
    out[~v] = 0
    return out, v


def _values(rng, kind: str, cap: int, num_rows: int, seg_of_row):
    """A value column of ``kind``: random values with nulls (ints spanning
    their whole range, so sums wrap), one group made all-null and, for
    floats, another all-NaN."""
    if kind in ("int32", "int64"):
        info = np.iinfo(_NP[kind])
        vals = rng.integers(info.min, info.max, cap, dtype=_NP[kind],
                            endpoint=True)
    else:
        vals = _draw(rng, kind, cap, 16)
    valid = rng.random(cap) >= 0.15
    live_segs = np.unique(seg_of_row[:num_rows])
    if len(live_segs) >= 3:
        valid[seg_of_row == live_segs[0]] = False
        if kind == "float64":
            vals[seg_of_row == live_segs[1]] = np.nan
    valid[num_rows:] = False
    vals[~valid] = 0
    return vals.astype(_NP[kind]), valid


def _cols(vals, valid, kind: str):
    dt, jdt = _TYPES[kind]
    d = _DICT if kind == "string" else None
    return (Col(torch.from_numpy(vals.copy()), torch.from_numpy(valid.copy()),
                dt, d),
            JCol(jnp.asarray(vals), jnp.asarray(valid), jdt, d))


def _same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype.kind == "f":
        assert got.dtype == want.dtype, what
        got, want = got.view(np.int64), want.view(np.int64)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), what


def _structures(kcols, num_rows: int, cap: int, presorted: bool = False):
    port = G.group_segments([c for c, _ in kcols], num_rows, cap,
                            presorted=presorted)
    ref = JG.group_segments([j for _, j in kcols], num_rows, cap,
                            presorted=presorted)
    return port, ref


# no rows: the two smallest capacities are enough
_GRID = [(cap, kind, case) for cap in CAPS for kind in KINDS for case in CASES
         if case != "empty" or cap <= 64]


@pytest.mark.parametrize("cap,kind,case", _GRID)
def test_segments_match_reference(cap, kind, case):
    rng = np.random.default_rng([cap, KINDS.index(kind), CASES.index(case)])
    kv, kvalid, n = _keys(rng, kind, case, cap)
    (p_perm, p_ids, p_bnd, p_live), (r_perm, r_ids, r_bnd, r_live) = \
        _structures([_cols(kv, kvalid, kind)], n, cap)
    for got, want, what in ((p_perm, r_perm, "perm"), (p_ids, r_ids,
                            "seg_ids"), (p_bnd, r_bnd, "boundary"),
                            (p_live, r_live, "live")):
        _same(got, want, what)
    pctx = G.segment_structure(p_ids, cap)
    rctx = JG.segment_structure(r_ids, cap)
    for f in ("boundary", "seg_start", "seg_end"):
        _same(getattr(pctx, f), getattr(rctx, f), f)
    seg_of_row = np.asarray(r_ids)
    for vkind in KINDS:
        vals, valid = _values(rng, vkind, cap, n, seg_of_row)
        pc, jc = _cols(vals, valid, vkind)
        dt, jdt = _TYPES[vkind]
        _same(G.segment_count(pc.validity, pctx),
              JG.segment_count(jc.validity, rctx), (vkind, "count"))
        sums = [(pc.values, jc.values)]
        if vkind in ("int32", "date", "bool"):
            sums.append((pc.values.to(torch.int64),
                         jc.values.astype(jnp.int64)))
        for pv, jv in sums:
            ps, pn = G.segment_sum(pv, pc.validity, pctx)
            rs, rn = JG.segment_sum(jv, jc.validity, rctx)
            _same(ps, rs, (vkind, "sum", str(pv.dtype)))
            _same(pn, rn, (vkind, "sum count"))
        _same(G.segment_min(pc.values, pc.validity, pctx, dt),
              JG.segment_min(jc.values, jc.validity, rctx, jdt),
              (vkind, "min"))
        _same(G.segment_max(pc.values, pc.validity, pctx, dt),
              JG.segment_max(jc.values, jc.validity, rctx, jdt),
              (vkind, "max"))
        for ign in (False, True):
            for pf, jf in ((G.segment_first, JG.segment_first),
                           (G.segment_last, JG.segment_last)):
                pv, pm = pf(pc.values, pc.validity, pctx, ign)
                jv, jm = jf(jc.values, jc.validity, rctx, ign)
                _same(pv, jv, (vkind, pf.__name__, ign))
                _same(pm, jm, (vkind, pf.__name__, ign, "valid"))


@pytest.mark.parametrize("kind", ["int32", "int64", "date", "string"])
@pytest.mark.parametrize("cap", [8, 1024, 4096])
def test_presorted_gives_the_sorted_result(cap, kind):
    """Sorted keys with no null: the presorted structure equals the sorted
    one, and both equal the reference's."""
    rng = np.random.default_rng([cap, KINDS.index(kind), 7])
    for n in (0, cap // 2, cap):
        vals = np.sort(_draw(rng, kind, n, max(n // 3, 1)))
        kv, kvalid = _pad(vals, np.ones(n, bool), cap, kind)
        cols = [_cols(kv, kvalid, kind)]
        sorted_, ref = _structures(cols, n, cap)
        pre, ref_pre = _structures(cols, n, cap, presorted=True)
        for a, b, c, d in zip(sorted_, pre, ref, ref_pre):
            _same(a, b, "port presorted")
            _same(a, c, "reference")
            _same(a, d, "reference presorted")


@pytest.mark.parametrize("cap", [8, 1024])
def test_combine_compact_keys_matches_reference(cap):
    rng = np.random.default_rng(cap)
    n = cap - 3
    cols = []
    for kind in ("string", "bool", "string"):
        vals = _draw(rng, kind, n, 5)
        cols.append(_cols(*_pad(vals, rng.random(n) >= 0.2, cap, kind), kind))
    got = G.combine_compact_keys([c for c, _ in cols])
    want = JG.combine_compact_keys([j for _, j in cols])
    _same(got.values, want.values, "codes")
    _same(got.validity, want.validity, "validity")
    assert G.combine_compact_keys([cols[0][0]]) is None
    num = _cols(*_pad(np.arange(n), np.ones(n, bool), cap, "int64"), "int64")
    assert G.combine_compact_keys([cols[0][0], num[0]]) is None
    # the combined code groups exactly as the separate keys do
    combined = _structures([(got, want)], n, cap)[0][2]
    separate = _structures(cols, n, cap)[0][2]
    _same(combined.sum(), separate.sum(), "groups")


@pytest.mark.parametrize("cap", [1, 8, 1024, 4096])
def test_seg_starts_and_ends_match_reference(cap):
    """Any boundary mask, a first row that is no boundary, none and all
    rows boundaries among them: the reference's cummax/cummin indices."""
    rng = np.random.default_rng(cap + 11)
    masks = [rng.random(cap) < p for p in (0.01, 0.3, 0.9)]
    masks += [np.zeros(cap, bool), np.ones(cap, bool)]
    for m in masks:
        for first in (False, True):
            m = m.copy()
            m[0] = first
            b = torch.from_numpy(m)
            _same(W.seg_starts(b), JW.seg_starts(jnp.asarray(m)), "starts")
            _same(W.seg_ends(b), JW.seg_ends(jnp.asarray(m)), "ends")
