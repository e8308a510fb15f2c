"""String helpers over dictionary-encoded columns.

Counterpart of ``spark_rapids_tpu/ops/strings.py``. Device string columns are int32 codes into a small host-side
SORTED dictionary, so a scalar string function runs once per distinct value
on the host and reaches the rows as one device gather, and two columns with
different dictionaries are remapped onto their sorted union before they meet.
A function whose result is a string (``dict_transform_to_string``) sorts and
dedupes its outputs into a new dictionary, so the invariant holds for what
it returns too: equal strings have equal codes, and code order is string
order.
"""

from __future__ import annotations

import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col


def _empty_dict():
    return pa.array([], type=pa.string())


def sorted_dict_and_rank(entries):
    """File-order dictionary entries → (sorted pa dictionary, rank array
    mapping file-order index → sorted code)."""
    dict_arr = pa.array(entries, pa.string())
    order = pc.array_sort_indices(dict_arr)
    sorted_dict = dict_arr.take(order)
    n = len(dict_arr)
    rank = np.empty(max(n, 1), dtype=np.int32)
    rank[order.to_numpy(zero_copy_only=False)] = np.arange(n, dtype=np.int32)
    return sorted_dict, rank


def align_many(cols):
    """Remap a list of string Cols onto one shared sorted union dictionary."""
    dicts = [c.dictionary if c.dictionary is not None else _empty_dict()
             for c in cols]
    if all(d.equals(dicts[0]) for d in dicts[1:]):
        return list(cols)
    union = pa.concat_arrays(dicts).unique().sort()
    idx = {v: i for i, v in enumerate(union.to_pylist())}
    out = []
    for c, d in zip(cols, dicts):
        m = np.array([idx[v] for v in d.to_pylist()] or [0], dtype=np.int32)
        vals = torch.from_numpy(m).to(c.values.device)[c.values.long()]
        out.append(Col(torch.where(c.validity, vals, 0), c.validity, T.STRING,
                       union))
    return out


def dict_transform_to_string(c: Col, fn) -> Col:
    """Apply a python str -> str (or None) function per dictionary entry.
    The outputs, sorted and deduped, are the new dictionary; the row codes
    are remapped by one device gather, and an entry mapped to None makes
    its rows null."""
    entries = c.dictionary.to_pylist() if c.dictionary is not None else []
    outs = [fn(e) for e in entries]
    uniq = sorted(set(o for o in outs if o is not None))
    index = {v: i for i, v in enumerate(uniq)}
    code_map = np.array([index.get(o, 0) for o in outs], dtype=np.int32)
    null_map = np.array([o is None for o in outs], dtype=bool)
    if len(code_map) == 0:
        code_map = np.zeros(1, np.int32)
        null_map = np.zeros(1, bool)
    dev = c.values.device
    codes = c.values.long()
    new_codes = torch.from_numpy(code_map).to(dev)[codes]
    entry_null = torch.from_numpy(null_map).to(dev)[codes]
    validity = c.validity & ~entry_null
    new_codes = torch.where(validity, new_codes, torch.zeros_like(new_codes))
    return Col(new_codes, validity, T.STRING, pa.array(uniq, type=pa.string()))


def coalesce_strings(cols):
    """The first non-null of several string columns, over their shared
    union dictionary."""
    cols = align_many(cols)
    vals = cols[-1].values
    validity = cols[-1].validity
    for c in reversed(cols[:-1]):
        vals = torch.where(c.validity, c.values, vals)
        validity = c.validity | validity
    return Col(torch.where(validity, vals, torch.zeros_like(vals)), validity,
               T.STRING, cols[0].dictionary)


def java_substring(s: str, pos: int, length: int | None) -> str:
    """Spark substring (``UTF8String.substringSQL``): 1-based, a negative
    pos counts from the end, 0 is taken as 1. The end is counted from the
    unclamped start, so ``substring('abc', -5, 3)`` is 'a'."""
    n = len(s)
    start = pos - 1 if pos > 0 else n + pos if pos < 0 else 0
    end = n if length is None else start + length
    start = max(start, 0)
    if start >= end:
        return ""
    return s[start:end]


def dict_transform_to_values(c: Col, fn, out_dtype: T.DataType) -> Col:
    """Apply a python str → value (or None) function per dictionary entry;
    the result reaches the rows as one device gather."""
    entries = c.dictionary.to_pylist() if c.dictionary is not None else []
    outs = [fn(e) for e in entries]
    np_dt = T.to_numpy_dtype(out_dtype)
    vals = np.array([o if o is not None else out_dtype.default_value()
                     for o in outs], dtype=np_dt)
    nulls = np.array([o is None for o in outs], dtype=bool)
    if len(vals) == 0:
        vals = np.zeros(1, np_dt)
        nulls = np.zeros(1, bool)
    dev = c.values.device
    codes = c.values.long()
    new_vals = torch.from_numpy(vals).to(dev)[codes]
    entry_null = torch.from_numpy(nulls).to(dev)[codes]
    validity = c.validity & ~entry_null
    default = torch.tensor(out_dtype.default_value(),
                           dtype=out_dtype.torch_dtype, device=dev)
    return Col(torch.where(validity, new_vals, default), validity, out_dtype)


def union_dictionaries(l: Col, r: Col):
    """Remap two string Cols onto one sorted union dictionary (a host union
    and two device gathers), as any cross-column string operation needs."""
    a, b = align_many([l, r])
    return a, b


def if_strings(pred: Col, a: Col, b: Col) -> Col:
    """``pred ? a : b`` over two string columns (a null predicate takes b),
    on their union dictionary."""
    a, b = union_dictionaries(a, b)
    take_a = pred.values & pred.validity
    vals = torch.where(take_a, a.values, b.values)
    validity = torch.where(take_a, a.validity, b.validity)
    return Col(torch.where(validity, vals, torch.zeros_like(vals)), validity,
               T.STRING, a.dictionary)


_CONCAT_CROSS_LIMIT = 1 << 20


def concat_cols(l: Col, r: Col) -> Col:
    """concat(a, b) of two string columns, null if either is null. Small
    dictionaries: the whole |L|x|R| pair dictionary is built on the host and
    the rows take one 2-D gather. Larger cross products: the distinct code
    pairs present are found on the device (one ``unique``) and only those
    are built on the host."""
    dl = l.dictionary.to_pylist() if l.dictionary is not None else []
    dr = r.dictionary.to_pylist() if r.dictionary is not None else []
    dl, dr = dl or [""], dr or [""]
    nl, nr = len(dl), len(dr)
    validity = l.validity & r.validity
    dev = l.values.device
    key = l.values.to(torch.int64) * nr + r.values.to(torch.int64)
    key = torch.where(validity, key, torch.zeros_like(key))
    if nl * nr <= _CONCAT_CROSS_LIMIT:
        strs = [a + b for a in dl for b in dr]
        uniq = sorted(set(strs))
        index = {v: i for i, v in enumerate(uniq)}
        pair_map = torch.tensor([index[s] for s in strs], dtype=torch.int32,
                                device=dev)
        codes = pair_map[key]
    else:
        uk, inv = torch.unique(key, return_inverse=True)
        keys = uk.cpu().tolist()
        strs = [dl[k // nr] + dr[k % nr] for k in keys]
        uniq = sorted(set(strs))
        index = {v: i for i, v in enumerate(uniq)}
        code_of = torch.tensor([index[s] for s in strs], dtype=torch.int32,
                               device=dev)
        codes = code_of[inv]
    return Col(torch.where(validity, codes, torch.zeros_like(codes)),
               validity, T.STRING, pa.array(uniq, type=pa.string()))


def java_length(s: str) -> int:
    """Spark length(): characters (code points of the UTF8String)."""
    return len(s)


def like_to_regex(pattern: str, escape: str = "\\") -> str:
    """A SQL LIKE pattern as an anchored Python regex (Spark's
    ``StringUtils.escapeLikeRegex``): ``%`` any run, ``_`` one character,
    the escape character quoting a following ``_``, ``%`` or itself (any
    other use is an error, as in Spark). The whole string must match
    (``\\Z``: a trailing newline is not skipped), and ``.`` spans newlines
    (Spark compiles with DOTALL)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape:
            if i + 1 >= len(pattern):
                raise ValueError(
                    f"the escape character is not allowed to end the LIKE "
                    f"pattern {pattern!r}")
            nxt = pattern[i + 1]
            if nxt not in ("_", "%", escape):
                raise ValueError(
                    f"the escape character must precede '_', '%' or itself "
                    f"in the LIKE pattern {pattern!r}")
            out.append(re.escape(nxt))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
        i += 1
    return "(?s)^" + "".join(out) + r"\Z"


_FLOAT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _unique_values(c: Col):
    """The distinct values of a fixed-width column (invalid slots hold the
    default) on the device, and each row's index among them; only the
    distinct values cross to the host. A float column is made unique by
    its bit pattern: ``torch.unique`` takes -0.0 and 0.0 as one value,
    where Spark prints them apart ('-0.0' and '0.0')."""
    bits = _FLOAT_BITS.get(c.values.dtype)
    if bits is None:
        uv, inv = torch.unique(c.values, return_inverse=True)
        return uv.cpu().numpy(), inv
    ub, inv = torch.unique(c.values.view(bits), return_inverse=True)
    return ub.view(c.values.dtype).cpu().numpy(), inv


def value_transform_to_string(c: Col, fmt) -> Col:
    """Fixed-width values → a string Col: ``fmt`` (value → str or None)
    formats each distinct value present once on the host into a sorted
    dictionary; the rows take one device gather (the cast to string,
    ``from_unixtime`` and ``date_format``)."""
    uv, inv = _unique_values(c)
    strs = [fmt(v) for v in uv]
    uniq = sorted(set(s for s in strs if s is not None))
    index = {s: i for i, s in enumerate(uniq)}
    dev = c.values.device
    code_of = torch.tensor([index.get(s, 0) for s in strs] or [0],
                           dtype=torch.int32, device=dev)
    null_of = torch.tensor([s is None for s in strs] or [False],
                           dtype=torch.bool, device=dev)
    validity = c.validity & ~null_of[inv]
    codes = torch.where(validity, code_of[inv], torch.zeros_like(inv,
                                                                 dtype=torch.int32))
    return Col(codes, validity, T.STRING, pa.array(uniq, type=pa.string()))


def value_transform_to_values(c: Col, fn, out_dtype: T.DataType) -> Col:
    """Fixed-width values → fixed-width values through ``fn`` (value →
    value or None) over the distinct values present, one device gather."""
    uv, inv = _unique_values(c)
    outs = [fn(v) for v in uv]
    np_dt = T.to_numpy_dtype(out_dtype)
    dev = c.values.device
    vals = torch.from_numpy(np.array(
        [out_dtype.default_value() if o is None else o for o in outs]
        or [out_dtype.default_value()], dtype=np_dt)).to(dev)
    nulls = torch.tensor([o is None for o in outs] or [False],
                         dtype=torch.bool, device=dev)
    validity = c.validity & ~nulls[inv]
    default = torch.tensor(out_dtype.default_value(),
                           dtype=out_dtype.torch_dtype, device=dev)
    return Col(torch.where(validity, vals[inv], default), validity, out_dtype)
