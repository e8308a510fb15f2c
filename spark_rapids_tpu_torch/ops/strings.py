"""String helpers over dictionary-encoded columns.

Counterpart of the parts of ``spark_rapids_tpu/ops/strings.py`` the ported
path uses. Device string columns are int32 codes into a small host-side
SORTED dictionary, so a scalar string function runs once per distinct value
on the host and reaches the rows as one device gather, and two columns with
different dictionaries are remapped onto their sorted union before they meet.
A function whose result is a string (``dict_transform_to_string``) sorts and
dedupes its outputs into a new dictionary, so the invariant holds for what
it returns too: equal strings have equal codes, and code order is string
order.
"""

from __future__ import annotations

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
