"""Complex-type create and extract expressions.

Counterpart of ``spark_rapids_tpu/expr/complexexprs.py``: ``CreateNamedStruct``,
``GetStructField``, ``CreateArray``, ``GetArrayItem``, ``Size``,
``ElementAt``, ``ArrayContains``, ``CreateMap`` and ``GetMapValue``.

- The fused create+extract pairs (``struct(..).f``, ``array(..)[i]``,
  ``size(array(..))``, ``map(..)[k]``, ``split(..)[i]``,
  ``size(split(..))``) are rewritten inside ``eval`` as in the reference,
  bit for bit, and build no nested column.
- A value that is materialized (a projection that ends in a struct, an
  array or a map) becomes a nested device column (``ops/nested.py``).
- An extraction from a real nested column reads it on the device: the
  rows' element ranges come from the lengths' prefix, and the per-row
  answers from one gather or one ``index_add_``/``scatter_reduce_`` over
  the elements. The reference answers these on its host path.
- Elements, fields and map values may be nested: an item of an
  ``array<struct>`` is a struct column, a field of a struct may be an
  array, and chains such as ``lines[0].l_suppkey`` or ``size(aa[0])``
  read through the levels (the item by a nested gather, ``ops/nested.py``).
  ``array_contains`` takes a scalar element type only.

Spark, not the reference, where they differ: ``element_at(arr, 0)`` raises
(Spark's ``INVALID_INDEX_OF_ZERO``; the reference's default shim answers
null), and a map with a duplicate key raises (Spark 3's default
``spark.sql.mapKeyDedupPolicy=EXCEPTION``; the reference takes the last
pair), as does a null map key. ``size(null)`` is -1, never null (Spark's
legacy default and the reference's).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import StructVector
from spark_rapids_tpu_torch.expr.core import Col, Expression, Literal
from spark_rapids_tpu_torch.ops import nested as N


def _live(ctx) -> torch.Tensor:
    return torch.arange(ctx.capacity, device=ctx.device) < ctx.num_rows


def _null_col(dtype: T.DataType, ctx, dictionary=None) -> Col:
    return Col(torch.full((ctx.capacity,), dtype.default_value(),
                          dtype=dtype.torch_dtype, device=ctx.device),
               torch.zeros((ctx.capacity,), dtype=torch.bool,
                           device=ctx.device), dtype, dictionary)


def _align(a: Col, b: Col):
    """Two Cols of one element type; strings onto one dictionary."""
    if a.is_string and b.is_string and a.dictionary is not b.dictionary:
        from spark_rapids_tpu_torch.ops.strings import union_dictionaries
        return union_dictionaries(a, b)
    return a, b


def _per_element(vec, needle: Col):
    """(rows, elements, needle at each element's row) over a list or map
    column's ``total`` elements, the needle cast to the element type and
    strings on one dictionary."""
    from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
    rows = N.element_rows(vec.data, vec.total)
    elems = Col.from_vector(vec.flat)
    nv = _cast_col(needle, elems.dtype)
    elems, nv = _align(elems, nv)
    return rows, elems, nv


def _row_any(flags: torch.Tensor, rows: torch.Tensor, cap: int):
    """Per row: whether any of its elements' ``flags`` is set."""
    acc = torch.zeros((cap,), dtype=torch.int32, device=flags.device)
    acc.index_add_(0, rows, flags.to(torch.int32))
    return acc > 0


def _gather_element(vec, src: torch.Tensor, ok: torch.Tensor,
                    values: bool = False) -> Col:
    """The flat element (or, for a map's ``values``, the value) at ``src``
    where ``ok``, else null; a nested element by a nested gather."""
    from spark_rapids_tpu_torch.ops.filtering import gather_cols
    flat = vec.values if values else vec.flat
    return gather_cols([Col.from_vector(flat)],
                       src.clamp(0, flat.capacity - 1), ok)[0]


class CreateNamedStruct(Expression):
    """named_struct('a', x, 'b', y): alternating name literals and values."""

    def __init__(self, *name_value_pairs):
        if len(name_value_pairs) % 2:
            raise ValueError("struct() takes name/value pairs")
        self.children = list(name_value_pairs)

    @property
    def field_names(self):
        names = []
        for e in self.children[0::2]:
            if not isinstance(e, Literal):
                raise ValueError("struct field names must be literals")
            names.append(e.value)
        return names

    @property
    def field_values(self):
        return self.children[1::2]

    @property
    def dtype(self):
        return T.StructDataType(self.field_names,
                                [v.dtype for v in self.field_values])

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return CreateNamedStruct(*children)

    def eval(self, ctx):
        live = _live(ctx)
        fields = []
        for v in self.field_values:
            c = v.eval(ctx)
            if c.nested is not None:
                # its padding rows are already null and empty
                fields.append(c)
                continue
            valid = c.validity & live
            default = torch.tensor(c.dtype.default_value(),
                                   dtype=c.values.dtype, device=ctx.device)
            fields.append(Col(torch.where(valid, c.values, default), valid,
                              c.dtype, c.dictionary))
        return Col.from_vector(StructVector(
            self.dtype, [f.to_vector() for f in fields], live))

    def __repr__(self):
        return f"named_struct({', '.join(map(repr, self.children))})"


class GetStructField(Expression):
    """struct.field: over ``struct(..)`` the field's own expression (fused);
    over a real struct column, the field's device column."""

    def __init__(self, child, name: str):
        self.children = [child]
        self.field = name

    @property
    def dtype(self):
        ct = self.children[0].dtype
        if not isinstance(ct, T.StructDataType):
            raise NotImplementedError(f"get_field of a {ct!r}")
        if self.field not in ct.names:
            raise ValueError(f"no field {self.field!r} in {ct!r}")
        return ct.types[ct.names.index(self.field)]

    def with_children(self, children):
        return GetStructField(children[0], self.field)

    def eval(self, ctx):
        src = self.children[0]
        if isinstance(src, CreateNamedStruct):
            i = src.field_names.index(self.field)
            return src.field_values[i].eval(ctx)
        sv = src.eval(ctx).nested
        i = sv.dtype.names.index(self.field)
        return Col.from_vector(sv.fields[i])

    def __repr__(self):
        return f"{self.children[0]!r}.{self.field}"


class CreateArray(Expression):
    """array(a, b, c): the elements' common type; never null."""

    def __init__(self, *children):
        self.children = list(children)

    @property
    def dtype(self):
        from spark_rapids_tpu_torch.expr.conditional import _common_type
        elem = (_common_type([c.dtype for c in self.children])
                if self.children else T.NULL)
        return T.ArrayType(elem)

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return CreateArray(*children)

    def elements(self, ctx) -> list:
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        elem_t = self.dtype.element_type
        return [_cast_col(e.eval(ctx), elem_t) for e in self.children]

    def eval(self, ctx):
        if not self.children:
            raise NotImplementedError("array() of no element is not ported")
        return Col.from_vector(N.from_columns(
            self.dtype, self.elements(ctx), ctx.num_rows, ctx.capacity))

    def __repr__(self):
        return f"array({', '.join(map(repr, self.children))})"


def list_item(vec, ic: Col, live: torch.Tensor) -> Col:
    """Element ``ic`` (0-based, per row) of each ``live`` row of a real list
    column: null when the list or the index is null or the index is out of
    range (Spark non-ANSI)."""
    i = ic.values.to(torch.int64)
    lengths = vec.data.to(torch.int64)
    ok = vec.validity & ic.validity & (i >= 0) & (i < lengths) & live
    return _gather_element(vec, N.starts_of(vec.data) + i, ok)


class GetArrayItem(Expression):
    """arr[i], 0-based: null when i is out of bounds (Spark non-ANSI). Over
    ``array(..)`` and ``split(..)`` the reference's fused forms; over a real
    list column a device gather."""

    def __init__(self, child, index):
        self.children = [child, index]

    @property
    def dtype(self):
        ct = self.children[0].dtype
        if not isinstance(ct, T.ArrayType):
            raise NotImplementedError(f"an item of a {ct!r}")
        return ct.element_type

    def with_children(self, children):
        return GetArrayItem(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        from spark_rapids_tpu_torch.expr.strings import StringSplit
        src, idx = self.children
        if isinstance(src, StringSplit):
            # fused split(s, re)[i]: one split per DICTIONARY entry
            if not isinstance(idx, Literal):
                raise NotImplementedError(
                    "split(...)[col] is not ported (a literal index only)")
            from spark_rapids_tpu_torch.ops import strings as S
            c = src.children[0].eval(ctx)
            i = idx.value

            def fn(s):
                parts = src.split_one(s)
                return (parts[int(i)] if i is not None
                        and 0 <= int(i) < len(parts) else None)
            return S.dict_transform_to_string(c, fn)
        if not isinstance(src, CreateArray) or T.is_nested(self.dtype):
            return list_item(src.eval(ctx).nested,
                             _cast_col(idx.eval(ctx), T.INT), _live(ctx))
        elem_t = self.dtype
        elems = src.elements(ctx)
        n = len(elems)
        if isinstance(idx, Literal):
            i = idx.value
            if i is None or i < 0 or i >= n:
                return _null_col(elem_t, ctx)
            return elems[int(i)]
        ic = _cast_col(idx.eval(ctx), T.INT)
        out = _null_col(elem_t, ctx, elems[0].dictionary
                        if elems and elems[0].is_string else None)
        for i, e in enumerate(elems):
            e, out = _align(e, out)
            hit = ic.validity & (ic.values == i)
            out = Col(torch.where(hit, e.values, out.values),
                      torch.where(hit, e.validity, out.validity),
                      elem_t, out.dictionary)
        return out

    def __repr__(self):
        return f"{self.children[0]!r}[{self.children[1]!r}]"


class Size(Expression):
    """size(array or map): the element count; -1 for a null input, never
    null (Spark's legacy default)."""

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        ct = self.children[0].dtype
        if not isinstance(ct, (T.ArrayType, T.MapType)):
            raise NotImplementedError(f"size of a {ct!r}")
        return T.INT

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return Size(children[0])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.strings import StringSplit
        src = self.children[0]
        if isinstance(src, StringSplit):
            from spark_rapids_tpu_torch.ops import strings as S
            c = src.children[0].eval(ctx)
            out = S.dict_transform_to_values(
                c, lambda s: len(src.split_one(s)), T.INT)
            return Col(torch.where(out.validity, out.values, -1),
                       torch.ones_like(out.validity), T.INT)
        if isinstance(src, CreateArray):
            return Col(torch.full((ctx.capacity,), len(src.children),
                                  dtype=torch.int32, device=ctx.device),
                       torch.ones((ctx.capacity,), dtype=torch.bool,
                                  device=ctx.device), T.INT)
        c = src.eval(ctx)
        live = _live(ctx)
        vals = torch.where(c.validity, c.values.to(torch.int32), -1)
        return Col(torch.where(live, vals, 0), live, T.INT)

    def __repr__(self):
        return f"size({self.children[0]!r})"


def _check_index_zero(zero: torch.Tensor):
    if bool(zero.any()):
        raise RuntimeError(
            "[INVALID_INDEX_OF_ZERO] The index 0 is invalid: element_at "
            "takes a 1-based index (Spark raises in every release)")


class ElementAt(Expression):
    """element_at(array, i): 1-based, a negative index counts from the end,
    a null index or an index out of range gives null (Spark non-ANSI), and
    index 0 raises (Spark's INVALID_INDEX_OF_ZERO)."""

    def __init__(self, child, index):
        self.children = [child, index]

    @property
    def dtype(self):
        ct = self.children[0].dtype
        if not isinstance(ct, T.ArrayType):
            raise NotImplementedError(f"element_at of a {ct!r}")
        return ct.element_type

    def with_children(self, children):
        return ElementAt(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        src, idx = self.children
        if isinstance(src, CreateArray) and not T.is_nested(self.dtype):
            n = len(src.children)
            if isinstance(idx, Literal):
                i = idx.value
                if i == 0:
                    _check_index_zero(_live(ctx))
                if i is None:
                    return _null_col(self.dtype, ctx)
                return GetArrayItem(src, Literal(
                    int(i) - 1 if i > 0 else n + int(i), T.INT)).eval(ctx)
            ic = _cast_col(idx.eval(ctx), T.INT)
            _check_index_zero(ic.validity & (ic.values == 0) & _live(ctx))
            shifted = torch.where(ic.values > 0, ic.values - 1,
                                  n + ic.values)
            return GetArrayItem(src, _ColExpr(Col(shifted, ic.validity,
                                                  T.INT))).eval(ctx)
        vec = src.eval(ctx).nested
        ic = _cast_col(idx.eval(ctx), T.INT)
        _check_index_zero(vec.validity & ic.validity & (ic.values == 0)
                          & _live(ctx))
        i = ic.values.to(torch.int64)
        zero_based = torch.where(i > 0, i - 1, vec.data.to(torch.int64) + i)
        return list_item(vec, Col(zero_based, ic.validity, T.LONG),
                         _live(ctx))

    def __repr__(self):
        return f"element_at({self.children[0]!r}, {self.children[1]!r})"


class _ColExpr(Expression):
    """An already-evaluated column as an expression (ElementAt's shifted
    index into GetArrayItem's fused multiplex)."""

    def __init__(self, col: Col):
        self.children = []
        self._col = col

    @property
    def dtype(self):
        return self._col.dtype

    def eval(self, ctx):
        return self._col


class ArrayContains(Expression):
    """array_contains(array, value): true if present; null when absent but
    the array holds a null, or when the array or the value is null; false
    otherwise (Spark)."""

    def __init__(self, child, value):
        self.children = [child, value]

    @property
    def dtype(self):
        ct = self.children[0].dtype
        if not isinstance(ct, T.ArrayType) or T.is_nested(ct.element_type):
            raise NotImplementedError(
                f"array_contains over a {ct!r} is not ported (scalar "
                "elements only)")
        return T.BOOLEAN

    def with_children(self, children):
        return ArrayContains(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        src, needle = self.children
        if isinstance(src, CreateArray):
            elem_t = src.dtype.element_type
            nv = _cast_col(needle.eval(ctx), elem_t)
            found = torch.zeros((ctx.capacity,), dtype=torch.bool,
                                device=ctx.device)
            has_null = torch.zeros_like(found)
            for ec in src.elements(ctx):
                ec, nv = _align(ec, nv)
                found = found | (ec.validity & (ec.values == nv.values))
                has_null = has_null | ~ec.validity
            valid = nv.validity & (found | ~has_null)
            return Col(found, valid, T.BOOLEAN)
        vec = src.eval(ctx).nested
        rows, elems, nv = _per_element(vec, needle.eval(ctx))
        t = vec.total
        ev, evalid = elems.values[:t], elems.validity[:t]
        found = _row_any(evalid & (ev == nv.values[rows]), rows, ctx.capacity)
        has_null = _row_any(~evalid, rows, ctx.capacity)
        valid = (vec.validity & nv.validity & (found | ~has_null)
                 & _live(ctx))
        return Col(found & valid, valid, T.BOOLEAN)

    def __repr__(self):
        return f"array_contains({self.children[0]!r}, {self.children[1]!r})"


def _check_map_keys(keys: list, ctx):
    """Spark's map building: a null key raises, and so does a duplicate key
    (``spark.sql.mapKeyDedupPolicy=EXCEPTION``, Spark 3's default)."""
    live = _live(ctx)
    for i, k in enumerate(keys):
        if bool((live & ~k.validity).any()):
            raise RuntimeError("[NULL_MAP_KEY] Cannot use null as map key")
        for k2 in keys[i + 1:]:
            a, b = _align(k, k2)
            if bool((live & (a.values == b.values)).any()):
                raise RuntimeError(
                    "[DUPLICATED_MAP_KEY] Duplicate map key was found "
                    "(spark.sql.mapKeyDedupPolicy=EXCEPTION)")


class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...): never null; a null or duplicate key raises
    (Spark's default)."""

    def __init__(self, *children):
        if len(children) % 2:
            raise ValueError("map() takes key/value pairs")
        self.children = list(children)

    @property
    def dtype(self):
        from spark_rapids_tpu_torch.expr.conditional import _common_type
        ks = [c.dtype for c in self.children[0::2]]
        vs = [c.dtype for c in self.children[1::2]]
        return T.MapType(_common_type(ks) if ks else T.NULL,
                         _common_type(vs) if vs else T.NULL)

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return CreateMap(*children)

    def pairs(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        mt = self.dtype
        keys = [_cast_col(k.eval(ctx), mt.key_type)
                for k in self.children[0::2]]
        _check_map_keys(keys, ctx)
        return keys, [_cast_col(v.eval(ctx), mt.value_type)
                      for v in self.children[1::2]]

    def eval(self, ctx):
        if not self.children:
            raise NotImplementedError("map() of no pair is not ported")
        keys, values = self.pairs(ctx)
        return Col.from_vector(N.from_columns(
            self.dtype, keys, ctx.num_rows, ctx.capacity, values=values))

    def __repr__(self):
        return f"map({', '.join(map(repr, self.children))})"


class GetMapValue(Expression):
    """map[key]: null when the key is absent (Spark non-ANSI). Over
    ``map(..)`` a chain of key-equality selects over the pairs (the
    reference's fused form, its keys checked as Spark builds a map); over a
    real map column the first entry whose key equals the row's."""

    def __init__(self, child, key):
        self.children = [child, key]

    @property
    def dtype(self):
        ct = self.children[0].dtype
        if not isinstance(ct, T.MapType):
            raise NotImplementedError(f"map_value of a {ct!r}")
        return ct.value_type

    def with_children(self, children):
        return GetMapValue(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
        from spark_rapids_tpu_torch.expr.predicates import EqualTo
        src, key = self.children
        elem_t = self.dtype
        if isinstance(src, CreateMap):
            _check_map_keys([_cast_col(k.eval(ctx), src.dtype.key_type)
                             for k in src.children[0::2]], ctx)
            out = _null_col(elem_t, ctx)
            for k_expr, v_expr in zip(src.children[0::2],
                                      src.children[1::2]):
                hit_col = EqualTo(key, k_expr).eval(ctx)
                hit = hit_col.validity & hit_col.values
                v = _cast_col(v_expr.eval(ctx), elem_t)
                v, out = _align(v, out)
                out = Col(torch.where(hit, v.values, out.values),
                          torch.where(hit, v.validity, out.validity),
                          elem_t, out.dictionary)
            return out
        vec = src.eval(ctx).nested
        rows, keys, kv = _per_element(vec, key.eval(ctx))
        t = vec.total
        hit = (keys.validity[:t] & kv.validity[rows]
               & (keys.values[:t] == kv.values[rows]))
        none = vec.values.capacity
        pos = torch.arange(t, dtype=torch.int64, device=ctx.device)
        first = torch.full((ctx.capacity,), none, dtype=torch.int64,
                           device=ctx.device)
        first.scatter_reduce_(0, rows, torch.where(hit, pos, none), "amin")
        ok = (first < none) & vec.validity & _live(ctx)
        return _gather_element(vec, first, ok, values=True)

    def __repr__(self):
        return f"{self.children[0]!r}[{self.children[1]!r}]"


def simplify_extract(e: Expression) -> Expression:
    """``struct(.., f, x, ..).f`` as ``x``, and ``map(k1, v1, ..)[k]`` with
    literal, distinct keys and a literal ``k`` as its value (or a null of
    the value type), where the value's type is the map's; every other
    expression as it is (the same object when nothing changes). Column
    pruning runs it first, so the other fields' columns are not read."""
    def fn(x):
        if isinstance(x, GetStructField) and isinstance(x.children[0],
                                                        CreateNamedStruct):
            src = x.children[0]
            return src.field_values[src.field_names.index(x.field)]
        if (isinstance(x, GetMapValue) and isinstance(x.children[0], CreateMap)
                and isinstance(x.children[1], Literal)):
            src = x.children[0]
            keys = src.children[0::2]
            if not all(isinstance(k, Literal) and k.value is not None
                       for k in keys):
                return x
            kv = [k.value for k in keys]
            if len(set(kv)) != len(kv):
                return x          # the build raises; keep it
            for k, v in zip(keys, src.children[1::2]):
                if k.value == x.children[1].value:
                    return v if v.dtype == x.dtype else x
            return Literal(None, x.dtype)
        return x
    out = e.transform(fn)
    return e if repr(out) == repr(e) else out
