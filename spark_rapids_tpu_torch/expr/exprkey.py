"""Structural keys over expression trees.

The port's copy of ``expr_key`` and the helpers it calls from
``spark_rapids_tpu/runtime/fuse.py`` (``:332-435``); nothing else of that
module is ported. The SQL lowering (``sql/lower.py``) keys aggregates,
group expressions and ORDER BY items by it: two expressions with equal keys
are the same computation.
"""

from __future__ import annotations

import decimal
import threading
import types as _types

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Expression


def expr_key(e):
    """Stable hashable key for an expression tree: class identity + every
    constructor-visible field, recursively."""
    if isinstance(e, Expression):
        parts = [type(e).__module__, type(e).__qualname__]
        d = vars(e) if hasattr(e, "__dict__") else {
            s: getattr(e, s, None) for s in getattr(e, "__slots__", ())}
        for k in sorted(d):
            parts.append((k, _value_key(d[k])))
        return tuple(parts)
    return _value_key(e)


class _Unkeyable:
    """Marker embedded in a key when some field has no stable content key
    (an arbitrary object whose repr would embed its address)."""

    __slots__ = ()

    def __repr__(self):
        return "<unkeyable>"


UNKEYABLE = _Unkeyable()


_fn_key_active = threading.local()


def _fn_key(v):
    """Stable content key for a plain Python function: bytecode, consts,
    names, defaults, closure contents and the module globals it reads."""
    if hasattr(v, "__func__"):          # bound method: instance state matters
        return ("bound", _value_key(v.__self__), _fn_key(v.__func__))
    # mutually recursive globals would recurse forever; on re-entry the
    # function's bytecode already contributes at the outer level
    active = getattr(_fn_key_active, "ids", None)
    if active is None:
        active = _fn_key_active.ids = set()
    if id(v) in active:
        return ("recursive-fn", getattr(v, "__qualname__", "?"))
    active.add(id(v))
    try:
        return _fn_key_inner(v)
    finally:
        active.discard(id(v))


def _fn_key_inner(v):
    code = v.__code__
    consts = tuple(_value_key(c) for c in code.co_consts)
    defaults = tuple(_value_key(d) for d in (v.__defaults__ or ()))
    closure = tuple(_value_key(c.cell_contents)
                    for c in (v.__closure__ or ()))
    # a global the function reads keys by VALUE (modules by name)
    fglobals = getattr(v, "__globals__", {}) or {}
    gparts = []
    for name in code.co_names:
        if name in fglobals:
            g = fglobals[name]
            gparts.append((name, ("mod", g.__name__)
                           if isinstance(g, _types.ModuleType)
                           else _value_key(g)))
    return ("fn", code.co_code, consts, code.co_names, code.co_varnames,
            defaults, closure, tuple(gparts))


def _value_key(v):
    if isinstance(v, Expression):
        return expr_key(v)
    if isinstance(v, (list, tuple)):
        return tuple(_value_key(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _value_key(x)) for k, x in v.items()))
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return (type(v).__name__, v)
    if isinstance(v, T.DataType):
        return v
    if isinstance(v, decimal.Decimal):   # a scalar subquery's value
        return ("Decimal", str(v))
    if isinstance(v, type):
        return ("class", v.__module__, v.__qualname__)
    if isinstance(v, _types.CodeType):   # nested function consts
        return ("code", v.co_code, tuple(_value_key(c) for c in v.co_consts),
                v.co_names)
    if callable(v) and hasattr(v, "__code__"):
        try:
            return _fn_key(v)
        except (AttributeError, ValueError):
            return UNKEYABLE
    return UNKEYABLE
