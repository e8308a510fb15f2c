"""Cast — Spark (non-ANSI) cast semantics on the device.

Counterpart of ``spark_rapids_tpu/expr/cast.py``, limited to what TPC-H q1
and the numeric promotion of its arithmetic use:

- string → date parses each *dictionary entry* once on the host with Spark's
  ``stringToDate`` rules (``yyyy[-m[m][-d[d]]]``, optional time part), then
  gathers on the device; an unparsable entry is null;
- int → long, int → double and long → double widen exactly as the JAX
  package's ``astype`` does.

Any other pair raises ``NotImplementedError`` (``supported_cast`` lets the
planner refuse it before anything runs).
"""

from __future__ import annotations

import datetime

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression

_WIDENING = {(T.IntegerType, T.LongType), (T.IntegerType, T.DoubleType),
             (T.LongType, T.DoubleType)}


def supported_cast(frm: T.DataType, to: T.DataType) -> bool:
    return (frm == to or (type(frm), type(to)) in _WIDENING
            or (isinstance(frm, T.StringType) and isinstance(to, T.DateType)))


def _parse_date(s: str):
    """Spark DateTimeUtils.stringToDate subset: yyyy[-m[m][-d[d]]] with an
    optional trailing time part after 'T' or ' '."""
    t = s.strip()
    for sep in ("T", " "):
        if sep in t:
            t = t.split(sep, 1)[0]
    parts = t.split("-")
    try:
        if len(parts) == 1:
            d = datetime.date(int(parts[0]), 1, 1)
        elif len(parts) == 2:
            d = datetime.date(int(parts[0]), int(parts[1]), 1)
        elif len(parts) == 3:
            d = datetime.date(int(parts[0]), int(parts[1]), int(parts[2]))
        else:
            return None
    except ValueError:
        return None
    return (d - datetime.date(1970, 1, 1)).days


def cast_col(c: Col, to: T.DataType) -> Col:
    frm = c.dtype
    if frm == to:
        return c
    if not supported_cast(frm, to):
        raise NotImplementedError(f"cast {frm} -> {to} is not ported yet")
    if isinstance(frm, T.StringType):
        from spark_rapids_tpu_torch.ops.strings import dict_transform_to_values
        return dict_transform_to_values(c, _parse_date, to)
    return Col(c.values.to(to.torch_dtype), c.validity, to).canonicalized()


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DataType):
        self.children = [child]
        self.to = to

    @property
    def dtype(self):
        return self.to

    def with_children(self, children):
        return Cast(children[0], self.to)

    def eval(self, ctx):
        return cast_col(self.children[0].eval(ctx), self.to)

    def __repr__(self):
        return f"cast({self.children[0]!r} AS {self.to})"
