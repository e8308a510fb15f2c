"""String expressions — counterpart of the parts of
``spark_rapids_tpu/expr/strings.py`` the ported path uses (reference
stringFunctions.scala, GpuSubstring).

A string function is a dictionary transform (``ops/strings.py``): it runs
once per distinct value on the host and reaches the rows as one device
gather. Its result dictionary is sorted and unique again, so comparisons,
joins and group-bys over the result stay plain int32 code arithmetic.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Expression, Literal
from spark_rapids_tpu_torch.ops import strings as S


class Substring(Expression):
    """substring(str, pos[, len]): Spark's 1-based indexing, a negative pos
    counting from the end. ``pos`` and ``len`` must be integer literals
    (the reference has the same limit); anything else is refused when the
    expression is typed, so at planning."""

    def __init__(self, child, pos: Expression,
                 length: Expression | None = None):
        self.children = [child, pos] + ([length] if length is not None
                                        else [])

    @property
    def dtype(self):
        if not isinstance(self.children[0].dtype, T.StringType):
            raise NotImplementedError(
                f"substring of a {self.children[0].dtype} is not ported yet")
        for a in self.children[1:]:
            if not (isinstance(a, Literal) and isinstance(a.value, int)
                    and not isinstance(a.value, bool)):
                raise NotImplementedError(
                    "substring with a non-literal position or length is not "
                    "ported yet")
        return T.STRING

    def with_children(self, children):
        return Substring(children[0], children[1],
                         children[2] if len(children) > 2 else None)

    def eval(self, ctx):
        _ = self.dtype
        p = self.children[1].value
        ln = self.children[2].value if len(self.children) > 2 else None
        c = self.children[0].eval(ctx)
        return S.dict_transform_to_string(
            c, lambda s: S.java_substring(s, p, ln))

    def __repr__(self):
        return f"substring({self.children[0]!r})"
