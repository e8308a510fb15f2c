"""String expressions — counterpart of ``spark_rapids_tpu/expr/strings.py``
(reference stringFunctions.scala: GpuUpper, GpuLower, GpuLength,
GpuStringTrim, GpuSubstring, GpuStartsWith, GpuEndsWith, GpuContains,
GpuLike, GpuRLike, GpuConcat, GpuConcatWs, GpuStringReplace, GpuStringLPad,
GpuStringRPad, GpuStringRepeat, GpuStringLocate, GpuSubstringIndex,
GpuStringTranslate, GpuFindInSet, GpuRegExpReplace, GpuRegExpExtract,
GpuMd5, GpuGetJsonObject) and ``StringSplit`` (GpuStringSplit), whose
array is a list column (``ops/nested.from_dictionary``: each dictionary
entry is split once on the host, and the rows gather the entries' lists
by code); ``split(..)[i]`` and ``size(split(..))`` stay dictionary
transforms (``expr/complexexprs.py``).

A string function is a dictionary transform (``ops/strings.py``): it runs
once per distinct value on the host and reaches the rows as one device
gather. Its result dictionary is sorted and unique again, so comparisons,
joins and group-bys over the result stay plain int32 code arithmetic. The
pattern, position and padding arguments must be literals (the reference has
the same limit); anything else is refused when the expression is typed, so
at planning.
"""

from __future__ import annotations

import hashlib
import json
import re

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Col, Expression, Literal
from spark_rapids_tpu_torch.ops import strings as S


def _string_child(e: Expression, what: str) -> None:
    if not isinstance(e.dtype, T.StringType):
        raise NotImplementedError(f"{what} of a {e.dtype} is not ported yet")


def _literal_args(exprs, what: str, types=None) -> list:
    out = []
    for i, a in enumerate(exprs):
        if not isinstance(a, Literal) or a.value is None:
            raise NotImplementedError(
                f"{what} with a non-literal argument is not ported yet")
        if types is not None and not isinstance(a.value, types[i]):
            raise NotImplementedError(
                f"{what} with a {type(a.value).__name__} argument is not "
                "ported yet")
        out.append(a.value)
    return out


class _UnaryString(Expression):
    out_dtype = T.STRING

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        _string_child(self.children[0], type(self).__name__.lower())
        return self.out_dtype

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if isinstance(self.out_dtype, T.StringType):
            return S.dict_transform_to_string(c, self.fn)
        return S.dict_transform_to_values(c, self.fn, self.out_dtype)

    def fn(self, s):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class Upper(_UnaryString):
    def fn(self, s):
        return s.upper()


class Lower(_UnaryString):
    def fn(self, s):
        return s.lower()


class Length(_UnaryString):
    out_dtype = T.INT

    def fn(self, s):
        return S.java_length(s)


class Trim(_UnaryString):
    """trim(s): Spark strips the space character only."""

    def fn(self, s):
        return s.strip(" ")


class LTrim(_UnaryString):
    def fn(self, s):
        return s.lstrip(" ")


class RTrim(_UnaryString):
    def fn(self, s):
        return s.rstrip(" ")


class Reverse(_UnaryString):
    def fn(self, s):
        return s[::-1]


class InitCap(_UnaryString):
    """initcap(s): each space-separated word's first letter upper case, the
    rest lower case."""

    def fn(self, s):
        return " ".join(w[:1].upper() + w[1:].lower() if w else w
                        for w in s.split(" "))


class Md5(_UnaryString):
    """md5(s): the 32-character hex digest of the UTF-8 bytes, once per
    dictionary entry."""

    def fn(self, s):
        return hashlib.md5(s.encode("utf-8")).hexdigest()


class Substring(Expression):
    """substring(str, pos[, len]): Spark's 1-based indexing, a negative pos
    counting from the end. ``pos`` and ``len`` must be integer literals."""

    def __init__(self, child, pos: Expression,
                 length: Expression | None = None):
        self.children = [child, pos] + ([length] if length is not None
                                        else [])

    @property
    def dtype(self):
        _string_child(self.children[0], "substring")
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


class _StringPredicate(Expression):
    """str op literal pattern → boolean, once per dictionary entry."""

    def __init__(self, child, pattern: Expression):
        self.children = [child, pattern]

    @property
    def dtype(self):
        _string_child(self.children[0], type(self).__name__.lower())
        self.matcher(*_literal_args(self.children[1:], type(self).__name__,
                                    (str,)))
        return T.BOOLEAN

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        test = self.matcher(self.children[1].value)
        c = self.children[0].eval(ctx)
        return S.dict_transform_to_values(c, test, T.BOOLEAN)

    def matcher(self, p):
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__.lower()}({self.children[0]!r}, "
                f"{self.children[1]!r})")


class StartsWith(_StringPredicate):
    def matcher(self, p):
        return lambda s: s.startswith(p)


class EndsWith(_StringPredicate):
    def matcher(self, p):
        return lambda s: s.endswith(p)


class Contains(_StringPredicate):
    def matcher(self, p):
        return lambda s: p in s


class Like(_StringPredicate):
    """str LIKE pattern (escape ``\\``): the pattern translated once
    (``like_to_regex``), matched once per dictionary entry. An invalid
    escape raises while the expression is typed, as Spark's analyzer
    does."""

    def matcher(self, p):
        rx = re.compile(S.like_to_regex(p))
        return lambda s: rx.match(s) is not None


class RLike(_StringPredicate):
    """str RLIKE regex: true when the regex matches anywhere (Java's
    ``Matcher.find``; Python's ``re`` for the common subset)."""

    def matcher(self, p):
        rx = re.compile(p)
        return lambda s: rx.search(s) is not None


class Concat(Expression):
    """concat(s1, s2, ...) of strings: null if any input is null."""

    def __init__(self, *children):
        self.children = list(children)

    @property
    def dtype(self):
        for c in self.children:
            _string_child(c, "concat")
        return T.STRING

    def with_children(self, children):
        return Concat(*children)

    def eval(self, ctx):
        cols = [c.eval(ctx) for c in self.children]
        out = cols[0]
        for c in cols[1:]:
            out = S.concat_cols(out, c)
        return out

    def __repr__(self):
        return f"concat({', '.join(map(repr, self.children))})"


class ConcatWs(Expression):
    """concat_ws(sep, s1, ...): nulls are skipped, so the result is never
    null for a non-null literal separator."""

    def __init__(self, sep: Expression, *children):
        self.children = [sep] + list(children)

    @property
    def dtype(self):
        _literal_args(self.children[:1], "concat_ws", (str,))
        for c in self.children[1:]:
            _string_child(c, "concat_ws")
        return T.STRING

    def with_children(self, children):
        return ConcatWs(children[0], *children[1:])

    def eval(self, ctx):
        sep = Literal(self.children[0].value, T.STRING).eval(ctx)
        acc = Literal("", T.STRING).eval(ctx)
        ones = torch.ones((ctx.capacity,), dtype=torch.bool,
                          device=ctx.device)
        started = torch.zeros_like(ones)
        for ch in self.children[1:]:
            c = ch.eval(ctx)
            joined = S.concat_cols(S.concat_cols(acc, sep), c)
            use_joined = Col(c.validity & started, ones, T.BOOLEAN)
            valid_c = Col(c.validity, ones, T.BOOLEAN)
            # a null input keeps the accumulator; the first non-null one
            # replaces it; every later one joins it after the separator
            step = S.if_strings(use_joined, joined,
                                S.if_strings(valid_c, c, acc))
            acc = Col(step.values, ones, T.STRING, step.dictionary)
            started = started | c.validity
        return acc

    def __repr__(self):
        return f"concat_ws({', '.join(map(repr, self.children))})"


class _LiteralArgsStringFn(Expression):
    """A string column and literal arguments → one dictionary transform."""

    out_dtype = T.STRING
    arg_types = None

    def __init__(self, child, *lits):
        self.children = [child] + list(lits)

    @property
    def dtype(self):
        _string_child(self.children[0], type(self).__name__)
        _literal_args(self.children[1:], type(self).__name__, self.arg_types)
        return self.out_dtype

    def with_children(self, children):
        return type(self)(*children)

    def make_fn(self, *args):
        return lambda s: self.fn(s, *args)

    def eval(self, ctx):
        fn = self.make_fn(*[a.value for a in self.children[1:]])
        c = self.children[0].eval(ctx)
        if isinstance(self.out_dtype, T.StringType):
            return S.dict_transform_to_string(c, fn)
        return S.dict_transform_to_values(c, fn, self.out_dtype)

    def fn(self, s, *args):
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__.lower()}"
                f"({', '.join(map(repr, self.children))})")


class StringReplace(_LiteralArgsStringFn):
    """replace(str, search, replace); an empty search leaves str as it is."""
    arg_types = (str, str)

    def fn(self, s, search, rep):
        return s.replace(search, rep) if search else s


class StringLPad(_LiteralArgsStringFn):
    """lpad(str, len, pad): pad on the left to len, or cut to len."""
    arg_types = (int, str)

    def fn(self, s, ln, pad):
        if ln <= 0:
            return ""
        if len(s) >= ln or not pad:
            return s[:ln]
        need = ln - len(s)
        return (pad * need)[:need] + s


class StringRPad(_LiteralArgsStringFn):
    arg_types = (int, str)

    def fn(self, s, ln, pad):
        if ln <= 0:
            return ""
        if len(s) >= ln or not pad:
            return s[:ln]
        need = ln - len(s)
        return s + (pad * need)[:need]


class StringRepeat(_LiteralArgsStringFn):
    arg_types = (int,)

    def fn(self, s, n):
        return s * max(int(n), 0)


class SubstringIndex(_LiteralArgsStringFn):
    """substring_index(str, delim, count): the part before the count-th
    delimiter (from the end for a negative count)."""
    arg_types = (str, int)

    def fn(self, s, delim, count):
        if not delim or count == 0:
            return ""
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        return delim.join(parts[count:])


class StringTranslate(_LiteralArgsStringFn):
    """translate(str, from, to): each character of ``from`` becomes the one
    at its position in ``to``, or is deleted past its end."""
    arg_types = (str, str)

    def make_fn(self, frm, to):
        table = {}
        for i, ch in enumerate(frm):
            table.setdefault(ord(ch), to[i] if i < len(to) else None)
        return lambda s: s.translate(table)


class FindInSet(_LiteralArgsStringFn):
    """find_in_set(str, list): the 1-based position of str in the comma
    list, 0 when absent or when str holds a comma."""
    out_dtype = T.INT
    arg_types = (str,)

    def fn(self, s, str_list):
        if "," in s:
            return 0
        items = str_list.split(",")
        return items.index(s) + 1 if s in items else 0


class StringLocate(Expression):
    """locate(substr, str[, pos]): 1-based position of substr at or after
    pos, 0 when absent or when pos < 1."""

    def __init__(self, substr, child, start=None):
        self.children = [substr, child,
                         start if start is not None else Literal(1, T.INT)]

    @property
    def dtype(self):
        _string_child(self.children[1], "locate")
        _literal_args([self.children[0], self.children[2]], "locate",
                      (str, int))
        return T.INT

    def with_children(self, children):
        return StringLocate(children[0], children[1], children[2])

    def eval(self, ctx):
        p, st = self.children[0].value, self.children[2].value
        c = self.children[1].eval(ctx)
        return S.dict_transform_to_values(
            c, lambda s: 0 if st <= 0 else s.find(p, st - 1) + 1, T.INT)

    def __repr__(self):
        return f"locate({self.children[0]!r}, {self.children[1]!r})"


def _java_replacement_to_python(rep: str) -> str:
    """Java ``$1`` group references as Python's ``\\1`` (``\\$`` a literal
    dollar)."""
    out = []
    i = 0
    while i < len(rep):
        ch = rep[i]
        if ch == "\\" and i + 1 < len(rep):
            nxt = rep[i + 1]
            out.append(nxt if nxt == "$" else "\\" + nxt)
            i += 2
        elif ch == "$" and i + 1 < len(rep) and rep[i + 1].isdigit():
            out.append("\\" + rep[i + 1])
            i += 2
        else:
            out.append("\\\\" if ch == "\\" else ch)
            i += 1
    return "".join(out)


class RegExpReplace(_LiteralArgsStringFn):
    """regexp_replace(str, regex, replacement) with a literal regex (Java's
    syntax through Python's ``re`` for the common subset)."""
    arg_types = (str, str)

    def make_fn(self, pat, rep):
        rx = re.compile(pat)
        py_rep = _java_replacement_to_python(rep)
        return lambda s: rx.sub(py_rep, s)


class RegExpExtract(_LiteralArgsStringFn):
    """regexp_extract(str, regex, idx): group idx of the first match, or ''
    when nothing matches."""
    arg_types = (str, int)

    def make_fn(self, pat, idx):
        rx = re.compile(pat)

        def extract(s):
            m = rx.search(s)
            if m is None:
                return ""
            g = m.group(int(idx))
            return g if g is not None else ""
        return extract


class _RawInt(int):
    """An int that keeps its JSON token: Spark's get_json_object returns a
    scalar leaf's own text (1.00 stays "1.00")."""

    def __new__(cls, s):
        o = super().__new__(cls, s)
        o.raw = s
        return o


class _RawFloat(float):
    def __new__(cls, s):
        o = super().__new__(cls, s)
        o.raw = s
        return o


def json_path_get(doc: str, path: str):
    """Spark get_json_object over the path subset ``$.a.b``, ``$.a[0].b``,
    ``$[1]``: the raw token text of a scalar, compact JSON of an object or
    array, None for a missing path or an invalid document."""
    if doc is None or not path.startswith("$"):
        return None
    try:
        cur = json.loads(doc, parse_int=_RawInt, parse_float=_RawFloat)
    except (ValueError, TypeError):
        return None
    i, n = 1, len(path)
    while i < n:
        if path[i] == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            key = path[i + 1:j]
            if not key or not isinstance(cur, dict) or key not in cur:
                return None
            cur = cur[key]
            i = j
        elif path[i] == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            try:
                idx = int(path[i + 1:j])
            except ValueError:
                return None
            if not isinstance(cur, list) or not -len(cur) <= idx < len(cur):
                return None
            cur = cur[idx]
            i = j + 1
        else:
            return None
    if cur is None:
        return None
    if isinstance(cur, (dict, list)):
        return json.dumps(cur, separators=(",", ":"))
    if isinstance(cur, bool):
        return "true" if cur else "false"
    if isinstance(cur, (_RawInt, _RawFloat)):
        return cur.raw
    return str(cur)


class GetJsonObject(_LiteralArgsStringFn):
    """get_json_object(json, path) with a literal path: each distinct
    document parses once."""
    arg_types = (str,)

    def fn(self, s, path):
        return json_path_get(s, path)


def java_split(s: str, pattern: str, limit: int) -> list:
    """Java's ``String.split(regex, limit)`` (``Pattern.split``): limit > 0
    caps the part count (limit 1 returns the input unsplit); limit 0 drops
    trailing empty strings; limit < 0 keeps every part; no match gives the
    input itself (so ``""`` splits to ``[""]``); a zero-width match at the
    start makes no leading empty part; capture groups add nothing. The
    reference's copy (``re.split``) adds a capture group's text as parts."""
    if s is None:
        return []
    out = []
    index = 0
    limited = limit > 0
    for m in re.finditer(pattern, s):
        if limited and len(out) >= limit - 1:
            break
        if index == 0 and m.start() == 0 and m.end() == 0:
            continue
        out.append(s[index:m.start()])
        index = m.end()
    if index == 0 and not out:
        return [s]
    out.append(s[index:])
    if limit == 0:
        while out and out[-1] == "":
            out.pop()
    return out


def spark_split(s: str, pattern: str, limit: int) -> list:
    """Spark's ``split`` (``UTF8String.split``): an empty pattern over a
    non-empty string gives its characters (at most ``limit`` parts when
    limit > 0, the last holding the rest); otherwise limit 0 means -1, so
    trailing empty strings stay (the reference's java_split drops them),
    then Java's ``String.split``."""
    if s is None:
        return []
    if s and pattern == "":
        n = len(s)
        k = n if limit <= 0 or limit > n else limit
        return list(s[:k - 1]) + [s[k - 1:]]
    return java_split(s, pattern, -1 if limit == 0 else limit)


class StringSplit(Expression):
    """split(str, regex[, limit]) → array<string> with a literal pattern and
    limit (the reference's limit too), Spark's semantics (``spark_split``).
    Materialized, the array is a list column: each dictionary entry is
    split once on the host; fused under ``[i]`` or ``size`` it stays a
    dictionary transform (``expr/complexexprs.py``)."""

    def __init__(self, child, pattern, limit=None):
        self.children = ([child, pattern]
                         + ([limit] if limit is not None else []))

    @property
    def dtype(self):
        _string_child(self.children[0], "split")
        self.pattern_limit()
        return T.ArrayType(T.STRING)

    def with_children(self, children):
        return StringSplit(children[0], children[1],
                           children[2] if len(children) > 2 else None)

    def pattern_limit(self):
        pat = self.children[1]
        lim = self.children[2] if len(self.children) > 2 else None
        if not isinstance(pat, Literal) or not (lim is None or isinstance(
                lim, Literal)):
            raise NotImplementedError(
                "split with a non-literal pattern or limit is not ported")
        return pat.value, (-1 if lim is None else lim.value)

    def split_one(self, s):
        pat, lim = self.pattern_limit()
        return spark_split(s, pat, lim)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops import nested as N
        c = self.children[0].eval(ctx)
        entries = c.dictionary.to_pylist() if c.dictionary is not None else []
        return Col.from_vector(N.from_dictionary(
            c, [self.split_one(e) for e in entries], ctx.num_rows,
            self.dtype))

    def __repr__(self):
        return f"split({', '.join(map(repr, self.children))})"
