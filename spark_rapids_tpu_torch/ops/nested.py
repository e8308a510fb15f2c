"""Device ops over nested columns (``ListVector``, ``MapVector``,
``StructVector``; ``columnar/vector.py``).

The JAX package keeps a list column only between its arrow bridge and its
explode (``exec/generate.py``) and runs everything else over nested values
on its host path. The port keeps them as device columns through every
operator, so these ops carry them. An element, a map value or a struct
field may itself be a list, map or struct: each op recurses through
``ops/filtering.gather_cols`` and ``ops/concat.concat_cols``, which send a
nested column back here.

- ``gather``: rows by index. The new lengths are gathered, their exclusive
  cumsum gives the new starts, and the elements are gathered by a
  segmented index (each output element's row, from ``repeat_interleave``
  of the new lengths, plus its place in the row); a list of lists gathers
  its inner lists the same way, by those element indices. One host sync a
  list level: its new element count, which sizes its flat column.
- ``concat``: the rows of several columns one after another (each flat
  column's elements after the last one's); one host sync a column and
  list level, its element count.
- ``select_rows``: each row from one of several columns of one type (``If``,
  ``CaseWhen``, ``Coalesce``), as one ``gather`` over their ``concat``.
- ``equiv``: per row, whether two columns of one type hold the same value
  under Spark's ordering equivalence (two nulls, two NaNs, -0.0 and 0.0
  are equal at every level): the lengths compared, then the elements of
  the rows of equal length, recursively, and a segmented all-reduce of
  the elements' answers into their rows. One host sync a list level.
- ``order_ranks``: per row, an int64 rank under Spark's interpreted
  ordering of whole values (arrays element by element, a null element
  first and a prefix before the longer array; structs field by field, a
  null field first; the scalars by the sort's rules), equal ranks for the
  values ``equiv`` calls equal. A list level takes prefix doubling: about
  log2 of its longest list in dense-rank passes (one ``torch.unique``
  each), and one host sync, that length.
- ``explode_mapping``: for each output row of an explode, its source row
  and element index, from a searchsorted over the length prefix (the JAX
  package's ``GenerateExec._generate``).
- ``interleave``: ``k`` columns' rows taken row by row (``array(...)``'s
  elements, ``ExpandExec``'s ``k`` projections of a nested column).
- list building: from elements tagged with their row (the collects, over
  rows sorted into segments; ``from_tagged_elements``), from a fixed arity
  (``array(...)``, ``map(...)``; ``from_columns``), and from one list per
  dictionary entry (``split``; ``from_dictionary``).

Plain torch ops; no kernel. A CUDA column stays on the card: nothing here
copies to the host but the counts named above.
"""

from __future__ import annotations

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ListVector, MapVector,
                                                    StructVector,
                                                    TorchColumnVector,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.expr.core import Col


def _gather_flat(flat: TorchColumnVector, src: torch.Tensor, total: int,
                 fcap: int) -> TorchColumnVector:
    """``flat``'s elements at ``src`` (``total`` of them) into a column of
    ``fcap`` slots."""
    from spark_rapids_tpu_torch.ops.filtering import gather_cols
    dev = flat.data.device
    idx = torch.zeros((fcap,), dtype=torch.int64, device=dev)
    idx[:total] = src
    live = torch.arange(fcap, device=dev) < total
    return gather_cols([Col.from_vector(flat)], idx, live)[0].to_vector()


def starts_of(lengths: torch.Tensor) -> torch.Tensor:
    """Each row's first element in the flat column (int64)."""
    cs = torch.cumsum(lengths, 0, dtype=torch.int64)
    return cs - lengths.to(torch.int64)


def element_rows(lengths: torch.Tensor, total: int) -> torch.Tensor:
    """The row of each of the ``total`` elements (int64)."""
    rows = torch.arange(lengths.shape[0], dtype=torch.int64,
                        device=lengths.device)
    return torch.repeat_interleave(rows, lengths.to(torch.int64),
                                   output_size=total)


def _rebuild(vec: ListVector, lengths, validity, elem_src, total):
    """A list or map column like ``vec`` with new rows whose elements are
    ``vec``'s flat elements at ``elem_src``."""
    fcap = bucket_capacity(total)
    flat = _gather_flat(vec.flat, elem_src, total, fcap)
    if isinstance(vec, MapVector):
        values = _gather_flat(vec.values, elem_src, total, fcap)
        return MapVector(vec.dtype, lengths, validity, flat, values, total)
    return ListVector(vec.dtype, lengths, validity, flat, total)


def gather(vec, indices: torch.Tensor, valid_out: torch.Tensor):
    """Rows of a nested column by index (``ops/filtering.gather_cols``'s
    nested case): a slot where ``valid_out`` is false is null and empty."""
    valid = vec.validity[indices] & valid_out
    if isinstance(vec, StructVector):
        from spark_rapids_tpu_torch.ops.filtering import gather_cols
        fields = gather_cols([Col.from_vector(f) for f in vec.fields],
                             indices, valid)
        return StructVector(vec.dtype, [f.to_vector() for f in fields], valid)
    lengths = torch.where(valid, vec.data[indices],
                          torch.zeros((), dtype=vec.data.dtype,
                                      device=vec.data.device))
    total = int(lengths.sum())          # the gather's one host sync
    rows = element_rows(lengths, total)
    within = (torch.arange(total, dtype=torch.int64, device=lengths.device)
              - starts_of(lengths)[rows])
    src = starts_of(vec.data)[indices][rows] + within
    return _rebuild(vec, lengths, valid, src, total)


def take_rows(vec, lo: int, count: int, capacity: int):
    """Rows ``lo .. lo + count`` of a nested column, into ``capacity``
    slots (a partition's slice, a limit's cut)."""
    dev = vec.data.device
    idx = torch.arange(capacity, dtype=torch.int64, device=dev) + lo
    live = torch.arange(capacity, device=dev) < count
    idx = torch.where(live, idx, torch.zeros_like(idx)).clamp_(
        max=vec.capacity - 1)
    return gather(vec, idx, live)


def concat(vecs: list, counts: list, capacity: int):
    """The first ``counts[i]`` rows of each nested column, one after
    another, into ``capacity`` slots (``ops/concat.concat_cols``'s nested
    case)."""
    from spark_rapids_tpu_torch.ops.concat import concat_cols
    first = vecs[0]
    dev = first.data.device
    valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    off = 0
    for v, n in zip(vecs, counts):
        valid[off:off + n] = v.validity[:n]
        off += n
    if isinstance(first, StructVector):
        fields = [concat_cols([Col.from_vector(v.fields[i]) for v in vecs],
                              counts, capacity).to_vector()
                  for i in range(len(first.fields))]
        return StructVector(first.dtype, fields, valid)
    lengths = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    off = 0
    for v, n in zip(vecs, counts):
        lengths[off:off + n] = v.data[:n]
        off += n
    # each column's elements of its first counts[i] rows
    ecounts = [int(v.data[:n].sum()) for v, n in zip(vecs, counts)]
    total = sum(ecounts)
    fcap = bucket_capacity(total)
    flat = concat_cols([Col.from_vector(v.flat) for v in vecs], ecounts,
                       fcap).to_vector()
    if isinstance(first, MapVector):
        values = concat_cols([Col.from_vector(v.values) for v in vecs],
                             ecounts, fcap).to_vector()
        return MapVector(first.dtype, lengths, valid, flat, values, total)
    return ListVector(first.dtype, lengths, valid, flat, total)


def select_rows(vecs: list, choice: torch.Tensor, num_rows: int,
                capacity: int):
    """Row ``r`` of ``vecs[choice[r]]`` for each of the first ``num_rows``
    rows, in ``capacity`` slots: the columns' first ``num_rows`` rows
    concatenated, then one ``gather`` (the columns share one type)."""
    k = len(vecs)
    every = concat(vecs, [num_rows] * k, bucket_capacity(k * num_rows))
    r = torch.arange(capacity, dtype=torch.int64, device=choice.device)
    live = r < num_rows
    idx = torch.where(live, choice.to(torch.int64) * num_rows + r,
                      torch.zeros_like(r))
    return gather(every, idx, live)


def equiv(a: Col, b: Col) -> torch.Tensor:
    """Per row, whether ``a`` and ``b`` (one type, one capacity) are equal
    under Spark's ordering equivalence (``ordering.equiv``, which EqualTo
    uses for arrays and structs): two nulls are equal, a null and a value
    are not, at every level; doubles by ``compareDoubles`` (NaN equals NaN,
    -0.0 equals 0.0). Lists: equal lengths and every element equal. Maps
    have no equality in Spark; the planner refuses them."""
    from spark_rapids_tpu_torch.ops.strings import align_many
    both = a.validity & b.validity
    neither = ~a.validity & ~b.validity
    if a.nested is None:
        if a.is_string:
            a, b = align_many([a, b])
        eq = a.values == b.values
        if a.values.is_floating_point():
            eq = eq | (torch.isnan(a.values) & torch.isnan(b.values))
        return torch.where(both, eq, neither)
    va, vb = a.nested, b.nested
    if isinstance(va, StructVector):
        eq = both
        for fa, fb in zip(va.fields, vb.fields):
            eq = eq & equiv(Col.from_vector(fa), Col.from_vector(fb))
        return torch.where(both, eq, neither)
    same = both & (va.data == vb.data)
    lengths = torch.where(same, va.data, torch.zeros_like(va.data))
    total = int(lengths.sum())          # the level's one host sync
    rows = element_rows(lengths, total)
    within = (torch.arange(total, dtype=torch.int64, device=rows.device)
              - starts_of(lengths)[rows])
    fcap = bucket_capacity(total)
    ea = _gather_flat(va.flat, starts_of(va.data)[rows] + within, total, fcap)
    eb = _gather_flat(vb.flat, starts_of(vb.data)[rows] + within, total, fcap)
    ok = equiv(Col.from_vector(ea), Col.from_vector(eb))[:total]
    bad = torch.zeros((va.capacity,), dtype=torch.int32, device=rows.device)
    bad.index_add_(0, rows, (~ok).to(torch.int32))
    return torch.where(both, same & (bad == 0), neither)


#: the dense-rank passes of ``order_ranks`` (one ``torch.unique``, a sort,
#: each) and its calls; a caller that reports them sets both to 0 first
rank_stats = {"calls": 0, "passes": 0}


def _dense(key: torch.Tensor) -> torch.Tensor:
    """Each entry's place among the distinct values of ``key`` (int64)."""
    rank_stats["passes"] += 1
    return torch.unique(key, sorted=True, return_inverse=True)[1]


def _finish(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Ranks 1.. of the valid rows by ``key``, 0 for the null rows."""
    return torch.where(valid, _dense(key) + 1, torch.zeros_like(key))


def _scalar_image(c: Col) -> torch.Tensor:
    """An order-preserving int64 image of a scalar column: NaN above every
    double and equal to itself, -0.0 equal to 0.0, strings by their code
    in the sorted dictionary."""
    v = c.values
    if v.is_floating_point():
        v = v.to(torch.float64)
        v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
        v = torch.where(v == 0, torch.zeros_like(v), v)
        b = v.view(torch.int64)
        # negative doubles: their bits run backwards, so flip the low 63
        return torch.where(b < 0, b ^ torch.iinfo(torch.int64).max, b)
    return v.to(torch.int64)


def order_ranks(col: Col, order=None) -> torch.Tensor:
    """Per row of ``col`` an int64 rank in ``[0, capacity]`` under Spark's
    interpreted ordering of whole values: null rows (and padding) rank 0,
    below every value; equal values (``equiv``: two nulls, two NaNs, -0.0
    and 0.0, at every level) rank equal; the ranks of other values are
    ordered as the values are. ``order`` (a ``SortOrder``), when it is
    descending, reverses the ranks of the values.

    - scalars: one dense rank of an order-preserving int64 image;
    - structs: the fields' ranks folded from the first field, a dense rank
      of (ranks so far, next field's rank) a field;
    - arrays: the elements ranked first (recursively), then prefix doubling
      over the positions: ``h`` ranks each element's run of ``2^k``
      elements, the end of the list padding it with 0, below every element
      (a null element ranks 1, a value 2..), so a prefix comes before the
      longer array. ``h`` of ``2^(k+1)`` is the dense rank of the pair (the
      run's ``h``, ``h`` of the run ``2^k`` further on). After
      ``ceil(log2(longest))`` rounds ``h`` at a list's first element ranks
      the whole list. A pass a position (least significant first) would
      take ``longest`` stable sorts; doubling takes about log2 of it, which
      holds for long lists too.

    Every level ends in one more dense rank of its rows, so the ranks stay
    below the capacity and compose at the next level up. A map has no
    order in Spark and raises."""
    rank_stats["calls"] += 1
    r = _ranks(col)
    if order is not None and not order.ascending:
        r = torch.where(col.validity, (col.validity.shape[0] + 1) - r, r)
    return r


def _ranks(col: Col) -> torch.Tensor:
    valid = col.validity
    vec = col.nested
    if vec is None:
        return _finish(_scalar_image(col), valid)
    if isinstance(vec, MapVector):
        raise NotImplementedError("a map has no order (Spark orders no map)")
    if isinstance(vec, StructVector):
        acc = None
        cap = vec.capacity
        for f in vec.fields:
            rf = _ranks(Col.from_vector(f))
            acc = rf if acc is None else _dense(acc * (cap + 1) + rf)
        if acc is None:
            return valid.to(torch.int64)
        return _finish(acc, valid)
    lengths = vec.data.to(torch.int64)
    total = int(vec.total)
    if total == 0:
        return valid.to(torch.int64)
    longest = int(lengths.max())            # the level's one host sync
    rows = element_rows(lengths, total)
    starts = starts_of(lengths)
    within = (torch.arange(total, dtype=torch.int64, device=rows.device)
              - starts[rows])
    lens = lengths[rows]
    # element ranks: a null element 1, values 2.., the end of a list 0
    h = _ranks(Col.from_vector(vec.flat))[:total] + 1
    bound = h.new_tensor(vec.flat.capacity + 2)
    idx = torch.arange(total, dtype=torch.int64, device=rows.device)
    step = 1
    while step < longest:
        has = within + step < lens
        nxt = torch.where(has, h[(idx + step).clamp(max=total - 1)],
                          torch.zeros_like(h))
        h = _dense(h * bound + nxt) + 1
        step <<= 1
    first = h[starts.clamp(max=total - 1)]
    key = torch.where(lengths > 0, first + 1, torch.ones_like(first))
    return _finish(key, valid)


def explode_mapping(lengths: torch.Tensor, num_rows: int, outer: bool):
    """The explode of the first ``num_rows`` rows whose element counts are
    ``lengths``: ``(src, elem_idx, real, live, total, out_cap)``. Output row
    ``p`` comes from row ``src[p]``'s element ``elem_idx[p]``; ``real`` is
    false where an outer explode pads a null or empty list with one row of
    a null element; ``live`` marks the ``total`` output rows."""
    dev = lengths.device
    cap = lengths.shape[0]
    row_live = torch.arange(cap, device=dev) < num_rows
    eff = lengths.to(torch.int64)
    if outer:
        eff = torch.clamp(eff, min=1)
    eff = torch.where(row_live, eff, torch.zeros_like(eff))
    cum = torch.cumsum(eff, 0)
    total = int(cum[-1]) if cap else 0      # the one host sync
    out_cap = bucket_capacity(total)
    pos = torch.arange(out_cap, dtype=torch.int64, device=dev)
    src = torch.searchsorted(cum, pos, right=True).clamp_(max=cap - 1)
    base = torch.where(src > 0, cum[(src - 1).clamp(min=0)],
                       torch.zeros_like(src))
    elem_idx = pos - base
    live = pos < total
    real = (elem_idx < lengths[src].to(torch.int64)) & live
    return src, elem_idx, real, live, total, out_cap


def from_tagged_elements(elems: Col, rows: torch.Tensor, total: int,
                         capacity: int, dtype: T.DataType,
                         dedupe: bool = False) -> ListVector:
    """A non-null list in every one of ``capacity`` rows, row ``r`` holding
    the elements tagged ``r`` in their order (``rows`` nondecreasing over
    the ``total`` elements of ``elems``; untagged rows hold an empty list).
    ``dedupe`` keeps the first of equal elements of a row, after a stable
    sort by (row, value), so a row's elements come out in value order
    (``collect_set``; Spark leaves its order unspecified); a nested element
    sorts and compares by its ``order_ranks``."""
    from spark_rapids_tpu_torch.ops.filtering import gather_cols
    from spark_rapids_tpu_torch.ops.sorting import (SortOrder, rank_key,
                                                    sort_permutation)
    dev = rows.device
    ecap = elems.values.shape[0]
    if dedupe and total:
        live = torch.arange(ecap, device=dev) < total
        row_col = Col(torch.zeros((ecap,), dtype=torch.int64, device=dev),
                      live, T.LONG)
        row_col.values[:total] = rows
        # a nested element sorts and compares by its rank
        key = rank_key(elems) if elems.nested is not None else elems
        perm = sort_permutation([row_col, key], [SortOrder(), SortOrder()],
                                total, ecap)
        srt = gather_cols([row_col, key], perm, live)
        r, e = srt[0].values[:total], srt[1]
        same = torch.zeros((total,), dtype=torch.bool, device=dev)
        if total > 1:
            ev = e.values[:total]
            eq = ev[1:] == ev[:-1]
            if isinstance(e.dtype, T.FractionalType):
                eq = eq | (torch.isnan(ev[1:]) & torch.isnan(ev[:-1]))
            same[1:] = (r[1:] == r[:-1]) & eq
        keep = torch.nonzero(~same).squeeze(1)
        total = int(keep.shape[0])
        rows = r[keep]
        ncap = bucket_capacity(total)
        idx = torch.zeros((ncap,), dtype=torch.int64, device=dev)
        idx[:total] = perm[keep]
        elems = gather_cols([elems], idx,
                            torch.arange(ncap, device=dev) < total)[0]
    lengths = torch.bincount(rows, minlength=capacity)[:capacity].to(
        torch.int32) if total else torch.zeros((capacity,), dtype=torch.int32,
                                               device=dev)
    flat = elems.to_vector()
    fcap = bucket_capacity(total)
    if flat.capacity != fcap:
        flat = _gather_flat(flat, torch.arange(total, device=dev), total,
                            fcap)
    valid = torch.ones((capacity,), dtype=torch.bool, device=dev)
    return ListVector(dtype, lengths, valid, flat, total)


def interleave(cols: list, num_rows: int):
    """The first ``num_rows`` rows of ``k`` Cols as one flat Col of
    ``num_rows * k`` elements, row by row (strings onto one dictionary)."""
    from spark_rapids_tpu_torch.ops.strings import align_many
    k = len(cols)
    total = num_rows * k
    fcap = bucket_capacity(total)
    dev = cols[0].values.device
    if cols[0].nested is not None:
        # nested elements: the columns one after another, then row by row
        j = torch.arange(fcap, dtype=torch.int64, device=dev)
        live = j < total
        idx = torch.where(live, (j % k) * num_rows + j // k,
                          torch.zeros_like(j))
        every = concat([c.nested for c in cols], [num_rows] * k, fcap)
        return Col.from_vector(gather(every, idx, live)), total
    if cols[0].is_string:
        cols = align_many(cols)
    vals = torch.stack([c.values[:num_rows] for c in cols], 1).reshape(-1)
    valid = torch.stack([c.validity[:num_rows] for c in cols], 1).reshape(-1)
    v = torch.full((fcap,), cols[0].dtype.default_value(),
                   dtype=vals.dtype, device=dev)
    m = torch.zeros((fcap,), dtype=torch.bool, device=dev)
    v[:total] = vals
    m[:total] = valid
    return Col(v, m, cols[0].dtype, cols[0].dictionary), total


def from_columns(dtype: T.DataType, cols: list, num_rows: int,
                 capacity: int, values: list | None = None):
    """``array(c0, ..., ck-1)`` (or, with ``values``, ``map(k0, v0, ...)``)
    in each of the first ``num_rows`` rows: a non-null list of ``k``
    elements, the padding rows empty."""
    dev = cols[0].values.device
    k = len(cols)
    flat, total = interleave(cols, num_rows)
    live = torch.arange(capacity, device=dev) < num_rows
    lengths = torch.where(live, torch.full((capacity,), k, dtype=torch.int32,
                                           device=dev),
                          torch.zeros((capacity,), dtype=torch.int32,
                                      device=dev))
    if values is None:
        return ListVector(dtype, lengths, live, flat.to_vector(), total)
    vflat, _ = interleave(values, num_rows)
    return MapVector(dtype, lengths, live, flat.to_vector(),
                     vflat.to_vector(), total)


def from_dictionary(codes: Col, entry_lists: list, num_rows: int,
                    dtype: T.DataType) -> ListVector:
    """Each row's list from its dictionary entry's: ``entry_lists[d]`` is
    the (host) list of dictionary entry ``d``, or None for a null list. The
    entries' lists cross to the device once, as a list column of one row
    an entry, and the rows gather it by code; a null row is null."""
    from spark_rapids_tpu_torch.columnar.arrow import list_array_to_device
    dev = codes.values.device
    entries = list_array_to_device(
        pa.array(entry_lists or [None], type=T.to_arrow_type(dtype)),
        dtype, None, dev)
    cap = codes.values.shape[0]
    live = torch.arange(cap, device=dev) < num_rows
    return gather(entries, codes.values.long(), codes.validity & live)
