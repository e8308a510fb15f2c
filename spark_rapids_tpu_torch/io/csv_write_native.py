"""Native CSV encode: one transfer per device column, vectorized host text.

Counterpart of ``spark_rapids_tpu/io/csv_write_native.py`` (reference
ColumnarOutputWriter.scala:182; cudf formats the text on the GPU). The
engine's device holds strings as dictionary codes and never row strings, so
the device hands over each column's values and validity in one copy (the
live rows only) and the host formats them with numpy, without an arrow
table.

Formats (where they differ from pyarrow's CSV writer, they are these):
- doubles: the shortest round-trip repr (numpy ``astype('U')``);
- booleans: true/false (Spark's casing);
- floats: the shortest repr that round-trips the float32;
- dates: ISO yyyy-mm-dd; timestamps: ISO with a 'T' separator and six
  fraction digits, in UTC without a zone (the reference's format);
- decimals: fixed scale from the unscaled int64;
- strings: RFC-4180 quoting (a value with a comma, quote, CR or LF is
  quoted, its quotes doubled);
- nulls: an empty field.
A header line names the columns.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T


def _quote_strings(vals: np.ndarray) -> np.ndarray:
    """RFC-4180: quote the values holding a delimiter, quote or newline."""
    need = (np.char.find(vals, ",") >= 0) | (np.char.find(vals, '"') >= 0) \
        | (np.char.find(vals, "\n") >= 0) | (np.char.find(vals, "\r") >= 0)
    if not need.any():
        return vals
    quoted = np.char.add(
        np.char.add('"', np.char.replace(vals, '"', '""')), '"')
    return np.where(need, quoted, vals)


def _to_host(col, num_rows: int):
    """The live rows' values and validity in one device-to-host copy."""
    data = col.data[:num_rows]
    valid = col.validity[:num_rows]
    if data.dtype == torch.bool:
        both = torch.stack([data, valid]).cpu().numpy()
        return both[0], both[1]
    raw = torch.cat([data.contiguous().view(torch.uint8),
                     valid.view(torch.uint8)]).cpu().numpy()
    nb = num_rows * data.element_size()
    vals = raw[:nb].view(T.to_numpy_dtype(col.dtype))
    return vals, raw[nb:].view(np.bool_)


def _format_column(col, dt: T.DataType, num_rows: int) -> np.ndarray:
    """One column as a U-dtype array of ``num_rows`` fields ('' for null)."""
    vals, valid = _to_host(col, num_rows)
    if isinstance(dt, T.StringType):
        if col.dictionary is not None:
            entries = np.array(col.dictionary.to_pylist() + [""],
                               dtype=object)
            codes = np.where(valid, vals, len(entries) - 1)
            txt = entries[codes].astype("U")
        else:
            txt = np.full(num_rows, "", dtype="U1").astype(object)
        txt = _quote_strings(np.asarray(txt, dtype="U"))
    elif isinstance(dt, T.BooleanType):
        txt = np.where(vals, "true", "false")
    elif isinstance(dt, T.DateType):
        txt = vals.astype("datetime64[D]").astype("U")
    elif isinstance(dt, T.TimestampType):
        txt = vals.astype("datetime64[us]").astype("U")
    elif isinstance(dt, T.DecimalType):
        iv = vals.astype(np.int64)
        s = dt.scale
        if s == 0:
            txt = iv.astype("U")
        else:
            sign = np.where(iv < 0, "-", "")
            mag = np.abs(iv)
            whole = (mag // 10**s).astype("U")
            frac = np.char.zfill((mag % 10**s).astype("U"), s)
            txt = np.char.add(np.char.add(np.char.add(sign, whole), "."),
                              frac)
    else:
        # integers and doubles: numpy's str (the shortest repr of a double)
        txt = vals.astype("U32")
    return np.where(valid, txt, "")


def write_batch_file(path: str, batch, schema: T.StructType,
                     header: bool = True, append: bool = False) -> int:
    """One batch → CSV bytes written to ``path``: the header line, then each
    row's fields joined by commas, each line ending in a newline. The rows
    are joined by arrow's element-wise join in one pass (the reference
    concatenates Python strings; the bytes are the same). Returns the bytes
    written."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = batch.num_rows
    cols = []
    for f, c in zip(schema.fields, batch.columns):
        arr = pa.array(_format_column(c, f.data_type, n), pa.string())
        # pyarrow cuts a numpy text array of more than its chunk size
        # (about 64 MB of UCS-4) into a ChunkedArray: one array again
        cols.append(arr.combine_chunks()
                    if isinstance(arr, pa.ChunkedArray) else arr)
    parts = []
    if header:
        parts.append(",".join(
            np.asarray(_quote_strings(np.array([f.name for f in
                                                schema.fields], dtype="U")))
            .tolist()).encode("utf-8") + b"\n")
    if n:
        rows = (pc.binary_join_element_wise(*cols, ",") if cols
                else pa.array([""] * n, pa.string()))
        # each row and its newline: the row, then an empty field, joined
        lines = pc.binary_join_element_wise(rows, pa.scalar(""), "\n")
        offsets = np.frombuffer(lines.buffers()[1], np.int32,
                                n + 1, lines.offset)
        parts.append(memoryview(lines.buffers()[2])[
            int(offsets[0]):int(offsets[-1])])
    elif not header:
        parts.append(b"\n")
    blob = b"".join(parts)
    with open(path, "ab" if append else "wb") as f:
        f.write(blob)
    return len(blob)
