"""Device CSV scan: a vectorized host boundary scan, the parse on the device.

Counterpart of ``spark_rapids_tpu/io/csv_native.py`` (the reference hands
raw CSV bytes to cudf's parser, GpuBatchScanExec / CSVPartitionReader). The
field boundaries are metadata: one vectorized numpy pass finds delimiters
and newlines and checks the row shape. The bulk work, digit bytes to
numbers, runs on the device (``ops/csv_decode.py``).

Scope: an optional header (schema fields are matched to its columns by
name, as the arrow reader does), a one-byte delimiter, '\\n' line ends,
RFC-4180 quoted fields (boundaries masked by quote parity, wrapping quotes
stripped; a doubled or stray quote inside a field sends the file to the
arrow reader), and int32/int64/double columns (doubles only with
``spark.rapids.tpu.sql.csv.read.float.enabled``). The whole scope decision
is one host pass per file (``try_scan_for_device``), made before the scan
commits to the device: a file out of scope returns None and goes through
the arrow reader whole, as the reference's per-type confs gate cudf.

One difference from the reference: the exponent/inf/nan gate looks at the
double columns' fields only, where the reference looks at every byte of the
body. A file whose other columns hold the letters e, n or i (a flag column,
a name) keeps the device parse; a double written with an exponent still
sends its file to the arrow reader. The parsed values are the same either
way.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

#: CSV files since the last reset_routes(): ``device_files`` (parsed on the
#: device) and ``arrow_files`` (read by the arrow reader: out of the device
#: scope, or the device parse not engaged)
routes = {"device_files": 0, "arrow_files": 0}
_ROUTES_LOCK = threading.Lock()


def reset_routes() -> None:
    with _ROUTES_LOCK:
        for k in routes:
            routes[k] = 0


def route(name: str, n: int = 1) -> None:
    with _ROUTES_LOCK:
        routes[name] += n


class CsvShape:
    """The host-scanned structure of one CSV file, ready for the parse."""

    def __init__(self, data: np.ndarray, n_rows: int, starts: np.ndarray,
                 lens: np.ndarray, col_of: dict):
        self.data = data          # the raw bytes as uint8 (device-bound)
        self.n_rows = n_rows
        self.starts = starts      # (n_rows, n_file_cols) int32
        self.lens = lens          # (n_rows, n_file_cols) int32
        self.col_of = col_of      # schema field name → file column index


def column_in_scope(dtype, allow_floats: bool) -> bool:
    """Integers of every width parse on the device; floats and doubles when
    the float conf allows them; anything else (a timestamp among them, as
    in the reference) sends the file to the arrow reader."""
    if isinstance(dtype, T.FractionalType):
        return allow_floats
    return isinstance(dtype, T.IntegralType)


def _float_notation(body: np.ndarray, bounds: np.ndarray, n_file_cols: int,
                    dbl: list) -> bool:
    """True when a byte e, n or i (either case: exponent, nan and inf
    spellings, which need strtod) lies in a field of one of the ``dbl``
    file columns. Each such byte's field is the count of field boundaries
    before it (``bounds``: the body's field-ending delimiters and
    newlines)."""
    lowered = body | np.uint8(0x20)   # ASCII to lower case
    letters = np.flatnonzero((lowered == ord("e")) | (lowered == ord("n"))
                             | (lowered == ord("i")))
    if not letters.size:
        return False
    col = np.searchsorted(bounds, letters) % n_file_cols
    return bool(np.isin(col, dbl).any())


def try_scan_for_device(path: str, schema, delimiter: str = ",",
                        header: bool = True,
                        allow_floats: bool = False) -> CsvShape | None:
    """One host pass that decides the scope and finds the field offsets.
    Returns None for a file out of the device scope (the caller reads it
    through arrow); never raises for well-formed content out of scope, so
    the device route is only committed when it can finish."""
    if schema is None or not schema.fields:
        return None
    if not all(column_in_scope(f.data_type, allow_floats)
               for f in schema.fields):
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if b"\r" in raw:
        return None
    if raw and not raw.endswith(b"\n"):
        raw += b"\n"
    data = np.frombuffer(raw, dtype=np.uint8)
    delim_byte = delimiter.encode()[0]

    start = 0
    if header:
        first_nl = raw.find(b"\n")
        if first_nl < 0 or b'"' in raw[:first_nl]:
            return None           # a quoted header: the arrow reader
        names = raw[:first_nl].decode("utf-8", "replace").split(delimiter)
        start = first_nl + 1
        col_of = {}
        for f in schema.fields:
            if f.name not in names:
                return None       # the arrow reader reports a missing column
            col_of[f.name] = names.index(f.name)
        n_file_cols = len(names)
    else:
        n_file_cols = len(schema.fields)
        col_of = {f.name: i for i, f in enumerate(schema.fields)}

    body = data[start:]
    is_delim = body == delim_byte
    is_nl = body == ord("\n")
    is_quote = body == ord('"')
    n_quotes = int(is_quote.sum())
    if n_quotes:
        # RFC 4180: delimiters and newlines inside quotes are content. A
        # byte is inside quotes iff the count of quotes before it is odd
        # (a doubled quote toggles twice and keeps the parity)
        parity = np.cumsum(is_quote, dtype=np.int64)
        in_quotes = np.empty(len(body), bool)
        in_quotes[0] = False
        in_quotes[1:] = (parity[:-1] & 1).astype(bool)
        if n_quotes & 1:
            return None           # an unterminated quote: the arrow reader
        is_delim = is_delim & ~in_quotes
        is_nl = is_nl & ~in_quotes
    n_rows = int(is_nl.sum())
    if n_rows == 0:
        return CsvShape(data, 0, np.zeros((0, n_file_cols), np.int32),
                        np.zeros((0, n_file_cols), np.int32), col_of)
    bounds = np.flatnonzero(is_delim | is_nl).astype(np.int64)
    if len(bounds) != n_rows * n_file_cols:
        return None               # ragged rows or embedded delimiters
    b = bounds.reshape(n_rows, n_file_cols)
    if not is_nl[b[:, -1]].all():
        return None               # a row ends in a delimiter, not a newline
    prev = np.empty_like(b)
    prev[:, 1:] = b[:, :-1]
    prev[0, 0] = -1
    prev[1:, 0] = b[:-1, -1]
    starts = (prev + 1 + start).astype(np.int32)
    lens = (b - prev - 1).astype(np.int32)
    if n_quotes:
        # unquote wrapped fields: "123" → 123. Quotes that do not simply
        # wrap a field (doubled quotes in content, a stray quote) send the
        # file to the arrow reader: numeric columns never hold them
        last = np.clip(starts + lens - 1, 0, len(data) - 1)
        first_b = data[np.clip(starts, 0, len(data) - 1)]
        quoted = (lens >= 2) & (first_b == ord('"')) & \
            (data[last] == ord('"'))
        if int(quoted.sum()) * 2 != n_quotes:
            return None
        starts = (starts + quoted).astype(np.int32)
        lens = (lens - 2 * quoted).astype(np.int32)
    dbl = [col_of[f.name] for f in schema.fields
           if isinstance(f.data_type, T.FractionalType)]
    if dbl and _float_notation(body, bounds, n_file_cols, dbl):
        return None
    return CsvShape(data, n_rows, starts, lens, col_of)


def decode_shape_device(shape: CsvShape, schema, device):
    """Parse a scanned file on the device: one copy of its bytes, one parse
    per schema column. Returns a ColumnarBatch."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                        bucket_capacity)
    from spark_rapids_tpu_torch.ops import csv_decode as CD

    device = torch.device(device)
    n = shape.n_rows
    cap = bucket_capacity(max(n, 1))
    data = shape.data if len(shape.data) else np.zeros(1, np.uint8)
    data_d = torch.from_numpy(data.copy()).to(device)
    cols = []
    for f in schema.fields:
        j = shape.col_of[f.name]
        starts = np.zeros(cap, np.int32)
        lens = np.full(cap, -1, np.int32)
        if n:
            starts[:n] = shape.starts[:, j]
            lens[:n] = shape.lens[:, j]
        s_d = torch.from_numpy(starts).to(device)
        l_d = torch.from_numpy(lens).to(device)
        dt = f.data_type
        if isinstance(dt, T.LongType):
            vals, valid = CD.parse_int64(data_d, s_d, l_d, cap)
        elif isinstance(dt, T.IntegralType):
            vals, valid = CD.parse_narrow_int(data_d, s_d, l_d, cap,
                                              dt.torch_dtype)
        else:
            vals, valid = CD.parse_float64(data_d, s_d, l_d, cap)
            vals = vals.to(dt.torch_dtype)
        vals = torch.where(valid, vals, torch.zeros_like(vals))
        cols.append(TorchColumnVector(f.data_type, vals, valid))
    return ColumnarBatch(cols, n, schema)
