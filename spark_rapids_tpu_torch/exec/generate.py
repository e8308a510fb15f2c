"""Generate exec (explode, posexplode, and their ``outer`` forms) —
counterpart of ``spark_rapids_tpu/exec/generate.py`` (reference
GpuGenerateExec).

The generator column is a ``ListVector``. Each batch's explode mapping
(``ops/nested.explode_mapping``: for each output row its source row and
element index, from a searchsorted over the length prefix, the
reference's) drives one gather of the other columns (``gather_cols``, so a
nested payload column rides it too) and one gather of the flat elements.
The one host sync is the output row count, which sizes the batch. The
elements may be nested: an ``array<struct>`` explodes into a
``StructVector`` column and an ``array<array>`` into a ``ListVector``
column, both gathered by the same mapping (``ops/nested.gather``, one more
host sync a list level). The reference's device rule refuses a nested
element (``spark_rapids_tpu/plan/overrides.py:1005-1008``); its host path
answers, and the port is held to that answer.

An outer explode keeps a null or empty list as one row with a null
element (and, for posexplode, a null position); a plain one drops it. A
batch that explodes to no row yields nothing. A map generator is refused
at planning (``plan/overrides.py``).
"""

from __future__ import annotations

import threading

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.expr.core import Col
from spark_rapids_tpu_torch.ops import nested as N
from spark_rapids_tpu_torch.ops.filtering import gather_cols


def generate_output(child_output: T.StructType, generator_col: str,
                    element_type: T.DataType, pos: bool,
                    outer: bool) -> T.StructType:
    """The child's columns but the generator, then ``pos`` (posexplode)
    and ``col``, as Spark names them."""
    fields = [f for f in child_output if f.name != generator_col]
    if pos:
        fields.append(T.StructField("pos", T.INT, outer))
    fields.append(T.StructField("col", element_type, True))
    return T.StructType(fields)


class GenerateExec(TorchExec):
    def __init__(self, generator_col: str, child: TorchExec,
                 outer: bool = False, element_type: T.DataType | None = None,
                 pos: bool = False, conf=None):
        super().__init__(child, conf=conf)
        self.generator_col = generator_col
        self.outer = outer
        self.pos = pos
        self.element_type = (element_type or
                             child.output[generator_col].data_type
                             .element_type)
        #: per-run record: input rows and list elements, output rows
        self.stats = {"rows_in": 0, "elements_in": 0, "rows_out": 0}
        self._lock = threading.Lock()

    @property
    def output(self):
        return generate_output(self.child.output, self.generator_col,
                               self.element_type, self.pos, self.outer)

    def execute_partition(self, split):
        for batch in self.child.execute_partition(split):
            out = self._generate(batch)
            if out is not None:
                yield out

    def _generate(self, batch: ColumnarBatch) -> ColumnarBatch | None:
        names = batch.schema.names
        gi = names.index(self.generator_col)
        lv = batch.columns[gi]
        n = batch.num_rows
        src, elem_idx, real, live, total, out_cap = N.explode_mapping(
            lv.data, n, self.outer)
        with self._lock:
            self.stats["rows_in"] += n
            self.stats["elements_in"] += lv.total
            self.stats["rows_out"] += total
        if total == 0:
            return None
        others = [Col.from_vector(c) for i, c in enumerate(batch.columns)
                  if i != gi]
        out_cols = [c.to_vector() for c in gather_cols(others, src, live)]
        if self.pos:
            out_cols.append(Col(torch.where(real, elem_idx.to(torch.int32),
                                            0), real, T.INT).to_vector())
        flat_pos = N.starts_of(lv.data)[src] + elem_idx
        flat_pos = torch.where(real, flat_pos, torch.zeros_like(flat_pos))
        elem = gather_cols([Col.from_vector(lv.flat)],
                           flat_pos.clamp(max=lv.flat.capacity - 1), real)[0]
        out_cols.append(elem.to_vector())
        return ColumnarBatch(out_cols, total, self.output)

    def args_string(self):
        kind = "posexplode" if self.pos else "explode"
        return f"{kind}({self.generator_col}), outer={self.outer}"
