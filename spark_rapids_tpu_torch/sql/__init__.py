"""SQL front-end: text → AST → logical plan.

Counterpart of ``spark_rapids_tpu/sql/``: a recursive-descent parser over
the SQL subset of the TPC-H/TPC-DS text (``parser.py``, a copy), lowered
onto ``plan/nodes.py`` with Catalyst's analysis moves (``lower.py``): filter
pushdown into the join graph, equi-key extraction, the aggregate split, and
ORDER BY over output names, aliases and ordinals. ``TorchSession.sql()`` is
the entry point; what the port cannot plan raises ``NotImplementedError``
while the text is lowered.
"""

from spark_rapids_tpu_torch.sql.lower import lower_sql
from spark_rapids_tpu_torch.sql.parser import parse_sql

__all__ = ["parse_sql", "lower_sql"]
