"""spark_rapids_tpu_torch — the columnar SQL engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The module layout follows the JAX package ``spark_rapids_tpu`` one to one, so a
reader finds each counterpart under the same path:

  config.py     — typed conf registry (``spark.rapids.tpu.*`` keys keep their names)
  types.py      — Spark SQL types with their torch dtypes
  columnar/     — padded device column vectors and batches, Arrow conversion
  ops/          — plain tensor ops and the CUDA kernels (``ops/cuda_kernels.py``)
  io/           — parquet page parsing on the host, page decode on the device
  expr/         — expression trees evaluated over torch tensors
  exec/         — physical operators (scan, filter, project, aggregate, sort)
  plan/         — logical plan nodes and the rules that turn them into execs
  session.py    — ``TorchSession`` and the DataFrame API
  benchmarks/   — the TPC-H generator, queries and NumPy oracles

Everything runs eagerly on an explicit ``device``. The package imports torch,
numpy and pyarrow, and never jax. Only the parts of the engine that TPC-H q1
needs exist so far; anything else raises ``NotImplementedError`` when a plan is
built, never at run time with a wrong answer.
"""

__version__ = "0.1.0"
