"""Counterpart of ``spark_rapids_tpu/ops/``."""
