"""Counterpart of ``spark_rapids_tpu/io/``."""
