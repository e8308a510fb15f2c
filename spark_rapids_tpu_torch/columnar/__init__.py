"""Counterpart of ``spark_rapids_tpu/columnar/``."""
