"""The memory runtime — counterpart of ``spark_rapids_tpu/runtime/``: the
spill catalog and its tiers (``memory.py``, ``direct_spill.py``), the OOM
retry ladder (``retry.py``), fault injection (``faults.py``), the device
semaphore (``semaphore.py``) and the pipelined stages (``pipeline.py``)."""
