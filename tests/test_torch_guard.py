"""Guards of the PyTorch port's boundaries:

- no module of ``spark_rapids_tpu_torch``, and not ``chip_smoke.py``, imports
  jax or anything of the JAX package ``spark_rapids_tpu``;
- ``TorchSession()`` with no CUDA device raises instead of running on the CPU;
- what the port has not ported raises ``NotImplementedError`` when the plan is
  built, never a wrong answer at run time.
"""

import os
import subprocess
import sys
import textwrap

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import spark_rapids_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        assert len(names) >= 25, names
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # as a module: main() does not run
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "spark_rapids_tpu"
                     or m.startswith("spark_rapids_tpu."))
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_session_without_a_card_raises(monkeypatch):
    from spark_rapids_tpu_torch.session import TorchSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession(device="cuda:0")
    assert TorchSession(device="cpu").device.type == "cpu"


def test_encoded_upload_raises():
    from spark_rapids_tpu_torch.session import TorchSession
    with pytest.raises(NotImplementedError):
        TorchSession({"spark.rapids.tpu.sql.parquet.encodedUpload.enabled":
                      "true"}, device="cpu")
    with pytest.raises(NotImplementedError):
        TorchSession({"spark.rapids.tpu.sql.pallas.enabled": "false"},
                     device="cpu")


@pytest.fixture
def table_path(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": ["a", "b", "a"], "x": [1.0, 2.0, 3.0],
                             "n": pa.array([1, 2, 3], pa.int64())}), path)
    return path


def test_unported_expressions_raise_when_built(table_path):
    import spark_rapids_tpu_torch.functions as F
    with pytest.raises(NotImplementedError):
        F.col("x") > F.lit(1.0)
    with pytest.raises(NotImplementedError):
        F.col("x") == F.lit(1.0)
    with pytest.raises(NotImplementedError):
        F.count()


def test_unported_plans_raise_at_planning(table_path):
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.session import TorchSession
    df = TorchSession(device="cpu").read_parquet(table_path)
    # a group-by on a non-dictionary key needs the sort-based group-by
    with pytest.raises(NotImplementedError):
        df.group_by(F.col("n")).agg(F.sum(F.col("x"))).physical_plan()
    # a cast pair outside the slice
    with pytest.raises(NotImplementedError):
        df.select(F.cast(F.col("x"), T.INT)).physical_plan()
    # several files in several partitions need the exchange
    two = TorchSession(device="cpu").read_parquet([table_path, table_path])
    with pytest.raises(NotImplementedError):
        two.group_by(F.col("k")).agg(F.sum(F.col("x"))).physical_plan()
    # the arrow reader path is not ported
    off = TorchSession({"spark.rapids.tpu.sql.parquet.deviceDecode.enabled":
                        "false"}, device="cpu").read_parquet(table_path)
    with pytest.raises(NotImplementedError):
        off.physical_plan()


def test_filter_and_project_outside_an_aggregate(table_path):
    """FilterExec/ProjectExec run where the planner cannot hoist them."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    df = (TorchSession(device="cpu").read_parquet(table_path)
          .filter(F.col("x") <= F.lit(2.0))
          .select(F.col("k"), (F.col("x") * F.col("n") + F.lit(1))
                  .alias("y")))
    assert df.collect().to_pylist() == [{"k": "a", "y": 2.0},
                                        {"k": "b", "y": 5.0}]
