"""Guards of the PyTorch port's boundaries:

- no module of ``spark_rapids_tpu_torch``, and not ``chip_smoke.py``, imports
  jax or anything of the JAX package ``spark_rapids_tpu``;
- the native scanner (``spark_rapids_tpu_torch/native``) builds from its own
  source into the port's build directory and loads nothing of the JAX
  package's ``native/``;
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
        assert len(names) >= 30, names
        # the SQL slice's modules are among those checked
        assert {pkg.__name__ + "." + m for m in (
            "sql", "sql.lower", "sql.parser", "sql.tpch_queries",
            "plan.pruning", "expr.exprkey", "expr.datetime", "native",
            "io.readers", "expr.conditional", "benchmarks.tpcds",
            "exec.window", "expr.windows", "ops.nested", "exec.generate",
            "expr.complexexprs", "columnar.rows", "ops.random",
            "columnar.encoded", "runtime", "runtime.arm", "runtime.checksum",
            "runtime.faults", "runtime.retry", "runtime.memory",
            "runtime.direct_spill", "runtime.semaphore", "runtime.pipeline",
            "shuffle.serialization", "shuffle.manager", "shuffle.transport",
            "shuffle.partitioning")} <= set(
                names)
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
    assert int(out.stdout.strip()) >= 30


def test_native_scanner_builds_from_its_own_source():
    """In a fresh process the port's scanner builds and loads from
    ``spark_rapids_tpu_torch/native/parquet_host.cpp`` into
    ``build/native/``; no library or source of ``spark_rapids_tpu/native``
    is opened, and no module of the JAX package is imported."""
    code = textwrap.dedent("""
        import builtins, ctypes, os, sys
        opened, loaded = [], []
        real_open, real_cdll = builtins.open, ctypes.CDLL.__init__
        def spy_open(f, *a, **k):
            opened.append(os.path.abspath(str(f)))
            return real_open(f, *a, **k)
        def spy_cdll(self, name, *a, **k):
            loaded.append(os.path.abspath(str(name)))
            return real_cdll(self, name, *a, **k)
        builtins.open = spy_open
        ctypes.CDLL.__init__ = spy_cdll
        from spark_rapids_tpu_torch import native as N
        N.parquet_lib()
        builtins.open = real_open
        ref = os.path.abspath(os.path.join("spark_rapids_tpu", "native"))
        port = os.path.abspath(os.path.join("spark_rapids_tpu_torch",
                                            "native", "parquet_host.cpp"))
        assert N.SOURCE == port, N.SOURCE
        assert port in opened, opened
        assert not [f for f in opened + loaded if f.startswith(ref)]
        build = os.path.abspath(os.path.join("build", "native"))
        assert loaded and all(f.startswith(build) for f in loaded), loaded
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith(("jax.", "jaxlib", "spark_rapids_tpu."))
                     or m == "spark_rapids_tpu")
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_session_without_a_card_raises(monkeypatch):
    from spark_rapids_tpu_torch.session import TorchSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession(device="cuda:0")
    assert TorchSession(device="cpu").device.type == "cpu"


def test_encoded_upload_raises():
    """Encoded upload is ported (on by default, as in the reference): the
    conf is accepted either way. An unregistered conf still raises."""
    from spark_rapids_tpu_torch import config as CFG
    from spark_rapids_tpu_torch.session import TorchSession
    for v in ("true", "false"):
        s = TorchSession({"spark.rapids.tpu.sql.parquet.encodedUpload."
                          "enabled": v}, device="cpu")
        assert s.conf.get(CFG.PARQUET_ENCODED_UPLOAD) == (v == "true")
    assert TorchSession(device="cpu").conf.get(CFG.PARQUET_ENCODED_UPLOAD)
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
    # the comparisons, AND, OR, NOT, COUNT(*), /, abs and unary minus over a
    # number are ported, and the untyped null since the expression slice;
    # unary minus over a boolean, a list literal and sum(*) are not
    -(F.col("x") / F.lit(2.0))
    with pytest.raises(NotImplementedError):
        _ = (-((F.col("x") <= F.lit(1.0))
               | (F.col("x") <= F.lit(2.0)))).dtype
    from spark_rapids_tpu_torch import types as T
    assert F.lit(None).dtype == T.NULL
    with pytest.raises(NotImplementedError):
        F.lit([1, 2])
    from spark_rapids_tpu_torch.expr.aggregates import Sum
    with pytest.raises(NotImplementedError):
        Sum(None)    # sum(*)


def test_unported_plans_raise_at_planning(table_path):
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.session import TorchSession
    df = TorchSession(device="cpu").read_parquet(table_path)
    # window functions in SQL text lower since (one spec plans); two specs
    # in one select plan too since the window-spec slice (one window exec
    # a spec, chained); a window over a context expression does not
    spark = df.session
    spark.create_or_replace_temp_view("t", df)
    spark.sql("select k, sum(x) over (partition by k) as s from t"
              ).physical_plan()
    spark.sql("select k, sum(x) over (partition by k) as s, "
              "sum(x) over (partition by n) as u from t").physical_plan()
    with pytest.raises(NotImplementedError):
        df.window([F.alias(F.over(F.row_number(),
                                  [F.spark_partition_id()]), "r")]
                  ).physical_plan()
    # a cast pair Spark refuses (double to int is ported since the
    # expression slice)
    df.select(F.cast(F.col("x"), T.INT)).physical_plan()
    with pytest.raises(NotImplementedError):
        df.select(F.cast(F.col("x"), T.DATE)).physical_plan()
    # several partitions plan an exchange; its serializing fallback and
    # range partitioning plan since the memory-runtime slice, and the
    # serializing shuffle refuses a nested column (it has no frame)
    no_shuffle = TorchSession({"spark.rapids.tpu.shuffle.enabled": "false"},
                              device="cpu")
    two = no_shuffle.read_parquet([table_path, table_path])
    two.group_by(F.col("k")).agg(F.sum(F.col("x"))).physical_plan()
    no_shuffle.read_parquet(table_path).repartition(2, "k").physical_plan()
    nested = no_shuffle.create_dataframe(
        pa.table({"k": [1, 2], "a": pa.array([[1], [2, 3]])}))
    with pytest.raises(NotImplementedError):
        nested.repartition(2, "k").physical_plan()
    from spark_rapids_tpu_torch.plan import nodes as NN
    from spark_rapids_tpu_torch.session import DataFrame
    ranged = DataFrame(NN.ExchangeNode(df._plan, "range", 2,
                                       keys=[F.col("k")]), df.session)
    ranged.physical_plan()
    # joins of two keyless aggregates over several partitions: their cross
    # join (TPC-DS q88's shape) plans
    many = TorchSession(device="cpu").read_parquet([table_path, table_path])
    counts = many.agg(F.count().alias("c"))
    sums = many.agg(F.sum(F.col("x")).alias("s"))
    counts.join(sums, how="cross").physical_plan()
    # a keyless full outer join plans too since; a keyless right outer join
    # (the nested-loop join with a left build side) does not
    counts.join(sums, how="full").physical_plan()
    with pytest.raises(NotImplementedError):
        counts.join(sums, how="right").physical_plan()
    # a window avg over a decimal column: the reference returns the
    # unscaled mean there (a window avg over a double plans)
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr import windows as WX
    from spark_rapids_tpu_torch.expr.aggregates import Average
    spec = WX.WindowSpec((F.col("k"),), (), WX.FULL_FRAME)
    dec = df.select(F.col("k"), F.cast(F.col("n"), T.DecimalType(7, 2))
                    .alias("d"), F.col("x"))
    dec.window([E.Alias(WX.WindowExpression(Average(F.col("x")), spec),
                        "a")]).physical_plan()
    with pytest.raises(NotImplementedError):
        dec.window([E.Alias(WX.WindowExpression(Average(F.col("d")), spec),
                            "a")]).physical_plan()
    # the arrow reader path, the ORC and CSV scans, the pushed filter and
    # the Alluxio path rewrite are ported; what the scan still refuses is an
    # ORC or CSV scan its format's conf disables (the port has no host plan
    # to hand it to)
    from spark_rapids_tpu_torch.io.filescan import FileScanNode
    node = FileScanNode(table_path, "parquet",
                        pushed_filter=F.col("x") <= 1.0)
    assert node.pushed_filter is not None
    pushed = TorchSession(device="cpu").read_parquet(
        table_path, pushed_filter=F.col("x") <= 1.0).collect()
    assert pushed.column("x").to_pylist() == [1.0]
    d = os.path.dirname(table_path)
    alluxio = TorchSession({"spark.rapids.tpu.alluxio.pathsToReplace":
                            f"/nowhere/alluxio->{d}"}, device="cpu")
    got = alluxio.read_parquet(os.path.join(
        "/nowhere/alluxio", os.path.basename(table_path))).collect()
    assert got.column("n").to_pylist() == [1, 2, 3]
    import pyarrow.csv as pcsv
    import pyarrow.orc as orc
    src = pq.read_table(table_path)
    orc_path = os.path.join(os.path.dirname(table_path), "guard.orc")
    csv_path = os.path.join(os.path.dirname(table_path), "guard.csv")
    orc.write_table(src, orc_path)
    pcsv.write_csv(src, csv_path)
    for fmt, path in (("orc", orc_path), ("csv", csv_path)):
        key = f"spark.rapids.tpu.sql.format.{fmt}.enabled"
        on = TorchSession(device="cpu")
        read = getattr(on, f"read_{fmt}")
        assert read(path).collect().num_rows == src.num_rows
        off = TorchSession({key: "false"}, device="cpu")
        with pytest.raises(NotImplementedError, match=key):
            getattr(off, f"read_{fmt}")(path).physical_plan()


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
