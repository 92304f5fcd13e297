"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports JAX, flax, optax or any module of horovod_tpu.  Its root exports
the JAX package's root names, lazily, so that the launcher starts
without torch."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import horovod_tpu_torch, horovod_tpu_torch.torch\n"
        "import horovod_tpu_torch.models, horovod_tpu_torch.ops.flash_attention\n"
        "import horovod_tpu_torch.common.controller_net\n"
        "import horovod_tpu_torch.common.relay\n"
        "import horovod_tpu_torch.ops.dist_ops, horovod_tpu_torch.ops.adasum\n"
        "import horovod_tpu_torch.ops.fusion_buffer\n"
        "import horovod_tpu_torch.runner, horovod_tpu_torch.runner.launch\n"
        "import horovod_tpu_torch.runner.gpu_run\n"
        "import horovod_tpu_torch.runner.config_parser\n"
        "import horovod_tpu_torch.runner.driver_service\n"
        "import horovod_tpu_torch.runner.endpoints\n"
        "import horovod_tpu_torch.runner.hosts\n"
        "import horovod_tpu_torch.runner.http_server\n"
        "import horovod_tpu_torch.runner.job_secret\n"
        "import horovod_tpu_torch.runner.safe_shell_exec\n"
        "import horovod_tpu_torch.common.metrics\n"
        "import horovod_tpu_torch.runner.elastic_run\n"
        "import horovod_tpu_torch.runner.elastic.worker\n"
        "import horovod_tpu_torch.torch.elastic\n"
        "import horovod_tpu_torch.common.elastic\n"
        "import horovod_tpu_torch.checkpoint\n"
        "import horovod_tpu_torch.checkpoint.manager\n"
        "import horovod_tpu_torch.checkpoint.shard_io\n"
        "import horovod_tpu_torch.checkpoint.delta\n"
        "import horovod_tpu_torch.checkpoint.elastic\n"
        "import horovod_tpu_torch.checkpoint.preemption\n"
        "import horovod_tpu_torch.tune, horovod_tpu_torch.tune.session\n"
        "import horovod_tpu_torch.tune.search, horovod_tpu_torch.tune.profile\n"
        "import horovod_tpu_torch.common.parameter_manager\n"
        "import horovod_tpu_torch.common.optim\n"
        "import horovod_tpu_torch.torch.checkpoint\n"
        "import horovod_tpu_torch.native\n"
        "import horovod_tpu_torch.parallel, horovod_tpu_torch.training\n"
        "import horovod_tpu_torch.models.bert\n"
        "import horovod_tpu_torch.parallel.sharding\n"
        "import horovod_tpu_torch.parallel.collectives\n"
        "import horovod_tpu_torch.parallel.attention\n"
        "import horovod_tpu_torch.parallel.moe\n"
        "import horovod_tpu_torch.parallel.pipeline\n"
        "import horovod_tpu_torch.models.resnet\n"
        "import horovod_tpu_torch.models.mnist\n"
        "import horovod_tpu_torch.torch.sync_batch_norm\n"
        "import horovod_tpu_torch.sparse, horovod_tpu_torch.sparse.embedding\n"
        "import horovod_tpu_torch.models.dlrm\n"
        "import horovod_tpu_torch.serve, horovod_tpu_torch.serve.replica\n"
        "import horovod_tpu_torch.serve.server\n"
        "import horovod_tpu_torch.spark, horovod_tpu_torch.spark.torch\n"
        "import horovod_tpu_torch.spark.params, horovod_tpu_torch.spark.store\n"
        "import horovod_tpu_torch.spark.util, horovod_tpu_torch.spark.backend\n"
        "import horovod_tpu_torch.spark.estimator\n"
        "import horovod_tpu_torch.ray, horovod_tpu_torch.ray.runner\n"
        "import horovod_tpu_torch.ray.elastic, horovod_tpu_torch.mxnet\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} + ('pyspark', 'ray', 'mxnet', 'cloudpickle'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _port_sources():
    root = os.path.join(REPO, "horovod_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_reference():
    offenders = []
    sources = list(_port_sources())
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} "
                          f"{n}" for n in names if _forbidden(n)]
    assert offenders == []


@pytest.mark.parametrize("subdir", ["examples", "_alias"])
def test_scan_covers_the_entry_points(subdir):
    """The scan above reaches the examples and the ``horovod`` alias,
    and none of their files imports the root's ``horovod`` package
    either (the JAX package's alias): the port's alias is reached by its
    directory on the path, never imported by the port itself."""
    root = os.path.join(REPO, "horovod_tpu_torch", subdir)
    sources = sorted(p for p in _port_sources()
                     if p.startswith(root + os.sep))
    want = sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                  for f in files if f.endswith(".py"))
    assert sources == want and len(want) >= (17 if subdir == "examples"
                                             else 2)
    offenders = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                          for n in names
                          if _forbidden(n) or n.split(".")[0] == "horovod"]
    assert offenders == []


TOOLS = ("validate_trace", "blackbox_merge", "tune_report", "hvdtop",
         "flame", "measure_torch_staging", "measure_elastic",
         "profile_resnet", "chaos_soak")
# What the operator tools must not load: the JAX stack, the JAX package,
# and the root's ``tools`` and ``bench`` (the JAX package's own tools).
TOOLS_FORBIDDEN = FORBIDDEN + ("tools", "bench")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax_reference_root_tools_or_bench(tool):
    """Each module of ``horovod_tpu_torch/tools/``: its source names none
    of them, and importing it (as ``python -m`` runs it, from the repo
    root) loads none of them."""
    path = os.path.join(REPO, "horovod_tpu_torch", "tools", tool + ".py")
    assert path in set(_port_sources())
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        offenders += [f"{node.lineno} {n}" for n in names
                      if n.split(".")[0] in TOOLS_FORBIDDEN]
    assert offenders == []
    code = ("import sys\n"
            f"import horovod_tpu_torch.tools.{tool}\n"
            "print(','.join(sorted(m for m in sys.modules if m.split('.')[0]"
            f" in {TOOLS_FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_chaos_soak_names_no_root_tools_path():
    """The port's chaos soak reaches ``hvdtop``, ``blackbox_merge`` and
    ``validate_trace`` as modules of its own package: its source edits no
    ``sys.path`` and names no path under the root's ``tools/``."""
    path = os.path.join(REPO, "horovod_tpu_torch", "tools", "chaos_soak.py")
    with open(path) as f:
        src = f.read()
    assert re.findall(r"(?<!horovod_tpu_torch/)\btools/", src) == []
    assert "sys.path" not in src
    assert "from horovod_tpu_torch.tools import hvdtop" in src
    assert "from horovod_tpu_torch.tools import blackbox_merge, " \
        "validate_trace" in src


def test_tools_are_the_eight():
    root = os.path.join(REPO, "horovod_tpu_torch", "tools")
    assert sorted(f[:-3] for f in os.listdir(root) if f.endswith(".py")) == \
        sorted(TOOLS + ("__init__",))


def test_root_exports_the_jax_root_names():
    import horovod_tpu
    import horovod_tpu_torch
    want = set(horovod_tpu.__all__)
    assert {"serve", "sparse"} <= want
    assert set(horovod_tpu_torch.__all__) == want
    for name in sorted(want):
        assert getattr(horovod_tpu_torch, name) is not None, name
    assert issubclass(horovod_tpu_torch.HostsUpdatedInterrupt, Exception)
    assert horovod_tpu_torch.tune_status() is None      # not initialized


def test_torch_binding_exports_the_jax_binding_names():
    import horovod_tpu.torch
    import horovod_tpu_torch.torch
    assert horovod_tpu_torch.torch.__all__ == horovod_tpu.torch.__all__
    for name in horovod_tpu_torch.torch.__all__:
        assert getattr(horovod_tpu_torch.torch, name) is not None, name


DLRM_NAMES = {"DLRMConfig", "DLRMDense", "bce_logits_loss",
              "dlrm_tiny_config", "synthetic_click_batch"}
CONVERTERS = {"convert_flax_bert_params", "convert_flax_gpt_params",
              "convert_flax_resnet_params", "convert_flax_mnist_params",
              "convert_flax_dlrm_params"}


def test_models_export_the_jax_names_less_dlrm_plus_converters():
    """Since the sparse engine is ported, "less DLRM" is empty: the JAX
    list (DLRM names included) plus the five converters."""
    import horovod_tpu.models
    import horovod_tpu_torch.models
    assert DLRM_NAMES <= set(horovod_tpu.models.__all__)
    assert set(horovod_tpu_torch.models.__all__) == \
        set(horovod_tpu.models.__all__) | CONVERTERS
    for name in horovod_tpu_torch.models.__all__:
        assert getattr(horovod_tpu_torch.models, name) is not None, name


def test_sparse_and_serve_export_the_jax_names():
    import horovod_tpu.serve
    import horovod_tpu.sparse
    import horovod_tpu_torch.serve
    import horovod_tpu_torch.sparse
    for jmod, tmod in ((horovod_tpu.sparse, horovod_tpu_torch.sparse),
                       (horovod_tpu.serve, horovod_tpu_torch.serve)):
        assert tmod.__all__ == jmod.__all__
        for name in tmod.__all__:
            assert getattr(tmod, name) is not None, name


def test_spark_and_ray_export_the_jax_names():
    """``mxnet`` has no ``__all__`` in either package: any attribute of
    the descope stub raises (``tests/test_torch_port_ray.py``)."""
    import horovod_tpu.ray
    import horovod_tpu.spark
    import horovod_tpu_torch.ray
    import horovod_tpu_torch.spark
    for jmod, tmod in ((horovod_tpu.spark, horovod_tpu_torch.spark),
                       (horovod_tpu.ray, horovod_tpu_torch.ray)):
        assert tmod.__all__ == jmod.__all__
        for name in tmod.__all__:
            assert getattr(tmod, name) is not None, name


def test_parallel_exports_the_jax_names():
    import horovod_tpu.parallel
    import horovod_tpu_torch.parallel
    assert horovod_tpu_torch.parallel.__all__ == \
        horovod_tpu.parallel.__all__
    for name in horovod_tpu_torch.parallel.__all__:
        assert getattr(horovod_tpu_torch.parallel, name) is not None, name


def test_tune_and_checkpoint_export_the_jax_names():
    import horovod_tpu.checkpoint
    import horovod_tpu.tune
    import horovod_tpu_torch.checkpoint
    import horovod_tpu_torch.tune
    assert set(horovod_tpu_torch.tune.__all__) == \
        set(horovod_tpu.tune.__all__)
    assert set(horovod_tpu.checkpoint.__all__) <= \
        set(horovod_tpu_torch.checkpoint.__all__)
    for mod in (horovod_tpu_torch.tune, horovod_tpu_torch.checkpoint):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name


def test_runner_imports_without_torch():
    code = (
        "import sys\n"
        "import horovod_tpu_torch.runner, horovod_tpu_torch.runner.launch\n"
        "import horovod_tpu_torch.runner.gpu_run\n"
        "import horovod_tpu_torch.runner.elastic_run\n"
        "import horovod_tpu_torch.checkpoint, horovod_tpu_torch.tune\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('torch', 'jax', 'horovod_tpu'))\n"
        "print(','.join(loaded))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_native_imports_and_builds_without_torch():
    """The native coordinator's loader and its build need neither torch
    nor JAX nor the JAX package."""
    code = (
        "import sys\n"
        "from horovod_tpu_torch import native\n"
        "assert native.available(), native.unavailable_reason()\n"
        "native.NativeCoordinatorServer(2).stop()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('torch', 'jax', 'horovod_tpu'))\n"
        "print(','.join(loaded))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


# Keras 3.13 imports jax itself where it is installed
# (keras/src/callbacks/orbax_checkpoint.py, in a try), so these
# subprocesses hide the forbidden packages: an import of one by the port
# fails there, while Keras's own optional import is skipped.
_HIDDEN = ("import sys\n"
           f"for name in {FORBIDDEN!r}:\n"
           "    sys.modules[name] = None\n")


def _import_report(code, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra, PYTHONPATH=REPO)
    code = (_HIDDEN + code +
            "bad = sorted(m for m, v in sys.modules.items() if v is not None"
            f" and m.split('.')[0] in {FORBIDDEN!r})\n"
            "print('BAD=' + ','.join(bad))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("module,env", [
    ("horovod_tpu_torch.keras", {"KERAS_BACKEND": "torch"}),
    ("horovod_tpu_torch.tensorflow", {}),
    ("horovod_tpu_torch.spark.keras", {}),
])
def test_keras_and_tensorflow_bindings_load_no_jax(module, env):
    """Each binding in its own process; the TF one with its alias
    ``tensorflow.keras``, the Keras one checks its backend."""
    code = f"import {module}\n"
    if module.endswith("tensorflow"):
        code += "import horovod_tpu_torch.tensorflow.keras\n"
    if module.endswith(".keras") and env:
        code += "import keras\nassert keras.backend.backend() == 'torch'\n"
    out = _import_report(code, env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "BAD=", out.stdout


def test_keras_impl_imports_without_keras():
    """``horovod_tpu_torch._keras`` imports Keras inside its functions."""
    out = _import_report("sys.modules['keras'] = None\n"
                         "import horovod_tpu_torch._keras\n", {})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "BAD=", out.stdout


def test_static_scan_covers_the_keras_and_tensorflow_bindings():
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("_keras/__init__.py", "_keras/callbacks.py",
                "keras/__init__.py", "keras/callbacks.py",
                "keras/elastic.py", "tensorflow/__init__.py",
                "tensorflow/graph_ops.py", "tensorflow/sync_batch_norm.py",
                "tensorflow/elastic.py", "tensorflow/keras/__init__.py",
                "spark/keras.py"):
        assert os.path.join("horovod_tpu_torch", rel) in sources, rel


def test_keras_and_tensorflow_export_the_jax_names():
    """``keras`` and ``tensorflow`` (and its ``keras`` alias) have the JAX
    package's ``__all__``; ``spark.keras`` has none in either package,
    and defines the same public classes and functions."""
    import horovod_tpu.keras
    import horovod_tpu.spark.keras
    import horovod_tpu.tensorflow
    import horovod_tpu_torch.keras
    import horovod_tpu_torch.spark.keras
    import horovod_tpu_torch.tensorflow
    import horovod_tpu_torch.tensorflow.keras
    for jmod, tmod in ((horovod_tpu.keras, horovod_tpu_torch.keras),
                       (horovod_tpu.tensorflow,
                        horovod_tpu_torch.tensorflow)):
        assert tmod.__all__ == jmod.__all__
        for name in tmod.__all__:
            assert getattr(tmod, name) is not None, name
    assert horovod_tpu_torch.tensorflow.keras.DistributedOptimizer is \
        horovod_tpu_torch.keras.DistributedOptimizer

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and getattr(v, "__module__", None) == mod.__name__}
    jmod, tmod = horovod_tpu.spark.keras, horovod_tpu_torch.spark.keras
    assert not hasattr(jmod, "__all__") and not hasattr(tmod, "__all__")
    assert public(tmod) == public(jmod) == {"KerasEstimator", "KerasModel"}
