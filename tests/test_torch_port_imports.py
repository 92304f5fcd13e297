"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports JAX, flax, optax or any module of horovod_tpu."""

import ast
import os
import subprocess
import sys

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
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
