"""Nothing the benchmark runs loads JAX or the JAX package; the
references load nothing of the port."""

import json
import subprocess
import sys

from hvdbench import spec, worker

PROBE = r"""
import json, os, sys
from hvdbench import spec
bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
mode = sys.argv[1]
for w in bench["workloads"]:
    cell = spec.Cell(w["name"])
    cell.reference
    if mode == "all":
        import hvdbench.run, hvdbench.calibrate
        cell.driver
        cell.flops
        for m in bench["end_to_end"] + bench["per_layer"]:
            cell.reader(m["name"])
        import horovod_tpu_torch.torch
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(mode):
    out = subprocess.run([sys.executable, "-c", PROBE, mode], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return json.loads(out.splitlines()[-1])


def test_the_harness_and_the_port_load_no_jax():
    tops = {m.split(".")[0] for m in _loaded("all")}
    assert "horovod_tpu_torch" in tops
    assert not tops & set(worker.FORBIDDEN), tops & set(worker.FORBIDDEN)


def test_the_references_load_nothing_of_the_port():
    tops = {m.split(".")[0] for m in _loaded("reference")}
    assert "torch" in tops
    assert not tops & ({"horovod_tpu_torch"} | set(worker.FORBIDDEN))


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "horovod_tpu_torch_x", sys)
    assert "horovod_tpu_torch_x" not in worker.forbidden_modules()
    monkeypatch.setitem(sys.modules, "horovod_tpu.common", sys)
    assert "horovod_tpu.common" in worker.forbidden_modules()


def test_a_run_that_loads_jax_prints_no_result(tree, monkeypatch):
    import torch
    from hvdbench import run
    monkeypatch.setitem(sys.modules, "jax", sys)
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    try:
        run.run_cell(cell, 1, 0.2, False, device=torch.device("cpu"))
    except ImportError as e:
        assert "jax" in str(e)
    else:
        raise AssertionError("a run with jax loaded gave a result")
