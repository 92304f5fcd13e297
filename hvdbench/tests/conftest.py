"""A throwaway tree for the harness's CPU tests: a copy of ``hvdbench/``
with tiny configurations, mixes and cells added as new files and new
entries of a copied ``BENCHMARK.json``, as a later change adds its own.

The limits of the tiny cells were set as the real cells' are: above the
sound program's readings at these sizes on the CPU (bf16: loss gap up to
4e-5, leaf-norm gaps up to 2e-3 and 1.5e-2), below the fp8-products
control's gradient norm gap (1.1e-2 to 1.7e-2 on the fault tests' three
seeds)."""

import json
import os
import shutil

import pytest

from hvdbench import spec

TINY_GPT = dict(vocab_size=256, n_positions=64, n_ctx=64, n_embd=64,
                n_layer=2, n_head=4)
TINY_RESNET = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                   image_size=32)
TINY_LIMITS = {"loss_gap": 8e-5, "grad_norm_gap": 5e-3,
               "update_norm_gap": 5e-2}


def _add_config(root, name, base, changes):
    src = os.path.join(root, "hvdbench", "configs", base)
    dst = os.path.join(root, "hvdbench", "configs", name)
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(changes, name=name)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def make_tree(root: str) -> str:
    shutil.copytree(os.path.join(spec.ROOT, "hvdbench"),
                    os.path.join(root, "hvdbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _add_config(root, "gpt_tiny", "gpt2_small", TINY_GPT)
    _add_config(root, "resnet_tiny", "resnet50", TINY_RESNET)
    h = os.path.join(root, "hvdbench")
    for name, ranks in (("tiny", 1), ("tiny2", 2)):
        _write(os.path.join(h, "traffic", name + ".json"),
               {"loop": "closed", "ranks": ranks, "rows_per_rank": 4,
                "seq_len": 32, "distinct_batches": 4, "warmup_steps": 2,
                "trace_steps": 2})
    cells = (("gpt_tiny.cpu", "gpt_tiny", "tiny", 1),
             ("gpt_tiny.2rank", "gpt_tiny", "tiny2", 2),
             ("resnet_tiny.cpu", "resnet_tiny", "tiny", 1))
    for name, cfg, traffic, chips in cells:
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": traffic, "chips": chips,
                                   "why": "a CPU test's cell"})
        work = {"limits": TINY_LIMITS}
        if cfg == "gpt_tiny":
            work["reference"] = {"block_rows": 2}
        _write(os.path.join(h, "workloads", name + ".json"), work)
    for cfg in ("gpt_tiny", "resnet_tiny"):
        bench["configs"].append({
            "name": cfg, "source": "a CPU test",
            "file": f"hvdbench/configs/{cfg}/config.json", "reduced": [],
            "why": "a CPU test's configuration"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"] += ["gpt_tiny.cpu", "gpt_tiny.2rank"]
        if m["name"] == "train_images_per_s":
            m["workloads"] += ["resnet_tiny.cpu"]
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def port_on_path(monkeypatch):
    """Launched ranks import the port from this checkout and the harness
    from the throwaway tree (their working directory)."""
    monkeypatch.setenv("PYTHONPATH", spec.ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
