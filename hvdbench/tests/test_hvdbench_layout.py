"""A configuration, a traffic mix, a cell and a metric come as new files
and new entries: nothing the harness has is edited to run them."""

import hashlib
import json
import math
import os

import torch

from hvdbench import run, spec, trace


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "hvdbench")):
        for f in files:
            if f.endswith((".py", ".json")):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_run_a_new_cell(tmp_path):
    from hvdbench.tests.conftest import make_tree
    root = str(tmp_path)
    make_tree(root)
    before = _digest(root)
    h = os.path.join(root, "hvdbench")
    with open(os.path.join(h, "traffic", "tiny_long.json"), "w") as f:
        json.dump({"loop": "closed", "ranks": 1, "rows_per_rank": 2,
                   "seq_len": 48, "distinct_batches": 3,
                   "warmup_steps": 1, "trace_steps": 1}, f)
    with open(os.path.join(h, "workloads", "gpt_tiny.long.json"), "w") as f:
        json.dump({"limits": {"loss_gap": 1e-3, "grad_norm_gap": 0.05,
                              "update_norm_gap": 0.1}}, f)
    with open(os.path.join(h, "metrics", "rows_per_step.py"), "w") as f:
        f.write("def read(run):\n"
                "    return run['cell'].traffic['rows_per_rank']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "gpt_tiny.long", "config": "gpt_tiny",
                               "traffic": "tiny_long", "chips": 1,
                               "why": "a new mix"})
    bench["end_to_end"].append({"name": "rows_per_step", "unit": "count",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["gpt_tiny.long"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = spec.Cell("gpt_tiny.long", root=root)
    line, ranks, _ = run.run_cell(cell, 5, 0.2, False,
                                  device=torch.device("cpu"))
    assert line["metrics"]["rows_per_step"]["value"] == 2
    assert [ln.split(":")[0] for ln in run.run_lines(ranks, False)] == \
        ["hvdbench phases (s from the process's start)", "hvdbench steps"]
    assert {"setup_s", "step_ms_p95", "peak_mem_gib"} <= set(line["metrics"])
    assert "train_tokens_per_s" not in line["metrics"]
    assert line["correct"], line["checks"]
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_per_layer_metrics_follow_their_cell_lists():
    names = {m["name"] for m in spec.Cell("resnet50.1chip").per_layer()}
    assert names == {"hvd_init_s", "step_mfu_pct.images",
                     "device_idle_pct.images"}
    names = {m["name"] for m in spec.Cell("gpt2_small.1chip").per_layer()}
    assert names == {"hvd_init_s", "step_mfu_pct.tokens",
                     "flash_roofline_pct", "device_idle_pct.tokens"}


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_trace_summary():
    spans = [("step", 0, 100), ("forward", 0, 40), ("loss_item", 90, 100),
             ("step", 100, 200)]
    ev = [_event("kernel", "flash_fwd_wgmma_kernel", 10, 20),
          _event("kernel", "gemm", 20, 30),
          _event("kernel", "ncclDevKernel_AllReduce_Sum_f32", 60, 20),
          _event("cuda_runtime", "cudaLaunchKernel", 5, 2),
          _event("kernel", "gemm", 150, 40),
          _event("kernel", "gemm", 230, 40)]
    s = trace.summarize(ev, spans, 2)
    assert s["window_s"] == 200e-6
    assert math.isclose(s["busy_s"], 100e-6)
    assert math.isclose(s["idle_s"]["forward"], 10e-6)
    assert math.isclose(s["idle_s"]["other"], 90e-6)
    assert math.isclose(trace.kernel_seconds(s, "nccl", "allreduce"), 20e-6)
    assert s["category_s"]["flash_fwd"] == 20e-6


def test_a_trace_with_no_device_event_fails():
    try:
        trace.summarize([_event("kernel", "gemm", 300, 10)],
                        [("step", 0, 100)], 1)
    except RuntimeError as e:
        assert "no device event" in str(e)
    else:
        raise AssertionError("an empty trace read as a result")


def test_parts_are_noted_only_while_a_trace_records(monkeypatch):
    with trace.span("step"):
        pass
    rec = type("Rec", (), {"spans": []})()
    monkeypatch.setattr(trace, "_recording", rec)
    with trace.span("step"):
        with trace.span("forward"):
            pass
    assert [n for n, _, _ in rec.spans] == ["forward", "step"]
    (_, f0, f1), (_, s0, s1) = rec.spans
    assert s0 <= f0 <= f1 <= s1
