"""The port's program spans (``horovod_tpu_torch.common.timeline``): the
recorder, when it records, the spans at the port's layer boundaries
(``hvd.init`` and its phases, the models' forward, the flash op, the
optimizer, the data plane), the device trace and Timeline on its clock,
and the stall inspector's bookkeeping under concurrent threads."""

import json
import logging
import sys
import threading
import time

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from horovod_tpu_torch.common import timeline as tl
from horovod_tpu_torch.common.stall_inspector import StallInspector
from horovod_tpu_torch.models import gpt, lfm2, resnet
from horovod_tpu_torch.tools import validate_trace


@pytest.fixture
def off(monkeypatch):
    """No Timeline or device trace left open by another test."""
    monkeypatch.setattr(tl, "_forced", 0)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(spans):
    """{span name: [names of its children]} over ``spans``."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        if s.parent in by_id:
            out.setdefault(by_id[s.parent].name, []).append(s.name)
    return out


def test_off_span_is_the_shared_noop_and_records_nothing(off):
    assert not tl.recording()
    before = len(tl.spans())
    sp = tl.span("test.off", layer=1)
    assert sp is tl.NO_SPAN
    with sp:
        pass
    assert len(tl.spans()) == before


def test_the_profiler_flag_turns_recording_on_and_off(off, monkeypatch):
    assert autograd_profiler._is_profiler_enabled is False
    with _cpu_profile():
        assert autograd_profiler._is_profiler_enabled is True
        assert tl.recording()
        assert tl.span("test.flag") is not tl.NO_SPAN
    assert autograd_profiler._is_profiler_enabled is False
    assert not tl.recording()
    # A torch without the flag: only a Timeline or a device trace.
    monkeypatch.delattr(autograd_profiler, "_is_profiler_enabled")
    assert not tl.recording()
    monkeypatch.setattr(tl, "_forced", 1)
    assert tl.recording()


def test_nested_spans_record_parent_thread_and_the_wall_clock(off):
    t0 = time.time()
    with _cpu_profile():
        with tl.span("test.outer", k=7):
            with tl.span("test.inner"):
                time.sleep(0.002)
    t1 = time.time()
    got = {s.name: s for s in tl.spans(t0 * 1e6)
           if s.name.startswith("test.")}
    outer, inner = got["test.outer"], got["test.inner"]
    assert inner.parent == outer.id and outer.attrs == {"k": 7}
    assert inner.thread == outer.thread == threading.get_ident()
    assert t0 * 1e6 <= outer.start_us <= inner.start_us
    assert inner.end_us <= outer.end_us <= t1 * 1e6
    assert inner.end_us - inner.start_us >= 2000


def test_a_span_ended_on_another_thread_keeps_its_parent(off):
    with _cpu_profile():
        with tl.span("test.submitter"):
            tl.begin_span("test.key", "test.crossing", tensor="t")
        th = threading.Thread(target=tl.end_span, args=("test.key",))
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    got = {s.name: s for s in tl.spans() if s.name.startswith("test.")}
    assert got["test.crossing"].parent == got["test.submitter"].id
    assert got["test.crossing"].attrs == {"tensor": "t"}
    tl.end_span("test.never-opened")


def test_the_buffer_keeps_the_newest_and_counts_drops(off, monkeypatch):
    rec = tl.SpanRecorder(capacity=4)
    monkeypatch.setattr(tl, "_recorder", rec)
    for i in range(6):
        with tl.span(f"test.{i}", always=True):
            pass
    assert [s.name for s in tl.spans()] == ["test.2", "test.3", "test.4",
                                           "test.5"]
    assert tl.dropped() == 2


def test_init_records_its_phases_which_survive_shutdown():
    import horovod_tpu_torch.torch as hvd
    t0 = tl.now_us()
    hvd.init()
    hvd.shutdown()
    got = tl.spans(t0)
    init = [s for s in got if s.name == "hvd.init"]
    assert len(init) == 1 and init[0].parent == 0
    phases = [s.name for s in sorted(got, key=lambda s: s.start_us)
              if s.parent == init[0].id]
    assert phases == ["init.rendezvous", "init.arming", "init.backend",
                      "init.runtime", "init.metrics"]
    assert all(init[0].start_us <= s.start_us <= s.end_us <= init[0].end_us
               for s in got if s.parent == init[0].id)


def test_tiny_gpt_step_records_its_forward_tree(off):
    cfg = gpt.gpt_tiny_config(dtype=torch.float32, num_layers=2,
                              attention_impl="flash")
    model = gpt.GPTLMHeadModel(cfg, device="cpu", seed=0)
    ids = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    t0 = tl.now_us()
    with _cpu_profile():
        gpt.lm_loss(model(ids), ids).backward()
    got = tl.spans(t0)
    names = [s.name for s in got]
    assert names.count("gpt.forward") == 1
    tree = _tree(got)
    assert tree["gpt.forward"] == ["gpt.embed", "gpt.block", "gpt.block",
                                   "gpt.head"]
    assert [s.attrs for s in got if s.name == "gpt.block"] == [
        {"layer": 0}, {"layer": 1}]
    assert tree["gpt.block"] == ["gpt.attention", "gpt.mlp"] * 2
    assert tree["gpt.attention"] == ["flash.fwd"] * 2
    assert names.count("gpt.loss") == 1 and names.count("flash.bwd") == 2


def test_tiny_lfm2_step_records_its_forward_tree(off):
    cfg = lfm2.LFM2MoEConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=3,
        num_attention_heads=2, num_key_value_heads=1,
        layer_types=("conv", "full_attention", "conv"), num_dense_layers=1,
        num_experts=8, num_experts_per_tok=2, experts_held=range(0, 4),
        dtype=torch.float32, attention_impl="flash")
    model = lfm2.LFM2MoEForCausalLM(cfg, device="cpu", seed=0)
    ids = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    t0 = tl.now_us()
    with _cpu_profile():
        gpt.lm_loss(model(ids), ids).backward()
    got = tl.spans(t0)
    names = [s.name for s in got]
    tree = _tree(got)
    assert tree["lfm2.forward"] == ["lfm2.embed"] + ["lfm2.block"] * 3 + [
        "lfm2.head"]
    assert [s.attrs for s in got if s.name == "lfm2.block"] == [
        {"layer": 0, "op": "conv", "ffn": "dense"},
        {"layer": 1, "op": "attention", "ffn": "moe"},
        {"layer": 2, "op": "conv", "ffn": "moe"}]
    assert tree["lfm2.block"] == [
        "lfm2.conv", "lfm2.ffn", "lfm2.attention", "moe.route",
        "moe.dispatch", "moe.experts", "moe.combine", "lfm2.conv",
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert tree["lfm2.attention"] == ["flash.fwd"]
    assert names.count("gpt.loss") == 1 and names.count("flash.bwd") == 1
    assert names.count("moe.bwd") == 2

def test_tiny_resnet_records_its_forward_tree(off):
    model = resnet.ResNet(stage_sizes=[1, 1], block_cls=resnet.ResNetBlock,
                          num_classes=10, num_filters=8,
                          dtype=torch.float32, device="cpu", seed=0)
    x = torch.randn(2, 3, 32, 32)
    t0 = tl.now_us()
    with _cpu_profile():
        model(x)
    got = tl.spans(t0)
    assert [s.name for s in got].count("resnet.forward") == 1
    assert _tree(got)["resnet.forward"] == [
        "resnet.stem", "resnet.block", "resnet.block", "resnet.head"]
    assert [s.attrs for s in got if s.name == "resnet.block"] == [
        {"block": 0}, {"block": 1}]


def test_device_trace_holds_the_spans_over_the_ops_they_enclose(tmp_path):
    x = torch.randn(64, 64)
    forced = tl._forced
    tl.start_xla_trace(str(tmp_path))
    try:
        with tl.span("test.matmul", rows=64):
            torch.mm(x, x)
    finally:
        path = tl.stop_xla_trace()
    assert validate_trace.validate_file(path) == []
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (sp,) = [e for e in events if e.get("name") == "test.matmul"]
    assert sp["ph"] == "X" and sp["cat"] == "horovod"
    assert sp["args"]["rows"] == 64
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert sp["ts"] <= mm["ts"] and \
        mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"]
    assert {"name": "process_name", "ph": "M", "pid": sp["pid"], "tid": 0,
            "args": {"name": "horovod rank 0"}} in events
    assert sp["pid"] != mm["pid"]
    assert tl._forced == forced


def test_timeline_file_is_on_the_recorder_clock(tmp_path):
    import horovod_tpu_torch.torch as hvd
    path = tmp_path / "timeline.json"
    hvd.init()
    try:
        t0 = time.time()
        hvd.start_timeline(str(path))
        assert tl.recording()
        hvd.allreduce(torch.ones(3), name="spans.tl", op=hvd.Sum)
        hvd.stop_timeline()
        t1 = time.time()
    finally:
        hvd.shutdown()
    events = json.loads(path.read_text())
    ts = [e["ts"] for e in events if "ts" in e]
    assert ts and all(t0 * 1e6 <= t <= t1 * 1e6 for t in ts)
    assert validate_trace.validate_file(str(path)) == []


def test_two_ranks_record_the_data_plane_of_one_allreduce():
    from test_torch_port_multiproc import run_port_workers
    from multiproc import assert_all_ok
    results = run_port_workers("""
        import json
        from torch.profiler import ProfilerActivity, profile
        from horovod_tpu_torch.common import timeline as tl
        t0 = tl.now_us()
        with profile(activities=[ProfilerActivity.CPU]):
            out = hvd.allreduce(torch.ones(5) * (RANK + 1), op=hvd.Sum,
                                name="spans.grad")
        assert out.tolist() == [3.0] * 5, out
        got = tl.spans(t0)
        by_id = {s.id: s for s in got}
        print("SPANS", json.dumps([
            [s.name, s.attrs, by_id[s.parent].name if s.parent in by_id
             else None] for s in got]))
    """, nproc=2)
    assert_all_ok(results)
    for _, out in results:
        line = [ln for ln in out.splitlines() if ln.startswith("SPANS ")]
        got = json.loads(line[0][len("SPANS "):])
        names = [n for n, _, _ in got]
        (neg,) = [a for n, a, _ in got if n == "negotiate"]
        assert neg == {"tensor": "spans.grad", "op": "ALLREDUCE"}
        (coll,) = [a for n, a, _ in got if n == "collective"]
        assert coll == {"op": "ALLREDUCE", "tensors": 1, "bytes": 20}
        assert ["gloo.allreduce", {}, "collective"] in got
        assert ["fusion.pack", {}, "gloo.allreduce"] in got
        assert ["fusion.unpack", {}, "gloo.allreduce"] in got
        assert names.count("collective") == 1


def test_stall_inspector_bookkeeping_holds_under_threads(monkeypatch):
    # Every tensor is past the warning age at once: check() warns and
    # marks them while the churn records and removes them.
    monkeypatch.setattr(logging.getLogger("horovod_tpu_torch.stall"),
                        "disabled", True)
    insp = StallInspector(warning_time_s=0.0, world_size=4)
    stop = threading.Event()
    errors = []

    def churn(k):
        try:
            i = 0
            while not stop.is_set():
                name = f"t{k}.{i % 64}"
                insp.record_uncached_tensor(name, k)
                insp.record_cached_tensor(name)
                insp.remove(f"t{k}.{(i + 32) % 64}")
                i += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def check():
        try:
            while not stop.is_set():
                insp.check()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=churn, args=(k,)) for k in range(3)]
    threads += [threading.Thread(target=check) for _ in range(2)]
    try:
        for th in threads:
            th.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    for k in range(3):
        for i in range(64):
            insp.remove(f"t{k}.{i}")
    assert insp._uncompleted == {} and insp._warned == set()
