"""The readers of the port's program spans (``hvd_init_self_s``,
``forward_host_ms.tokens`` and ``.images``) against spans recorded in
this process and hand-made rank results."""

import statistics
import time
import types

import pytest

from hvdbench import spec
from horovod_tpu_torch.common import timeline as tl

CELLS = {"forward_host_ms.tokens": ("gpt2_small.1chip", "gpt.forward"),
         "forward_host_ms.images": ("resnet50.1chip", "resnet.forward")}


@pytest.fixture
def recorder(monkeypatch):
    rec = tl.SpanRecorder()
    monkeypatch.setattr(tl, "_recorder", rec)
    return rec


def _record(name, n, seconds=0.001):
    for _ in range(n):
        with tl.span(name, always=True):
            time.sleep(seconds)


def _run(cell, t_start, t_init, t_window1, chips=None):
    if chips is not None:
        cell = types.SimpleNamespace(chips=chips, traffic=cell.traffic)
    return {"cell": cell, "t_start": t_start,
            "ranks": [{"t_init": t_init, "t_window1": t_window1}]}


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_forward_host_ms_is_the_median_traced_forward(recorder, metric):
    cell_name, span_name = CELLS[metric]
    cell = spec.Cell(cell_name)
    read = cell.reader(metric)
    steps = int(cell.traffic["trace_steps"])
    _record(span_name, 2)            # before the window ends: not read
    t_window1 = time.time()
    _record(span_name, steps)
    _record("gpt.block" if span_name == "gpt.forward" else "resnet.block", 3)
    got = [s for s in tl.spans(t_window1 * 1e6) if s.name == span_name]
    want = statistics.median((s.end_us - s.start_us) / 1e3 for s in got)
    run = _run(cell, 0.0, 0.0, t_window1)
    assert read(run) == want and want >= 1.0
    assert read(_run(cell, 0.0, 0.0, t_window1, chips=4)) is None
    _record(span_name, 1)
    assert read(run) is None         # one forward more than traced


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_forward_host_ms_reads_nothing_after_drops(monkeypatch, metric):
    cell_name, span_name = CELLS[metric]
    cell = spec.Cell(cell_name)
    steps = int(cell.traffic["trace_steps"])
    monkeypatch.setattr(tl, "_recorder", tl.SpanRecorder(capacity=steps))
    t_window1 = time.time()
    _record(span_name, steps + 1)
    assert len(tl.spans()) == steps and tl.dropped() == 1
    assert cell.reader(metric)(_run(cell, 0.0, 0.0, t_window1)) is None


@pytest.mark.parametrize("cell_name", ["gpt2_small.1chip", "resnet50.1chip"])
def test_hvd_init_self_s_is_the_init_span(recorder, cell_name):
    cell = spec.Cell(cell_name)
    read = cell.reader("hvd_init_self_s")
    t_start = time.time()
    _record("hvd.init", 1, seconds=0.01)
    t_init = time.time()
    _record("hvd.init", 1)           # a later init: not this rank's
    (init,) = [s for s in tl.spans() if s.start_us <= t_init * 1e6]
    run = _run(cell, t_start, t_init, t_init)
    assert read(run) == (init.end_us - init.start_us) / 1e6
    assert 0.01 <= read(run) < t_init - t_start
    assert read(_run(cell, t_start, t_init, t_init, chips=4)) is None
    assert read(_run(cell, t_init, t_init, t_init)) is None
    recorder.dropped = 1
    assert read(run) is None


def test_readers_find_nothing_without_the_recorder(monkeypatch):
    """A port older than the recorder has no ``spans``: the readers
    return None and do not raise."""
    monkeypatch.delattr(tl, "spans")
    for metric, (cell_name, _) in sorted(CELLS.items()) + [
            ("hvd_init_self_s", ("gpt2_small.1chip", None))]:
        cell = spec.Cell(cell_name)
        assert cell.reader(metric)(_run(cell, 0.0, 1.0, 1.0)) is None
