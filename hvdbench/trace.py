"""The device trace of a run's traced steps, read in memory.

``torch.profiler`` traces the card alone (CUDA activity) around a fixed
count of steps.  It records no host operator: nothing here reads them,
and recording each of a step's thousands of operators slows the host
that launches them, which reads as idle time on the card.  The window opens :data:`MARGIN_S` after the profiler
starts and closes that long after a synchronize, so that no edge
kernel's event is lost (the margins of
``horovod_tpu_torch.common.timeline``'s device trace).
:data:`CATEGORIES`, :func:`category`, :func:`device_ms_by_name` and
:func:`ms_by_category` are frozen copies of
``horovod_tpu_torch/profile_step.py``'s arithmetic.

The harness marks each step and each part of a step with :func:`span`,
which, while a trace records, notes the part's start and end on the
host's clock (``time.time()``, the clock of the trace's timestamps);
:func:`summarize` takes the span of the steps as the traced window, the
union of device intervals inside it as busy time, and labels each idle
gap by the innermost part open at its middle.
"""

import contextlib
import json
import os
import tempfile
import time

MARGIN_S = 0.010
STEP = "step"

CATEGORIES = (("flash_fwd", ("flash_fwd",)),
              ("matmul_fp32", ("f32f32", "sgemm")),
              ("matmul_16bit", ("gemm", "xmma", "cutlass", "cublas",
                                "nvjet")),
              ("softmax", ("softmax",)),
              ("layer_norm", ("layer_norm",)),
              ("optimizer", ("adam", "foreach", "multi_tensor")),
              ("reduce", ("reduce",)))

# Work on the card in a torch.profiler Chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def device_ms_by_name(events) -> dict:
    """Device ms per kernel (or copy, or set) name, summed over a Chrome
    trace's events."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def ms_by_category(by_name: dict) -> dict:
    """:func:`device_ms_by_name`'s times summed by :func:`category`,
    largest first."""
    out = {}
    for name, ms in by_name.items():
        out[category(name)] = out.get(category(name), 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


_recording = None


@contextlib.contextmanager
def span(name: str):
    """Note the host's start and end of harness part ``name`` in the
    trace that records, if one does."""
    rec = _recording
    if rec is None:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        rec.spans.append((name, t0 * 1e6, time.time() * 1e6))


class DeviceTrace:
    """``with DeviceTrace() as t: <steps>``, then ``t.events``: the
    Chrome trace's events with ``ts`` in microseconds of the host's clock,
    held in memory (the file it passes through, in ``TMPDIR``, is
    deleted), and ``t.spans``: the harness parts, (name, start, end) in
    the same microseconds."""

    def __enter__(self):
        global _recording
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self.spans = []
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        time.sleep(MARGIN_S)
        _recording = self
        return self

    def __exit__(self, *exc):
        global _recording
        _recording = None
        self._torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        self._prof.stop()
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        # Timestamps are microseconds after ``baseTimeNanoseconds`` where
        # the trace gives it, else since the epoch.
        base = doc.get("baseTimeNanoseconds", 0) / 1e3
        self.events = doc["traceEvents"]
        for e in self.events:
            if "ts" in e:
                e["ts"] = float(e["ts"]) + base
        return False


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events, spans, steps: int) -> dict:
    """Busy and idle time of the card over the traced steps, device time
    by kernel name, and idle time by the harness part the host was in.
    ``spans``: :attr:`DeviceTrace.spans`.  Raises when there is no step
    span or no device event inside the steps."""
    step_spans = [s for s in spans if s[0] == STEP]
    if not step_spans:
        raise RuntimeError("the trace holds no harness step")
    lo = min(s[1] for s in step_spans)
    hi = max(s[2] for s in step_spans)
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS
               and lo <= e["ts"] < hi]
    if not kernels:
        raise RuntimeError("the device trace holds no device event inside "
                           "the traced steps")
    merged = _union((e["ts"], min(e["ts"] + e["dur"], hi)) for e in kernels)
    busy_us = sum(b - a for a, b in merged)
    parts = [s for s in spans if s[0] != STEP]
    idle = {}
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [s for s in parts if s[1] <= mid < s[2]]
        label = min(open_, key=lambda s: s[2] - s[1])[0] if open_ \
            else "other"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    by_name = device_ms_by_name(kernels)
    return {"steps": steps, "window_s": (hi - lo) / 1e6,
            "busy_s": busy_us / 1e6,
            "kernel_s": {n: ms / 1e3 for n, ms in by_name.items()},
            "category_s": {c: ms / 1e3
                           for c, ms in ms_by_category(by_name).items()},
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def kernel_seconds(summary: dict, *needles) -> float:
    """Device seconds of the kernels whose names hold every needle
    (case-insensitive)."""
    return sum(s for n, s in summary["kernel_s"].items()
               if all(k.lower() in n.lower() for k in needles))
