"""Runtime metrics: process-wide counters, gauges, and histograms.

The live-numbers layer the Timeline (post-hoc chrome trace) and the
StallInspector (log lines) cannot provide: every hot path — the
background cycle loop, the controller frame plane, fusion planning, the
response cache, and the collective backends — accumulates into one
process-wide registry that can be read at any moment.

Design constraints (this sits ON the hot paths):

  * lock-cheap: one small lock per metric; an increment is a dict get +
    float add.  No allocation on the steady-state path.
  * bounded: histograms accumulate into FIXED log-scale buckets (no
    per-sample storage) — a week-long run holds the same few hundred
    floats as a one-minute run.
  * dependency-free: stdlib only; importable before jax, safe from any
    thread, meaningful before/after ``hvd.init()``.

Three read paths:

  * ``snapshot()`` → plain nested dict (the ``hvd.metrics_snapshot()``
    API, also what bench.py embeds in BENCH artifacts);
  * ``render_snapshot()`` / ``MetricsRegistry.render_prometheus()`` →
    Prometheus text exposition, served by :class:`MetricsServer` when
    ``HOROVOD_METRICS_PORT`` is set (guarded by the same job-secret
    HMAC as the rendezvous KV server);
  * ``merge_snapshots()`` → cross-rank aggregation: the rank-0
    coordinator collects per-rank snapshots over the control plane
    (controller_net MQ/MR frames) and exposes the merged view.
"""

import bisect
import functools
import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger("horovod_tpu_torch.metrics")


def log_bounds(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` log-scale bucket upper bounds from ``start`` by
    ``factor`` — the fixed-size accumulation grid for histograms."""
    out: List[float] = []
    b = float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


# Default grids.  Times span 1 µs (an inline cache-hit send) to ~67 s
# (a stalled negotiation); bytes span one cache-line-ish payload to
# ~17 GB; counts cover fusion batch sizes.
TIME_BUCKETS = log_bounds(1e-6, 2.0, 27)
BYTE_BUCKETS = log_bounds(256.0, 4.0, 14)
COUNT_BUCKETS = log_bounds(1.0, 2.0, 16)


def _sanitize(value: object) -> str:
    """Label values may carry wire-derived bytes (e.g. frame magics):
    strip the structural characters of the canonical key AND anything
    non-printable, so a hostile or corrupt value can never forge extra
    labels or emit exposition-breaking bytes (a raw newline in a label
    would make every subsequent scrape unparseable)."""
    return "".join(ch if 32 <= ord(ch) < 127 and ch not in ',="'
                   else "_" for ch in str(value))


def _label_key(labels: Dict[str, object]) -> str:
    """Canonical label serialization (sorted ``k=v`` pairs): the child
    key in snapshots and the inside of the Prometheus ``{...}``."""
    return ",".join("%s=%s" % (k, _sanitize(labels[k]))
                    for k in sorted(labels))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[str, object] = {}

    def clear(self):
        """Zero the metric in place (tests).  The object itself stays
        registered — instrumented modules hold references to it."""
        with self._lock:
            self._children.clear()

    def drop(self, **labels):
        """Retire every labeled child matching ALL given label values.
        Publishers that re-emit a bounded top-K family (the profiler
        digest) use this so stale label combinations don't outlive the
        set they belonged to — a labeled child otherwise lives forever."""
        match = set("%s=%s" % (k, _sanitize(labels[k])) for k in labels)
        with self._lock:
            for key in [k for k in self._children
                        if match.issubset(k.split(","))]:
                del self._children[key]

    def _collapse(self, d: dict):
        """Unlabeled metrics snapshot to a bare value; labeled ones to
        ``{label_key: value}``."""
        if list(d.keys()) == [""]:
            return d[""]
        return d


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        key = _label_key(labels) if labels else ""
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + value

    def value(self, **labels) -> float:
        key = _label_key(labels) if labels else ""
        with self._lock:
            return float(self._children.get(key, 0.0))

    def snapshot(self):
        with self._lock:
            return self._collapse(dict(self._children))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        key = _label_key(labels) if labels else ""
        with self._lock:
            self._children[key] = float(value)

    def inc(self, value: float = 1.0, **labels):
        key = _label_key(labels) if labels else ""
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        key = _label_key(labels) if labels else ""
        with self._lock:
            return float(self._children.get(key, 0.0))

    snapshot = Counter.snapshot


class Histogram(_Metric):
    """Fixed log-scale-bucket histogram: ``observe()`` is a bisect over
    ~two dozen bounds plus a few float adds — cheap enough for per-call
    ``time.perf_counter`` deltas on the cycle loop."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: Tuple[float, ...] = TIME_BUCKETS):
        super().__init__(name, help)
        self.bounds = tuple(bounds)

    def observe(self, value: float, **labels):
        value = float(value)
        # Slot i counts values <= bounds[i]; the final slot is +Inf.
        idx = bisect.bisect_left(self.bounds, value)
        key = _label_key(labels) if labels else ""
        with self._lock:
            h = self._children.get(key)
            if h is None:
                h = {"counts": [0] * (len(self.bounds) + 1),
                     "sum": 0.0, "count": 0, "min": None, "max": None}
                self._children[key] = h
            h["counts"][idx] += 1
            h["sum"] += value
            h["count"] += 1
            if h["min"] is None or value < h["min"]:
                h["min"] = value
            if h["max"] is None or value > h["max"]:
                h["max"] = value

    def _child_snapshot(self, h: dict) -> dict:
        buckets = [[le, c] for le, c in zip(self.bounds, h["counts"])]
        buckets.append(["+Inf", h["counts"][-1]])
        return {"count": h["count"], "sum": h["sum"],
                "min": h["min"], "max": h["max"], "buckets": buckets}

    def snapshot(self):
        with self._lock:
            return self._collapse({k: self._child_snapshot(h)
                                   for k, h in self._children.items()})


class MetricsRegistry:
    """Name → metric map with get-or-create semantics: any module may
    declare the same metric; the first declaration wins (a kind clash
    is a programming error and raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    "metric %r already registered as %s, not %s"
                    % (name, m.kind, cls.kind))
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Tuple[float, ...] = TIME_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, bounds=bounds)

    def reset(self):
        """Zero every metric in place (see _Metric.clear)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    def snapshot(self) -> dict:
        """Plain nested dict, JSON-serializable: the wire format for
        cross-rank aggregation and the ``hvd.metrics_snapshot()``
        return value."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            snap = m.snapshot()
            if snap == {} or snap is None:
                continue
            out[m.kind + "s"][m.name] = snap
        return out

    def render_prometheus(self) -> str:
        with self._lock:
            helps = {m.name: m.help for m in self._metrics.values()}
            kinds = {m.name: m.kind for m in self._metrics.values()}
        snap = self.snapshot()
        # Emit TYPE headers even for still-empty metrics so a scrape of
        # a fresh process is non-empty and self-describing.
        empties = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, kind in kinds.items():
            section = kind + "s"
            if name not in snap.get(section, {}):
                empties[section][name] = None
        text = render_snapshot(snap, helps=helps)
        for section in ("counters", "gauges", "histograms"):
            for name in empties[section]:
                text += "# TYPE %s %s\n" % (name, section[:-1])
        return text


def _prom_escape(v: object) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"')


def _prom_labels(key: str, extra: str = "") -> str:
    parts = []
    if key:
        for item in key.split(","):
            k, _, v = item.partition("=")
            parts.append('%s="%s"' % (k, _prom_escape(v)))
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _as_children(val) -> Dict[str, object]:
    """Normalize a snapshot entry to {label_key: value} form (bare
    values and unlabeled histogram children collapse to key "")."""
    if isinstance(val, dict) and not ("count" in val and "buckets" in val):
        return val
    return {"": val}


def render_snapshot(snap: dict, prefix: str = "",
                    helps: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition of a snapshot dict.  ``prefix`` lets
    an aggregated (cluster-merged) snapshot render next to the local
    one without name collisions."""
    helps = helps or {}
    lines: List[str] = []
    for section, ptype in (("counters", "counter"), ("gauges", "gauge")):
        for name, val in sorted(snap.get(section, {}).items()):
            full = prefix + name
            if helps.get(name):
                lines.append("# HELP %s %s" % (full, helps[name]))
            lines.append("# TYPE %s %s" % (full, ptype))
            for key, v in sorted(_as_children(val).items()):
                lines.append("%s%s %s" % (full, _prom_labels(key), v))
    for name, val in sorted(snap.get("histograms", {}).items()):
        full = prefix + name
        if helps.get(name):
            lines.append("# HELP %s %s" % (full, helps[name]))
        lines.append("# TYPE %s histogram" % full)
        for key, h in sorted(_as_children(val).items()):
            cum = 0
            for le, c in h.get("buckets", []):
                cum += c
                le_s = "+Inf" if le == "+Inf" else repr(float(le))
                lines.append("%s_bucket%s %d" % (
                    full, _prom_labels(key, 'le="%s"' % le_s), cum))
            lines.append("%s_sum%s %s" % (full, _prom_labels(key),
                                          h.get("sum", 0.0)))
            lines.append("%s_count%s %d" % (full, _prom_labels(key),
                                            h.get("count", 0)))
    return "\n".join(lines) + "\n" if lines else ""


def _merge_hist(a: dict, b: dict) -> dict:
    out = {"count": a.get("count", 0) + b.get("count", 0),
           "sum": a.get("sum", 0.0) + b.get("sum", 0.0)}
    mins = [m for m in (a.get("min"), b.get("min")) if m is not None]
    maxs = [m for m in (a.get("max"), b.get("max")) if m is not None]
    out["min"] = min(mins) if mins else None
    out["max"] = max(maxs) if maxs else None
    ab, bb = a.get("buckets", []), b.get("buckets", [])
    if len(ab) == len(bb) and all(x[0] == y[0] for x, y in zip(ab, bb)):
        out["buckets"] = [[x[0], x[1] + y[1]] for x, y in zip(ab, bb)]
    else:  # mismatched grids (mixed versions): keep totals only
        out["buckets"] = []
    return out


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Element-wise sum of snapshot dicts: counters and gauges add
    (gauges therefore read as cross-rank totals, e.g. total outstanding
    tensors), histograms merge bucket-wise."""
    merged = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for section in ("counters", "gauges"):
            for name, val in snap.get(section, {}).items():
                acc = merged[section].setdefault(name, {})
                for key, v in _as_children(val).items():
                    acc[key] = acc.get(key, 0.0) + v
        for name, val in snap.get("histograms", {}).items():
            acc = merged["histograms"].setdefault(name, {})
            for key, h in _as_children(val).items():
                acc[key] = _merge_hist(acc[key], h) if key in acc else h
    for section in merged:
        merged[section] = {
            name: (children[""] if list(children.keys()) == [""]
                   else children)
            for name, children in merged[section].items()}
    return merged


# ---------------------------------------------------------------------------
# The process-wide registry + module-level conveniences
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              bounds: Tuple[float, ...] = TIME_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, bounds=bounds)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset():
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# Collective instrumentation shared by the data-plane backends
# ---------------------------------------------------------------------------

COLLECTIVE_OPS = REGISTRY.counter(
    "hvd_collective_ops_total",
    "Collective dispatches by data-plane backend and op type")
COLLECTIVE_BYTES = REGISTRY.counter(
    "hvd_collective_bytes_total",
    "Payload bytes moved per backend and op type")
COLLECTIVE_SECONDS = REGISTRY.histogram(
    "hvd_collective_seconds",
    "Host wall time per collective dispatch (includes device wait only "
    "when the caller blocks)", bounds=TIME_BUCKETS)


def list_nbytes(arrays, *args, **kwargs) -> int:
    """Payload bytes of a tensor batch without forcing a device
    transfer (jax and numpy arrays both expose .nbytes)."""
    return sum(int(getattr(a, "nbytes", 0)) for a in arrays)


def one_nbytes(array, *args, **kwargs) -> int:
    return int(getattr(array, "nbytes", 0))


def record_collective(backend: str, op: str, nbytes: int, seconds: float):
    COLLECTIVE_OPS.inc(1, backend=backend, op=op)
    COLLECTIVE_BYTES.inc(nbytes, backend=backend, op=op)
    COLLECTIVE_SECONDS.observe(seconds, backend=backend, op=op)


def timed_collective(backend: str, op: str,
                     nbytes_fn: Callable[..., int]):
    """Method decorator for backend collectives: times the call and
    records op count + payload bytes.  ``nbytes_fn`` receives the
    method's arguments (minus self) and must be side-effect free."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            result = fn(self, *args, **kwargs)
            dt = time.perf_counter() - t0
            try:
                record_collective(backend, op,
                                  int(nbytes_fn(*args, **kwargs)), dt)
            except Exception:
                logger.debug("collective metrics failed", exc_info=True)
            return result
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# /metrics HTTP endpoint (opt-in via HOROVOD_METRICS_PORT)
# ---------------------------------------------------------------------------

class MetricsServer:
    """The ``/metrics`` / ``/status`` / ``/profile`` / ``/blackbox``
    HTTP endpoint.  It rides the rendezvous KV server's handler and
    job-secret HMAC guard (``runner/http_server.py``,
    ``runner/job_secret.py``), which arrive with the runner in the
    multi-rank slice; until then starting it raises, so a configured
    endpoint is never silently served without its auth guard."""

    def __init__(self, port: int = 0, registry: Optional[MetricsRegistry] = None,
                 cluster_provider: Optional[Callable[[], Optional[dict]]] = None,
                 secret: Optional[str] = None,
                 status_provider: Optional[Callable[[], Optional[dict]]] = None,
                 profile_provider: Optional[Callable[[], Optional[dict]]] = None):
        raise NotImplementedError(
            "the /metrics endpoint needs the runner's KV handler and "
            "job-secret guard, which are ported with the multi-rank "
            "data plane (slice 2)")


def serve(port: int = 0, registry: Optional[MetricsRegistry] = None,
          cluster_provider=None, secret: Optional[str] = None,
          status_provider=None, profile_provider=None) -> MetricsServer:
    return MetricsServer(port=port, registry=registry,
                         cluster_provider=cluster_provider, secret=secret,
                         status_provider=status_provider,
                         profile_provider=profile_provider)
