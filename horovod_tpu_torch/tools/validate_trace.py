"""Chrome-trace well-formedness checker for Horovod timeline output.

Validates the JSON the TimelineWriter produces (common/timeline.py),
the device trace ``timeline.stop_xla_trace`` writes — and, in
``--merged`` mode, the cross-rank postmortem traces
``blackbox_merge`` builds — against the chrome://tracing
event-format rules this repo relies on:

  * top level is an array of event objects, each with a phase ``ph``;
  * duration events balance: every ``E`` has a matching earlier ``B``
    on the same (pid, tid) lane, and no lane ends with an open span —
    in a merged multi-rank trace each rank is its own pid, so B/E
    pairing is checked per rank, never across ranks;
  * timestamps are non-negative numbers, and B/E timestamps are
    non-decreasing per lane (spans come from causally ordered
    lifecycle transitions of one tensor);
  * metadata (``M``) events carry ``args.name`` (the tid→tensor map);
  * counter (``C``) events carry an ``args`` dict of numeric series.

Merged mode adds the postmortem invariants:

  * EVERY timestamped event is non-decreasing per (pid, tid) lane —
    a clock-alignment bug in the merge shows up as time running
    backwards inside one rank's lane;
  * at least two pids are present (a "merged" trace of one rank is a
    merge that silently dropped its inputs).

Usable as a library (``validate_events`` / ``validate_file`` return a
list of error strings, empty = valid) and as a CLI (exits nonzero on
malformed input)::

    python -m horovod_tpu_torch.tools.validate_trace [--merged] TRACE_JSON [...]

Counterpart of the JAX package's ``tools/validate_trace.py``, with its
rules unchanged.  One addition: a file in the trace-event format's
JSON Object Format (``{"traceEvents": [...], ...}``, what
``torch.profiler`` exports and ``timeline.stop_xla_trace`` writes) is
read as its ``traceEvents`` array, each event held to the same rules;
the JAX tool reads only the JSON Array Format and rejects such a file
as a whole.
"""

import json
import sys
from typing import List

# Phases that are valid but carry no structure we verify beyond ts.
_PASSTHROUGH_PHASES = {"i", "I", "X", "b", "e", "n", "s", "t", "f",
                       "N", "O", "D", "P"}


def validate_events(events, merged: bool = False) -> List[str]:
    errors: List[str] = []
    if not isinstance(events, list):
        return ["top-level JSON must be an array of trace events"]
    depth = {}      # (pid, tid) -> open B count
    last_ts = {}    # (pid, tid) -> last B/E timestamp
    last_any = {}   # (pid, tid) -> last timestamp of ANY event (merged)
    pids = set()
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            errors.append("event %d: not an object with a 'ph' phase"
                          % i)
            continue
        ph = e["ph"]
        if ph == "M":
            if not isinstance(e.get("args"), dict) or \
                    "name" not in e["args"]:
                errors.append("event %d: metadata without args.name"
                              % i)
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
                or ts < 0:
            errors.append("event %d: missing or negative ts (%r)"
                          % (i, ts))
            continue
        lane = (e.get("pid", 0), e.get("tid", 0))
        pids.add(e.get("pid", 0))
        if merged:
            if ts < last_any.get(lane, 0.0):
                errors.append(
                    "event %d: merged ts moved backwards on lane %r "
                    "(%r < %r)" % (i, lane, ts, last_any[lane]))
            last_any[lane] = max(last_any.get(lane, 0.0), ts)
        if ph in ("B", "E"):
            if ts < last_ts.get(lane, 0.0):
                errors.append(
                    "event %d: ts moved backwards on lane %r "
                    "(%r < %r)" % (i, lane, ts, last_ts[lane]))
            last_ts[lane] = max(last_ts.get(lane, 0.0), ts)
            if ph == "B":
                if "name" not in e:
                    errors.append("event %d: 'B' without a name" % i)
                depth[lane] = depth.get(lane, 0) + 1
            else:
                depth[lane] = depth.get(lane, 0) - 1
                if depth[lane] < 0:
                    errors.append(
                        "event %d: 'E' without a matching 'B' on "
                        "lane %r" % (i, lane))
                    depth[lane] = 0
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) and
                    not isinstance(v, bool)
                    for v in args.values()):
                errors.append(
                    "event %d: 'C' without a numeric args dict" % i)
        elif ph not in _PASSTHROUGH_PHASES:
            errors.append("event %d: unknown phase %r" % (i, ph))
    for lane, d in sorted(depth.items(), key=lambda kv: str(kv[0])):
        if d != 0:
            errors.append("lane %r: %d unclosed 'B' span(s)"
                          % (lane, d))
    if merged and len(pids) < 2:
        errors.append("merged trace contains %d pid(s); a cross-rank "
                      "merge needs at least 2" % len(pids))
    return errors


def validate_file(path: str, merged: bool = False) -> List[str]:
    try:
        with open(path) as f:
            events = json.load(f)
    except (OSError, ValueError) as e:
        return ["%s: unreadable or invalid JSON: %s" % (path, e)]
    if isinstance(events, dict) and "traceEvents" in events:
        events = events["traceEvents"]
    return validate_events(events, merged=merged)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    merged = False
    if "--merged" in argv:
        merged = True
        argv.remove("--merged")
    if not argv:
        print("usage: validate_trace.py [--merged] TIMELINE_JSON "
              "[...]", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        errors = validate_file(path, merged=merged)
        if errors:
            rc = 1
            for err in errors:
                print("%s: %s" % (path, err))
        else:
            print("%s: OK" % path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
