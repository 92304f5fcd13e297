"""Cross-rank causal postmortem: merge black-box flight-recorder dumps.

Input: the per-rank JSON dumps ``common/flight_recorder.py`` writes on
failure triggers (lost-rank promotion, stall shutdown, fatal unwind,
SIGUSR2, chaos-drill end).  Output:

  * one **chrome-trace** JSON (validated by ``validate_trace
    --merged``): every rank is a pid, events land on per-subsystem tid
    lanes (frames / liveness / replay / checkpoint / elastic / fault),
    and the recovery-phase breakdown renders as B/E spans on a
    synthetic "postmortem" process so the whole incident reads
    left-to-right in chrome://tracing;
  * one machine-readable **verdict**: the failed rank and/or relay,
    the first divergent event, and a detect→promote→restore→resume
    span breakdown whose segments partition fault→resumption — the
    numbers the MTTR bench lane embeds in its artifact instead of
    coarse wall-clock timers.

Clock alignment: each dump's events carry wall-clock stamps from its
own process.  Worker clocks are aligned to the coordinator's with the
classic NTP pairing over the HB liveness round-trips the recorder
already logs (coordinator HB broadcast ↔ worker hb_rx downlink;
worker HB send ↔ coordinator hb_rx uplink):

    offset(r) = (median(t_rx_down − t_tx_down)
                 − median(t_rx_up − t_tx_up)) / 2

so merged time = wall − offset, coordinator frame.  Ranks with no
pairable traffic merge at offset 0.  No wire-format change is needed:
the recorder's (session, ordinal, cycle) tags come from identifiers
the control plane already had.

CLI::

    python -m horovod_tpu_torch.tools.blackbox_merge DUMP_DIR
        [-o trace.json] [--verdict verdict.json]

Prints the verdict JSON on stdout; exits nonzero when no dumps are
found or any dump is malformed.

Counterpart of the JAX package's ``tools/blackbox_merge.py``, copied:
the dump schema is the same in both packages, so either merges the
other's dumps into the same trace and verdict.
"""

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from . import validate_trace

# tid lanes per rank-pid: one per subsystem, so chrome://tracing shows
# each rank's planes stacked in a fixed, comparable order.
_LANES = {
    "frame_tx": 1, "frame_rx": 1,
    "hb_tx": 2, "hb_rx": 2, "promote": 2, "limbo": 2, "resume": 2,
    "register": 2, "wedge": 2,
    "relay_attach": 3, "relay_down": 3, "relay_lost": 3, "rehome": 3,
    "replay": 4,
    "submit": 5,
    "ckpt": 6,
    "elastic": 7,
    "failpoint": 8, "fatal": 8, "stall": 8,
    "note": 9,
}
_LANE_NAMES = {1: "frames", 2: "liveness", 3: "relay", 4: "replay",
               5: "submit", 6: "checkpoint", 7: "elastic", 8: "fault",
               9: "markers"}

_PHASES = ("detect", "promote", "restore", "resume")


class MergeError(RuntimeError):
    pass


def load_dumps(path: str) -> List[dict]:
    """Load every ``blackbox-*.json`` under a directory (or the single
    file given).  Several dumps for one rank (promotion at fault time
    + drill end) are UNIONED event-wise: the later dump's ring may
    have evicted the pre-fault frames the earlier one preserved —
    exactly the evidence a postmortem exists for — so older dumps are
    never discarded, only exact-duplicate events are."""
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(glob.glob(os.path.join(path, "blackbox-*.json")))
    by_rank: Dict[str, dict] = {}
    seen: Dict[str, set] = {}
    for f in files:
        try:
            with open(f) as fh:
                d = json.load(fh)
        except (OSError, ValueError) as e:
            raise MergeError("%s: unreadable or invalid JSON: %s"
                             % (f, e))
        if not isinstance(d, dict) or \
                not isinstance(d.get("events"), list):
            raise MergeError("%s: not a flight-recorder dump" % f)
        for i, e in enumerate(d["events"]):
            # The merge indexes events by wall/kind throughout; a
            # truncated or foreign dump must fail HERE as the
            # documented MergeError (crisp nonzero exit), never as a
            # KeyError deep inside offset estimation.
            if not isinstance(e, dict) or \
                    not isinstance(e.get("wall"), (int, float)) or \
                    not isinstance(e.get("kind"), str):
                raise MergeError(
                    "%s: event %d lacks wall/kind (truncated or "
                    "foreign dump?)" % (f, i))
        key = str(d.get("rank"))
        prev = by_rank.get(key)
        if prev is None:
            by_rank[key] = d
            seen[key] = {(e.get("mono"), e["wall"], e["kind"])
                         for e in d["events"]}
        else:
            # Same process, same mono clock: (mono, wall, kind)
            # identifies an event across overlapping ring snapshots.
            fresh = []
            for e in d["events"]:
                sig = (e.get("mono"), e["wall"], e["kind"])
                if sig not in seen[key]:
                    seen[key].add(sig)
                    fresh.append(e)
            prev["events"].extend(fresh)
            prev["events"].sort(key=lambda e: (e.get("mono", 0.0),
                                               e["wall"]))
            if d.get("wall_at_dump", 0) >= \
                    prev.get("wall_at_dump", 0):
                for meta in ("reason", "wall_at_dump",
                             "mono_at_dump", "pid"):
                    if meta in d:
                        prev[meta] = d[meta]
    if not by_rank:
        raise MergeError("no blackbox-*.json dumps under %s" % path)
    return [by_rank[k] for k in sorted(by_rank)]


def _is_coord(dump: dict) -> bool:
    return any(e.get("role") == "coord" for e in dump["events"])


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def _nn_deltas(tx_times: List[float], rx_times: List[float]
               ) -> List[float]:
    """rx − tx for each reception paired to its NEAREST send.  Robust
    to drops and to either side missing the other's first beats (a
    FIFO zip shifts every pair after one loss); correct as long as
    |skew + delay| stays under half the HB cadence — the regime NTP-
    class clock error lives in.  Bounded: only the newest 256 of each
    side are considered (the ring is bounded anyway)."""
    tx = tx_times[-256:]
    deltas = []
    for rx in rx_times[-256:]:
        if not tx:
            break
        nearest = min(tx, key=lambda t: abs(rx - t))
        deltas.append(rx - nearest)
    return deltas


def estimate_offsets(dumps: List[dict]) -> Dict[str, float]:
    """Per-rank wall-clock offset relative to the coordinator dump
    (``merged = wall - offset``), NTP-style over the HB round trips
    the recorder already logs; 0 when no pairable traffic exists (or
    for the coordinator itself)."""
    coord = next((d for d in dumps if _is_coord(d)), dumps[0])
    cev = coord["events"]
    # Downlink HB leaves the coordinator as one broadcast frame_tx
    # (field ``frame`` carries the wire kind).
    hb_down = [e["wall"] for e in cev
               if e["kind"] == "frame_tx" and e.get("role") == "coord"
               and _frame_kind(e) == "HB"]
    # Uplink HB arrives at the coordinator as per-peer hb_rx events —
    # keyed by worker rank (``peer``) or, for a root-attached relay's
    # own HB, by ``relay`` id (keyed here as "relay<id>", the relay's
    # dump rank tag).
    hb_up_rx: Dict[object, List[float]] = {}
    for e in cev:
        if e["kind"] == "hb_rx" and e.get("role") == "coord":
            if e.get("peer") is not None:
                hb_up_rx.setdefault(e["peer"], []).append(e["wall"])
            elif e.get("relay") is not None:
                hb_up_rx.setdefault("relay%s" % e["relay"],
                                    []).append(e["wall"])
    offsets: Dict[str, float] = {str(coord.get("rank")): 0.0}
    for d in dumps:
        key = str(d.get("rank"))
        if key in offsets:
            continue
        ev = d["events"]
        # The dumping node's view: HB downlink arrivals and HB uplink
        # sends.  Workers and relays record the same event shapes;
        # root-attached relays pair against the coordinator's per-relay
        # hb_rx, while a relay DEEPER in the tree (its HBs are consumed
        # by its parent relay, never seen by the root) has no pairable
        # round trip and falls back to offset 0.
        down_rx = [e["wall"] for e in ev if e["kind"] == "hb_rx"
                   and e.get("role") in ("worker", "relay")
                   and e.get("peer") is None and e.get("relay") is None]
        up_tx = [e["wall"] for e in ev if e["kind"] == "frame_tx"
                 and e.get("role") in ("worker", "relay")
                 and _frame_kind(e) == "HB"]
        coord_rx = hb_up_rx.get(d.get("rank"),
                                hb_up_rx.get(key, []))
        # offset = ((rx_down - tx_down) - (rx_up - tx_up)) / 2: the
        # one-way skews cancel the symmetric network delay.
        m_down = _median(_nn_deltas(hb_down, down_rx))
        m_up = _median(_nn_deltas(up_tx, coord_rx))
        if m_down is not None and m_up is not None:
            offsets[key] = (m_down - m_up) / 2.0
        else:
            offsets[key] = 0.0
    return offsets


def _frame_kind(e: dict) -> str:
    """The wire-frame kind (CH/RS/HB/...) of a frame event — the
    recorder's ``frame`` payload field."""
    return str(e.get("frame") or "")


def merged_events(dumps: List[dict],
                  offsets: Optional[Dict[str, float]] = None
                  ) -> List[Tuple[float, dict, dict]]:
    """All events across dumps as (merged_wall, event, dump), sorted
    by merged time (ties broken by rank then event order)."""
    if offsets is None:
        offsets = estimate_offsets(dumps)
    out = []
    for d in dumps:
        off = offsets.get(str(d.get("rank")), 0.0)
        for i, e in enumerate(d["events"]):
            out.append((e["wall"] - off, i, e, d))
    out.sort(key=lambda t: (t[0], str(t[3].get("rank")), t[1]))
    return [(t[0], t[2], t[3]) for t in out]


def _first(evs, pred):
    for t, e, d in evs:
        if pred(e):
            return t, e, d
    return None


def _last(evs, pred):
    hit = None
    for t, e, d in evs:
        if pred(e):
            hit = (t, e, d)
    return hit


def compute_verdict(dumps: List[dict],
                    offsets: Optional[Dict[str, float]] = None) -> dict:
    """The machine-readable postmortem: who failed, where the streams
    first diverged, and where the recovery time went."""
    if offsets is None:
        offsets = estimate_offsets(dumps)
    evs = merged_events(dumps, offsets)

    promote = _first(evs, lambda e: e["kind"] == "promote"
                     and not e.get("clean"))
    # The earliest relay_down NAMING a relay: the dying relay's own
    # fail-stop event (kill/uplink-cut), its parent witnessing the
    # dead or silent child link (interior loss, wedge), or the root
    # losing a direct relay link — whichever was recorded first.
    relay_down = _first(evs, lambda e: e["kind"] == "relay_down"
                        and e.get("relay") is not None)
    relay_lost = _first(evs, lambda e: e["kind"] == "relay_lost")
    fault_note = _first(evs, lambda e: e["kind"] == "note"
                        and e.get("note") == "drill.fault")
    resumed_note = _last(evs, lambda e: e["kind"] == "note"
                         and e.get("note") == "drill.resumed")
    limbo = _first(evs, lambda e: e["kind"] == "limbo")
    fatals = [(t, e, d) for t, e, d in evs if e["kind"] == "fatal"]
    restores = [(t, e, d) for t, e, d in evs
                if e["kind"] == "ckpt" and e.get("phase") == "restore"]

    # The verdict must come from the EVENTS, never the drill's own
    # markers — the whole point is closing the loop on drills that
    # today only assert recovery happened.
    failed_rank = None
    if promote is not None:
        failed_rank = promote[1].get("peer")
    failed_relay = None
    if relay_down is not None:
        failed_relay = relay_down[1].get("relay")

    # Resize triggers, time-ordered: the typed elasticity events name
    # WHY each world change happened (scale_up_discovery /
    # straggler_migration / death).  Three event forms feed this —
    # the driver's typed elastic_scale_up / elastic_migrate records,
    # the coordinator-notice evictions, and the epoch_plan trigger
    # label; an epoch_plan restating the trigger of the typed event
    # that preceded it is collapsed.
    resize_triggers: List[str] = []
    for t, e, d in evs:
        kind = e["kind"]
        trig = None
        if kind == "elastic_scale_up":
            trig = "scale_up_discovery"
        elif kind == "elastic_migrate" and e.get("phase") == "evict":
            trig = "straggler_migration"
        elif kind == "elastic" and e.get("event") == "evict":
            trig = "death"
        elif kind == "elastic" and e.get("event") == "epoch_plan" and \
                e.get("trigger") in ("scale_up_discovery",
                                     "straggler_migration", "death"):
            trig = e["trigger"]
            if resize_triggers and resize_triggers[-1] == trig:
                trig = None
        if trig is not None:
            resize_triggers.append(trig)

    # First divergent event: the earliest (merged-time) piece of
    # evidence that some rank's view of the world stopped matching its
    # peers' — limbo entry, a relay loss, a silent-peer promotion, a
    # fatal unwind.
    candidates = [x for x in (limbo, relay_down, relay_lost, promote,
                              fatals[0] if fatals else None)
                  if x is not None]
    first_div = min(candidates, key=lambda x: x[0]) if candidates \
        else None

    # --- span breakdown: segments partitioning fault -> resumption ---
    t_fault = fault_note[0] if fault_note else (
        first_div[0] if first_div else None)
    t_promote = promote[0] if promote else (
        relay_down[0] if relay_down else None)
    t_unwind = max(t for t, _, _ in fatals) if fatals else None
    t_restore = max(t for t, _, _ in restores) if restores else None
    t_resumed = resumed_note[0] if resumed_note else None

    spans = {}
    if t_fault is not None:
        # Anchor chain: each phase ends where the next begins; absent
        # anchors collapse their phase to zero at the previous anchor
        # so the segments always sum to (t_resumed - t_fault).
        anchors = [t_fault]
        for t in (t_promote, t_unwind, t_restore, t_resumed):
            anchors.append(max(anchors[-1], t) if t is not None
                           else anchors[-1])
        for name, a, b in zip(_PHASES, anchors[:-1], anchors[1:]):
            spans[name] = round(b - a, 6)
        spans["total"] = round(anchors[-1] - anchors[0], 6)

    def _ev(hit):
        if hit is None:
            return None
        t, e, d = hit
        out = dict(e)
        out["merged_wall"] = t
        out["dump_rank"] = d.get("rank")
        return out

    return {
        "failed_rank": failed_rank,
        "failed_relay": failed_relay,
        "resize_triggers": resize_triggers,
        "resize_trigger": resize_triggers[-1] if resize_triggers
        else None,
        "first_divergent_event": _ev(first_div),
        "spans": spans,
        "mttr_s": spans.get("total"),
        "clock_offsets": offsets,
        "ranks": [d.get("rank") for d in dumps],
        "events_total": sum(len(d["events"]) for d in dumps),
    }


def build_trace(dumps: List[dict],
                offsets: Optional[Dict[str, float]] = None,
                verdict: Optional[dict] = None) -> List[dict]:
    """Chrome-trace events for the merged timeline (valid under
    validate_trace --merged)."""
    if offsets is None:
        offsets = estimate_offsets(dumps)
    if verdict is None:
        verdict = compute_verdict(dumps, offsets)
    evs = merged_events(dumps, offsets)
    if not evs:
        return []
    t0 = evs[0][0]
    trace: List[dict] = []
    pid_of: Dict[str, int] = {}
    for i, d in enumerate(dumps):
        key = str(d.get("rank"))
        pid_of[key] = i
        trace.append({"name": "process_name", "ph": "M", "pid": i,
                      "args": {"name": "rank %s" % key}})
        for tid, lane in sorted(_LANE_NAMES.items()):
            trace.append({"name": "thread_name", "ph": "M", "pid": i,
                          "tid": tid, "args": {"name": lane}})
    for t, e, d in evs:
        pid = pid_of[str(d.get("rank"))]
        tid = _LANES.get(e["kind"], 9)
        args = {k: v for k, v in e.items()
                if k not in ("mono", "wall") and v is not None}
        # Chrome-trace args must be JSON scalars/containers; they are.
        name = e["kind"]
        for extra in ("phase", "reason", "outcome", "note"):
            if e.get(extra):
                name = "%s:%s" % (name, e[extra])
                break
        trace.append({"name": name, "ph": "i", "s": "t", "pid": pid,
                      "tid": tid, "ts": max(0.0, (t - t0) * 1e6),
                      "args": args})
    # Recovery-phase breakdown as B/E spans on a synthetic process:
    # the left-to-right story of the incident.
    spans = verdict.get("spans") or {}
    if spans.get("total"):
        pm_pid = len(dumps)
        trace.append({"name": "process_name", "ph": "M", "pid": pm_pid,
                      "args": {"name": "postmortem"}})
        trace.append({"name": "thread_name", "ph": "M", "pid": pm_pid,
                      "tid": 1, "args": {"name": "recovery"}})
        cursor = _fault_ts_us(evs, verdict, t0)
        for phase in _PHASES:
            dur = max(0.0, float(spans.get(phase, 0.0))) * 1e6
            trace.append({"name": phase, "ph": "B", "pid": pm_pid,
                          "tid": 1, "ts": cursor})
            cursor += dur
            trace.append({"name": phase, "ph": "E", "pid": pm_pid,
                          "tid": 1, "ts": cursor})
    return trace


def _fault_ts_us(evs, verdict, t0: float) -> float:
    fd = verdict.get("first_divergent_event") or {}
    for t, e, d in evs:
        if e["kind"] == "note" and e.get("note") == "drill.fault":
            return max(0.0, (t - t0) * 1e6)
    if fd.get("merged_wall") is not None:
        return max(0.0, (fd["merged_wall"] - t0) * 1e6)
    return 0.0


def merge(path: str) -> Tuple[List[dict], dict]:
    """Load → align → merge: returns (trace_events, verdict)."""
    dumps = load_dumps(path)
    offsets = estimate_offsets(dumps)
    verdict = compute_verdict(dumps, offsets)
    trace = build_trace(dumps, offsets, verdict)
    return trace, verdict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="dump directory (or one dump file)")
    p.add_argument("-o", "--out", help="write the merged chrome trace "
                   "here")
    p.add_argument("--verdict", help="write the verdict JSON here")
    args = p.parse_args(argv)
    try:
        trace, verdict = merge(args.path)
    except MergeError as e:
        print("blackbox_merge: %s" % e, file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(trace, f)
        # Self-check the artifact we just wrote.
        errors = validate_trace.validate_events(trace, merged=True)
        if errors:
            for err in errors:
                print("merged trace invalid: %s" % err,
                      file=sys.stderr)
            return 1
    if args.verdict:
        with open(args.verdict, "w") as f:
            json.dump(verdict, f, indent=2)
    print(json.dumps(verdict, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
