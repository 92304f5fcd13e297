#!/usr/bin/env python
"""hvdtop: live cluster dashboard over the ``GET /status`` plane.

A top(1) for a horovod_tpu_torch job: polls the job-secret-guarded /status
endpoint (served next to /metrics when ``HOROVOD_METRICS_PORT`` is
set — point it at rank 0 for the cluster view) and renders per-rank
liveness, straggler scores, replay/tune phase, and queue depth.

    python -m horovod_tpu_torch.tools.hvdtop --url http://worker0:9090
    python -m horovod_tpu_torch.tools.hvdtop --url http://worker0:9090 --once

Signs requests with the job secret (``HOROVOD_SECRET_KEY`` or
``--secret``) using the same HMAC contract as every rendezvous/metrics
request; against a secretless endpoint it fetches unsigned.  ``--once``
prints one plain-text frame and exits 0 (the scriptable/CI mode the
straggler bench lane uses); without it, a curses screen refreshes at
``--interval`` (falling back to plain-text polling when stdout is not
a tty or curses is unavailable).

Counterpart of the JAX package's ``tools/hvdtop.py``, signing with the
port's ``runner/job_secret.py`` (the same contract): the same frame for
the same ``/status``.
"""

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from ..runner import job_secret


_STATE_ORDER = {"lost": 0, "wedged": 1, "limbo": 2, "unknown": 3,
                "alive": 4}


def fetch_status(url: str, secret: str = "", timeout: float = 5.0) -> dict:
    """One signed (when a secret is given) GET of the /status JSON."""
    if not url.rstrip("/").endswith("/status"):
        url = url.rstrip("/") + "/status"
    headers = {}
    if secret:
        path = "/" + url.split("://", 1)[-1].split("/", 1)[-1]
        ts = repr(time.time())
        headers = {
            job_secret.TS_HEADER: ts,
            job_secret.HEADER: job_secret.sign(secret, "GET", path,
                                               b"", ts),
        }
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _bar(score: float, threshold: float, width: int = 12) -> str:
    """A small score meter scaled so the threshold sits at ~2/3."""
    if threshold <= 0:
        return ""
    frac = min(1.0, (score / threshold) * (2.0 / 3.0))
    filled = int(round(frac * width))
    return "#" * filled + "." * (width - filled)


def _profile_pane(cluster: dict) -> list:
    """The --profile pane: the cluster-wide top-K hot-frame digest
    (common/profiler.py rank-labeled gauges recovered from the MR/MA
    frames), worst share first."""
    profile = cluster.get("profile") or {}
    lines = ["profile digest (per-rank top hot frames, share of "
             "active samples):"]
    if not profile:
        lines.append("  (no digests: run ranks with HOROVOD_PROFILE=1)")
        return lines
    rows = []
    for r_s, entries in profile.items():
        for e in entries or []:
            rows.append((float(e.get("share") or 0.0), int(r_s),
                         e.get("lane", "?"), e.get("frame", "?")))
    rows.sort(key=lambda t: (-t[0], t[1]))
    lines.append("  %5s %4s  %-10s  %s" % ("share", "rank", "lane",
                                           "frame"))
    for share, rank, lane, frame in rows[:20]:
        lines.append("  %4.0f%% %4d  %-10s  %s" % (share * 100, rank,
                                                   lane, frame))
    return lines


def render(status: dict, now: float = None,
           show_profile: bool = False) -> str:
    """One plain-text frame of the dashboard (shared by --once, the
    plain poller, and the curses screen)."""
    now = time.time() if now is None else now
    lines = []
    replay = status.get("replay") or {}
    tune = status.get("tune") or {}
    head = "hvdtop — rank %s / size %s" % (status.get("rank", "?"),
                                           status.get("size", "?"))
    phase = "replay: %s (%d cycles replayed)" % (
        "active" if replay.get("active") else
        ("enabled" if replay.get("enabled") else "off"),
        int(replay.get("cycles_replayed") or 0))
    if tune:
        phase += ", tune: %s" % tune.get("phase", "?")
    lines.append(head)
    lines.append("%s | queue %s | ops %d | %s" % (
        phase, status.get("queue_depth", "?"),
        int(status.get("ops_dispatched") or 0),
        time.strftime("%H:%M:%S", time.localtime(now))))
    cluster = status.get("cluster")
    if not cluster:
        lines.append("(no cluster section: point hvdtop at the rank-0 "
                     "endpoint of a Python-coordinator world)")
        phases = status.get("phases") or {}
        if phases:
            lines.append("local phases: " + ", ".join(
                "%s=%.2fms" % (k, v * 1e3)
                for k, v in sorted(phases.items())))
        return "\n".join(lines) + "\n"
    sg = cluster.get("straggler") or {}
    threshold = float(sg.get("threshold") or 0.0)
    lines.append("cluster: size %s, %s%s | pending tensors %s | "
                 "straggler threshold %s" % (
                     cluster.get("size"),
                     "formed" if cluster.get("formed") else "forming",
                     ", BROKEN" if cluster.get("broken") else "",
                     cluster.get("pending_tensors"),
                     threshold or "off"))
    lines.append("%4s  %-7s %7s  %-12s %10s  %-30s %s" % (
        "rank", "state", "score", "meter", "heard(s)", "hot frame",
        "flags"))
    ranks = cluster.get("ranks") or {}
    order = sorted(ranks.items(),
                   key=lambda kv: (_STATE_ORDER.get(
                       kv[1].get("state"), 9),
                       -(kv[1].get("score") or 0.0), int(kv[0])))
    for r_s, d in order:
        score = float(d.get("score") or 0.0)
        flags = []
        if d.get("slow"):
            flags.append("SLOW")
        if d.get("via_relay") is not None:
            flags.append("via relay %s" % d["via_relay"])
        heard = d.get("last_heard_age_s")
        lines.append("%4s  %-7s %7.2f  %-12s %10s  %-30s %s" % (
            r_s, d.get("state", "?"), score,
            _bar(score, threshold) if threshold else "",
            "%.2f" % heard if heard is not None else "-",
            (d.get("hot_frame") or "-")[:30],
            " ".join(flags)))
    flagged = sg.get("flagged") or []
    if flagged:
        lines.append("slow ranks: %s (elastic/slow/<rank> published "
                     "to the rendezvous KV)" % flagged)
    if show_profile:
        lines.append("")
        lines.extend(_profile_pane(cluster))
    return "\n".join(lines) + "\n"


def _poll_plain(args) -> int:
    while True:
        try:
            status = fetch_status(args.url, args.secret, args.timeout)
        except (OSError, urllib.error.URLError, ValueError) as e:
            print("hvdtop: could not fetch %s: %s" % (args.url, e),
                  file=sys.stderr)
            return 2
        sys.stdout.write(render(status, show_profile=args.profile))
        sys.stdout.flush()
        if args.once:
            return 0
        time.sleep(args.interval)
        sys.stdout.write("\n")


def _poll_curses(args) -> int:
    import curses

    def loop(screen):
        curses.curs_set(0)
        screen.nodelay(True)
        while True:
            try:
                status = fetch_status(args.url, args.secret,
                                      args.timeout)
                frame = render(status, show_profile=args.profile)
            except (OSError, urllib.error.URLError, ValueError) as e:
                frame = "hvdtop: could not fetch %s: %s\n" % (
                    args.url, e)
            screen.erase()
            h, w = screen.getmaxyx()
            for i, line in enumerate(frame.splitlines()[:h - 1]):
                screen.addnstr(i, 0, line, w - 1)
            screen.addnstr(h - 1, 0, "q to quit", w - 1)
            screen.refresh()
            deadline = time.time() + args.interval
            while time.time() < deadline:
                ch = screen.getch()
                if ch in (ord("q"), ord("Q")):
                    return 0
                time.sleep(0.05)

    return curses.wrapper(loop) or 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="hvdtop", description="live horovod_tpu_torch cluster view "
        "over GET /status (docs/observability.md)")
    p.add_argument("--url", default="http://127.0.0.1:9090",
                   help="metrics/status endpoint base URL (rank 0 for "
                        "the cluster view)")
    p.add_argument("--secret", default=os.environ.get(
        "HOROVOD_SECRET_KEY", ""),
        help="job secret for HMAC signing (default: HOROVOD_SECRET_KEY)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh cadence, seconds")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-fetch HTTP timeout, seconds")
    p.add_argument("--once", action="store_true",
                   help="print one plain-text frame and exit 0")
    p.add_argument("--profile", action="store_true",
                   help="append the cluster top-K hot-frame digest "
                        "pane (ranks running HOROVOD_PROFILE=1)")
    p.add_argument("--plain", action="store_true",
                   help="poll in plain text (no curses)")
    args = p.parse_args(argv)
    if args.once or args.plain or not sys.stdout.isatty():
        return _poll_plain(args)
    try:
        return _poll_curses(args)
    except Exception:
        # A curses failure (odd TERM, no terminal caps) degrades to
        # the plain poller instead of dying.
        return _poll_plain(args)


if __name__ == "__main__":
    sys.exit(main())
