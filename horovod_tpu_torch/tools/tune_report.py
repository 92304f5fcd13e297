#!/usr/bin/env python
"""Pretty-print a tuned-profile artifact, or diff two of them.

Usage:
    python -m horovod_tpu_torch.tools.tune_report PROFILE.json
    python -m horovod_tpu_torch.tools.tune_report --diff OLD.json NEW.json
    python -m horovod_tpu_torch.tools.tune_report --json PROFILE.json

A profile is the frozen output of an autotune-then-freeze session
(horovod_tpu_torch/tune, docs/autotune.md): per-cycle-class knob winners +
objective scores plus the process-wide worker knobs.  The diff mode
shows knob deltas and the objective movement between two rounds —
the artifact-to-artifact comparison the bench lanes gate on.

Exit codes: 0 ok, 1 usage, 2 unreadable/invalid profile.

Counterpart of the JAX package's ``tools/tune_report.py``, reading
profiles through the port's ``tune/profile.py`` (the same schema): the
same output for the same profiles.
"""

import argparse
import json
import sys
import time

from ..tune.profile import TunedProfile, diff_profiles, load_profile


def _fmt_knobs(knobs: dict) -> str:
    return ", ".join("%s=%s" % (k, knobs[k]) for k in sorted(knobs))


def _fmt_score(score) -> str:
    if score is None:
        return "n/a"
    score = float(score)
    if score >= 1 << 20:
        return "%.2f MB/s" % (score / (1 << 20))
    return "%.1f B/s" % score


def render_profile(p: TunedProfile, path: str) -> str:
    lines = [
        "tuned profile: %s" % path,
        "  strategy:   %s" % p.strategy,
        "  world size: %d" % p.world_size,
        "  frozen at:  %s" % (
            time.strftime("%Y-%m-%d %H:%M:%S UTC",
                          time.gmtime(p.frozen_at_unix))
            if p.frozen_at_unix else "unknown"),
        "  worker knobs: %s" % _fmt_knobs(p.worker),
        "  cycle classes:",
    ]
    if not p.classes:
        lines.append("    (none — the session froze without traffic)")
    for name in sorted(p.classes):
        sec = p.classes[name]
        lines.append("    %-7s %s" % (name,
                                      _fmt_knobs(sec.get("knobs") or {})))
        lines.append("            objective %s over %s samples / %s "
                     "rounds" % (_fmt_score(sec.get("score_bytes_per_s")),
                                 sec.get("samples", "?"),
                                 sec.get("rounds", "?")))
    return "\n".join(lines)


def render_diff(a: TunedProfile, b: TunedProfile,
                path_a: str, path_b: str) -> str:
    d = diff_profiles(a, b)
    lines = ["tuned-profile diff: %s -> %s" % (path_a, path_b)]
    if d["strategy"][0] != d["strategy"][1]:
        lines.append("  strategy: %s -> %s" % d["strategy"])
    if d["world_size"][0] != d["world_size"][1]:
        lines.append("  world size: %s -> %s" % d["world_size"])
    for name in sorted(d["classes"]):
        sec = d["classes"][name]
        lines.append("  class %s:" % name)
        if sec["only_in"]:
            lines.append("    only in %s" %
                         (path_a if sec["only_in"] == "a" else path_b))
        for k, (va, vb) in sorted(sec["knob_deltas"].items()):
            lines.append("    %-14s %s -> %s" % (k, va, vb))
        if not sec["knob_deltas"] and not sec["only_in"]:
            lines.append("    knobs unchanged")
        sa, sb = sec["score_bytes_per_s"]
        if sa is not None or sb is not None:
            delta = "" if sec["score_delta_pct"] is None else \
                "  (%+.1f%%)" % sec["score_delta_pct"]
            lines.append("    objective      %s -> %s%s"
                         % (_fmt_score(sa), _fmt_score(sb), delta))
    if d["worker"]:
        lines.append("  worker knobs:")
        for k, (va, vb) in sorted(d["worker"].items()):
            lines.append("    %-14s %s -> %s" % (k, va, vb))
    else:
        lines.append("  worker knobs unchanged")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Pretty-print or diff tuned-profile artifacts")
    parser.add_argument("profiles", nargs="+",
                        help="profile path (or two with --diff)")
    parser.add_argument("--diff", action="store_true",
                        help="diff two profiles (knob + objective "
                             "deltas)")
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON instead of "
                             "text")
    args = parser.parse_args(argv)

    want = 2 if args.diff else 1
    if len(args.profiles) != want:
        parser.error("expected %d profile path(s), got %d"
                     % (want, len(args.profiles)))

    loaded = []
    for path in args.profiles:
        try:
            loaded.append(load_profile(path))
        except (OSError, ValueError) as e:
            print("error: could not load %s: %s" % (path, e),
                  file=sys.stderr)
            return 2

    if args.diff:
        a, b = loaded
        if args.json:
            print(json.dumps(diff_profiles(a, b), indent=2,
                             sort_keys=True, default=str))
        else:
            print(render_diff(a, b, *args.profiles))
    else:
        p = loaded[0]
        if args.json:
            print(json.dumps(p.to_dict(), indent=2, sort_keys=True))
        else:
            print(render_profile(p, args.profiles[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
