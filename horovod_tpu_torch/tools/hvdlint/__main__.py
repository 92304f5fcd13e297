"""hvdlint CLI.

Exit codes (CI contract):
  0 — clean: no violations beyond the baseline, no stale entries;
  1 — new violations and/or stale baseline entries;
  2 — usage error (unknown check, unreadable root).
"""

import argparse
import os
import sys

from . import CHECKS, Project, gate, load_baseline, run_checks, \
    save_baseline
from .core import PACKAGE

_DEFAULT_BASELINE = os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.hvdlint",
        description="Project-invariant static analysis for "
                    "horovod_tpu_torch (docs/static_analysis.md)")
    ap.add_argument("--check", default="all",
                    help="comma-separated check names, or 'all' "
                         "(known: %s)" % ", ".join(sorted(CHECKS)))
    ap.add_argument("--root", default=None,
                    help="repo root (default: three levels above this "
                         "package)")
    ap.add_argument("--baseline", default=_DEFAULT_BASELINE,
                    help="baseline file (default: the committed "
                         "horovod_tpu_torch/tools/hvdlint/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every violation, grandfathered or "
                         "not (exit 1 if any)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to exactly the current "
                         "violations (shrinks stale entries away)")
    args = ap.parse_args(argv)

    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    if not os.path.isdir(os.path.join(root, PACKAGE)):
        print("hvdlint: %r does not look like the repo root "
              "(no %s/)" % (root, PACKAGE), file=sys.stderr)
        return 2

    if args.check == "all":
        names = None
    else:
        names = [c.strip() for c in args.check.split(",") if c.strip()]
        unknown = [c for c in names if c not in CHECKS]
        if unknown:
            print("hvdlint: unknown check(s): %s (known: %s)"
                  % (", ".join(unknown), ", ".join(sorted(CHECKS))),
                  file=sys.stderr)
            return 2

    project = Project.from_root(root)
    for f in project.files:
        if f.parse_error:
            print("hvdlint: %s: syntax error: %s"
                  % (f.relpath, f.parse_error), file=sys.stderr)
            return 2

    if args.no_baseline:
        violations = run_checks(project, names)
        for v in violations:
            print(v.render())
        print("hvdlint: %d violation(s), baseline ignored"
              % len(violations))
        return 1 if violations else 0

    if args.update_baseline:
        violations = run_checks(project, names)
        save_baseline(args.baseline,
                      [v.key for v in violations])
        print("hvdlint: baseline rewritten with %d entr%s -> %s"
              % (len(violations),
                 "y" if len(violations) == 1 else "ies",
                 args.baseline))
        return 0

    result = gate(project, load_baseline(args.baseline), names)
    for v in result.new:
        print("NEW  " + v.render())
    for key in result.stale:
        print("STALE baseline entry %s — the violation is fixed; "
              "delete the entry (the baseline only shrinks)" % key)
    if result.grandfathered:
        print("hvdlint: %d grandfathered violation(s) riding the "
              "baseline" % len(result.grandfathered))
    if result.ok:
        print("hvdlint: clean (%s)"
              % (", ".join(names) if names else "all checks"))
        return 0
    print("hvdlint: %d new violation(s), %d stale baseline entr%s"
          % (len(result.new), len(result.stale),
             "y" if len(result.stale) == 1 else "ies"))
    return 1


if __name__ == "__main__":
    sys.exit(main())
