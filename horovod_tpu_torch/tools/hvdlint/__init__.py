"""hvdlint: project-invariant static analysis for horovod_tpu_torch.

Named AST checks encoding this codebase's hard-won invariants
(docs/static_analysis.md), scoped to the ``horovod_tpu_torch/`` tree
and ``chip_smoke.py`` and judged against the port's own catalogs
(``horovod_tpu_torch/docs/``), run as a tier-1 gate
(tests/test_torch_port_hvdlint.py) and as a CLI::

    python -m horovod_tpu_torch.tools.hvdlint --check all
    python -m horovod_tpu_torch.tools.hvdlint --check bounded-wait \
        --root /path/to/repo

Standard library only: importing it loads no torch.  The runtime half
of the suite — the lock-order witness — lives in
``horovod_tpu_torch/common/lockwitness.py`` (it must import with the
package, not with the linter).
"""

from typing import Dict, List, Optional

from . import (check_bounded_wait, check_frame_parity,
               check_hot_path_gate, check_knob_hygiene,
               check_registry_drift)
from .core import (GateResult, Project, Violation, apply_baseline,
                   load_baseline, save_baseline)

#: check name -> analyzer entry point (each: Project -> [Violation])
CHECKS = {
    "bounded-wait": check_bounded_wait.run,
    "knob-hygiene": check_knob_hygiene.run,
    "hot-path-gate": check_hot_path_gate.run,
    "registry-drift": check_registry_drift.run,
    "frame-parity": check_frame_parity.run,
}


def run_checks(project: Project,
               names: Optional[List[str]] = None) -> List[Violation]:
    """Run the named checks (all by default) and return every
    violation, ordered by (path, line)."""
    out: List[Violation] = []
    for name in (names or sorted(CHECKS)):
        out.extend(CHECKS[name](project))
    out.sort(key=lambda v: (v.path, v.line, v.check, v.ident))
    return out


def gate(project: Project, baseline_keys: List[str],
         names: Optional[List[str]] = None) -> GateResult:
    """The CI verdict: new violations and stale baseline entries both
    fail (the baseline only shrinks)."""
    return apply_baseline(run_checks(project, names), baseline_keys)


__all__ = ["CHECKS", "GateResult", "Project", "Violation", "gate",
           "run_checks", "load_baseline", "save_baseline",
           "apply_baseline"]
