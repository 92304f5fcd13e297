"""registry-drift: emitted names and their doc catalogs never diverge.

Three registries, three catalogs, all extracted from the AST (names
are registered across multi-line calls, through aliases, behind
helpers — a regex over source misses what the interpreter sees):

* **metrics** — every ``hvd_*`` name passed to
  ``counter()/gauge()/histogram()`` must appear in
  ``horovod_tpu_torch/docs/observability.md``, and every ``hvd_*``
  token in that doc
  must be a registered metric (dead documentation is drift too);
* **failpoint sites** — every constant site string passed to
  ``maybe_fail()`` must appear in the ``## Site catalog`` section of
  ``horovod_tpu_torch/docs/fault_injection.md``, and vice versa;
* **env knobs** — every ``HOROVOD_*`` string constant in the source
  tree must be documented *somewhere* under ``horovod_tpu_torch/docs/``
  or the README (``horovod_tpu_torch/docs/env_knobs.md`` is the
  canonical catalog), and every knob row in that catalog must still
  exist in source.

``common/failpoints.py`` is the infrastructure for sites (its own
``maybe_fail`` forwards a ``site`` variable), so site extraction skips
it; metric extraction keeps ``common/metrics.py`` (it registers real
collective metrics at module scope) and simply ignores non-constant
name arguments.  Dynamic names are invisible to the doc gate — keep
registrations literal.
"""

import ast
import re
from typing import Dict, List, Set, Tuple

from .core import DOCS, Project, Violation, call_attr_name, const_str

CHECK = "registry-drift"

_METRIC_DOC = DOCS + "/observability.md"
_SITE_DOC = DOCS + "/fault_injection.md"
_KNOB_DOC = DOCS + "/env_knobs.md"

_METRIC_TOKEN = re.compile(r"\bhvd_[a-z0-9_]+\b")
_SITE_TOKEN = re.compile(r"`([a-z0-9_]+(?:\.[a-z0-9_]+)+)`")
_KNOB_TOKEN = re.compile(r"\bHOROVOD_[A-Z0-9_]+\b")

_SITE_INFRA = ("horovod_tpu_torch/common/failpoints.py",)


def _source_metrics(project: Project) -> Dict[str, Tuple[str, int]]:
    """hvd_* metric name -> (first registering file, line)."""
    out: Dict[str, Tuple[str, int]] = {}
    for src in project.files:
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and \
                    call_attr_name(node) in ("counter", "gauge",
                                             "histogram") and node.args:
                name = const_str(node.args[0])
                if name and name.startswith("hvd_"):
                    out.setdefault(name, (src.relpath, node.lineno))
    return out


def _source_sites(project: Project) -> Dict[str, Tuple[str, int]]:
    out: Dict[str, Tuple[str, int]] = {}
    for src in project.files:
        if src.tree is None or src.relpath in _SITE_INFRA:
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and \
                    call_attr_name(node) == "maybe_fail" and node.args:
                site = const_str(node.args[0])
                if site and "." in site:
                    out.setdefault(site, (src.relpath, node.lineno))
    return out


def _source_knobs(project: Project) -> Dict[str, Tuple[str, int]]:
    out: Dict[str, Tuple[str, int]] = {}
    for src in project.files:
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            name = const_str(node)
            if name and _KNOB_TOKEN.fullmatch(name):
                out.setdefault(name, (src.relpath, node.lineno))
    return out


def _site_catalog_text(doc: str) -> str:
    """The ``## Site catalog`` section only — the rest of the doc may
    mention dotted identifiers (``hvd.init``) that are not sites."""
    m = re.search(r"^#{2,4}\s+Site catalog\s*$(.*?)(?=^#{1,4}\s|\Z)",
                  doc, re.M | re.S)
    return m.group(1) if m else ""


def _doc_line(doc: str, token: str) -> int:
    for i, line in enumerate(doc.splitlines(), start=1):
        if token in line:
            return i
    return 1


def run(project: Project) -> List[Violation]:
    out: List[Violation] = []

    # --- metrics <-> observability.md ---------------------------------
    metric_doc = project.docs.get(_METRIC_DOC, "")
    doc_metrics: Set[str] = set(_METRIC_TOKEN.findall(metric_doc))
    src_metrics = _source_metrics(project)
    for name, (path, line) in sorted(src_metrics.items()):
        if name not in doc_metrics:
            out.append(Violation(
                CHECK, path, line, name,
                "metric %s is emitted but missing from %s"
                % (name, _METRIC_DOC)))
    for name in sorted(doc_metrics - set(src_metrics)):
        out.append(Violation(
            CHECK, _METRIC_DOC, _doc_line(metric_doc, name), name,
            "documented metric %s is registered nowhere in the tree "
            "(dead doc entry)" % name))

    # --- failpoint sites <-> fault_injection.md site catalog ----------
    site_doc = project.docs.get(_SITE_DOC, "")
    catalog = _site_catalog_text(site_doc)
    doc_sites: Set[str] = set(_SITE_TOKEN.findall(catalog))
    src_sites = _source_sites(project)
    for site, (path, line) in sorted(src_sites.items()):
        if site not in doc_sites:
            out.append(Violation(
                CHECK, path, line, site,
                "failpoint site %s missing from the %s site catalog"
                % (site, _SITE_DOC)))
    for site in sorted(doc_sites - set(src_sites)):
        out.append(Violation(
            CHECK, _SITE_DOC, _doc_line(site_doc, site), site,
            "cataloged failpoint site %s is evaluated nowhere in the "
            "tree (dead doc entry)" % site))

    # --- env knobs <-> docs ------------------------------------------
    src_knobs = _source_knobs(project)
    all_doc_text = "\n".join(project.docs.values())
    documented: Set[str] = set(_KNOB_TOKEN.findall(all_doc_text))
    for knob, (path, line) in sorted(src_knobs.items()):
        if knob not in documented:
            out.append(Violation(
                CHECK, path, line, knob,
                "env knob %s is read in source but documented in no "
                "doc (add it to %s)" % (knob, _KNOB_DOC)))
    knob_doc = project.docs.get(_KNOB_DOC, "")
    for knob in sorted(set(_KNOB_TOKEN.findall(knob_doc))
                       - set(src_knobs)):
        out.append(Violation(
            CHECK, _KNOB_DOC, _doc_line(knob_doc, knob), knob,
            "cataloged env knob %s appears nowhere in source (dead "
            "doc entry)" % knob))
    return out
