"""hot-path-gate: instrumentation on hot paths hides behind ONE
attribute check.

The contract every observability subsystem in this repo ships under
(failpoints, flight recorder, lock witness — each perf-pinned): with
the subsystem disabled, a site on the frame/submit/cycle hot path
costs exactly one module-attribute check.  That only holds if every
call is *written* as::

    if _fr.ENABLED:
        _fr.record(...)
    if _fp.ENABLED and _fp.maybe_fail("site") == "drop":
        ...

An unguarded ``record()``/``maybe_fail()`` pays the full call (10-30x
the guard) on every event even when disabled — the exact regression
class the perf pins exist to catch, caught here before it runs.

Metrics are always-on by design (an ``.inc()`` is the budget), but
metric *registration* (``metrics.counter/gauge/histogram``) takes the
registry lock and allocates — in a hot module it must happen once at
module scope (the pre-bound ``_FRAMES_RECV = metrics.counter(...)``
idiom), never per call.

Observability ``note_*`` feeders (the straggler observatory's phase
collector and scorer, replay's disruption notes) follow the same
contract with an object-shaped gate: the call must sit behind either
an ``ENABLED`` check of the straggler module or an ``is not None``
guard on the collector/scorer — both one attribute check on the
disabled path.  A bare ``x.note_*(...)`` in a hot module pays the
full call even when the subsystem is off.

Hot modules are marked, not listed: a module participates by carrying
``# hvdlint-module: hot-path`` near its top.  Suppression for a
genuinely cold call inside a hot module:
``# hvdlint: hot-ok(<reason>)``.
"""

import ast
from typing import List

from .core import (Project, SourceFile, Violation, ancestors,
                   import_aliases, parent_map)

CHECK = "hot-path-gate"
TAG = "hot-ok"
MODULE_MARK = "# hvdlint-module: hot-path"

_REG_CALLS = ("counter", "gauge", "histogram")


def _is_hot(src: SourceFile) -> bool:
    return any(MODULE_MARK in line for line in src.lines)


def _contains_enabled(node: ast.AST, aliases) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "ENABLED" \
                and isinstance(sub.value, ast.Name) and \
                sub.value.id in aliases:
            return True
    return False


def _contains(node: ast.AST, target: ast.AST) -> bool:
    return any(sub is target for sub in ast.walk(node))


def _guarded(call: ast.Call, parents, aliases) -> bool:
    """True when an ancestor guard proves ``<alias>.ENABLED`` was
    truthy before this call can run: the call sits in the TRUE body
    of an ``if``/``while``/conditional expression whose test checks
    ENABLED, or after ENABLED in a short-circuiting ``and`` chain.
    The else/orelse branch is the opposite guarantee — a call there
    runs exactly when ENABLED is false and must NOT count."""
    prev: ast.AST = call
    for anc in ancestors(call, parents):
        if isinstance(anc, (ast.If, ast.While)) and \
                _contains_enabled(anc.test, aliases) and \
                any(stmt is prev for stmt in anc.body):
            return True
        if isinstance(anc, ast.IfExp) and \
                _contains_enabled(anc.test, aliases) and \
                anc.body is prev:
            return True
        if isinstance(anc, ast.BoolOp) and \
                isinstance(anc.op, ast.And):
            # ENABLED must appear in a value EVALUATED BEFORE the one
            # containing the call (short-circuit order).
            call_idx = next((i for i, v in enumerate(anc.values)
                             if _contains(v, call)), None)
            if call_idx is not None and any(
                    _contains_enabled(v, aliases)
                    for v in anc.values[:call_idx]):
                return True
        prev = anc
    return False


def _contains_isnot(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Compare) and
               any(isinstance(op, ast.IsNot) for op in sub.ops)
               for sub in ast.walk(node))


def _none_guarded(call: ast.Call, parents) -> bool:
    """True when an ancestor guard carries an ``is not None``
    comparison evaluated before the call can run (the object-shaped
    disabled gate: ``if sg is not None: sg.note_arrival(...)``)."""
    prev: ast.AST = call
    for anc in ancestors(call, parents):
        if isinstance(anc, (ast.If, ast.While)) and \
                _contains_isnot(anc.test) and \
                any(stmt is prev for stmt in anc.body):
            return True
        if isinstance(anc, ast.IfExp) and \
                _contains_isnot(anc.test) and anc.body is prev:
            return True
        if isinstance(anc, ast.BoolOp) and \
                isinstance(anc.op, ast.And):
            call_idx = next((i for i, v in enumerate(anc.values)
                             if _contains(v, call)), None)
            if call_idx is not None and any(
                    _contains_isnot(v)
                    for v in anc.values[:call_idx]):
                return True
        prev = anc
    return False


def _check_file(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    if src.tree is None or not _is_hot(src):
        return out
    parents = parent_map(src.tree)
    fr_aliases = set(import_aliases(src.tree, "flight_recorder"))
    fp_aliases = set(import_aliases(src.tree, "failpoints"))
    metric_aliases = set(import_aliases(src.tree, "metrics"))
    sg_aliases = set(import_aliases(src.tree, "straggler"))

    def in_function(node) -> bool:
        return any(isinstance(a, (ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                   for a in ancestors(node, parents))

    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        owner = node.func.value
        if not isinstance(owner, ast.Name):
            continue
        attr = node.func.attr
        if owner.id in fr_aliases and attr == "record" and \
                not _guarded(node, parents, fr_aliases) and \
                not src.annotated(node, TAG):
            out.append(Violation(
                CHECK, src.relpath, node.lineno, "unguarded-record",
                "flight_recorder.record() not behind `if %s.ENABLED:`"
                " — the disabled hot path must cost one attribute "
                "check" % owner.id))
        elif owner.id in fp_aliases and attr == "maybe_fail" and \
                not _guarded(node, parents, fp_aliases) and \
                not src.annotated(node, TAG):
            out.append(Violation(
                CHECK, src.relpath, node.lineno, "unguarded-maybe-fail",
                "failpoints.maybe_fail() not behind `if %s.ENABLED"
                "...` — the disabled hot path must cost one attribute "
                "check" % owner.id))
        elif attr.startswith("note_") and owner.id != "self" and \
                not _guarded(node, parents, sg_aliases) and \
                not _none_guarded(node, parents) and \
                not src.annotated(node, TAG):
            # owner "self" is the subsystem's own internal dispatch
            # (e.g. replay routing on_broken through note_disruption),
            # not a hot-path feeder site.
            out.append(Violation(
                CHECK, src.relpath, node.lineno, "unguarded-note",
                "%s.%s() not behind an ENABLED / `is not None` gate "
                "— the disabled hot path must cost one attribute "
                "check" % (owner.id, attr)))
        elif owner.id in metric_aliases and attr in _REG_CALLS and \
                in_function(node) and not src.annotated(node, TAG):
            out.append(Violation(
                CHECK, src.relpath, node.lineno,
                "metric-registration-in-function",
                "metrics.%s() inside a function in a hot module — "
                "pre-bind the metric at module scope" % attr))
    return out


def run(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.files:
        out.extend(_check_file(src))
    return out
