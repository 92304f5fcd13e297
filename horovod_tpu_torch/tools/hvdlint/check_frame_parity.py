"""frame-parity: every wire frame kind sent has a recv handler, and
the out-of-stream set is classified identically on every role.

The PR 8 rule, mechanized: a two-letter frame kind that one side
emits and no side dispatches is a frame that silently hits a
``logger.warning("unexpected frame")`` branch — or worse, desyncs the
reconnect stream cursor.  And the out-of-stream kinds (liveness HB,
metrics MQ/MR/MA) must be excluded from stream-ordinal accounting *on
both sides of every link* (worker, coordinator, relay): PR 8's
post-review bug was exactly a kind counted in the ordinal on one side
only, which made resume replay off-by-N after a reconnect.

Extraction (AST, wire modules ``controller_net.py`` + ``relay.py``):

* kind constants: 2-byte literals assigned to ``*MAGIC*`` names;
* SENT: kind arguments of calls whose name contains ``send`` or
  ``broadcast`` (direct literals or names resolving to kinds);
* HANDLED: kinds compared against in ``==`` / ``in`` dispatch tests,
  resolving tuple constants (``_OOS_UP``-style sets) through their
  assignments.

Checks:

* every statically-known SENT kind appears in HANDLED somewhere;
* ``controller_net``'s ``_OOS_DOWN`` is exactly ``{HB, MQ}`` and
  ``_OOS_UP`` exactly ``{HB, MR}`` (the worker and coordinator both
  classify through these two names — one definition, both sides);
* the relay special-cases every out-of-stream kind (HB/MQ/MR/MA) in
  its own dispatch — a relay that forwards one of these into the RB
  item stream breaks the identical-classification rule.

Suppression: ``# hvdlint: parity-ok(<reason>)`` on the send site.
"""

import ast
from typing import Dict, List, Set

from .core import Project, SourceFile, Violation, const_bytes

CHECK = "frame-parity"
TAG = "parity-ok"

OOS_KINDS = ("HB", "MQ", "MR", "MA")
EXPECT_OOS_DOWN = {"HB", "MQ"}
EXPECT_OOS_UP = {"HB", "MR"}


def _wire_files(project: Project) -> List[SourceFile]:
    return [f for f in project.files
            if f.relpath.endswith(("controller_net.py", "relay.py"))]


def _kind_of(node, kind_names: Dict[str, str]):
    b = const_bytes(node)
    if b is not None and len(b) == 2:
        try:
            return b.decode("ascii")
        except UnicodeDecodeError:
            return None
    if isinstance(node, ast.Name):
        return kind_names.get(node.id)
    if isinstance(node, ast.Attribute):
        return kind_names.get(node.attr)
    return None


def _collect(src: SourceFile):
    """(kind_names, oos_tuples, sent, handled) for one wire module."""
    kind_names: Dict[str, str] = {}
    oos_tuples: Dict[str, Set[str]] = {}
    if src.tree is None:
        return kind_names, oos_tuples, [], set()
    # pass 1: constants
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            b = const_bytes(node.value)
            if "MAGIC" in name and b is not None and len(b) == 2:
                kind_names[name] = b.decode("ascii", "replace")
    # pass 2: OOS tuple definitions (resolve members through pass 1)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) and \
                "OOS" in node.targets[0].id and \
                isinstance(node.value, (ast.Tuple, ast.List, ast.Set)):
            kinds = set()
            for elt in node.value.elts:
                k = _kind_of(elt, kind_names)
                if k:
                    kinds.add(k)
            oos_tuples[node.targets[0].id] = kinds
    # pass 3: sends and dispatch comparisons
    sent = []          # (kind, node)
    handled: Set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if "send" in fname or "broadcast" in fname:
                for arg in node.args:
                    k = _kind_of(arg, kind_names)
                    if k:
                        sent.append((k, node))
        elif isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)):
                    for side in (node.left, comp):
                        k = _kind_of(side, kind_names)
                        if k:
                            handled.add(k)
                elif isinstance(op, (ast.In, ast.NotIn)):
                    if isinstance(comp, (ast.Tuple, ast.List,
                                         ast.Set)):
                        for elt in comp.elts:
                            k = _kind_of(elt, kind_names)
                            if k:
                                handled.add(k)
                    elif isinstance(comp, ast.Name) and \
                            comp.id in oos_tuples:
                        handled.update(oos_tuples[comp.id])
    return kind_names, oos_tuples, sent, handled


def run(project: Project) -> List[Violation]:
    out: List[Violation] = []
    files = _wire_files(project)
    if not files:
        return out
    all_handled: Set[str] = set()
    per_file = {}
    for src in files:
        per_file[src.relpath] = _collect(src)
        all_handled.update(per_file[src.relpath][3])

    for src in files:
        kind_names, oos_tuples, sent, _ = per_file[src.relpath]
        # 5a: every sent kind has a recv dispatch branch somewhere.
        flagged = set()
        for kind, node in sent:
            if kind not in all_handled and kind not in flagged and \
                    not src.annotated(node, TAG):
                flagged.add(kind)
                out.append(Violation(
                    CHECK, src.relpath, node.lineno,
                    "unhandled-kind-" + kind,
                    "frame kind %r is sent here but no wire module "
                    "dispatches on it (no recv handler)" % kind))
        # 5b: the coordinator/worker OOS classification tables.
        if src.relpath.endswith("controller_net.py"):
            for tup, expect in (("_OOS_DOWN", EXPECT_OOS_DOWN),
                                ("_OOS_UP", EXPECT_OOS_UP)):
                got = oos_tuples.get(tup)
                if got is None:
                    out.append(Violation(
                        CHECK, src.relpath, 1, "oos-missing-" + tup,
                        "out-of-stream table %s is gone — worker and "
                        "coordinator no longer share one "
                        "classification" % tup))
                elif got != expect:
                    out.append(Violation(
                        CHECK, src.relpath, 1, "oos-table-" + tup,
                        "%s classifies %s, the wire contract says %s "
                        "(HB/MQ/MR/MA must be out-of-stream on BOTH "
                        "sides)" % (tup, sorted(got), sorted(expect))))
        # 5c: the relay dispatches every OOS kind itself.
        if src.relpath.endswith("relay.py"):
            handled_here = per_file[src.relpath][3]
            for kind in OOS_KINDS:
                if kind not in handled_here:
                    out.append(Violation(
                        CHECK, src.relpath, 1, "oos-relay-" + kind,
                        "relay has no dispatch branch for out-of-"
                        "stream kind %s — it would enter the RB item "
                        "stream and desync resume cursors" % kind))
    return out
