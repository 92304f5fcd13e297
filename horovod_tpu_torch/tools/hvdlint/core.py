"""hvdlint core: project model, annotations, violations, baseline.

The analyzers in ``horovod_tpu_torch/tools/hvdlint/check_*.py`` encode
this codebase's hard-won invariants (docs/static_analysis.md) as named
checks over a :class:`Project` — a parsed snapshot of the
``horovod_tpu_torch/`` tree (its ``tools/``, ``examples/`` and
``_alias/`` included) and ``chip_smoke.py``, plus the port's doc
catalogs (``horovod_tpu_torch/docs/``) and the README.  Everything
works on ``ast`` trees, never on regexes over source, so multi-line
calls, aliased imports and computed names are seen the way the
interpreter sees them.

Annotation grammar (suppression is always *named*, never bare)::

    # hvdlint: <check-tag>(<reason>)

e.g. ``# hvdlint: bounded-by(mux selector polls at 0.2s)`` on the
violating line, any line of the violating statement, or the line
directly above it.  A bare ``# hvdlint:`` comment or an empty reason
does NOT suppress — the reason is the point (it names the deadline /
contract that covers the site).

Baseline workflow: ``baseline.json`` holds grandfathered violation
keys (``check:path:ident``).  New violations fail; a baselined
violation that disappears makes its entry STALE, which also fails
until the entry is deleted — the baseline only ever shrinks.
"""

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

# The scanned package and its doc catalogs, relative to the repo root.
PACKAGE = "horovod_tpu_torch"
DOCS = PACKAGE + "/docs"

# Directories never scanned (generated/vendored/bytecode).
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}

# The annotation grammar.  The reason must be non-empty; it may wrap
# across consecutive comment-only continuation lines until the
# closing paren.
_ANNOT_START_RE = re.compile(r"#\s*hvdlint:\s*([a-z0-9-]+)\s*\(")


@dataclasses.dataclass
class Violation:
    """One finding: ``check`` names the analyzer, ``ident`` is the
    stable baseline key component (an env-var name, a metric name, a
    construct slug — NOT a line number, so baselines survive edits
    elsewhere in the file)."""
    check: str
    path: str          # repo-relative, forward slashes
    line: int
    ident: str
    message: str

    @property
    def key(self) -> str:
        return "%s:%s:%s" % (self.check, self.path, self.ident)

    def render(self) -> str:
        return "%s:%d: [%s] %s  (key %s)" % (
            self.path, self.line, self.check, self.message, self.key)


class SourceFile:
    """One parsed python file: text, lines, ast tree, annotations."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:
            self.parse_error = str(e)
        self._annotations: Optional[Dict[int, List[Tuple[str, str]]]] \
            = None

    @property
    def annotations(self) -> Dict[int, List[Tuple[str, str]]]:
        """1-based line -> [(tag, reason), ...]."""
        if self._annotations is None:
            out: Dict[int, List[Tuple[str, str]]] = {}
            i = 0
            while i < len(self.lines):
                m = _ANNOT_START_RE.search(self.lines[i])
                if m is None:
                    i += 1
                    continue
                tag = m.group(1)
                text = self.lines[i][m.end():]
                span = [i + 1]
                while ")" not in text and i + 1 < len(self.lines):
                    nxt = self.lines[i + 1].strip()
                    if not nxt.startswith("#"):
                        break
                    i += 1
                    span.append(i + 1)
                    text += " " + nxt.lstrip("#").strip()
                reason = text.split(")", 1)[0].strip()
                if reason:
                    for ln in span:
                        out.setdefault(ln, []).append((tag, reason))
                i += 1
            self._annotations = out
        return self._annotations

    def annotated(self, node: ast.AST, tag: str) -> bool:
        """True when ``node`` carries a ``# hvdlint: tag(reason)``
        annotation — on any line the node spans, or the line directly
        above its first line."""
        first = getattr(node, "lineno", 0)
        last = getattr(node, "end_lineno", first) or first
        for ln in range(first - 1, last + 1):
            for t, reason in self.annotations.get(ln, ()):
                if t == tag and reason:
                    return True
        return False


class Project:
    """The analyzed snapshot: parsed python files + raw doc texts.

    Tests plant violations by constructing one from in-memory strings
    (:meth:`from_strings`); the CLI and the tier-1 gate build one from
    the real tree (:meth:`from_root`)."""

    def __init__(self, files: List[SourceFile],
                 docs: Dict[str, str]):
        self.files = files
        self.docs = docs
        self._by_path = {f.relpath: f for f in files}

    def get(self, relpath: str) -> Optional[SourceFile]:
        return self._by_path.get(relpath)

    def iter_files(self, prefixes: Iterable[str] = ("",)
                   ) -> List[SourceFile]:
        pres = tuple(prefixes)
        return [f for f in self.files
                if any(f.relpath.startswith(p) for p in pres)]

    @classmethod
    def from_root(cls, root: str) -> "Project":
        files: List[SourceFile] = []
        base = os.path.join(root, PACKAGE)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(dirpath, fn)
                rel = os.path.relpath(p, root)
                with open(p, "r", encoding="utf-8",
                          errors="replace") as fh:
                    files.append(SourceFile(rel, fh.read()))
        # chip_smoke.py is part of the emitting surface (the card's
        # lane sets knobs and reads metrics there) even though it sits
        # at the top level.
        smoke = os.path.join(root, "chip_smoke.py")
        if os.path.exists(smoke):
            with open(smoke, "r", encoding="utf-8",
                      errors="replace") as fh:
                files.append(SourceFile("chip_smoke.py", fh.read()))
        docs: Dict[str, str] = {}
        docs_dir = os.path.join(root, DOCS)
        if os.path.isdir(docs_dir):
            for fn in sorted(os.listdir(docs_dir)):
                if fn.endswith(".md"):
                    with open(os.path.join(docs_dir, fn), "r",
                              encoding="utf-8", errors="replace") as fh:
                        docs[DOCS + "/" + fn] = fh.read()
        readme = os.path.join(root, "README.md")
        if os.path.exists(readme):
            with open(readme, "r", encoding="utf-8",
                      errors="replace") as fh:
                docs["README.md"] = fh.read()
        return cls(files, docs)

    @classmethod
    def from_strings(cls, sources: Dict[str, str],
                     docs: Optional[Dict[str, str]] = None
                     ) -> "Project":
        return cls([SourceFile(p, t) for p, t in sources.items()],
                   dict(docs or {}))


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------

def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def ancestors(node: ast.AST,
              parents: Dict[ast.AST, ast.AST]) -> List[ast.AST]:
    out = []
    cur = parents.get(node)
    while cur is not None:
        out.append(cur)
        cur = parents.get(cur)
    return out


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def const_bytes(node: ast.AST) -> Optional[bytes]:
    if isinstance(node, ast.Constant) and isinstance(node.value, bytes):
        return node.value
    return None


def call_attr_name(call: ast.Call) -> Optional[str]:
    """``x.y(...)`` -> ``y``; ``f(...)`` -> ``f``."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def import_aliases(tree: ast.AST, module_tail: str) -> List[str]:
    """Local names a module is bound to, for ``import x.y as z`` /
    ``from . import y as z`` forms whose imported module's last path
    component is ``module_tail``."""
    names: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == module_tail:
                    names.append(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[-1] == module_tail:
                    names.append(alias.asname or alias.name)
    return names


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------

def load_baseline(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("grandfathered", []))


def save_baseline(path: str, keys: List[str]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"grandfathered": sorted(set(keys))}, fh, indent=2)
        fh.write("\n")


@dataclasses.dataclass
class GateResult:
    new: List[Violation]
    grandfathered: List[Violation]
    stale: List[str]

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale


def apply_baseline(violations: List[Violation],
                   baseline: List[str]) -> GateResult:
    base = set(baseline)
    seen = {v.key for v in violations}
    new = [v for v in violations if v.key not in base]
    old = [v for v in violations if v.key in base]
    stale = sorted(base - seen)
    return GateResult(new=new, grandfathered=old, stale=stale)
