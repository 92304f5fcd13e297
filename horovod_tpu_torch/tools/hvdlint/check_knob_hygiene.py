"""knob-hygiene: configuration is parsed in ``common/env.py``, nowhere
else.

The START_TIMEOUT lesson, generalized: when each call site re-reads an
environment variable with its own default, the defaults drift apart
and a knob silently means different things in different subsystems
(PR 6 found four competing start-timeout parses).  The contract since:
``horovod_tpu_torch/common/env.py`` is the single parse point — everything
else goes through its accessors (``env_bool`` / ``env_int`` /
``env_float`` / ``env_str`` / ``env_require`` / ``env_set`` / ...).

Flagged (everywhere under ``horovod_tpu_torch/`` except
``common/env.py``):

* ``os.getenv(...)``,
* ``os.environ.get(...)``,
* ``os.environ[...]`` *reads* (Load context),
* ``"X" in os.environ`` membership tests.

Deliberately allowed (not knob parses):

* whole-environment passthrough — ``dict(os.environ)``,
  ``os.environ.copy()/items()/keys()/values()``;
* *writes* — ``os.environ[k] = v``, ``del os.environ[k]``,
  ``os.environ.update/pop/setdefault`` (the launcher→worker contract
  is installed by writing the environment).

Suppression: ``# hvdlint: env-ok(<reason>)`` for the rare read that
is genuinely not a knob (e.g. bootstrap before the package exists).
"""

import ast
from typing import List, Optional

from .core import Project, SourceFile, Violation

CHECK = "knob-hygiene"
TAG = "env-ok"

SCOPE = ("horovod_tpu_torch/",)
EXEMPT = ("horovod_tpu_torch/common/env.py",)

_ALLOWED_METHODS = ("update", "pop", "setdefault", "copy", "items",
                    "keys", "values")


def _is_os_environ(node) -> bool:
    return isinstance(node, ast.Attribute) and \
        node.attr == "environ" and \
        isinstance(node.value, ast.Name) and node.value.id == "os"


def _knob_ident(arg) -> str:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.Attribute):
        return arg.attr
    if isinstance(arg, ast.Name):
        return arg.id
    return "dynamic"


def _check_file(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    if src.tree is None:
        return out

    def flag(node, ident: str, what: str):
        if not src.annotated(node, TAG):
            out.append(Violation(
                CHECK, src.relpath, node.lineno, ident,
                "%s of %s outside common/env.py — route through an "
                "env.py accessor" % (what, ident)))

    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            # os.getenv(...)
            if isinstance(fn, ast.Attribute) and fn.attr == "getenv" \
                    and isinstance(fn.value, ast.Name) and \
                    fn.value.id == "os":
                ident = _knob_ident(node.args[0]) if node.args \
                    else "dynamic"
                flag(node, ident, "os.getenv read")
            # os.environ.get(...)
            elif isinstance(fn, ast.Attribute) and \
                    _is_os_environ(fn.value):
                if fn.attr == "get":
                    ident = _knob_ident(node.args[0]) if node.args \
                        else "dynamic"
                    flag(node, ident, "os.environ.get read")
                elif fn.attr not in _ALLOWED_METHODS:
                    flag(node, fn.attr,
                         "os.environ.%s call" % fn.attr)
        elif isinstance(node, ast.Subscript) and \
                _is_os_environ(node.value) and \
                isinstance(node.ctx, ast.Load):
            flag(node, _knob_ident(node.slice),
                 "os.environ[...] read")
        elif isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)) and \
                        _is_os_environ(comp):
                    flag(node, _knob_ident(node.left),
                         "`in os.environ` test")
    return out


def run(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.iter_files(SCOPE):
        if src.relpath in EXEMPT:
            continue
        out.extend(_check_file(src))
    return out
