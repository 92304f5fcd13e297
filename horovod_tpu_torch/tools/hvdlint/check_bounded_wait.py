"""bounded-wait: no control-plane wait may be unbounded.

The invariant behind the PR 6 liveness work: every blocking primitive
in the control plane carries a deadline — a wedged peer, a half-open
socket or a lost wakeup must surface as a timeout, never as a thread
parked forever.  The historical holes this mechanizes: the
``settimeout(None)`` recv hole (a worker blocked forever on a wedged
coordinator), and the recv-timed replay reset that wedged one rank in
replay while its peer negotiated.

Flagged constructs (control-plane modules only):

* ``sock.settimeout(None)`` — an explicitly unbounded socket;
* ``.recv(...)`` / ``.recv_into(...)`` / ``.accept()`` in a function
  with no prior non-None ``settimeout(...)`` call;
* ``.get()`` with no arguments (a blocking ``Queue.get``; dict lookups
  always pass a key, so the zero-arg form is queue-like);
* ``.wait()`` with no timeout (``Event``/``Condition``);
* ``.join()`` with no arguments (``Thread.join``; ``str.join`` always
  takes an iterable, so the zero-arg form is thread-like).

Suppression: ``# hvdlint: bounded-by(<reason>)`` naming the deadline
that covers the site (a selector poll period, a caller-armed poll
timeout, a documented legacy opt-out).
"""

import ast
from typing import List

from .core import Project, SourceFile, Violation, parent_map

CHECK = "bounded-wait"
TAG = "bounded-by"

# The control plane: the modules where an unbounded wait is a wedged
# world, not a latent bug.
SCOPE = (
    "horovod_tpu_torch/common/controller_net.py",
    "horovod_tpu_torch/common/relay.py",
    "horovod_tpu_torch/common/runtime.py",
    "horovod_tpu_torch/runner/elastic/",
    "horovod_tpu_torch/checkpoint/coordinator.py",
)

_RECV_ATTRS = ("recv", "recv_into", "accept")


def _is_none(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _timeout_kw(call: ast.Call):
    for kw in call.keywords:
        if kw.arg == "timeout":
            return kw
    return None


def _check_file(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    if src.tree is None:
        return out
    parents = parent_map(src.tree)

    def enclosing_function(node):
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = parents.get(cur)
        return None

    # Per-function positions of non-None settimeout calls: a recv /
    # accept is bounded when one precedes it in the same function.
    bounded_after = {}
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "settimeout" and node.args and \
                not _is_none(node.args[0]):
            fn = enclosing_function(node)
            lines = bounded_after.setdefault(fn, [])
            lines.append(node.lineno)

    def flag(node, ident, message):
        if not src.annotated(node, TAG):
            out.append(Violation(CHECK, src.relpath, node.lineno,
                                 ident, message))

    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        fn_attr = node.func.attr \
            if isinstance(node.func, ast.Attribute) else None
        if fn_attr == "settimeout" and node.args and \
                _is_none(node.args[0]):
            flag(node, "settimeout-none",
                 "settimeout(None): unbounded socket — name the "
                 "covering deadline with "
                 "`# hvdlint: bounded-by(...)` or arm a poll timeout")
        elif fn_attr in _RECV_ATTRS:
            fn = enclosing_function(node)
            prior = [ln for ln in bounded_after.get(fn, [])
                     if ln <= node.lineno]
            if not prior:
                flag(node, "unbounded-" + fn_attr,
                     ".%s() with no prior settimeout in this "
                     "function: the wait has no deadline" % fn_attr)
        elif fn_attr == "get" and not node.args and not node.keywords:
            flag(node, "unbounded-get",
                 "zero-argument .get(): a blocking Queue.get with no "
                 "timeout")
        elif fn_attr == "wait":
            kw = _timeout_kw(node)
            if (not node.args and kw is None) or \
                    (kw is not None and _is_none(kw.value)):
                flag(node, "unbounded-wait",
                     ".wait() with no timeout: the waiter has no "
                     "deadline")
        elif fn_attr == "join" and not node.args and \
                _timeout_kw(node) is None:
            flag(node, "unbounded-join",
                 ".join() with no timeout: a wedged thread parks the "
                 "joiner forever")
    return out


def run(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.iter_files(SCOPE):
        out.extend(_check_file(src))
    return out
