"""The port's hvdlint (``horovod_tpu_torch/tools/hvdlint``): its tier-1
gate over the port's tree, and its analyzers held against the JAX
package's gate (``tools/hvdlint``).

* The gate: every check over ``horovod_tpu_torch/`` and
  ``chip_smoke.py`` against the port's catalogs
  (``horovod_tpu_torch/docs/``), clean under the committed baseline,
  which is empty, and clean without it.
* The 20 cases of ``tests/test_hvdlint.py`` with their fixtures under
  ``horovod_tpu_torch/`` paths.  Each planted fixture also runs
  through the JAX gate on the same source under ``horovod_tpu/``
  paths: both must report the same (check, path, ident, line) set once
  the prefix is mapped, and the clean twins stay silent in both.
* The CLI's exit codes, the import's isolation from JAX, and the
  catalogs' rows against the port's tree.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from horovod_tpu_torch.tools.hvdlint import (  # noqa: E402
    CHECKS, Project, apply_baseline, gate, load_baseline, run_checks)
from horovod_tpu_torch.tools.hvdlint import \
    check_registry_drift as port_drift  # noqa: E402
from tools import hvdlint as jax_hvdlint  # noqa: E402

pytestmark = pytest.mark.lint

PKG = "horovod_tpu_torch"
DOCS = PKG + "/docs"
BASELINE = os.path.join(REPO, PKG, "tools", "hvdlint", "baseline.json")
CLI = [sys.executable, "-m", PKG + ".tools.hvdlint"]


def _keys(violations):
    return {v.key for v in violations}


def _idents(violations, check=None):
    return {v.ident for v in violations
            if check is None or v.check == check}


def _to_jax(path: str) -> str:
    """A port path as the JAX gate scopes it: the port's catalogs sit
    at the root ``docs/``, its package at ``horovod_tpu/``."""
    if path.startswith(DOCS + "/"):
        return "docs/" + path[len(DOCS) + 1:]
    if path.startswith(PKG + "/"):
        return "horovod_tpu/" + path[len(PKG) + 1:]
    return path


def _findings(violations, mapped: bool = False):
    return {(v.check, _to_jax(v.path) if mapped else v.path, v.ident,
             v.line) for v in violations}


def _both(sources, docs=None, checks=None):
    """Run the port's gate on ``sources``/``docs`` (port paths) and the
    JAX gate on the same texts under the JAX paths; assert that they
    agree and return the port's violations."""
    port = run_checks(Project.from_strings(sources, docs), checks)
    jax = jax_hvdlint.run_checks(jax_hvdlint.Project.from_strings(
        {_to_jax(p): t for p, t in sources.items()},
        {_to_jax(p): t for p, t in (docs or {}).items()}), checks)
    assert _findings(port, mapped=True) == _findings(jax)
    return port


# ---------------------------------------------------------------------------
# THE gate: the port's tree, judged against its committed baseline
# ---------------------------------------------------------------------------

def test_tree_is_clean_under_baseline():
    project = Project.from_root(REPO)
    for f in project.files:
        assert f.parse_error is None, (f.relpath, f.parse_error)
    baseline = load_baseline(BASELINE)
    assert baseline == [], \
        "the port's baseline must stay empty: %r" % baseline
    result = gate(project, baseline)
    msg = "\n".join(v.render() for v in result.new)
    assert not result.new, "new hvdlint violations:\n" + msg
    assert not result.stale, \
        "stale baseline entries (violation fixed — delete them): %r" \
        % result.stale


def test_tree_reports_nothing_without_baseline():
    violations = run_checks(Project.from_root(REPO))
    assert violations == [], "\n".join(v.render() for v in violations)


def test_project_scope_is_the_port():
    """The port's snapshot holds the port's package (its tools,
    examples and alias included) and chip_smoke.py, and reads the
    port's catalogs and the README: nothing of the JAX package, the
    root tools or the root docs."""
    project = Project.from_root(REPO)
    paths = {f.relpath for f in project.files}
    assert "chip_smoke.py" in paths
    for want in (PKG + "/common/env.py", PKG + "/tools/chaos_soak.py",
                 PKG + "/_alias/__init__.py",
                 PKG + "/examples/pytorch/pytorch_mnist.py"):
        assert want in paths, want
    assert all(p == "chip_smoke.py" or p.startswith(PKG + "/")
               for p in paths), sorted(
        p for p in paths if not p.startswith(PKG + "/"))
    assert set(project.docs) == {DOCS + "/env_knobs.md",
                                 DOCS + "/fault_injection.md",
                                 DOCS + "/observability.md", "README.md"}


# ---------------------------------------------------------------------------
# the CLI's exit codes
# ---------------------------------------------------------------------------

def _copy_port_tree(dst):
    """The files the gate reads: the package's sources and catalogs,
    chip_smoke.py and the README."""
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns(
                        "__pycache__", "build", "*.so", "*.cu", "*.cc"))
    for name in ("chip_smoke.py", "README.md"):
        shutil.copy(os.path.join(REPO, name), os.path.join(dst, name))


def _plant_bounded_wait(root):
    pkg = root / PKG / "common"
    pkg.mkdir(parents=True)
    (pkg / "controller_net.py").write_text(
        "def f(sock):\n    sock.settimeout(None)\n")
    return ["--check", "bounded-wait", "--root", str(root),
            "--baseline", str(root / "baseline.json")], ["settimeout-none"]


def _plant_knob_read(root):
    _copy_port_tree(str(root))
    (root / PKG / "common" / "widget.py").write_text(
        "import os\nX = os.environ.get(\"HOROVOD_X\")\n")
    return ["--check", "all", "--root", str(root)], [
        "[knob-hygiene] os.environ.get read of HOROVOD_X",
        "key knob-hygiene:%s/common/widget.py:HOROVOD_X" % PKG,
        "key registry-drift:%s/common/widget.py:HOROVOD_X" % PKG]


def _head(root):
    return ["--check", "all"], ["hvdlint: clean (all checks)"]


def _head_no_baseline(root):
    return ["--check", "all", "--no-baseline"], [
        "hvdlint: 0 violation(s), baseline ignored"]


def _unknown_check(root):
    return ["--check", "nope"], ["unknown check"]


def _not_a_root(root):
    return ["--check", "all", "--root", str(root)], [
        "does not look like the repo root (no %s/)" % PKG]


@pytest.mark.parametrize("case, rc", [
    (_head, 0), (_head_no_baseline, 0), (_plant_bounded_wait, 1),
    (_plant_knob_read, 1), (_unknown_check, 2), (_not_a_root, 2)],
    ids=["head", "head_no_baseline", "planted_bounded_wait",
         "planted_knob_read_in_a_copy_of_the_port",
         "unknown_check", "not_a_root"])
def test_cli_exit_codes(tmp_path, case, rc):
    """0 clean, 1 new violations, 2 usage error — through a subprocess
    as a user runs it; the output names what it found."""
    args, says = case(tmp_path)
    proc = subprocess.run(CLI + args, cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    for text in says:
        assert text in proc.stdout + proc.stderr, \
            (text, proc.stdout + proc.stderr)


def test_import_loads_no_jax_nor_the_jax_package():
    code = ("import sys, json\n"
            "import horovod_tpu_torch.tools.hvdlint as h\n"
            "import horovod_tpu_torch.tools.hvdlint.__main__\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.splitlines()[-1])
    bad = [m for m in loaded
           if m.split(".")[0] in ("jax", "horovod_tpu", "tools", "torch",
                                  "numpy", "flax", "optax")]
    assert bad == [], bad


# ---------------------------------------------------------------------------
# the catalogs against the port's tree
# ---------------------------------------------------------------------------

def _rows(doc: str):
    """The first cell of every table row (header and rule excluded)."""
    out = []
    for line in doc.splitlines():
        if line.startswith("| `"):
            out.append(line.split("|")[1])
    return out


def _catalog(project, name):
    return project.docs[DOCS + "/" + name]


@pytest.mark.parametrize("doc, token, source_names", [
    ("env_knobs.md", port_drift._KNOB_TOKEN, port_drift._source_knobs),
    ("observability.md", port_drift._METRIC_TOKEN,
     port_drift._source_metrics),
    ("fault_injection.md", port_drift._SITE_TOKEN,
     port_drift._source_sites),
], ids=["knobs", "metrics", "failpoint_sites"])
def test_each_catalog_row_names_the_ports_tree(doc, token, source_names):
    """Every row of the port's catalog names something the port's tree
    reads, registers or evaluates, and every such name has a row in
    that catalog (not merely a mention in the README)."""
    project = Project.from_root(REPO)
    text = _catalog(project, doc)
    if doc == "fault_injection.md":
        text = port_drift._site_catalog_text(text)
    rows = [r for r in _rows(text) if token.search(r)]
    assert rows, doc
    in_source = set(source_names(project))
    named = set()
    for cell in rows:
        names = set(token.findall(cell))
        assert names and names <= in_source, (doc, cell)
        named |= names
    assert in_source <= named, sorted(in_source - named)


def test_catalogs_name_no_jax_only_knob_metric_or_site():
    """The JAX package's own catalog rows that the port's tree does not
    name (its CPU ring, TPU probe and bench lanes) stay out of the
    port's catalogs, which the root docs do not replace."""
    project = Project.from_root(REPO)
    with open(os.path.join(REPO, "docs", "env_knobs.md")) as f:
        root_knobs = set(port_drift._KNOB_TOKEN.findall(f.read()))
    with open(os.path.join(REPO, "docs", "fault_injection.md")) as f:
        root_sites = set(port_drift._SITE_TOKEN.findall(
            port_drift._site_catalog_text(f.read())))
    jax_only_knobs = root_knobs - set(port_drift._source_knobs(project))
    jax_only_sites = root_sites - set(port_drift._source_sites(project))
    assert "HOROVOD_TPU_FORCE_CPU" in jax_only_knobs
    assert {"ring.send", "ring.setup"} <= jax_only_sites
    port_text = "\n".join(project.docs[d] for d in project.docs
                          if d.startswith(DOCS + "/"))
    assert not jax_only_knobs & set(
        port_drift._KNOB_TOKEN.findall(port_text))
    assert not jax_only_sites & set(
        port_drift._SITE_TOKEN.findall(port_text))


# ---------------------------------------------------------------------------
# baseline workflow
# ---------------------------------------------------------------------------

def test_baseline_new_grandfathered_stale_partition():
    violations = _both({PKG + "/common/controller_net.py":
                        "def f(s):\n    s.settimeout(None)\n"},
                       checks=["bounded-wait"])
    assert violations, "the planted violation must be found"
    key = violations[0].key
    assert key == "bounded-wait:%s/common/controller_net.py:" \
        "settimeout-none" % PKG
    res = apply_baseline(violations, [key])
    assert res.ok and res.grandfathered and not res.new
    res = apply_baseline(violations, [])
    assert not res.ok and _keys(res.new) == {key}
    res = apply_baseline([], [key])
    assert not res.ok and res.stale == [key]


def test_annotation_grammar_multiline_and_bare():
    src = (
        "def f(s, t, u):\n"
        "    # hvdlint: bounded-by(select polls at\n"
        "    # 0.2s so this recv cannot block)\n"
        "    s.settimeout(None)\n"
        "    # hvdlint: bounded-by()\n"
        "    t.settimeout(None)\n"
        "    u.settimeout(None)  # no annotation at all\n"
    )
    violations = _both({PKG + "/common/controller_net.py": src},
                       checks=["bounded-wait"])
    assert [v.line for v in violations] == [6, 7]


# ---------------------------------------------------------------------------
# planted fixtures, one or more per check, each held against the JAX gate
# ---------------------------------------------------------------------------

_HOT_HEADER = ("# hvdlint-module: hot-path\n"
               "from . import flight_recorder as _fr\n"
               "from . import failpoints as _fp\n"
               "from . import metrics\n")

_HOT_GUARDED = _HOT_HEADER + (
    "_C = metrics.counter('hvd_ok_total', 'module scope')\n"
    "def handle(frame):\n"
    "    if _fr.ENABLED:\n"
    "        _fr.record('frame_rx', peer=1)\n"
    "    if _fp.ENABLED and _fp.maybe_fail('site.x') == 'drop':\n"
    "        return\n"
)

_CONTROLLER = (
    "_MAGIC_REQ = b'RQ'\n"
    "_MAGIC_HB = b'HB'\n"
    "_MAGIC_METRICS_REQ = b'MQ'\n"
    "_MAGIC_METRICS_REP = b'MR'\n"
    "_MAGIC_ROGUE = b'ZZ'\n"
    "_OOS_DOWN = (_MAGIC_HB,)\n"          # wrong: MQ missing
    "_OOS_UP = (_MAGIC_HB, _MAGIC_METRICS_REP)\n"
    "def send(sock):\n"
    "    _send_frame(sock, _MAGIC_ROGUE, b'')\n"
    "def recv(magic):\n"
    "    if magic == _MAGIC_REQ:\n"
    "        return True\n"
    "    if magic in _OOS_UP:\n"
    "        return True\n"
)

_RELAY = (
    "MAGIC_METRICS_AGG = b'MA'\n"
    "def on_frame(magic):\n"
    "    if magic == b'HB':\n"
    "        return True\n"
    "    if magic == b'MQ':\n"
    "        return True\n"
    "    if magic == b'MR':\n"
    "        return True\n"
    # MA deliberately NOT dispatched
)

# name -> (sources, docs, check, exact idents or None, lines or None,
#          idents that must be among the findings, idents that must not)
FIXTURES = {
    "bounded_wait_catches_each_construct": (
        {PKG + "/common/runtime.py": (
            "import queue, threading\n"
            "def f(sock, q, ev, th):\n"
            "    sock.settimeout(None)\n"
            "    sock.recv(4)\n"
            "    q.get()\n"
            "    ev.wait()\n"
            "    th.join()\n")},
        None, "bounded-wait",
        {"settimeout-none", "unbounded-recv", "unbounded-get",
         "unbounded-wait", "unbounded-join"}, [3, 4, 5, 6, 7], (), ()),
    "bounded_wait_clean_forms_do_not_fire": (
        {PKG + "/common/runtime.py": (
            "def f(sock, q, ev, th, d, parts):\n"
            "    sock.settimeout(2.0)\n"
            "    sock.recv(4)\n"
            "    q.get(timeout=1.0)\n"
            "    ev.wait(timeout=0.5)\n"
            "    ev.wait(5)\n"
            "    th.join(timeout=3.0)\n"
            "    d.get('key', 0)\n"
            "    ','.join(parts)\n")},
        None, "bounded-wait", set(), [], (), ()),
    "bounded_wait_scope_excludes_non_control_plane": (
        {PKG + "/models/mnist.py":
         "def f(sock):\n    sock.settimeout(None)\n"},
        None, "bounded-wait", set(), [], (), ()),
    "bounded_wait_scope_excludes_the_data_plane": (
        {PKG + "/ops/dist_ops.py":
         "def f(work):\n    work.wait()\n"},
        None, "bounded-wait", set(), [], (), ()),
    "knob_hygiene_flags_reads_not_writes": (
        {PKG + "/runner/launch.py": (
            "import os\n"
            "A = os.environ.get('HOROVOD_X')\n"
            "B = os.getenv('HOROVOD_Y', '1')\n"
            "C = os.environ['HOROVOD_Z']\n"
            "D = 'HOROVOD_W' in os.environ\n"
            "os.environ['HOROVOD_OK'] = '1'\n"
            "E = dict(os.environ)\n"
            "os.environ.update({'HOROVOD_OK': '2'})\n"
            "os.environ.pop('HOROVOD_OK', None)\n")},
        None, "knob-hygiene",
        {"HOROVOD_X", "HOROVOD_Y", "HOROVOD_Z", "HOROVOD_W"},
        [2, 3, 4, 5], (), ()),
    "knob_hygiene_covers_the_ports_tools": (
        {PKG + "/tools/flame.py":
         "import os\nS = os.environ.get('HOROVOD_SECRET_KEY', '')\n"},
        None, "knob-hygiene", {"HOROVOD_SECRET_KEY"}, [2], (), ()),
    "knob_hygiene_env_py_exempt": (
        {PKG + "/common/env.py":
         "import os\nA = os.environ.get('HOROVOD_X')\n"},
        None, "knob-hygiene", set(), [], (), ()),
    "knob_hygiene_annotation_exempt": (
        {PKG + "/runner/launch.py": (
            "import os\n"
            "A = os.environ.get('HOROVOD_X')  "
            "# hvdlint: env-ok(bootstrap before env.py exists)\n")},
        None, "knob-hygiene", set(), [], (), ()),
    "hot_path_gate_catches_unguarded_instrumentation": (
        {PKG + "/common/runtime.py": _HOT_HEADER + (
            "def handle(frame):\n"
            "    _fr.record('frame_rx', peer=1)\n"
            "    if _fp.maybe_fail('site.x') == 'drop':\n"
            "        return\n"
            "    c = metrics.counter('hvd_oops_total', 'registered hot')\n")},
        None, "hot-path-gate",
        {"unguarded-record", "unguarded-maybe-fail",
         "metric-registration-in-function"}, None, (), ()),
    "hot_path_gate_else_branch_is_not_guarded": (
        {PKG + "/common/runtime.py": _HOT_HEADER + (
            "def handle(frame):\n"
            "    if _fr.ENABLED:\n"
            "        pass\n"
            "    else:\n"
            "        _fr.record('frame_rx')\n"
            "    ok = _fp.maybe_fail('s.x') == 'drop' and _fp.ENABLED\n")},
        None, "hot-path-gate",
        {"unguarded-record", "unguarded-maybe-fail"}, [9, 10], (), ()),
    "hot_path_gate_polices_straggler_note_sites": (
        {PKG + "/common/runtime.py": _HOT_HEADER + (
            "from . import straggler as _sg\n"
            "def handle(col, sg, dt):\n"
            "    col.note_latency(dt)\n"
            "    if _sg.ENABLED:\n"
            "        col.note_exec(dt)\n"
            "    if sg is not None:\n"
            "        sg.note_arrival('k', 1, dt)\n"
            "    self_like = sg\n"
            "    if sg is not None and dt > 0:\n"
            "        self_like.note_complete('k')\n"
            "    # hvdlint: hot-ok(cold path, loop exists iff scorer does)\n"
            "    sg.note_worker_phases({})\n"
            "class R:\n"
            "    def on_broken(self):\n"
            "        self.note_disruption('broken')\n")},
        None, "hot-path-gate", {"unguarded-note"}, [7], (), ()),
    "hot_path_gate_guarded_clean": (
        {PKG + "/common/runtime.py": _HOT_GUARDED},
        None, "hot-path-gate", set(), [], (), ()),
    "hot_path_gate_unmarked_clean": (
        {PKG + "/common/runtime.py":
         _HOT_GUARDED.replace("# hvdlint-module: hot-path\n", "")
         + "def cold():\n    _fr.record('x')\n"},
        None, "hot-path-gate", set(), [], (), ()),
    "registry_drift_metrics_both_directions": (
        {PKG + "/common/widget.py": (
            "from . import metrics\n"
            "_C = metrics.counter('hvd_planted_total', 'undocumented')\n")},
        {DOCS + "/observability.md":
         "documents `hvd_ghost_total` which nobody registers"},
        "registry-drift", None, None,
        ("hvd_planted_total", "hvd_ghost_total"), ()),
    "registry_drift_failpoint_sites_and_env_knobs": (
        {PKG + "/common/widget.py": (
            "from . import failpoints as _fp\n"
            "import os\n"
            "def f():\n"
            "    if _fp.ENABLED:\n"
            "        _fp.maybe_fail('planted.site')\n"
            "    return os.environ.get('HOROVOD_PLANTED_KNOB')\n")},
        {DOCS + "/fault_injection.md":
         "## Site catalog\n\n| `ghost.site` | gone | - |\n\n## Next\n",
         DOCS + "/env_knobs.md": "| `HOROVOD_GHOST_KNOB` | gone |\n"},
        "registry-drift", None, None,
        ("planted.site", "ghost.site", "HOROVOD_PLANTED_KNOB",
         "HOROVOD_GHOST_KNOB"), ()),
    "registry_drift_chip_smoke_knob_needs_a_row": (
        {"chip_smoke.py": "ENV = {'HOROVOD_SMOKE_ONLY': '1'}\n"},
        {DOCS + "/env_knobs.md": "| `HOROVOD_OTHER` | gone |\n"},
        "registry-drift", {"HOROVOD_SMOKE_ONLY", "HOROVOD_OTHER"},
        None, (), ()),
    "frame_parity_unhandled_kind_and_oos_tables": (
        {PKG + "/common/controller_net.py": _CONTROLLER,
         PKG + "/common/relay.py": _RELAY},
        None, "frame-parity", None, None,
        ("unhandled-kind-ZZ", "oos-table-_OOS_DOWN", "oos-relay-MA"),
        ("oos-table-_OOS_UP",)),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_planted_fixture_matches_the_jax_gate(name):
    """Each fixture finds exactly what its JAX twin in
    ``tests/test_hvdlint.py`` finds, at the same lines, and both
    gates agree on it."""
    sources, docs, check, exact, lines, among, absent = FIXTURES[name]
    violations = _both(sources, docs, [check])
    idents = _idents(violations)
    assert all(v.check == check for v in violations)
    if exact is not None:
        assert idents == exact, idents
    if lines is not None:
        assert sorted(v.line for v in violations) == lines
    for ident in among:
        assert ident in idents, (ident, idents)
    for ident in absent:
        assert ident not in idents, (ident, idents)
    for v in violations:
        assert v.path in set(sources) | set(docs or {}), v.path


def test_registry_drift_names_the_port_paths():
    """The port's findings point at the port's files and catalogs."""
    sources, docs = FIXTURES["registry_drift_metrics_both_directions"][:2]
    by_ident = {v.ident: v for v in _both(sources, docs,
                                          ["registry-drift"])}
    assert by_ident["hvd_planted_total"].path == PKG + "/common/widget.py"
    assert by_ident["hvd_ghost_total"].path == DOCS + "/observability.md"


def test_every_check_is_exercised_by_a_fixture():
    assert set(CHECKS) == set(jax_hvdlint.CHECKS) == {
        "bounded-wait", "knob-hygiene", "hot-path-gate",
        "registry-drift", "frame-parity"}
    assert {f[2] for f in FIXTURES.values()} == set(CHECKS)


def test_baseline_file_is_valid_json_with_known_shape():
    with open(BASELINE) as fh:
        data = json.load(fh)
    assert data == {"grandfathered": []}


def test_analyzers_are_the_jax_gates_with_the_scope_changed():
    """Each analyzer's functions are the JAX gate's, body for body
    (docstrings aside): only the module-level scope constants differ."""
    def functions(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        out = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                body = node.body
                if isinstance(body[0], ast.Expr) and \
                        isinstance(body[0].value, ast.Constant):
                    body = body[1:]
                out[node.name] = [ast.dump(b) for b in body]
        return out

    here = os.path.join(REPO, PKG, "tools", "hvdlint")
    there = os.path.join(REPO, "tools", "hvdlint")
    checks = sorted(n for n in os.listdir(there) if n.startswith("check_"))
    assert checks == sorted(n for n in os.listdir(here)
                            if n.startswith("check_"))
    for name in checks:
        assert functions(os.path.join(here, name)) == \
            functions(os.path.join(there, name)), name
