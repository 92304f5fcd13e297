"""The port's autotuner held against the JAX package's: ``common/optim``
(GP, Bayesian optimization), ``common/parameter_manager``, ``tune/``
(search strategies, the profile artifact, the tuning session) and their
wiring into ``common/env`` and ``controller_net``.

The same seeded numpy inputs and the same streams of round observations
go through both packages, and the results must be equal, not close: GP
posteriors, BO proposals, search trajectories, session announcements and
frozen profiles.  A profile written by either package loads in the other
and prints with ``tools/tune_report.py``.  The multi-process cases start
port workers through the port's launcher on gloo: ``HOROVOD_TUNE=1``
freezes and then replays wire-free with the parameters of an untuned
run, a profile reload skips the search, and ``HOROVOD_AUTOTUNE=1``
converges.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu.common import env as jenv
from horovod_tpu.common import parameter_manager as jpm
from horovod_tpu.common.optim import bayesian_optimization as jbo
from horovod_tpu.common.optim import gaussian_process as jgp
from horovod_tpu.tune import profile as jprof
from horovod_tpu.tune import search as jsearch
from horovod_tpu.tune import session as jsess

from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.common import failpoints as pfp
from horovod_tpu_torch.common import metrics as pmetrics
from horovod_tpu_torch.common import parameter_manager as ppm
from horovod_tpu_torch.common.optim import bayesian_optimization as pbo
from horovod_tpu_torch.common.optim import gaussian_process as pgp
from horovod_tpu_torch.tune import profile as pprof
from horovod_tpu_torch.tune import search as psearch
from horovod_tpu_torch.tune import session as psess

from test_torch_port_multiproc import launcher_env, run_port_launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 1024 * 1024

JAX = {"gp": jgp, "bo": jbo, "pm": jpm, "search": jsearch,
       "profile": jprof, "session": jsess, "env": jenv}
PORT = {"gp": pgp, "bo": pbo, "pm": ppm, "search": psearch,
        "profile": pprof, "session": psess, "env": penv}


# ---------------------------------------------------------------------------
# GP and Bayesian optimization: identical posteriors and proposals
# ---------------------------------------------------------------------------

def _gp_posterior(pkg, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(6, 2)
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    gp = pkg["gp"].GaussianProcessRegressor(alpha=1e-6,
                                            length_scale=0.4)
    prior = gp.predict(rng.rand(3, 2))
    gp.fit(x, y)
    return prior, gp.predict(rng.rand(9, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_posterior_equals_jax(seed):
    (jp_m, jp_s), (j_m, j_s) = _gp_posterior(JAX, seed)
    (pp_m, pp_s), (p_m, p_s) = _gp_posterior(PORT, seed)
    for a, b in ((jp_m, pp_m), (jp_s, pp_s), (j_m, p_m), (j_s, p_s)):
        assert np.array_equal(a, b)


def test_gp_interpolates_observations():
    x = np.array([[0.0], [0.5], [1.0]])
    y = np.array([0.0, 1.0, 0.0])
    gp = pgp.GaussianProcessRegressor(alpha=1e-10, length_scale=0.3)
    gp.fit(x, y)
    mean, std = gp.predict(x)
    np.testing.assert_allclose(mean, y, atol=1e-4)
    assert (std < 0.05).all()
    _, far_std = gp.predict(np.array([[3.0]]))
    assert far_std[0] > 0.3


def _bo_run(pkg, seed, noise, optimum):
    bo = pkg["bo"].BayesianOptimization(bounds=[(1.0, 128.0)],
                                        gp_noise=noise, seed=seed)
    x = np.array([64.0])
    seen = []
    for _ in range(10):
        bo.add_sample(x, float(-(x[0] - optimum) ** 2))
        x = bo.next_sample()
        seen.append(x.copy())
    best_x, best_y = bo.best
    return seen, best_x, best_y


@pytest.mark.parametrize("seed,noise,optimum", [(5, 0.2, 20.0),
                                                (11, 0.1, 24.0),
                                                (6, 0.8, 90.0)])
def test_bo_proposals_equal_jax(seed, noise, optimum):
    j_seen, j_x, j_y = _bo_run(JAX, seed, noise, optimum)
    p_seen, p_x, p_y = _bo_run(PORT, seed, noise, optimum)
    assert all(np.array_equal(a, b) for a, b in zip(j_seen, p_seen))
    assert np.array_equal(j_x, p_x) and j_y == p_y
    assert all(1.0 <= v[0] <= 128.0 for v in p_seen)


def test_bo_proposal_concentrates_near_optimum():
    bo = pbo.BayesianOptimization(bounds=[(0.0, 1.0)], gp_noise=0.05,
                                  seed=1)
    x = np.array([0.05])
    for _ in range(25):
        bo.add_sample(x, float(-((x[0] - 0.7) ** 2) * 10.0))
        x = bo.next_sample()
    best_x, _ = bo.best
    assert abs(best_x[0] - 0.7) < 0.15


# ---------------------------------------------------------------------------
# the legacy parameter manager (HOROVOD_AUTOTUNE)
# ---------------------------------------------------------------------------

def _pm_run(pkg, monkeypatch, categorical):
    t = [0.0]
    monkeypatch.setattr(pkg["pm"].time, "monotonic", lambda: t[0])
    pm = pkg["pm"].ParameterManager(
        warmup_samples=1, steps_per_sample=1, bayes_opt_max_samples=10,
        gp_noise=0.2, initial_fusion_bytes=16 * MB,
        tune_categorical=categorical)
    trace = []
    while pm.active and len(trace) < 60:
        fusion_mb = pm.fusion_threshold_bytes / MB
        t[0] += 1.0
        pm.record_step(int(1e9 - 1e6 * (fusion_mb - 40.0) ** 2))
        trace.append((fusion_mb, dict(pm.categorical_params),
                      pm.params_version))
    return trace, pm.fusion_threshold_bytes, pm.active


@pytest.mark.parametrize("categorical", [False, True])
def test_parameter_manager_equals_jax_under_fixed_clock(monkeypatch,
                                                        categorical):
    j = _pm_run(JAX, monkeypatch, categorical)
    p = _pm_run(PORT, monkeypatch, categorical)
    assert j == p
    assert not p[2], "the manager must converge"


def test_parameter_manager_adopts_best(tmp_path):
    log = tmp_path / "autotune.csv"
    pm = ppm.ParameterManager(warmup_samples=1, steps_per_sample=1,
                              bayes_opt_max_samples=12, gp_noise=0.1,
                              initial_fusion_bytes=4 * MB,
                              initial_cycle_ms=5.0, log_path=str(log))

    def score(fusion_mb):
        return 1e9 * np.exp(-((fusion_mb - 64) / 50) ** 2)

    for _ in range(40):
        if not pm.active:
            break
        s = score(pm.fusion_threshold_bytes / MB)
        pm._steps = pm._steps_per_sample - 1
        pm._bytes = int(s)
        pm._window_start -= 1.0
        pm.record_step(0)
    assert not pm.active
    assert score(pm.fusion_threshold_bytes / MB) > score(4)
    text = log.read_text()
    assert text.startswith("sample,fusion_mb")
    assert len(text.strip().splitlines()) >= 5


def test_parameter_manager_converges_on_convex_objective():
    pm = ppm.ParameterManager(warmup_samples=2, steps_per_sample=1,
                              bayes_opt_max_samples=15, gp_noise=0.1,
                              initial_fusion_bytes=2 * MB,
                              tune_categorical=False)

    def convex(fusion_mb):
        return 1e9 - 1e6 * (fusion_mb - 48.0) ** 2

    windows = 0
    while pm.active and windows < 80:
        pm._steps = pm._steps_per_sample - 1
        pm._bytes = int(convex(pm.fusion_threshold_bytes / MB))
        pm._window_start -= 1.0
        pm.record_step(0)
        windows += 1
    assert not pm.active
    assert windows == 2 + 15
    assert convex(pm.fusion_threshold_bytes / MB) > convex(2.0)
    assert pm.params_version >= 1


def test_explicit_settings_pin_categorical_dimensions():
    pm = ppm.ParameterManager(warmup_samples=0, steps_per_sample=1,
                              bayes_opt_max_samples=4,
                              fixed_hierarchical=True, fixed_cache=None)
    assert all(combo[0] is True for combo in pm._combos)
    pm2 = ppm.ParameterManager(warmup_samples=0, steps_per_sample=1,
                               bayes_opt_max_samples=4, fixed_cache=False)
    assert all(combo[1] is False for combo in pm2._combos)


# ---------------------------------------------------------------------------
# search strategies: identical trajectories
# ---------------------------------------------------------------------------

def _space(pkg):
    spec = pkg["search"].KnobSpec
    return {
        "fusion_mb": spec(default=64.0,
                          candidates=(2.0, 8.0, 32.0, 64.0, 128.0),
                          bounds=(1.0, 128.0), gp_samples=6),
        "coalesce": spec(default=True, candidates=(True, False)),
    }


def _objective(kind):
    if kind == "peak":
        return lambda v: -((v["fusion_mb"] - 24.0) ** 2) + \
            (3.0 if v["coalesce"] else 0.0)
    if kind == "flat":
        return lambda v: 1.0
    rng = np.random.RandomState(3)
    noise = rng.rand(400)
    it = iter(range(400))
    return lambda v: float(noise[next(it)] * v["fusion_mb"])


def _drive(strategy, objective, limit=200):
    steps = []
    while not strategy.converged and len(steps) < limit:
        v = strategy.current
        steps.append(dict(v))
        strategy.advance(objective(v))
    return steps, dict(strategy.best), strategy.best_score, \
        strategy.samples


@pytest.mark.parametrize("name", ["grid", "gp"])
@pytest.mark.parametrize("kind", ["peak", "flat", "noisy"])
def test_search_trajectory_equals_jax(name, kind):
    runs = []
    for pkg in (JAX, PORT):
        s = pkg["search"].make_strategy(name, _space(pkg), seed=7,
                                        gp_noise=0.8)
        runs.append(_drive(s, _objective(kind)))
    assert runs[0] == runs[1]
    if kind == "flat":
        assert runs[1][1] == {"fusion_mb": 64.0, "coalesce": True}
    for v in runs[1][0]:
        assert 1.0 <= v["fusion_mb"] <= 128.0


def test_grid_finish_mid_sweep_adopts_best_so_far():
    s = psearch.CoordinateSearch(_space(PORT))
    s.advance(1.0)
    s.advance(9.0)
    s.finish()
    assert s.converged
    assert s.best["fusion_mb"] == 2.0
    assert s.best["coalesce"] is True


# ---------------------------------------------------------------------------
# the profile artifact: one format for both packages
# ---------------------------------------------------------------------------

def _profile(pkg, fusion=32.0, cycle=1.0, score=1e6):
    return pkg["profile"].TunedProfile(
        world_size=4, strategy="grid", frozen_at_unix=1000.0,
        classes={"dense": {"knobs": {"fusion_mb": fusion},
                           "score_bytes_per_s": score,
                           "samples": 5, "rounds": 10}},
        worker={"cycle_time_ms": cycle, "coalesce": True,
                "replay_warmup": 3})


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX),
                                           (PORT, PORT)],
                         ids=["jax-to-port", "port-to-jax", "port"])
def test_profile_loads_in_either_package(tmp_path, writer, reader):
    path = str(tmp_path / "p.json")
    writer["profile"].save_profile(_profile(writer, 16.0, 2.5), path)
    p = reader["profile"].load_profile(path)
    assert p.to_dict() == _profile(reader, 16.0, 2.5).to_dict()
    assert p.fusion_bytes_for("dense") == 16 * MB
    assert p.fusion_bytes_for("sparse") is None


def test_profile_files_are_byte_equal(tmp_path):
    a, b = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jprof.save_profile(_profile(JAX), a)
    pprof.save_profile(_profile(PORT), b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_profile_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write('{"not": "a profile"}')
    with pytest.raises(ValueError):
        pprof.load_profile(path)
    assert pprof.try_load_profile(path) is None
    assert pprof.try_load_profile(str(tmp_path / "missing.json")) is None
    assert pprof.try_load_profile(None) is None


def test_profile_diff_equals_jax():
    d = pprof.diff_profiles(_profile(PORT, 32.0, 1.0, 1e6),
                            _profile(PORT, 64.0, 2.0, 2e6))
    assert d == jprof.diff_profiles(_profile(JAX, 32.0, 1.0, 1e6),
                                    _profile(JAX, 64.0, 2.0, 2e6))
    assert d["classes"]["dense"]["knob_deltas"]["fusion_mb"] == \
        (32.0, 64.0)
    assert d["classes"]["dense"]["score_delta_pct"] == \
        pytest.approx(100.0)


def test_knobs_adopt_profile(tmp_path, monkeypatch):
    path = str(tmp_path / "p.json")
    jprof.save_profile(_profile(JAX, fusion=16.0, cycle=2.5), path)
    monkeypatch.setenv("HOROVOD_TUNE", "1")
    monkeypatch.setenv("HOROVOD_TUNE_PROFILE", path)
    knobs = penv.Knobs.from_env()
    assert knobs.tune_profile_loaded
    assert knobs.fusion_threshold_bytes == 16 * MB
    assert knobs.cycle_time_ms == 2.5
    assert knobs.tune_profile_obj.to_dict() == \
        jenv.Knobs.from_env().tune_profile_obj.to_dict()
    # Missing/corrupt profile: tune from scratch (not an error).
    monkeypatch.setenv("HOROVOD_TUNE_PROFILE",
                       str(tmp_path / "absent.json"))
    assert not penv.Knobs.from_env().tune_profile_loaded


def _run_cli(*argv):
    """The JAX package's ``tools/tune_report.py``, then the port's
    ``horovod_tpu_torch.tools.tune_report``, on the same arguments: the
    two must print the same and exit alike; returns the first's run."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "tune_report.py"),
         *argv], capture_output=True, text=True, timeout=60)
    port = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.tune_report", *argv],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert (port.returncode, port.stdout) == (r.returncode, r.stdout)
    return r


def test_tune_report_prints_the_port_profile(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    pprof.save_profile(_profile(PORT, 32.0, 1.0, 1e6), a)
    pprof.save_profile(_profile(PORT, 64.0, 2.0, 2e6), b)
    r = _run_cli(a)
    assert r.returncode == 0, r.stderr
    assert "fusion_mb=32.0" in r.stdout and "dense" in r.stdout
    r = _run_cli("--diff", a, b)
    assert r.returncode == 0, r.stderr
    assert "32.0 -> 64.0" in r.stdout and "+100.0%" in r.stdout
    r = _run_cli("--json", a)
    assert json.loads(r.stdout)["kind"] == "horovod_tpu_tuned_profile"


# ---------------------------------------------------------------------------
# the tuning session: identical lifecycles for one round stream
# ---------------------------------------------------------------------------

class _Clock:
    """A monotonic clock that moves 1 ms per read."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 1e-3
        return self.t


def _session(pkg, monkeypatch, **kw):
    monkeypatch.setattr(pkg["session"], "time", _Clock())
    knobs = pkg["env"].Knobs(tune=True)
    kw.setdefault("strategy", "grid")
    kw.setdefault("cycles_per_sample", 2)
    kw.setdefault("warmup_windows", 1)
    kw.setdefault("max_samples", 50)
    return pkg["session"].TuningSession(knobs, world_size=4, **kw)


def _rounds(kind):
    """A stream of (nbytes, sparse) round observations, from a seed."""
    rng = np.random.RandomState({"dense": 1, "mixed": 2,
                                 "stale": 3}[kind])
    out = []
    for i in range(3000):
        sparse = kind == "mixed" and i % 2 == 1 or \
            kind == "stale" and i < 3
        out.append((int(rng.randint(1, 1 << 20)), sparse))
    return out


def _life(pkg, monkeypatch, kind, strategy, tmp_path):
    path = str(tmp_path / ("%s-%s-%s.json" % (
        kind, strategy, "jax" if pkg is JAX else "port")))
    s = _session(pkg, monkeypatch, strategy=strategy, profile_path=path)
    announcements, thresholds = [s.take_announcement()], []
    for nbytes, sparse in _rounds(kind):
        if not s.active:
            break
        thresholds.append(s.fusion_threshold_for(sparse))
        s.observe_round(nbytes, sparse)
        a = s.take_announcement()
        if a is not None:
            announcements.append(a)
    prof = pkg["profile"].load_profile(path).to_dict()
    prof.pop("frozen_at_unix")
    return announcements, thresholds, s.status(), prof


@pytest.mark.parametrize("strategy", ["grid", "gp"])
@pytest.mark.parametrize("kind", ["dense", "mixed", "stale"])
def test_session_lifecycle_equals_jax(monkeypatch, tmp_path, kind,
                                      strategy):
    j = _life(JAX, monkeypatch, kind, strategy, tmp_path)
    p = _life(PORT, monkeypatch, kind, strategy, tmp_path)
    assert j[:2] == p[:2]
    assert {k: v for k, v in j[2].items() if k != "profile_path"} == \
        {k: v for k, v in p[2].items() if k != "profile_path"}
    assert j[3] == p[3]
    announcements, _, status, prof = p
    assert announcements[0]["tuning_active"] is True
    assert announcements[-1]["tuning_active"] is False
    assert status["phase"] == "frozen"
    want = {"dense": {"dense"}, "mixed": {"dense", "sparse"},
            "stale": {"dense", "sparse"}}[kind]
    assert set(prof["classes"]) == want


def test_session_max_samples_force_converges(monkeypatch):
    s = _session(PORT, monkeypatch, max_samples=3)
    n = 0
    while s.active and n < 1000:
        s.observe_round(1024, sparse=False)
        n += 1
    assert s.phase == "frozen"
    assert s.status()["classes"]["dense"]["samples"] <= 3


def test_session_abort_reverts_to_defaults(monkeypatch):
    s = _session(PORT, monkeypatch)
    s.take_announcement()
    for _ in range(20):
        s.observe_round(1024, sparse=False)
    s.abort("rank_lost")
    assert (s.phase, s.abort_reason) == ("aborted", "rank_lost")
    ann = s.take_announcement()
    assert ann["tuning_active"] is False
    assert ann["tune_phase"] == "aborted"
    assert (ann["cycle_time_ms"], ann["coalesce"],
            ann["replay_warmup"]) == (1.0, True, 3)
    assert s.fusion_threshold_for(False) == 64 * MB
    s.observe_round(1024, sparse=False)
    assert s.take_announcement() is None


def test_session_failpoint_aborts_to_defaults(monkeypatch):
    pfp.configure("tune.propose=error(drill,times=1)")
    try:
        s = _session(PORT, monkeypatch)
        n = 0
        while not s.finished and n < 100:
            s.observe_round(1024, sparse=False)
            n += 1
        assert (s.phase, s.abort_reason) == ("aborted", "failpoint")
        assert pmetrics.REGISTRY.counter(
            "hvd_tune_aborts_total").value(reason="failpoint") >= 1
    finally:
        pfp.reset()


@pytest.mark.parametrize("writer", [JAX, PORT], ids=["jax", "port"])
def test_session_from_profile_starts_frozen(writer):
    prof = _profile(writer, fusion=16.0, cycle=2.0)
    s = psess.TuningSession.from_profile(penv.Knobs(tune=True), 4, prof)
    assert s.phase == "frozen" and not s.active
    ann = s.take_announcement()
    assert ann["tuning_active"] is False
    assert ann["cycle_time_ms"] == 2.0
    assert s.fusion_threshold_for(False) == 16 * MB
    assert s.fusion_threshold_for(True) == 64 * MB
    ref = jsess.TuningSession.from_profile(jenv.Knobs(tune=True), 4,
                                           _profile(JAX, 16.0, 2.0))
    assert ann == ref.take_announcement()


# ---------------------------------------------------------------------------
# through the port's launcher, on gloo
# ---------------------------------------------------------------------------

# A small MLP trained from a seed, its gradients averaged across the
# ranks.  Every step checks an integer allreduce exactly; the run prints the sha256 of the
# final parameters, the step the session froze at and the uplink frames
# of a window of replayed steps.
_TRAIN = """
import hashlib, json, os, time
import numpy as np
import torch
import horovod_tpu_torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
hvd.init()
RANK, SIZE = hvd.rank(), hvd.size()
torch.manual_seed(0)
torch.set_num_threads(1)
model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                            torch.nn.Linear(32, 4))
# The seed makes the ranks' weights equal: no broadcast, whose one-off
# names would keep the replay tracker from closing its first cycle.
opt = torch.optim.SGD(model.parameters(), lr=0.1)
rng = np.random.RandomState(10 + RANK)
data = torch.from_numpy(rng.randn(STEPS, 8, 16).astype(np.float32))
rt = basics._state().runtime
rp = rt.replay
tuned = os.environ.get("HOROVOD_TUNE") == "1"
searching = tuned and not basics._state().knobs.tune_profile_loaded or \
    os.environ.get("HOROVOD_AUTOTUNE") == "1"
assert rp.stats()["tuning_hold"] == searching, "replay held iff searching"
frozen_at = None
window = None
for i in range(STEPS):
    opt.zero_grad()
    model(data[i]).square().mean().backward()
    # One synchronous allreduce per gradient: every step's responses are
    # the same, so the replay tracker sees identical cycles.  (Hooks fire
    # as the backward goes, and how their gradients fuse depends on the
    # timing.)
    for name, p in model.named_parameters():
        p.grad.copy_(hvd.allreduce(p.grad, op=hvd.Average,
                                   name="grad." + name))
    opt.step()
    a = hvd.allreduce(torch.full((257,), float(RANK + 1)), op=hvd.Sum,
                      name="e2e.a")
    assert a[0].item() == SIZE * (SIZE + 1) / 2
    st = horovod_tpu_torch.tune_status()
    if tuned and frozen_at is None and st["phase"] == "frozen":
        frozen_at = i
    if window is None and i >= STEPS - 12 and rp.stats()["active"]:
        window = (i, dict(rt.controller.stats))
frames = None
if window is not None:
    s1 = dict(rt.controller.stats)
    frames = sum(s1[k] - window[1][k] for k in ("rq_frames", "ch_frames"))
digest = hashlib.sha256()
for name, p in sorted(model.state_dict().items()):
    digest.update(p.detach().numpy().tobytes())
print("RESULT " + json.dumps({
    "rank": RANK, "sha": digest.hexdigest(), "frozen_at": frozen_at,
    "replay": rp.stats()["active"], "frames": frames,
    "window_start": window and window[0],
    "status": horovod_tpu_torch.tune_status(),
    "loaded": basics._state().knobs.tune_profile_loaded}), flush=True)
hvd.shutdown()
"""


def _launch(tmp_path, name, extra_env, steps=60):
    script = tmp_path / (name + ".py")
    script.write_text("STEPS = %d\n" % steps + _TRAIN)
    rc, out = run_port_launcher(
        ["-np", "2", "-H", "localhost:2", sys.executable, str(script)],
        launcher_env(dict({"HOROVOD_STEADY_STATE_REPLAY": "1"},
                          **extra_env)))
    assert rc == 0, out[-4000:]
    results = {}
    for line in out.splitlines():
        if "<stdout>:RESULT " in line:
            r = json.loads(line.split("<stdout>:RESULT ", 1)[1])
            results[r["rank"]] = r
    assert sorted(results) == [0, 1], out[-4000:]
    return results


@pytest.fixture(scope="module")
def untuned(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("untuned"), "untuned", {})


@pytest.mark.parametrize("strategy", ["grid", "gp"])
def test_tune_freezes_then_replays_wire_free_like_an_untuned_run(
        tmp_path, untuned, strategy):
    prof = str(tmp_path / "profile.json")
    tuned = _launch(tmp_path, "tuned", {
        "HOROVOD_TUNE": "1", "HOROVOD_TUNE_STRATEGY": strategy,
        "HOROVOD_TUNE_CYCLES_PER_SAMPLE": "2",
        "HOROVOD_TUNE_WARMUP_WINDOWS": "1",
        "HOROVOD_TUNE_MAX_SAMPLES": "8",
        "HOROVOD_TUNE_PROFILE": prof})
    for r in (0, 1):
        t = tuned[r]
        assert t["frozen_at"] is not None, t
        assert t["status"]["phase"] == "frozen", t
        assert t["replay"] and t["frames"] == 0, t
        # The tuned knobs change how gradients are fused, not the sums.
        assert t["sha"] == untuned[r]["sha"] == untuned[0]["sha"]
    p = pprof.load_profile(prof)
    assert p.strategy == strategy and p.world_size == 2
    assert "dense" in p.classes
    # The JAX package reads the port's profile.
    assert jprof.load_profile(prof).to_dict() == p.to_dict()


def test_tune_profile_reload_skips_the_search(tmp_path, untuned):
    prof = str(tmp_path / "p.json")
    jprof.save_profile(_profile(JAX, fusion=32.0, cycle=1.0), prof)
    out = _launch(tmp_path, "reload", {"HOROVOD_TUNE": "1",
                                       "HOROVOD_TUNE_PROFILE": prof})
    for r in (0, 1):
        assert out[r]["loaded"], out[r]
        assert out[r]["frozen_at"] == 0, out[r]
        assert out[r]["status"]["phase"] == "frozen"
        assert out[r]["replay"] and out[r]["frames"] == 0, out[r]
        assert out[r]["sha"] == untuned[r]["sha"]


def test_legacy_autotune_converges(tmp_path, untuned):
    log = tmp_path / "at.csv"
    out = _launch(tmp_path, "autotune", {
        "HOROVOD_AUTOTUNE": "1",
        "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "3",
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4",
        "HOROVOD_AUTOTUNE_LOG": str(log)})
    for r in (0, 1):
        assert out[r]["replay"], out[r]
        assert out[r]["sha"] == untuned[r]["sha"]
    lines = log.read_text().strip().splitlines()
    assert lines[0].startswith("sample,") and len(lines) >= 3
