"""The port's chaos drills (``horovod_tpu_torch/tools/chaos_soak.py``)
beside the JAX package's (``tools/chaos_soak.py``) on the CPU: the
closed forms, and the checkpoint, delta-chain, MTTR, relay, straggler,
tune and autoscale drills with the JAX tier-1 tests' arguments
(tests/test_durable_checkpoint.py, test_delta_checkpoint.py,
test_liveness.py, test_relay_tree.py, test_straggler.py, test_tune.py,
test_autoscale_drill.py, test_flight_recorder.py).

Each drill asserts the JAX test's gates; the checkpoint and autoscale
drills also run in the JAX package on the same seed, and their
deterministic fields must be equal.  Timing fields are held only to the
JAX tests' bounds.  The harness, the soak and the replay-kill and serve
drills are in test_torch_port_chaos.py.
"""

import functools
import importlib.util
import os
import threading
import time
import warnings

import numpy as np
import pytest

from horovod_tpu_torch.common import flight_recorder as fr
from horovod_tpu_torch.common import lockwitness
from horovod_tpu_torch.common import metrics as hm
from horovod_tpu_torch.tools import blackbox_merge
from horovod_tpu_torch.tools import chaos_soak as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's ``tools/chaos_soak.py`` under a name of its own
    (other test files import it by its plain name)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_chaos_soak_drills", os.path.join(REPO, "tools",
                                                    "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def lock_witness():
    """The port's lock-order witness armed around a test, which fails on
    any recorded cycle."""
    lockwitness.reset()
    lockwitness.enable(package_filter="horovod_tpu_torch")
    try:
        yield lockwitness
        lockwitness.assert_no_cycles()
    finally:
        lockwitness.disable()
        lockwitness.reset()


# ---------------------------------------------------------------------------
# closed forms, at the drills' shapes
# ---------------------------------------------------------------------------

def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_checkpoint_closed_forms_equal_reference():
    jcs = _jax()
    for step in range(40):
        _same(cs._drill_grad(1, step, (257,)),
              jcs._drill_grad(1, step, (257,)))
        _same(cs._drill_params_at(step, (257,)),
              jcs._drill_params_at(step, (257,)))
        assert cs._delta_touched_rows(step) == \
            jcs._delta_touched_rows(step)
        for row in range(cs._DELTA_ROWS):
            _same(cs._delta_update(step, row), jcs._delta_update(step, row))
        _same(cs._delta_table_at(step), jcs._delta_table_at(step))
    assert (cs._DELTA_ROWS, cs._DELTA_DIM, cs._DELTA_PREFIX) == \
        (jcs._DELTA_ROWS, jcs._DELTA_DIM, jcs._DELTA_PREFIX)


@pytest.mark.parametrize("ranks", [4, 8, 16])
def test_mttr_and_autoscale_closed_forms_equal_reference(ranks):
    jcs = _jax()
    shape = (193,)
    for step in range(30):
        for rank in range(ranks):
            _same(cs._mttr_grad(rank, step, shape),
                  jcs._mttr_grad(rank, step, shape))
        assert cs._mttr_step_total(step, ranks) == \
            jcs._mttr_step_total(step, ranks)
        _same(cs._mttr_params_at(step, ranks, shape),
              jcs._mttr_params_at(step, ranks, shape))
        rows = 3 * 2 * ranks
        for row in range(rows):
            _same(cs._asz_row_at(step, row, rows),
                  jcs._asz_row_at(step, row, rows))
        for boundary in (0, 4, 11):
            _same(cs._asz_params_at(step, boundary, ranks, 2 * ranks,
                                    shape),
                  jcs._asz_params_at(step, boundary, ranks, 2 * ranks,
                                     shape))


# ---------------------------------------------------------------------------
# checkpoint kill-and-resume (tests/test_durable_checkpoint.py,
# tests/test_delta_checkpoint.py)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("mode", ["mid_epoch", "mid_write"])
def test_checkpoint_drill_kill_and_resume(mode, tmp_path):
    kw = dict(ranks=4, seed=13, steps=8, commit_every=2,
              commit_timeout_s=0.75)
    rec = cs.run_checkpoint_drill(mode, ckpt_dir=str(tmp_path / mode),
                                  device=CPU, **kw)
    assert rec["ok"], rec
    assert rec["bit_identical"]
    assert rec["torn_checkpoints"] == []
    assert rec["step_loss"] <= rec["step_loss_bound"]
    assert rec["restored_step"] == rec["committed_before_kill"]
    theirs = _jax().run_checkpoint_drill(
        mode, ckpt_dir=str(tmp_path / (mode + "-jax")), **kw)
    assert theirs["ok"], theirs
    for key in ("victim", "kill_step", "died_at_step", "restored_step",
                "step_loss"):
        assert rec[key] == theirs[key], key
    assert {s: [r["triggers"] for r in rules]
            for s, rules in rec["failpoint_triggers"].items()} == \
        {s: [r["triggers"] for r in rules]
         for s, rules in theirs["failpoint_triggers"].items()}
    assert sorted(rec) == sorted(theirs)


@pytest.mark.chaos
def test_delta_chain_drill_kill_mid_delta_write(tmp_path):
    kw = dict(ranks=4, seed=13, steps=12, commit_every=3)
    rec = cs.run_checkpoint_drill("mid_delta", ckpt_dir=str(tmp_path / "a"),
                                  device=CPU, **kw)
    assert rec["ok"], rec
    assert rec["bit_identical"]
    assert rec["tip_is_delta"], "drill degenerated to an all-base run"
    assert rec["torn_checkpoints"] == []
    assert rec["restored_step"] == rec["committed_before_kill"]
    theirs = _jax().run_checkpoint_drill(
        "mid_delta", ckpt_dir=str(tmp_path / "b"), **kw)
    assert theirs["ok"], theirs
    for key in ("victim", "kill_commit", "died_at_step", "restored_step",
                "restored_chain", "step_loss"):
        assert rec[key] == theirs[key], key
    assert sorted(rec) == sorted(theirs)


# ---------------------------------------------------------------------------
# MTTR (tests/test_liveness.py)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_mttr_smoke_kill_8_ranks():
    rec = cs.run_mttr_drill(fault="kill", when="idle", ranks=8, seed=7,
                            device=CPU)
    assert rec["ok"], rec
    assert rec["detect_s"] < 4.0, rec["detect_s"]
    assert rec["bit_identical"]
    assert rec["mttr_s"] is not None and rec["mttr_s"] < 15.0
    assert rec["replay_reengaged"]
    pm = rec["postmortem"]
    assert pm["ok"], pm
    assert pm["failed_rank"] == rec["victim"]
    assert pm["spans_sum_matches_mttr"]
    assert abs(pm["spans"]["total"] - rec["mttr_s"]) \
        <= 0.10 * rec["mttr_s"]


@pytest.mark.chaos
def test_mttr_smoke_wedge_8_ranks():
    rec = cs.run_mttr_drill(fault="wedge", when="idle", ranks=8, seed=9,
                            device=CPU)
    assert rec["ok"], rec
    assert rec["detect_s"] < 4.0, rec["detect_s"]
    assert rec["bit_identical"]
    assert rec["replay_reengaged"]


def test_transient_drop_resumes_same_world():
    rec = cs.run_mttr_drill(fault="conn_drop", when="idle", ranks=4,
                            seed=3, device=CPU)
    assert rec["ok"], rec
    assert rec["fatal_events"] == []
    assert rec["reconnects_resumed"] >= 1
    assert rec["params_bit_identical"]
    assert not rec["errors"] and not rec["results_bad"]


# ---------------------------------------------------------------------------
# relay tree (tests/test_relay_tree.py)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_relay_failover_smoke_8_ranks():
    t0 = time.monotonic()
    rec = cs.run_relay_drill(fault="kill", when="negotiation", ranks=8,
                             fanout=2, seed=3, device=CPU)
    assert rec["ok"], {k: rec.get(k) for k in
                       ("hangs", "errors", "results_bad",
                        "fatal_events", "rehomed", "rehome_s")}
    assert rec["fatal_events"] == []
    assert rec["rehomed"] >= len(rec["subtree"])
    assert rec["rehome_s"] <= rec["rehome_bound_s"]
    pm = rec["postmortem"]
    assert pm["ok"], pm
    assert pm["failed_relay"] == rec["victim_relay"]
    assert pm["trace_errors"] == []
    assert pm["dumps"] >= 8
    assert time.monotonic() - t0 < 12.0


@pytest.mark.chaos
def test_relay_wedge_transparent_8_ranks():
    rec = cs.run_relay_drill(fault="wedge", when="idle", ranks=8,
                             fanout=2, seed=5, device=CPU)
    assert rec["ok"], {k: rec.get(k) for k in
                       ("hangs", "errors", "results_bad",
                        "fatal_events", "rehomed", "rehome_s")}
    assert rec["fatal_events"] == []


@pytest.mark.chaos
def test_straggler_attribution_rides_ma_aggregation():
    agg = hm.REGISTRY.counter("hvd_relay_agg_metrics_total")
    agg0 = agg.value()
    rec = cs.run_straggler_drill(mode="replay", ranks=8, victim=5,
                                 delay_ms=25.0, seed=2, fanout=2,
                                 device=CPU)
    assert rec["ok"], {k: rec.get(k) for k in
                       ("named", "tta_s", "victim_score", "replay",
                        "scores", "hangs", "errors")}
    assert agg.value() > agg0


def test_negotiation_scale_probe_shape_and_fanout_bound():
    """The protocol-only probe (no runtimes, no data plane): the root
    sends once per link, and the tree bounds its links to O(fanout)."""
    tree = cs.run_negotiation_scale_probe(16, 4, rounds=3)
    flat = cs.run_negotiation_scale_probe(16, 0, rounds=3)
    assert flat["root_sends_per_round"] == 16
    assert tree["root_sends_per_round"] == \
        tree["topology"]["root_links"]
    assert tree["root_sends_per_round"] < flat["root_sends_per_round"]
    assert tree["wall_ms"]["median"] > 0
    assert tree["root_broadcast_ms"] >= 0
    theirs = _jax().run_negotiation_scale_probe(16, 4, rounds=3)
    assert tree["topology"] == theirs["topology"]
    assert tree["root_sends_per_round"] == theirs["root_sends_per_round"]
    assert sorted(tree) == sorted(theirs)


@pytest.mark.parametrize("value,ranks", [
    (None, 64), ("12", 12), ("", ValueError), ("6x4", ValueError)])
def test_relay_scale_ranks_knob_parses_as_the_jax_tool(monkeypatch, value,
                                                       ranks):
    """``--relay-scale`` reads HOROVOD_CHAOS_SCALE_RANKS as the JAX tool
    does: 64 when unset, and an empty or malformed value raises instead
    of running the default probe."""
    if value is None:
        monkeypatch.delenv("HOROVOD_CHAOS_SCALE_RANKS", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_CHAOS_SCALE_RANKS", value)
    for mod, argv in ((cs, ["--relay-scale", "--device", CPU]),
                      (_jax(), ["--relay-scale"])):
        seen = []
        monkeypatch.setattr(mod, "run_relay_drill",
                            lambda **kw: seen.append(kw["ranks"])
                            or {"ok": True})
        if ranks is ValueError:
            with pytest.raises(ValueError):
                mod.main(argv)
            assert seen == []
        else:
            assert mod.main(argv) == 0
            assert seen == [ranks]


# ---------------------------------------------------------------------------
# straggler attribution (tests/test_straggler.py)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_negotiation_mode_names_the_failpoint_delayed_rank():
    rec = cs.run_straggler_drill(mode="negotiation", ranks=8, victim=3,
                                 delay_ms=25.0, seed=0, serve_status=True,
                                 device=CPU)
    assert rec["ok"], {k: rec.get(k) for k in
                       ("named", "named_by_lag_source", "tta_s",
                        "victim_score", "scores",
                        "hangs", "errors", "hvdtop_rc")}
    assert rec["named_by_lag_source"]
    assert rec["tta_s"] < 10.0
    assert rec["hvdtop_rc"] == 0
    ranks = rec["status"]["cluster"]["ranks"]
    assert ranks["3"]["slow"] and ranks["3"]["state"] == "alive"
    assert any("SLOW" in line for line in rec["hvdtop_lines"])
    if rec["root_cause"] is not None:
        assert rec["root_cause_named"], rec.get("root_cause")
        assert rec["ttrc_s"] is not None and rec["ttrc_s"] < 20.0
    else:
        warnings.warn("straggler drill: root-cause digest did not "
                      "land before the drill deadline (advisory in "
                      "tier-1; strict in the slow matrix)")
    assert any("profile digest" in line for line in rec["hvdtop_lines"])


@pytest.mark.chaos
def test_replay_mode_keeps_attribution_current():
    rec = cs.run_straggler_drill(mode="replay", ranks=8, victim=3,
                                 delay_ms=25.0, seed=1, device=CPU)
    assert rec["ok"], {k: rec.get(k) for k in
                       ("named", "tta_s", "victim_score", "replay",
                        "hangs", "errors")}
    rp = rec["replay"]
    assert rp["engaged"]
    assert rp["cycles_replayed_at_named"] > 0
    assert rp["cycles_replayed_after"] > rp["cycles_replayed_at_named"]
    assert all(rp["active_at_end"])
    assert rec["tta_s"] < 10.0


# ---------------------------------------------------------------------------
# tune abort (tests/test_tune.py)
# ---------------------------------------------------------------------------

def test_tune_kill_drill_aborts_cleanly_with_postmortem():
    drill = cs.run_tune_kill_drill(mode="kill", ranks=4, seed=0,
                                   device=CPU)
    assert drill["ok"], drill
    assert drill["phase"] == "aborted"
    assert drill["abort_reason"] == "rank_lost"
    assert drill["knobs_consistent"], \
        "half-applied knob split across survivors"
    assert "aborted" in drill["tune_phases_recorded"]
    assert drill["postmortem"]["failed_rank"] == drill["victim"]


def test_tune_failpoint_drill_aborts_to_defaults():
    drill = cs.run_tune_kill_drill(mode="failpoint", ranks=4, seed=1,
                                   device=CPU)
    assert drill["ok"], drill
    assert drill["abort_reason"] == "failpoint"
    assert not drill["hangs"] and not drill["incorrect"]


# ---------------------------------------------------------------------------
# autoscale (tests/test_autoscale_drill.py)
# ---------------------------------------------------------------------------

def _explain(rec):
    return {k: v for k, v in rec.items()
            if k != "postmortem" and (v is False or "loss" in k)}


@pytest.mark.chaos
def test_autoscale_drill_smoke(lock_witness):
    kw = dict(ranks=4, grow_to=8, seed=0, steps_per_phase=6,
              policy_window=2, policy_cooldown_s=1.0,
              migrate_after_s=0.15, post_steps=6)
    rec = cs.run_autoscale_drill(device=CPU, **kw)
    assert rec["ok"], _explain(rec)
    assert rec["bit_identical_a"] and rec["bit_identical_b"]
    assert rec["rows_identical_a"] and rec["rows_identical_b"]
    assert rec["step_loss_a"] <= rec["commit_every"]
    assert rec["step_loss_b"] <= rec["commit_every"]
    assert rec["migrate_rank"] == rec["victim"]
    assert rec["cooldown_respected"]
    assert rec["replay_reengaged_grow"] and rec["replay_reengaged_shrink"]
    assert rec["postmortem"]["named_resize_triggers"]
    theirs = _jax().run_autoscale_drill(**kw)
    assert theirs["ok"], _explain(theirs)
    assert rec["victim"] == theirs["victim"]
    assert rec["migrate_rank"] == theirs["migrate_rank"]
    assert rec["postmortem"]["resize_triggers"] == \
        theirs["postmortem"]["resize_triggers"]
    assert sorted(rec) == sorted(theirs)


# ---------------------------------------------------------------------------
# flight recorder (tests/test_flight_recorder.py)
# ---------------------------------------------------------------------------

def test_promotion_dump_trigger_via_real_kill(tmp_path):
    """A lost-rank promotion on the port's coordinator dumps the black
    box: a two-rank world over the real control plane, rank 1 killed,
    grace expiry promotes, and the dump carries the promote event and
    the frame history before it."""
    fr.configure(directory=str(tmp_path), capacity=4096, enabled=True)
    world = None
    try:
        world = cs.ChaosWorld(2, stall_shutdown_s=4.0,
                              liveness_interval_s=0.3,
                              reconnect_grace_s=0.6, device=CPU)
        t1 = threading.Thread(
            target=world.collective,
            args=(1, "allreduce", "bb.t", np.ones(8, np.float32), 0,
                  10.0), daemon=True)
        t1.start()
        world.collective(0, "allreduce", "bb.t",
                         np.ones(8, np.float32), 0, 10.0)
        t1.join(timeout=10.0)
        world.kill_rank(1)
        deadline = time.monotonic() + 10.0
        files = []
        while time.monotonic() < deadline and not files:
            files = [f for f in os.listdir(str(tmp_path))
                     if "promotion" in f or "fatal" in f]
            time.sleep(0.05)
        assert files, "no dump after a rank promotion"
        dumps = blackbox_merge.load_dumps(str(tmp_path))
        all_events = [e for d in dumps for e in d["events"]]
        assert any(e["kind"] == "promote" and e.get("peer") == 1
                   for e in all_events), \
            "promote event missing from the dumps"
        assert any(e["kind"] == "frame_rx" for e in all_events), \
            "no frame history in the dumps"
    finally:
        if world is not None:
            world.close()
        fr.reset()


# ---------------------------------------------------------------------------
# slow mirrors of the JAX suite's matrices
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.slow
def test_mttr_matrix_full():
    report = cs.run_mttr_matrix(ranks=8, seed=13, device=CPU)
    assert report["ok"], [
        {k: c.get(k) for k in ("fault", "when", "ok", "errors",
                               "results_bad")}
        for c in report["cells"] if not c.get("ok")]
    assert len(report["cells"]) == 9
    assert report["mttr_s"]["p50"] is not None
    assert report["detect_s"]["p90"] is not None


@pytest.mark.chaos
@pytest.mark.slow
def test_relay_matrix_full_8_ranks():
    report = cs.run_relay_matrix(ranks=8, fanout=2, seed=13, device=CPU)
    assert report["ok"], [
        {k: c.get(k) for k in ("kind", "fault", "when", "ok",
                               "victim_kind", "errors")}
        for c in report["cells"] if not c.get("ok")]
    assert len(report["cells"]) == 18


@pytest.mark.chaos
@pytest.mark.slow
def test_relay_kill_drill_64_ranks():
    rec = cs.run_relay_drill(fault="kill", when="negotiation", ranks=64,
                             fanout=8, seed=0, device=CPU)
    assert rec["ok"], {k: rec.get(k) for k in
                       ("hangs", "errors", "results_bad",
                        "fatal_events", "rehomed", "rehome_s",
                        "rehome_bound_s")}
    assert rec["rehomed"] >= len(rec["subtree"]) == 8
    assert rec["rehome_s"] <= rec["rehome_bound_s"]


@pytest.mark.slow
def test_scale_lane_sublinear_to_256():
    out = cs.run_scale_lane(sizes=(8, 64, 256), fanout=8, rounds=5)
    assert out["sublinear"], out
    tree_sends, flat_sends = out["root_sends_tree_vs_flat_at_max"]
    assert tree_sends < flat_sends / 8


@pytest.mark.chaos
@pytest.mark.slow
def test_straggler_matrix_slow():
    for mode in ("negotiation", "replay"):
        for fanout in (0, 2):
            for victim in (1, 6):
                rec = cs.run_straggler_drill(
                    mode=mode, ranks=8, victim=victim, delay_ms=25.0,
                    seed=victim, fanout=fanout, device=CPU)
                assert rec["ok"], (mode, fanout, victim, rec)
                assert rec["root_cause_named"], \
                    (mode, fanout, victim, rec.get("root_cause"))
                assert rec["ttrc_s"] is not None and \
                    rec["ttrc_s"] < 20.0, (mode, fanout, victim, rec)


@pytest.mark.chaos
@pytest.mark.slow
def test_autoscale_matrix_full(lock_witness):
    report = cs.run_autoscale_matrix(ranks=8, grow_to=16, seed=0,
                                     device=CPU)
    assert report["ok"], {
        name: _explain(rec)
        for name, rec in report["cells"].items() if not rec["ok"]}
