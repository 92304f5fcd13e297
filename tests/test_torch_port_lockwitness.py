"""The port's runtime lock-order witness
(horovod_tpu_torch/common/lockwitness.py), held to the JAX package's 14
cases (tests/test_lockwitness.py) on this Python.

The port walks each stack from an explicit frame; the JAX module's
``traceback.walk_stack(None)`` starts several frames above its caller on
Python 3.12, so there it wraps the wrong locks and names the wrong
creation site.  The last case shows the difference.
"""

import os
import sys
import threading

import pytest

from horovod_tpu_torch.common import lockwitness as lw

# This file is the "package" under witness for the unit tests: the
# factory wraps locks whose creating frame's filename contains the
# filter, which for these tests is this very file.
_FILTER = os.path.basename(__file__)


@pytest.fixture
def witness():
    lw.reset()
    lw.enable(package_filter=_FILTER)
    yield lw
    lw.disable()
    lw.reset()


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()


def test_abba_inversion_is_caught_without_deadlock(witness):
    a = threading.Lock()
    b = threading.Lock()
    assert type(a).__name__ == "_WitnessLock"

    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    # Sequential threads: no schedule ever blocks, yet both orders
    # were observed — the hazard exists on SOME interleaving.
    _run(order_ab)
    _run(order_ba)
    found = witness.cycles()
    assert len(found) == 1, found
    report = witness.render_cycle(found[0])
    assert a.site in report and b.site in report
    assert "thread" in report and "witnessed:" in report
    with pytest.raises(AssertionError, match="lock-order cycle"):
        witness.assert_no_cycles()


def test_consistent_order_across_threads_is_clean(witness):
    a = threading.Lock()
    b = threading.Lock()

    def order_ab():
        with a:
            with b:
                pass

    _run(order_ab)
    _run(order_ab)
    assert witness.edge_count() == 1
    assert witness.cycles() == []
    witness.assert_no_cycles()


def test_single_thread_inversion_not_reported(witness):
    """One thread taking A->B then B->A (after releasing) cannot
    deadlock itself; the MIN_THREADS policy keeps it quiet."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert witness.cycles() == []


def test_suppressed_cycle_resurfaces_when_second_thread_proves_it(witness):
    """A cycle first seen single-threaded is suppressed (cannot
    self-deadlock) — but the SAME order taken later by a second
    thread makes it a real hazard, and the warm-edge fast path must
    not swallow the re-evaluation."""
    a = threading.Lock()
    b = threading.Lock()
    # One thread takes both orders: edges exist, cycle suppressed.
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert witness.cycles() == []
    # A second thread re-takes one of the orders: now >= 2 threads
    # across the cycle's edges — it must be reported.
    def order_ab():
        with a:
            with b:
                pass
    _run(order_ab)
    assert len(witness.cycles()) == 1, witness.cycles()


def test_stale_held_state_cannot_leak_across_armed_windows(witness):
    """A release that happens while the witness is disabled skips
    bookkeeping (the one-attribute-check contract); the next armed
    window must discard that thread's stale held list instead of
    fabricating edges from a lock that is long released."""
    a = threading.Lock()
    a.acquire()
    lw.disable()           # window closes while a is held
    a.release()            # bookkeeping skipped: held list now stale
    lw.enable(package_filter=_FILTER)   # new window (gen bump)
    b = threading.Lock()
    c = threading.Lock()
    with b:
        with c:
            pass
    # Without the generation stamp this records a->b from the stale
    # held entry; with it, only b->c exists.
    assert witness.edge_count() == 1
    assert witness.cycles() == []


def test_rlock_reentrancy_no_false_edges(witness):
    r = threading.RLock()
    assert type(r).__name__ == "_WitnessRLock"
    other = threading.Lock()

    def nested():
        with r:
            with r:               # reentrant: no self-edge
                with other:
                    pass
            with other:           # same order again
                pass

    _run(nested)
    assert witness.cycles() == []
    assert witness.edge_count() == 1   # r -> other, once


def test_out_of_order_release_keeps_graph_sane(witness):
    a = threading.Lock()
    b = threading.Lock()

    def hand_over_hand():
        a.acquire()
        b.acquire()
        a.release()               # release A while B still held
        b.release()

    _run(hand_over_hand)
    _run(hand_over_hand)
    assert witness.cycles() == []


def test_condition_over_witnessed_rlock_works(witness):
    """A witnessed RLock handed to threading.Condition must behave:
    the wrapper forwards _is_owned/_release_save/_acquire_restore, so
    wait()/notify() work even with reentrant acquisition (the
    ElasticDriver pattern: Condition(threading.RLock()))."""
    r = threading.RLock()
    assert type(r).__name__ == "_WitnessRLock"
    cond = threading.Condition(r)
    fired = []

    def waiter():
        with cond:
            with cond:               # reentrant hold while waiting
                while not fired:
                    assert cond.wait(timeout=5.0) or fired
        fired.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    for _ in range(100):
        with cond:
            if t.is_alive():
                fired.append(True)
                cond.notify_all()
                break
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert "woke" in fired
    witness.assert_no_cycles()


def test_graph_survives_lock_gc_without_phantom_cycles(witness):
    """id()-keyed graph nodes must pin their wrappers: after a lock
    is dropped and its address reused, a new lock must not inherit
    the dead lock's edges (phantom-cycle regression)."""
    import gc
    base = threading.Lock()
    for _ in range(50):
        tmp = threading.Lock()

        def order(a, b):
            with a:
                with b:
                    pass
        _run(lambda: order(base, tmp))
        del tmp
        gc.collect()
        # A fresh lock at a possibly-recycled address, acquired in
        # the OPPOSITE role: must never close a cycle with a dead
        # lock's edges.
        fresh = threading.Lock()
        _run(lambda: order(fresh, base))
        del fresh
        gc.collect()
    assert witness.cycles() == []


def test_filter_excludes_foreign_and_condition_locks(witness):
    """Locks created by frames outside the filter (here: threading.py
    internals via Condition()) stay raw — wrapping Condition's inner
    RLock would break its private-API use."""
    cond = threading.Condition()
    assert type(cond._lock).__name__ not in ("_WitnessLock",
                                             "_WitnessRLock")


def test_factory_reference_captured_while_armed_survives_disable():
    """`from threading import Lock` executed while the witness is
    patched binds the factory; after disable() that reference must
    keep producing raw locks, never raise."""
    lw.reset()
    lw.enable(package_filter=_FILTER)
    captured = threading.Lock
    lw.disable()
    raw = captured()            # must not raise, must be a real lock
    assert raw.acquire(timeout=1.0)
    raw.release()
    lw.reset()


def test_condition_wait_on_reentrant_rlock_keeps_witness_depth(witness):
    """After Condition.wait() returns on a depth-2 reentrantly-held
    RLock, the witness must still consider the lock held through the
    inner release — edges acquired in that window are real hazards."""
    r = threading.RLock()
    cond = threading.Condition(r)
    other = threading.Lock()

    def fn():
        with cond:
            with cond:                      # depth 2
                cond.wait(timeout=0.05)     # releases ALL, reacquires
            # depth back to 1: r is STILL held here.
            with other:
                pass

    _run(fn)
    assert witness.edge_count() == 1, \
        "r->other edge lost: witness dropped r at the inner release"
    witness.assert_no_cycles()


def test_enable_disable_restore_threading(monkeypatch):
    lw.reset()
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    lw.enable(package_filter=_FILTER)
    try:
        assert threading.Lock is not orig_lock
    finally:
        lw.disable()
    assert threading.Lock is orig_lock
    assert threading.RLock is orig_rlock
    assert not lw.ENABLED
    # Env arm path (what hvd.init calls).
    monkeypatch.setenv(lw.ENV_ENABLE, "1")
    assert lw.maybe_enable_from_env()
    try:
        assert lw.ENABLED
    finally:
        lw.disable()
        lw.reset()
    monkeypatch.delenv(lw.ENV_ENABLE)
    assert not lw.maybe_enable_from_env()


def test_disabled_path_overhead_stays_one_attribute_check():
    """Perf pin (the failpoints/flight-recorder precedent): with the
    witness disarmed, a wrapped lock's acquire+release is the raw
    lock operation plus ONE module-attribute check each.  The bound
    is absolute and loose for CI noise but fails immediately if the
    disabled path grows graph work (dict/TLS access is ~10x the
    guard)."""
    import timeit

    lw.reset()
    lw.enable(package_filter=_FILTER)
    wrapped = threading.Lock()
    lw.disable()                      # wrapper survives, gate is off
    assert type(wrapped).__name__ == "_WitnessLock"
    assert not lw.ENABLED

    n = 100_000
    per_op = timeit.timeit(
        "l.acquire(); l.release()",
        globals={"l": wrapped}, number=n) / n
    assert per_op < 5e-6, \
        "disabled witness lock costs %.0f ns/acquire-release pair " \
        "(>5 us): no longer raw-lock + one attribute check" \
        % (per_op * 1e9)
    lw.reset()


def _site_here(mod):
    """(the site ``mod`` names for this caller, this call's line)."""
    return mod._creation_site(), sys._getframe().f_lineno


def test_creation_site_names_the_caller_where_the_reference_does_not():
    """Both modules asked for the site of the same caller: the port
    names this file at the calling line; on Python 3.12 the JAX module's
    walk starts above its caller and names another frame."""
    from horovod_tpu.common import lockwitness as jax_lw
    site, line = _site_here(lw)
    assert site == "%s:%d" % (__file__, line), site
    jax_site, jax_line = _site_here(jax_lw)
    assert jax_line == line
    if sys.version_info >= (3, 12):
        assert jax_site != site, jax_site
    else:
        assert jax_site == site
