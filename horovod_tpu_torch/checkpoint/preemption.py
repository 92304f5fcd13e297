"""Preemption hook: one final commit inside the SIGTERM grace window.

Preemptible hosts are stopped with a SIGTERM followed (30s-ish later) by
SIGKILL.  The hook turns that window into one last durable commit:
drain any in-flight async save, then write a final synchronous
checkpoint of the committed state.  The previous handler (or the
default die-on-TERM) runs afterwards, so process supervision behavior
is unchanged — the job still dies, it just dies with its newest state
on disk.

Counterpart of :mod:`horovod_tpu.checkpoint.preemption`, copied, with
one repair: a second signal that arrives while the final commit runs
(the launcher passes a preemption's SIGTERM on to workers that got
their own) returns at once.  The reference's handler runs again, finds
the checkpointer finalized and chains to the default action, which
kills the process in the middle of its final commit.
"""

import logging
import signal
import threading
from typing import Iterable, Optional

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

_install_lock = threading.Lock()

DEFAULT_GRACE_S = 20.0


def install_preemption_hook(checkpointer,
                            signals: Iterable[int] = (signal.SIGTERM,),
                            grace_s: float = DEFAULT_GRACE_S,
                            chain: bool = True):
    """Install signal handlers that call
    ``checkpointer.finalize(timeout=grace_s, reason="preempt")``.

    Returns the mapping of signal -> previous handler.  ``chain``
    re-invokes the previous handler (or re-raises the default action)
    after the final commit, so a launcher's own TERM semantics still
    apply.  Main-thread only (signal module requirement); callers off
    the main thread get a no-op with a warning rather than a crash —
    a worker that cannot install the hook still checkpoints on its
    normal cadence.
    """
    if threading.current_thread() is not threading.main_thread():
        logger.warning("preemption hook not installed: signal "
                       "handlers require the main thread")
        return {}
    previous = {}
    committing = threading.Event()
    with _install_lock:
        for signum in signals:
            def _handler(got_signum, frame, _prev_box=previous):
                if committing.is_set():
                    logger.warning("ckpt: signal %d received during the "
                                   "final commit; the first one's "
                                   "handler chains when it ends",
                                   got_signum)
                    return
                committing.set()
                logger.warning("ckpt: signal %d received; attempting "
                               "final commit (grace %.0fs)",
                               got_signum, grace_s)
                # finalize() runs on a helper thread with a BOUNDED
                # join: the handler interrupts the main thread at an
                # arbitrary point, possibly inside checkpointer/
                # manager critical sections — calling finalize()
                # directly would then self-deadlock on the very locks
                # the interrupted frame holds.  Off-thread, the common
                # case (signal lands in training compute) finalizes
                # normally, and the held-lock case degrades to a
                # timed-out join: the final commit is lost but the
                # chained TERM semantics still run.
                try:
                    t = threading.Thread(
                        target=checkpointer.finalize,
                        kwargs={"timeout": grace_s,
                                "reason": "preempt"},
                        name="hvd-ckpt-preempt", daemon=True)
                    t.start()
                    t.join(grace_s + 5.0)
                    if t.is_alive():
                        logger.error("ckpt: final preemption commit "
                                     "did not finish inside the grace "
                                     "window; proceeding to terminate")
                except Exception:
                    logger.exception("ckpt: final preemption commit "
                                     "failed")
                committing.clear()
                if not chain:
                    return
                prev = _prev_box.get(got_signum)
                if callable(prev):
                    prev(got_signum, frame)
                elif prev == signal.SIG_DFL:
                    # Restore and re-raise so the default action
                    # (terminate) applies with the right exit status.
                    signal.signal(got_signum, signal.SIG_DFL)
                    signal.raise_signal(got_signum)

            previous[signum] = signal.getsignal(signum)
            signal.signal(signum, _handler)
    logger.debug("preemption hook installed for signals %s",
                 list(signals))
    return previous


def uninstall(previous: Optional[dict]):
    """Restore the handlers ``install_preemption_hook`` replaced."""
    for signum, handler in (previous or {}).items():
        try:
            signal.signal(signum, handler)
        except (ValueError, TypeError):
            pass
