"""Process-tree-safe command execution for the launcher.

The analog of the reference's ``safe_shell_exec`` (reference:
runner/common/util/safe_shell_exec.py:33-170): worker commands are
spawned in their own session (``setsid``) so the whole descendant tree
can be terminated together — on an event (elastic reset, another worker
failing) or on driver exit.  Uses ``psutil`` for recursive child
termination instead of a middleman process; without ``psutil`` it
signals the child's process group.

Counterpart of :mod:`horovod_tpu.runner.safe_shell_exec`, copied, except
for three things a preempted worker's final checkpoint commit needs:
``execute`` takes a grace per event and waits for a terminating watcher
up to it (the reference returns one second after the shell exits, while
the workers under it may still be finishing), and without ``psutil``
``terminate_process_tree`` waits for the process group up to the grace
before it kills what is left (the reference signals it and returns).
And with ``psutil`` it leaves the process it was given for that
process's parent to reap: the JAX package's copy waits on it through
``psutil.wait_procs``, which reaps a child of the caller, and
``Popen.wait`` then records exit code 0 for a killed rank.
"""

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import IO, Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch.exec")

GRACEFUL_TERMINATION_TIME_S = 5
# The grace a preempted worker gets: install_preemption_hook's default
# grace (checkpoint/preemption.py DEFAULT_GRACE_S, 20 s) and the 5 s its
# bounded join allows past it, with a margin.
PREEMPTION_TERMINATION_TIME_S = 30


def _terminate_process_group(pid: int, grace_s: float):
    try:
        pgid = os.getpgid(pid)
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            os.killpg(pgid, 0)
        except (ProcessLookupError, PermissionError):
            return
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def terminate_process_tree(pid: int,
                           grace_s: float = GRACEFUL_TERMINATION_TIME_S):
    """SIGTERM the process and all descendants, wait up to ``grace_s``
    for them, then SIGKILL leftovers."""
    try:
        import psutil
    except ImportError:
        _terminate_process_group(pid, grace_s)
        return
    try:
        root = psutil.Process(pid)
    except psutil.NoSuchProcess:
        return
    children = root.children(recursive=True)
    for p in [root] + children:
        try:
            p.terminate()
        except psutil.NoSuchProcess:
            pass
    deadline = time.monotonic() + grace_s
    # Only the descendants are waited on by psutil, which reaps what is
    # a child of this process: the root is left for its parent (the
    # ``Popen`` in ``execute``) to reap, so that its exit code is kept.
    _, alive = psutil.wait_procs(children, timeout=grace_s)
    while _running(root) and time.monotonic() < deadline:
        time.sleep(0.05)
    if _running(root):
        alive.append(root)
    for p in alive:
        try:
            p.kill()
        except psutil.NoSuchProcess:
            pass


def _running(proc) -> bool:
    """Whether ``proc`` (a ``psutil.Process``) has not exited: a zombie
    has, and waits only for its parent to reap it."""
    import psutil
    try:
        return proc.status() != psutil.STATUS_ZOMBIE
    except psutil.NoSuchProcess:
        return False


def _forward_stream(stream: IO[bytes], sinks: List[IO], prefix: str = ""):
    """Pump a child stream line-by-line into sinks (driver stdout and/or
    a per-rank capture file), optionally rank-prefixed (reference
    behavior: gloo_run.py:150-163 per-rank capture)."""
    for raw in iter(stream.readline, b""):
        line = raw.decode("utf-8", errors="replace")
        for sink in sinks:
            try:
                sink.write(prefix + line if prefix else line)
                sink.flush()
            except ValueError:   # sink closed
                pass
    stream.close()


def execute(command: str,
            env: Optional[dict] = None,
            stdout: Optional[IO] = None,
            stderr: Optional[IO] = None,
            index: Optional[int] = None,
            events: Optional[List[threading.Event]] = None,
            prefix_output_with_timestamp: bool = False,
            stdin_data: Optional[bytes] = None,
            event_grace_s: Optional[Dict[threading.Event, float]] = None
            ) -> int:
    """Run ``command`` through a shell in a new session; stream output;
    kill the whole tree if any event fires, after the grace
    ``event_grace_s`` gives that event (``GRACEFUL_TERMINATION_TIME_S``
    by default).  Returns the exit code.  ``stdin_data`` is written to
    the child's stdin and the pipe closed (used to hand secrets to
    remote shells without touching argv)."""
    proc = subprocess.Popen(
        command, shell=True, env=env,
        stdin=subprocess.PIPE if stdin_data is not None else None,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    if stdin_data is not None:
        try:
            proc.stdin.write(stdin_data)
            proc.stdin.close()
        except BrokenPipeError:
            pass

    prefix = ""
    if index is not None:
        prefix = f"[{index}]<stdout>:"
    out_sinks = [sys.stdout] + ([stdout] if stdout else [])
    err_sinks = [sys.stderr] + ([stderr] if stderr else [])
    threads = [
        threading.Thread(target=_forward_stream,
                         args=(proc.stdout, out_sinks, prefix),
                         daemon=True),
        threading.Thread(
            target=_forward_stream,
            args=(proc.stderr, err_sinks,
                  f"[{index}]<stderr>:" if index is not None else ""),
            daemon=True),
    ]
    for t in threads:
        t.start()

    stop_watch = threading.Event()
    graces = {ev: (event_grace_s or {}).get(ev, GRACEFUL_TERMINATION_TIME_S)
              for ev in (events or [])}

    def _watch_events():
        while not stop_watch.is_set():
            for ev, grace_s in graces.items():
                if ev.is_set():
                    logger.debug("terminating pid %d on event", proc.pid)
                    terminate_process_tree(proc.pid, grace_s=grace_s)
                    return
            time.sleep(0.1)

    watcher = None
    if events:
        watcher = threading.Thread(target=_watch_events, daemon=True)
        watcher.start()

    try:
        proc.wait()
    finally:
        stop_watch.set()
        if watcher is not None:
            # A watcher that is terminating the tree waits up to the
            # grace for the command's descendants: the command's shell
            # may die at once while the worker under it still finishes
            # (a final checkpoint commit under SIGTERM).
            watcher.join(timeout=max(graces.values()) + 1.0)
        for t in threads:
            t.join(timeout=5.0)
        # Reap any stragglers the command left behind.
        terminate_process_tree(proc.pid, grace_s=0.5)
    return proc.returncode
