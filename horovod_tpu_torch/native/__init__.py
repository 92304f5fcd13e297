"""The native C++ coordinator of horovod_tpu_torch: its build and its
ctypes binding.

Counterpart of :mod:`horovod_tpu.native`, with the same API
(``ensure_built``, ``load``, ``available``, ``NativeCoordinatorServer``)
and the same C interface.  ``coordinator.cc`` is the JAX package's file,
copied whole: it speaks the wire format of ``common/message.py``, so the
port's Python workers connect to it unchanged.  The JAX package's CPU
ring data plane (``collectives.cc``) is not carried: the port's data
plane is ``torch.distributed``.

The library is built with g++ at first use (a few seconds) into
``build/`` beside the source, under a name carrying the hash of the
source and the flags, so a rebuild happens only when either changes (a
``git archive`` extraction resets mtimes, so they cannot say that).
``HOROVOD_TPU_NATIVE=0`` forces the Python coordinator; set to a true
value, a build that fails is an error at init instead of a fallback
(``common/controller_net.py``, ``_make_server``).

Imports neither torch nor JAX: the launcher's ``--check-build`` reads
``available()`` before any framework loads.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

from ..common import env as env_mod

logger = logging.getLogger("horovod_tpu_torch.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "coordinator.cc")
BUILD_DIR = os.path.join(_DIR, "build")
# No -lrt: the JAX package links librt for shm_open in collectives.cc's
# same-host shared-memory plane; coordinator.cc alone calls none of it.
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False
_build_error = ""


def _env_enabled() -> bool:
    return env_mod.env_str("HOROVOD_TPU_NATIVE", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libhvdtpu_coord-{digest.hexdigest()[:16]}.so")


def ensure_built(force: bool = False) -> bool:
    """Compile the shared library if it is not built yet; returns
    success.  On failure :func:`unavailable_reason` says why."""
    global _build_error
    if not os.path.exists(_SRC):
        _build_error = f"{_SRC} is missing"
        return False
    lib = library_path()
    if not force and os.path.exists(lib):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A temporary file per process: ranks racing on a cold tree each
    # build privately, and the atomic replace leaves a whole library
    # whichever finishes last.
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        logger.info("built native coordinator: %s", lib)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as e:
        err = (getattr(e, "stderr", None) or b"")[:500]
        _build_error = "g++ not found" if isinstance(e, FileNotFoundError) \
            else f"g++ failed: {err.decode(errors='replace') or e}"
        logger.warning("native coordinator build failed (%s); using the "
                       "Python coordinator", _build_error)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load():
    """Returns the loaded CDLL or None."""
    global _lib, _tried, _build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _env_enabled():
            _build_error = "HOROVOD_TPU_NATIVE turns it off"
            return None
        if not ensure_built():
            return None
        try:
            lib = ctypes.CDLL(library_path())
        except OSError:
            # A library built by another compiler or glibc can fail to
            # load: rebuild once before falling back to Python.
            logger.warning("could not load %s; rebuilding", library_path(),
                           exc_info=True)
            if not ensure_built(force=True):
                return None
            try:
                lib = ctypes.CDLL(library_path())
            except OSError as e:
                _build_error = f"could not load the library: {e}"
                logger.warning("could not load %s", library_path(),
                               exc_info=True)
                return None
        lib.hvd_coord_create.restype = ctypes.c_void_p
        lib.hvd_coord_create.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double]
        lib.hvd_coord_port.restype = ctypes.c_int
        lib.hvd_coord_port.argtypes = [ctypes.c_void_p]
        lib.hvd_coord_set_fusion.argtypes = [ctypes.c_void_p,
                                             ctypes.c_longlong]
        lib.hvd_coord_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.hvd_coord_cache_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.hvd_coord_drain_round_bytes.restype = ctypes.c_int
        lib.hvd_coord_drain_round_bytes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int]
        lib.hvd_coord_stall_report.restype = ctypes.c_int
        lib.hvd_coord_stall_report.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.hvd_coord_stop.argtypes = [ctypes.c_void_p]
        lib.hvd_coord_counts.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is false ('' when it is true)."""
    return "" if available() else _build_error


class NativeCoordinatorServer:
    """Drop-in replacement for controller_net.CoordinatorServer backed
    by the C++ library.  When an autotuning ParameterManager is given, a
    poll thread feeds it the coordinator's live round/byte counters and
    pushes retuned fusion thresholds back."""

    POLL_INTERVAL_S = 0.1

    def __init__(self, size: int, bind_addr: str = "0.0.0.0",
                 port: int = 0, fusion_threshold: int = 64 << 20,
                 elastic: bool = False,
                 allow_ephemeral_fallback: bool = False,
                 param_manager=None, cache_capacity: int = 1024,
                 stall_warning_time_s: float = 60.0,
                 stall_shutdown_time_s: float = 0.0):
        lib = load()
        if lib is None:
            raise RuntimeError("native coordinator unavailable")
        self._lib = lib
        self._handle = lib.hvd_coord_create(
            size, bind_addr.encode(), port, fusion_threshold,
            1 if elastic else 0, 1 if allow_ephemeral_fallback else 0,
            cache_capacity, stall_warning_time_s, stall_shutdown_time_s)
        if not self._handle:
            raise OSError(
                f"native coordinator could not bind port {port}")
        self.port = lib.hvd_coord_port(self._handle)
        self.param_manager = param_manager
        self._stop = threading.Event()
        self._poll_thread = None
        if param_manager is not None:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="hvd-native-autotune",
                daemon=True)
            self._poll_thread.start()

    def drain_round_bytes(self, cap: int = 1024):
        """All per-round fused-byte values committed since the last
        drain (single consumer: the autotune poll thread, or a test)."""
        buf = (ctypes.c_longlong * cap)()
        vals = []
        while True:
            n = self._lib.hvd_coord_drain_round_bytes(
                self._handle, buf, cap)
            vals.extend(buf[:n])
            if n < cap:
                return vals

    def _poll_loop(self):
        # Drain the coordinator's per-round byte ring so the tuner sees
        # the true per-round distribution, not a window average.
        while not self._stop.wait(self.POLL_INTERVAL_S):
            if not self.param_manager.active:
                return
            vals = self.drain_round_bytes()
            for v in vals:
                self.param_manager.record_step(v)
            if vals:
                self._lib.hvd_coord_set_fusion(
                    self._handle,
                    self.param_manager.fusion_threshold_bytes)

    def departure_counts(self):
        """(ever_connected, departed) rank-connection counters."""
        if not self._handle:
            return 0, 0
        seen = ctypes.c_int()
        departed = ctypes.c_int()
        self._lib.hvd_coord_counts(self._handle, ctypes.byref(seen),
                                   ctypes.byref(departed))
        return seen.value, departed.value

    def cache_stats(self):
        """(fast_rounds, full_rounds) response-cache round counters."""
        if not self._handle:
            return 0, 0
        fast = ctypes.c_longlong()
        full = ctypes.c_longlong()
        self._lib.hvd_coord_cache_stats(self._handle, ctypes.byref(fast),
                                        ctypes.byref(full))
        return fast.value, full.value

    def stall_report(self) -> str:
        """Coordinator-side stall attribution text ('' = no stalls)."""
        if not self._handle:
            return ""
        buf = ctypes.create_string_buffer(65536)
        n = self._lib.hvd_coord_stall_report(self._handle, buf, len(buf))
        return buf.raw[:n].decode(errors="replace")

    def stop(self):
        self._stop.set()
        # Join the poll thread BEFORE freeing the C++ object: a poll
        # mid-flight would read freed memory.
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2.0)
            self._poll_thread = None
        if self._handle:
            self._lib.hvd_coord_stop(self._handle)
            self._handle = None
