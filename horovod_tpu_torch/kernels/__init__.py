"""Build and load the port's hand-written CUDA kernels.

Each ``*.cu`` file here exports a plain C interface.  At first use it is
compiled with ``nvcc -shared`` for ``sm_90a`` into ``build/`` beside the
sources (listed in ``.gitignore``), under a name carrying the hash of the
source and flags, so a rebuild happens only when either changes; the
shared library is then opened with :mod:`ctypes`.  No PyTorch header is
compiled, which keeps a build to seconds.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded = {}
build_seconds = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the horovod_tpu_torch CUDA kernels")


def library_path(source: str) -> str:
    with open(os.path.join(KERNEL_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def load(source: str) -> ctypes.CDLL:
    """Compile ``source`` (a file in this directory) if its library is
    not built yet, and return the loaded library.  Raises on any build
    failure; the compiler's output is kept in ``build/<stem>.log``."""
    with _lock:
        if source in _loaded:
            return _loaded[source]
        lib_path = library_path(source)
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(KERNEL_DIR, source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[source] = time.perf_counter() - t0
            log = os.path.join(BUILD_DIR,
                               os.path.splitext(source)[0] + ".log")
            with open(log, "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {source} (exit "
                    f"{proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)
        else:
            build_seconds.setdefault(source, 0.0)
        _loaded[source] = ctypes.CDLL(lib_path)
        return _loaded[source]
