"""Build and load the port's hand-written CUDA kernels.

Each ``*.cu`` file here exports a plain C interface.  At first use it is
compiled with ``nvcc -shared`` for ``sm_90a`` into ``build/`` beside the
sources (listed in ``.gitignore``), under a name carrying the hash of the
source, the shared headers (``*.cuh``) and the flags, so a rebuild
happens only when one of them changes; the shared library is then
opened with :mod:`ctypes`.  No PyTorch header is
compiled, which keeps a build to seconds.

:func:`build_report` reads what was built: per kernel, the registers
and spill bytes from the ``-Xptxas -v`` log and counts of chosen SASS
instructions from ``cuobjdump -sass``.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()       # guards _source_locks
_source_locks = {}             # one per source: builds run in parallel
_loaded = {}
build_seconds = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # hvdlint: env-ok(CUDA_HOME and CUDA_PATH locate the CUDA toolkit:
    # the toolchain's own variables, not Horovod knobs)
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the horovod_tpu_torch CUDA kernels")


def library_path(source: str) -> str:
    """The library built from ``source``, named by a hash of the source,
    every header (``*.cuh``) beside it, and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(KERNEL_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(KERNEL_DIR, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def log_path(source: str) -> str:
    """The compiler's output for the library ``load`` built."""
    return os.path.splitext(library_path(source))[0] + ".log"


def load(source: str) -> ctypes.CDLL:
    """Compile ``source`` (a file in this directory) if its library is
    not built yet, and return the loaded library.  Raises on any build
    failure; the compiler's output is kept in :func:`log_path`.  Calls
    for different sources may run at once, each its own ``nvcc``."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
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
            with open(log_path(source), "w") as f:
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


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas_log(text: str) -> Tuple[Dict[str, dict], list]:
    """Per kernel (mangled name): registers and spill bytes, from an
    ``-Xptxas -v`` log; and every warning line of the log."""
    kernels, current = {}, None
    for line in text.splitlines():
        entry = _PTXAS_ENTRY.search(line)
        if entry:
            current = kernels.setdefault(entry.group(1), {})
            continue
        if current is None:
            continue
        spill = _PTXAS_SPILL.search(line)
        if spill:
            current["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        regs = _PTXAS_REGS.search(line)
        if regs:
            current["registers"] = int(regs.group(1))
    warnings = [ln.strip() for ln in text.splitlines() if "warning" in ln]
    return kernels, warnings


def count_sass(text: str, mnemonics: Sequence[str]) -> Dict[str, dict]:
    """Per kernel (mangled name): how many SASS instructions of
    ``cuobjdump -sass`` output start with each mnemonic."""
    counts, current = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            current = counts.setdefault(line.split("Function : ")[1].strip(),
                                        {m: 0 for m in mnemonics})
            continue
        if current is None or "*/" not in line:
            continue
        # "/*0040*/   @P0 HGMMA.64x128x16.F32.BF16 ... ;  /* 0x... */"
        instr = line.split("*/", 1)[1].strip().split(";")[0].split()
        if instr and instr[0].startswith("@"):
            instr = instr[1:]
        if instr:
            for m in mnemonics:
                if instr[0].split(".")[0] == m:
                    current[m] += 1
    return counts


def build_report(source: str,
                 mnemonics: Sequence[str] = ("HGMMA", "UTMALDG", "SYNCS")
                 ) -> Tuple[Dict[str, dict], list]:
    """What the built ``source`` holds, per kernel: registers and spill
    bytes from its ptxas log, and counts of ``mnemonics`` in its SASS.
    Returns that and the log's warning lines.  Builds if needed."""
    load(source)
    with open(log_path(source)) as f:
        per_kernel, warnings = parse_ptxas_log(f.read())
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library_path(source)],
                          capture_output=True, text=True, check=True).stdout
    for name, counts in count_sass(sass, mnemonics).items():
        per_kernel.setdefault(name, {}).update(counts)
    return per_kernel, warnings
