"""Torch host-staging cost measurement.

Quantifies what the torch binding's data path costs relative to the
same bytes fed to the collective as a host tensor, two real worker
processes through the full eager plane (TCP controller + data
backend), three measurements:

  1. ``hvd.torch.allreduce(tensor)`` GB/s at 1/16/64 MB, the tensor on
     the card (``cuda:0``; ``--device cpu``: on the host) — the
     ``torch`` lane;
  2. the root ``hvd.allreduce`` of a host tensor made from numpy, GB/s
     at the same sizes — the ``numpy`` lane;
  3. conversion-only microbench: the ``.cpu()`` + ``.to(device)``
     round trip per size, synchronized before the clock stops (what
     staging a card's tensor through the host adds, independent of the
     collective).

Every allreduce result is checked exactly against the sum of the
ranks' fills (rank r fills r + 1) outside the timed region; a wrong
sum fails the run instead of passing as a rate.  Each lane's row names
the backend that carried it: two ranks on one card run gloo (NCCL
refuses two ranks on one device), which stages a CUDA tensor through
pinned host memory.

Prints one JSON object (``allreduce``, ``conversion_only``,
``paired``), or ``{"error": ...}`` and exits 1.

    python -m horovod_tpu_torch.tools.measure_torch_staging [--device cpu]
        [--sizes 1 16 64]

Counterpart of the JAX package's ``tools/measure_torch_staging.py``,
whose workers run on the host only; here the workers take the port's
env contract (``HOROVOD_RANK``/``HOROVOD_SIZE``/...,
``HOROVOD_TPU_COORDINATOR`` for the ``torch.distributed`` group and
``HOROVOD_CONTROLLER_ADDR``).
"""

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WORKER = r"""
import json, os, time
import numpy as np
import torch
import horovod_tpu_torch as hvd_root
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import fusion_buffer as fb

hvd.init()
RANK, SIZE = hvd.rank(), hvd.size()
kind = os.environ["BENCH_DEVICE"]
device = torch.device("cuda", hvd.local_rank() % torch.cuda.device_count()) \
    if kind == "cuda" else torch.device("cpu")
backend = basics._state().backend
EXPECT = float(sum(r + 1 for r in range(SIZE)))


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def carrier(t):
    if t.is_cuda and backend.name == "gloo":
        return "gloo, staged through pinned host memory"
    return backend.name if t.is_cuda else "gloo"


def exact(out):
    out = torch.as_tensor(out)
    return bool((out == EXPECT).all()) and out.numel() > 0


sizes_mb = json.loads(os.environ["BENCH_SIZES_MB"])
results, checked, wrong = [], 0, []
launches0 = dict(fb.launches)
for mb in sizes_mb:
    n = int(mb * 1024 * 1024 // 4)
    iters = max(5, int(64 / mb))
    for kind_ in ("torch", "numpy"):
        if kind_ == "torch":
            buf = torch.full((n,), float(RANK + 1), dtype=torch.float32,
                             device=device)
            reduce = lambda b=buf, mb=mb: hvd.allreduce(
                b, op=hvd.Sum, name="stage.%s.t" % mb)
        else:
            buf = torch.from_numpy(np.full((n,), float(RANK + 1),
                                           np.float32))
            reduce = lambda b=buf, mb=mb: hvd_root.allreduce(
                b, op=hvd_root.Sum, name="stage.%s.n" % mb).numpy()
        outs = [reduce() for _ in range(3)]
        chunks = []
        per = max(iters // 5, 1)
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(per):
                outs.append(reduce())
            sync()
            chunks.append(mb / 1024 * per /
                          (time.perf_counter() - t0))
            for out in outs:
                checked += 1
                if not exact(out):
                    wrong.append("%s MB %s" % (mb, kind_))
            outs = []
        chunks.sort()
        results.append({"size_mb": mb, "input": kind_,
                        "gbps": round(chunks[2], 3),
                        "gbps_best": round(chunks[-1], 3),
                        "device": str(buf.device),
                        "backend": carrier(buf)})
if wrong:
    raise SystemExit("rank %d: inexact allreduce sums (want %r): %s"
                     % (RANK, EXPECT, sorted(set(wrong))))

# Conversion-only round trip (no collective): what staging adds.
conv = []
for mb in sizes_mb:
    n = int(mb * 1024 * 1024 // 4)
    t = torch.full((n,), 1.0, dtype=torch.float32, device=device)
    sync()
    t0 = time.perf_counter()
    reps = 50
    for _ in range(reps):
        back = t.detach().cpu().to(device)
    sync()
    dt = (time.perf_counter() - t0) / reps
    conv.append({"size_mb": mb, "round_trip_us": round(dt * 1e6, 1)})

print("COUNTS " + json.dumps({
    "rank": RANK, "checked": checked,
    "fusion": {k: fb.launches[k] - launches0[k] for k in fb.launches}}),
    flush=True)
if RANK == 0:
    print("STAGEJSON " + json.dumps(
        {"allreduce": results, "conversion_only": conv}), flush=True)
hvd.shutdown()
"""


def _free_ports(n):
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def _pair(data: dict) -> dict:
    """The torch and numpy lanes of each size side by side, with the
    torch lane's overhead in percent of its rate."""
    by = {}
    for r in data["allreduce"]:
        by.setdefault(r["size_mb"], {})[r["input"]] = r
    paired = {}
    for mb, d in sorted(by.items()):
        t, n = d["torch"]["gbps"], d["numpy"]["gbps"]
        paired[str(mb)] = {
            "torch_gbps": t, "numpy_gbps": n,
            "torch_overhead_pct": round((n - t) / t * 100, 1) if t
            else None}
    return paired


def measure(sizes, device: str):
    """Runs the workers; returns the printed dict (``{"error": ...}``
    when a worker failed)."""
    nproc = 2
    coord_port, ctrl_port = _free_ports(2)
    procs = []
    for rank in range(nproc):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update({
            "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(nproc),
            "HOROVOD_LOCAL_RANK": str(rank),
            "HOROVOD_LOCAL_SIZE": str(nproc),
            "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_TPU_COORDINATOR": "127.0.0.1:%d" % coord_port,
            "HOROVOD_CONTROLLER_ADDR": "127.0.0.1:%d" % ctrl_port,
            "BENCH_SIZES_MB": json.dumps(sizes),
            "BENCH_DEVICE": device,
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for rc, out in zip((p.returncode for p in procs), outs):
        if rc != 0:
            return {"error": "worker rc=%s: %s" % (rc, out[-800:])}
    counts = [json.loads(line[len("COUNTS "):]) for out in outs
              for line in out.splitlines() if line.startswith("COUNTS ")]
    for line in outs[0].splitlines():
        if line.startswith("STAGEJSON "):
            data = json.loads(line[len("STAGEJSON "):])
            data["paired"] = _pair(data)
            data["device"] = device
            data["ranks"] = nproc
            data["exact"] = True
            data["results_checked"] = sum(c["checked"] for c in counts)
            data["fusion_launches"] = {
                k: sum(c["fusion"][k] for c in counts)
                for k in counts[0]["fusion"]} if counts else None
            return data
    return {"error": "no STAGEJSON line: %s" % outs[0][-800:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the torch lane's tensors live (default: "
                        "the card)")
    p.add_argument("--sizes", type=float, nargs="+", default=[1, 16, 64],
                   help="message sizes in MB")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("measure_torch_staging: no CUDA device is available "
                  "(--device cpu measures on the host)", file=sys.stderr)
            return 1
    sizes = [int(s) if float(s).is_integer() else s for s in args.sizes]
    data = measure(sizes, args.device)
    print(json.dumps(data, indent=1))
    return 1 if "error" in data else 0


if __name__ == "__main__":
    sys.exit(main())
