"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m hvdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A one-chip cell runs its rank in this process; a cell of more chips
starts its ranks with the port's launcher (``python -m
horovod_tpu_torch.runner.launch -np <n> -H localhost:<n>``), one rank a
card, as users run ``horovodrun``.  Each rank builds the configuration's
training step from the seed's weights, runs the three checked steps,
warms up, measures about ``--seconds`` seconds of steps and, with
``--trace 1``, traces a fixed count of steps more.  Once every rank's
program is gone, the plain reference repeats the checked steps from the
same weights and batches and :mod:`hvdbench.check` decides ``correct``.

The last line on standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (window steps over all ranks, and those
whose loss was not finite), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each compared number beside its
limit, as also the last lines on standard error.
"""

import os
import time


def _process_start() -> float:
    """When this process started, by the kernel's clock (to 10 ms),
    so that set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(ln.split()[1]) for ln in f
                        if ln.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from hvdbench import check, spec, traffic, worker  # noqa: E402

LAUNCH_TIMEOUT_S = 330
TOP = 10


def card_lines(chips: int) -> list:
    """The card's name and power limit, and with several chips how they
    are joined (``nvidia-smi topo -m``)."""
    def smi(*a):
        return subprocess.run(["nvidia-smi", *a], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    lines = ["hvdbench card: " + " | ".join(smi(
        "--query-gpu=index,name,power.limit",
        "--format=csv,noheader").splitlines())]
    if chips > 1:
        lines += ["hvdbench topo: " + ln for ln in smi("topo", "-m")
                  .splitlines()]
    return lines


def run_local(cell, seed: int, seconds: float, trace: bool, device=None):
    """The cell's one rank in this process: ([result], batches by rank)."""
    import horovod_tpu_torch.torch as hvd
    hvd.init()
    t_init = time.time()
    try:
        result, batches = worker.run_rank(cell, hvd, seed, seconds, trace,
                                          device=device)
    finally:
        hvd.shutdown()
    result.update(t_proc=T_START, t_init=t_init)
    return [result], [batches[:traffic.CHECKED_STEPS]]


def run_launched(cell, seeds, seconds: float, trace: bool,
                 worker_module: str = "hvdbench.worker",
                 device=None) -> tuple:
    """The cell's ranks under the port's launcher, each running
    ``worker_module`` over ``seeds``: ({seed: [result by rank]},
    forbidden modules the ranks loaded)."""
    n = cell.chips
    out = tempfile.mkdtemp(prefix="hvdbench.")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", str(n), "-H", f"localhost:{n}",
           sys.executable, "-m", worker_module, "--workload", cell.name,
           "--seeds", ",".join(str(s) for s in seeds),
           "--seconds", repr(float(seconds)), "--trace", str(int(trace)),
           "--out", out] + (["--device", str(device)] if device else [])
    proc = subprocess.Popen(cmd, cwd=cell.root, stdout=sys.stderr,
                            stderr=sys.stderr, start_new_session=True)
    try:
        rc = proc.wait(timeout=LAUNCH_TIMEOUT_S)
        if rc != 0:
            raise RuntimeError(f"the launcher exited with {rc}")
        ranks, forbidden = [], set()
        for r in range(n):
            with open(os.path.join(out, f"rank.{r}.json")) as f:
                got = json.load(f)
            ranks.append(got["runs"])
            forbidden.update(got["forbidden"])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    by_seed = {s: [ranks[r][i] for r in range(n)]
               for i, s in enumerate(seeds)}
    return by_seed, sorted(forbidden)


def checked_batches(cell, seed: int, device) -> list:
    """Every rank's checked batches, ``[rank][step]``, drawn anew."""
    return [[traffic.batch(cell, seed, r, i, device)
             for i in range(traffic.CHECKED_STEPS)]
            for r in range(cell.chips)]


def reference(cell, seed: int, batches, device, **kw) -> dict:
    """The plain reference's checked steps from the seed's weights on
    ``batches[rank][step]``; ``kw`` goes to its ``train`` (``prec``: where
    the control or the witness rounds)."""
    weights = cell.reference.make_weights(cell.config, seed, device)
    by_step = [list(steps) for steps in zip(*batches)]
    kw = dict(cell.workload.get("reference", {}), **kw)
    return cell.reference.train(cell.config, weights, by_step, **kw)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def metrics_of(cell, ranks: list, trace: bool) -> dict:
    run = {"cell": cell, "ranks": ranks, "t_start": T_START}
    wanted = cell.per_layer() if trace else cell.end_to_end()
    out = {}
    for m in wanted:
        value = cell.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _mean_of(ranks, key) -> dict:
    out = {}
    for r in ranks:
        for k, v in r["trace"][key].items():
            out[k] = out.get(k, 0.0) + v / len(ranks)
    return out


def result_line(cell, ranks: list, numbers: dict, trace: bool) -> dict:
    limits = cell.workload["limits"]
    device = {"platform": "gpu", "kind": ranks[0]["device_name"],
              "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    line = {"correct": check.judge(numbers, limits),
            "attempted": sum(r["steps"] for r in ranks),
            "failed": sum(r["failed_steps"] for r in ranks),
            "metrics": metrics_of(cell, ranks, trace), "device": device}
    if trace:
        device["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = sum(r["trace"]["window_s"]
                                 for r in ranks) / len(ranks)
        top = sorted(_mean_of(ranks, "kernel_s").items(),
                     key=lambda kv: -kv[1])[:TOP]
        line["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(
                _mean_of(ranks, "idle_s").items(),
                key=lambda kv: -kv[1])[:TOP]]}
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in limits}
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None,
             worker_module: str = "hvdbench.worker") -> tuple:
    """One run of ``cell``: (result line, rank results, every compared
    number).  ``device`` (tests only) runs the cell on another device
    than the cards."""
    import torch
    if cell.chips == 1:
        ranks, batches = run_local(cell, seed, seconds, trace, device)
        forbidden = []
    else:
        by_seed, forbidden = run_launched(cell, [seed], seconds, trace,
                                          worker_module, device)
        ranks, batches = by_seed[seed], None
    device = device or torch.device("cuda", 0)
    _free(device)
    if batches is None:
        batches = checked_batches(cell, seed, device)
    ref = reference(cell, seed, batches, device)
    numbers = check.gaps([r["check"] for r in ranks], ref)
    del batches
    _free(device)
    forbidden = sorted(set(forbidden) | set(worker.forbidden_modules()))
    if forbidden:
        raise ImportError("loaded in a run of the port: "
                          + ", ".join(forbidden))
    return result_line(cell, ranks, numbers, trace), ranks, numbers


def run_lines(ranks: list, trace: bool) -> list:
    """Earlier lines of the output: set-up's phases, the steps' median
    and counts, and with a trace the device time by category."""
    r0 = ranks[0]
    steps = [ms for r in ranks for ms in r["step_ms"]]
    lines = [
        "hvdbench phases (s from the process's start): " + ", ".join(
            f"{k} {max(r['t_' + k] for r in ranks) - T_START:.3f}"
            for k in ("init", "imported", "weights", "built", "checked",
                      "window0", "window1")),
        f"hvdbench steps: {len(steps)} pooled over {len(ranks)} rank(s), "
        f"median {statistics.median(steps)} ms, "
        f"launches {json.dumps(r0['launches'])}, "
        f"collectives {json.dumps(r0['collectives'])}"]
    if trace:
        per_step = {c: 1e3 * s / r0["trace"]["steps"]
                    for c, s in _mean_of(ranks, "category_s").items()}
        lines.append("hvdbench device ms a traced step by category: "
                     + json.dumps(per_step))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"hvdbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        line, ranks, numbers = run_cell(cell, args.seed, args.seconds,
                                        bool(args.trace))
    except ImportError as e:
        print(f"hvdbench: {e}", file=sys.stderr)
        return 4
    for ln in card_lines(cell.chips) + run_lines(ranks, bool(args.trace)):
        print(ln, flush=True)
    print("hvdbench numbers: " + json.dumps(numbers), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
