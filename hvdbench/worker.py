"""One rank of a cell: set-up, the three checked steps, warm-up, the
measured window and, with ``--trace 1``, the traced steps.

Each step is a Horovod training step as a user writes it with gradient
clipping: ``zero_grad``, forward, ``backward``, ``optimizer.synchronize()``
(the exposed wait for the gradient reductions), the clip where the
configuration has one, ``step()`` inside ``skip_synchronize()``, and
``loss.item()``, which ends the step on the host as a loop that logs its
loss does.  Each part runs inside :func:`hvdbench.trace.span`, which
notes it while a trace records.

Under the launcher every rank runs ``python3 -m hvdbench.worker`` and
writes its result as ``rank.<r>.json`` into ``--out``.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

import torch

from hvdbench import plain, spec, trace as trace_mod, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    flax's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def train_step(prog, batch) -> float:
    """One step; returns its loss."""
    opt = prog.opt
    with trace_mod.span("step"):
        with trace_mod.span("zero_grad"):
            opt.zero_grad(set_to_none=True)
        with trace_mod.span("forward"):
            loss = prog.loss(batch)
        with trace_mod.span("backward"):
            loss.backward()
        with trace_mod.span("synchronize"):
            opt.synchronize()
        if prog.clip is not None:
            with trace_mod.span("clip"):
                torch.nn.utils.clip_grad_norm_(prog.params.values(),
                                               prog.clip)
        with trace_mod.span("optimizer_step"):
            with opt.skip_synchronize():
                opt.step()
        with trace_mod.span("loss_item"):
            value = loss.item()
    return value


def checked_steps(prog, batches) -> dict:
    """The first :data:`traffic.CHECKED_STEPS` steps through
    :func:`train_step`: each loss, each leaf's gradient norm as the
    optimizer got it in step 1, each leaf's change over the steps."""
    start = {n: p.detach().clone() for n, p in prog.params.items()}
    losses, grad_norms = [], None
    for i, b in enumerate(batches[:traffic.CHECKED_STEPS]):
        losses.append(train_step(prog, b))
        if i == 0:
            grad_norms = plain.leaf_norms(
                {n: p.grad for n, p in prog.params.items()})
    with torch.no_grad():
        update = plain.leaf_norms(
            {n: p - start[n] for n, p in prog.params.items()})
    return {"loss": losses, "grad_norms": grad_norms, "update_norms": update}


def collective_counts() -> dict:
    """The runtime's count of collectives by label, from
    ``hvd_collective_seconds`` in ``basics.metrics_snapshot()``."""
    from horovod_tpu_torch.common import basics
    hist = basics.metrics_snapshot()["histograms"]
    return {k: v["count"]
            for k, v in hist.get("hvd_collective_seconds", {}).items()}


def _kernel_counts() -> dict:
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion_buffer as fb
    return {"flash": {fa.BODY_NAMES[b]: n
                      for b, n in fa.launches_by_body.items()},
            "fusion": dict(fb.launches)}


def run_rank(cell, hvd, seed: int, seconds: float, trace: bool,
             device=None, build_kw=None) -> tuple:
    """One rank's run in a world ``hvd.init()`` has made.  With
    ``seconds`` 0 only the checked steps run.  Returns (result, the
    rank's batches); the program's state is dropped before it returns."""
    cfg, t = cell.config, cell.traffic
    rank, size = hvd.rank(), hvd.size()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    driver = cell.driver
    phases = {"t_imported": time.time()}
    weights = cell.reference.make_weights(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["t_weights"] = time.time()
    prog = driver.build(cfg, t, weights, device, hvd, **(build_kw or {}))
    del weights
    batches = traffic.pool(cell, seed, rank, device)
    phases["t_built"] = time.time()
    result = {"rank": rank, "size": size,
              "check": checked_steps(prog, batches), **phases,
              "t_checked": time.time()}
    if seconds > 0:
        result.update(_measure(cell, hvd, prog, batches, seconds, trace,
                               device))
    del prog
    return result, batches


def _measure(cell, hvd, prog, batches, seconds, trace, device) -> dict:
    t = cell.traffic
    n = len(batches)
    i = traffic.CHECKED_STEPS
    warm = []
    for _ in range(int(t["warmup_steps"])):
        t0 = time.perf_counter()
        train_step(prog, batches[i % n])
        warm.append(time.perf_counter() - t0)
        i += 1
    # A fixed count of steps that lasts about ``seconds``, agreed by all
    # ranks, so that every rank runs the same collectives.
    steps = torch.tensor([float(max(1, math.ceil(
        seconds / statistics.median(warm))))], device=device)
    if hvd.size() > 1:
        steps = hvd.allreduce(steps, op=hvd.Max, name="hvdbench.steps")
    steps = int(steps.item())
    counts0 = collective_counts()
    kernels0 = _kernel_counts()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    step_ms, losses = [], []
    t_window0 = time.time()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(train_step(prog, batches[i % n]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        i += 1
    t_window1 = time.time()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counts1 = collective_counts()
    kernels1 = _kernel_counts()
    out = {"t_window0": t_window0, "t_window1": t_window1, "steps": steps,
           "step_ms": step_ms,
           "failed_steps": sum(not math.isfinite(x) for x in losses),
           "peak_bytes": peak,
           "collectives": {k: v - counts0.get(k, 0)
                           for k, v in counts1.items()},
           "launches": {k: {b: v - kernels0[k][b] for b, v in d.items()}
                        for k, d in kernels1.items()},
           "device_name": torch.cuda.get_device_name(device)
           if on_card else str(device),
           "trace": None}
    if trace:
        k = int(t["trace_steps"])
        with trace_mod.DeviceTrace() as tr:
            for _ in range(k):
                train_step(prog, batches[i % n])
                i += 1
        out["trace"] = trace_mod.summarize(tr.events, tr.spans, k)
    return out


def main(argv=None):
    t_proc = time.time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated; one run per seed")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="default: the card hvd.init() picked")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    import horovod_tpu_torch.torch as hvd
    hvd.init()
    t_init = time.time()
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run_rank(cell, hvd, seed, args.seconds,
                             bool(args.trace),
                             device=args.device and torch.device(args.device))
        result.update(t_proc=t_proc, t_init=t_init)
        runs.append(result)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    rank = hvd.rank()
    hvd.shutdown()
    with open(os.path.join(args.out, f"rank.{rank}.json"), "w") as f:
        json.dump({"runs": runs, "forbidden": forbidden_modules()}, f)


if __name__ == "__main__":
    main()
