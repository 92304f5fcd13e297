"""The readings that the limits in ``hvdbench/workloads/<cell>.json`` are
set from, at the cell's own sizes on the card.

    python3 -m hvdbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--no-program]

- ``program``: the port's three checked steps from each ``--seeds``
  seed against the plain reference (:mod:`hvdbench.check`); the lower
  reading of each number is the largest over the seeds;
- ``control``: the reference itself in the port's place, in bfloat16
  where the configuration computes in it, and with every matmul's or
  convolution's operands in float8 e4m3 and the gradient of its output
  in e5m2 (``plain.FP8_PRODUCTS``: fp8 products, the step below the
  configuration's bf16 that a faster program would take first), on each
  ``--control-seeds`` seed;
- ``control_fp8``: the reference in float8 wherever the configuration
  computes in bfloat16 (``plain.FP8``);
- ``bf16_witness``: the reference with bfloat16 where the configuration
  computes in it (``plain.BF16``), a second witness of what the port's
  precision alone reads;
- ``half_batch``: the reference on the first half of each rank's rows,
  the mean taken over them;
- ``no_exchange`` (cells of several ranks): rank 0's steps on its own
  gradient, the allreduce left out.

A step that returns its state unchanged reads 1 on ``update_norm_gap``
by the measure's definition and needs no run.  One JSON line per
reading, then a summary line.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys

import torch

from hvdbench import check, plain, run, spec, worker


def _as_ranks(ref: dict, ranks: int) -> list:
    """A reference's readings as the per-rank readings the port gives."""
    return [{"loss": [step[r] for step in ref["loss"]],
             "grad_norms": ref["grad_norms"],
             "update_norms": ref["update_norms"]} for r in range(ranks)]


def program_readings(cell, seeds, device) -> dict:
    """{seed: [rank readings]} of the port's checked steps."""
    if cell.chips == 1:
        import horovod_tpu_torch.torch as hvd
        hvd.init()
        out = {}
        try:
            for s in seeds:
                result, _ = worker.run_rank(cell, hvd, s, 0, False,
                                            device=device)
                out[s] = [result["check"]]
                run._free(device)
        finally:
            hvd.shutdown()
        return out
    by_seed, forbidden = run.run_launched(
        cell, seeds, 0, False,
        device=None if device.type == "cuda" else device)
    if forbidden:
        raise ImportError("loaded in a run of the port: "
                          + ", ".join(forbidden))
    return {s: [r["check"] for r in ranks] for s, ranks in by_seed.items()}


def fault_readings(cell, seed: int, device) -> dict:
    batches = run.checked_batches(cell, seed, device)
    ref = run.reference(cell, seed, batches, device)
    ranks = len(batches)
    out = {kind: check.gaps(
        _as_ranks(run.reference(cell, seed, batches, device, prec=prec),
                  ranks), ref)
        for kind, prec in (("control", plain.FP8_PRODUCTS),
                           ("control_fp8", plain.FP8),
                           ("bf16_witness", plain.BF16))}
    r = cell.reference
    half = [[r.take_rows(b, r.rows_of(b) // 2) for b in steps]
            for steps in batches]
    out["half_batch"] = check.gaps(
        _as_ranks(run.reference(cell, seed, half, device), ranks), ref)
    if ranks > 1:
        out["no_exchange"] = check.gaps(
            _as_ranks(run.reference(cell, seed, batches[:1], device), 1),
            ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--no-program", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    readings = {k: [] for k in ("program", "control", "control_fp8",
                                "bf16_witness", "half_batch",
                                "no_exchange")}

    def emit(kind, seed, numbers):
        readings[kind].append(numbers)
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          **numbers}), flush=True)

    if seeds and not args.no_program:
        for s, ranks in program_readings(cell, seeds, device).items():
            batches = run.checked_batches(cell, s, device)
            emit("program", s, check.gaps(
                ranks, run.reference(cell, s, batches, device)))
            del batches
            run._free(device)
    for s in (int(s) for s in args.control_seeds.split(",") if s):
        for kind, numbers in fault_readings(cell, s, device).items():
            emit(kind, s, numbers)
        run._free(device)
    summary = {"cell": cell.name, "kind": "summary",
               "card": torch.cuda.get_device_name(device)
               if device.type == "cuda" else str(device)}
    for kind, rows in readings.items():
        if rows:
            agg = max if kind in ("program", "bf16_witness") else min
            summary[kind] = {k: agg(r[k] for r in rows)
                             for k in check.NUMBERS}
            summary[kind]["n"] = len(rows)
    summary["state_unchanged"] = {"update_norm_gap": 1.0}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
