"""The comparison that decides ``correct``: the port's three checked
steps against the plain reference's, from the same weights and batches.

The numbers, of which a cell compares those that
``hvdbench/workloads/<cell>.json`` gives a limit:

- ``loss_gap``: the largest relative gap of a step's loss, over the
  three steps and every rank; ``first_loss_gap``: the same of step 1;
- ``grad_norm_gap``: over the leaves, the largest gap between the port's
  norm of a leaf's gradient as the optimizer got it in step 1 and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; ``median_grad_gap``: the median leaf's;
- ``update_norm_gap``, ``median_update_gap``: the same of each leaf's
  change over the three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a key's bias under softmax) move by round-off alone and are left
out of both leaf numbers, by that rule and not by name.
"""

import math
import statistics

NUMBERS = ("loss_gap", "first_loss_gap", "grad_norm_gap",
           "median_grad_gap", "update_norm_gap", "median_update_gap")
NOUGHT = 1e-3


def moved_leaves(ref: dict) -> list:
    grads = ref["grad_norms"]
    floor = NOUGHT * statistics.median(grads.values())
    return [n for n, g in grads.items() if g >= floor]


def _leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    missing = set(ref) - set(prog)
    if missing:
        raise KeyError(f"the port has no leaf {sorted(missing)[:3]}")
    med = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves]


def gaps(ranks: list, ref: dict) -> dict:
    """``ranks[r]``: rank r's checked readings (``worker.checked_steps``);
    ``ref``: the reference's (``plain.train``)."""
    leaves = moved_leaves(ref)

    def loss(steps):
        return max(abs(r["loss"][i] - ref["loss"][i][k])
                   / abs(ref["loss"][i][k])
                   for k, r in enumerate(ranks) for i in steps)

    out = {"loss_gap": loss(range(len(ref["loss"]))),
           "first_loss_gap": loss([0])}
    for key, worst, median in (("grad_norms", "grad_norm_gap",
                                "median_grad_gap"),
                               ("update_norms", "update_norm_gap",
                                "median_update_gap")):
        per_rank = [_leaf_gaps(r[key], ref[key], leaves) for r in ranks]
        out[worst] = max(max(g) for g in per_rank)
        out[median] = max(statistics.median(g) for g in per_rank)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limit
               for k, limit in limits.items())
