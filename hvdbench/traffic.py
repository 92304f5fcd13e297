"""The one generator of every traffic mix.

A mix (``hvdbench/traffic/<name>.json``) fixes the ranks, the rows a rank
takes a step (``rows_per_rank``), the row's own sizes (``seq_len`` for a
sequence model) and how many distinct batches a rank cycles through
(``distinct_batches``, at least the three checked steps').  What a row
holds is the configuration's (its reference's ``make_rows``).  Batch
``i`` of rank ``r`` comes from its own stream of the run's seed, so the
same seed gives the same batches on every run, and every batch differs.
The loop is closed: each rank starts a step when its last one ended.
"""

from hvdbench import plain

CHECKED_STEPS = 3


def batch(cell, seed: int, rank: int, index: int, device):
    t = cell.traffic
    gen = plain.generator(device, seed, "batch", rank, index)
    return cell.reference.make_rows(cell.config, t, t["rows_per_rank"],
                                    gen, device)


def pool(cell, seed: int, rank: int, device) -> list:
    """The distinct batches rank ``rank`` cycles through; its first
    :data:`CHECKED_STEPS` are the checked steps'."""
    n = int(cell.traffic["distinct_batches"])
    if n < CHECKED_STEPS:
        raise ValueError(f"traffic {cell.entry['traffic']}: "
                         f"distinct_batches {n} < {CHECKED_STEPS}")
    return [batch(cell, seed, rank, i, device) for i in range(n)]
