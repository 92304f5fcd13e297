"""1 - (union of device intervals) / (span of the traced steps), per
card, averaged over the cell's cards, in %."""
from hvdbench import readers


def read(run):
    return readers.idle_pct(run)
