"""Model FLOPs of all ranks' window steps over the window, over the
ranks' dense 16-bit peak (``hvdbench/roofline.py``), in %."""
from hvdbench import readers


def read(run):
    return readers.mfu_pct(run)
