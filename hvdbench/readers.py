"""What the metric readers (``hvdbench/metrics/<name>.py``) share.

A reader's ``run`` holds ``cell`` (:class:`hvdbench.spec.Cell`),
``ranks`` (each rank's result from :func:`hvdbench.worker.run_rank`) and
``t_start`` (the harness process's start, wall clock)."""

import statistics

from hvdbench import roofline
from hvdbench.trace import kernel_seconds


def window_s(run) -> float:
    """From the first rank's first window step to the last rank's last
    step's end."""
    return (max(r["t_window1"] for r in run["ranks"])
            - min(r["t_window0"] for r in run["ranks"]))


def rows_done(run) -> int:
    """Rows of all ranks' window steps."""
    return sum(r["steps"] for r in run["ranks"]) * \
        run["cell"].traffic["rows_per_rank"]


def mfu_pct(run) -> float:
    """Model FLOPs of all ranks' window steps over the window, over the
    ranks' 16-bit peak."""
    cell = run["cell"]
    flops = cell.flops.step_flops(cell.config, cell.traffic) * \
        sum(r["steps"] for r in run["ranks"])
    peak = roofline.of(run["ranks"][0]["device_name"])["bf16_flops"]
    return 100.0 * flops / window_s(run) / (len(run["ranks"]) * peak)


def idle_pct(run) -> float:
    """1 - busy / traced window, per card, averaged over the cards."""
    return statistics.mean(100.0 * (1.0 - r["trace"]["busy_s"]
                                    / r["trace"]["window_s"])
                           for r in run["ranks"])


def per_step_kernel_s(r, *needles) -> float:
    """Device seconds a traced step of the kernels whose names hold
    every needle, on rank result ``r``."""
    return kernel_seconds(r["trace"], *needles) / r["trace"]["steps"]
