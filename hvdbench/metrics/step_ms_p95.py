"""95th percentile of every window step's host wall time, every rank's
steps pooled; each step ends in ``loss.item()``."""
import statistics


def read(run):
    steps = [ms for r in run["ranks"] for ms in r["step_ms"]]
    return statistics.quantiles(steps, n=20)[18]
