"""From the harness process's start (for a launched cell: before the
launcher starts) to the last rank's first window step."""


def read(run):
    return max(r["t_window0"] for r in run["ranks"]) - run["t_start"]
