"""From the harness process's start to the last rank's return from
``hvd.init()``."""


def read(run):
    return max(r["t_init"] for r in run["ranks"]) - run["t_start"]
