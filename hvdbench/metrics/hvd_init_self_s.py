"""The port's own ``hvd.init`` span (``horovod_tpu_torch.common.timeline``),
from ``basics.init``'s entry to its return, in s: the one such span that
starts between the harness process's start and the rank's return from
``hvd.init()``.  None for a launched cell (its ranks' spans stay in their
processes), where the port records no spans, or where its recorder
dropped any."""


def read(run):
    if run["cell"].chips != 1:
        return None
    try:
        from horovod_tpu_torch.common.timeline import dropped, spans
    except ImportError:
        return None
    t_init_us = run["ranks"][0]["t_init"] * 1e6
    init = [s for s in spans(run["t_start"] * 1e6)
            if s.name == "hvd.init" and s.start_us <= t_init_us]
    if dropped() or len(init) != 1:
        return None
    return (init[0].end_us - init[0].start_us) / 1e6
