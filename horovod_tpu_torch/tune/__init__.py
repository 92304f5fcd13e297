"""Autotune-then-freeze: online knob tuning as replay's warmup phase.

The reference Horovod ships a Bayesian autotuner over fusion threshold
and cycle time (common/parameter_manager.{h,cc}); Li et al. VLDB '20
(PAPERS.md) shows the production shape: measure during early
iterations, FREEZE the winning schedule, then run it static and
wire-free.  This package implements that lifecycle for the port's
runtime:

    warmup -> search -> freeze -> replay

* ``TuningSession`` (session.py) runs on the rank-0 coordinator and
  scores every negotiation round from the live byte/latency stream the
  metrics registry already measures, **per cycle-class**: dense
  allreduce/broadcast rounds and sparse alltoall rounds (the DLRM
  three-alltoall exchange) are windowed, scored and searched
  independently, because their fusion optima differ.
* Search strategies (search.py): deterministic coordinate descent over
  a fixed knob grid (``grid`` — the test/CI strategy), or the
  resurrected Gaussian-process sampler (``gp``,
  common/parameter_manager.py lineage) for the continuous knobs.
* Worker-side knob flips (cycle time, request coalescing, replay
  warmup) are announced through the existing PA control frames,
  broadcast under the coordinator server lock — every rank applies
  them at the same position in its response stream, so no two ranks
  ever run different knobs for the same cycle (rank-local flips would
  poison replay's same-schedule contract).  The per-class fusion
  thresholds live only on the coordinator (fusion planning happens
  there) and need no synchronization, the reference semantics.
* On convergence the session freezes the winner into a
  ``TunedProfile`` (profile.py) — a JSON artifact reloadable via
  ``HOROVOD_TUNE_PROFILE`` so restarts and elastic resizes skip the
  re-search — and announces ``tuning_active: false``; only then does
  the steady-state replay tracker (common/replay.py) engage, on the
  tuned schedule.  Tuning and replay are phases of one pipeline, not
  mutually exclusive modes.

Enabling: ``HOROVOD_TUNE=1`` (see docs/autotune.md for the knob
catalog and the profile artifact format).

Counterpart of :mod:`horovod_tpu.tune`, copied.
"""

from .profile import (PROFILE_VERSION, TunedProfile, diff_profiles,
                      load_profile, save_profile)
from .search import CoordinateSearch, GPSearch, make_strategy
from .session import (CLASS_DENSE, CLASS_SPARSE, TuningSession,
                      WORKER_KNOB_DEFAULTS)

__all__ = [
    "PROFILE_VERSION", "TunedProfile", "diff_profiles", "load_profile",
    "save_profile", "CoordinateSearch", "GPSearch", "make_strategy",
    "CLASS_DENSE", "CLASS_SPARSE", "TuningSession",
    "WORKER_KNOB_DEFAULTS",
]
