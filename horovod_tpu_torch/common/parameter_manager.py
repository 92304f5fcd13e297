"""Autotuner: Bayesian optimization of runtime knobs from live
throughput.

Reference: common/parameter_manager.{h,cc} (251+528) — tunables scored
by bytes/sec over sampling windows, warmup samples discarded, best
params adopted when tuning converges; the search is JOINT over the
continuous knobs (fusion-threshold-MB × cycle-time-ms, GP + Expected
Improvement, BayesianParameter :186-220) and the categorical knobs
(hierarchical allreduce on/off, cache on/off — CategoricalParameterEntry
:140-184), and the winning parameters are synchronized to every rank
(Controller::SynchronizeParameters, controller.cc:39-53).

Deltas from the reference:
  * fusion planning happens ONLY on the rank-0 coordinator (workers
    execute broadcast fused batches), so the fusion threshold needs no
    cross-rank synchronization — but the categorical knobs are
    worker-side data-plane choices, so the coordinator announces them
    through PA frames positioned in the response stream (every worker
    flips between the same two batches; controller_net.py);
  * the reference's cycle-time knob exists because its background loop
    polls on a fixed cadence (operations.cc:587 1 ms sleep); this
    runtime is event-driven (wakes on submit), so there is no polling
    cadence to tune — ``cycle_time_ms`` is carried for API parity but
    fixed;
  * categorical search: one GP per category combination, explored
    round-robin window-by-window, best (combo, fusion) adopted at
    convergence — the reference's nested Categorical/Bayesian layout
    with the same effect.

Counterpart of :mod:`horovod_tpu.common.parameter_manager`, copied: the
port's runtime is event-driven too (``common/runtime.py``).
"""

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np

from .optim.bayesian_optimization import BayesianOptimization

logger = logging.getLogger("horovod_tpu_torch.autotune")

MB = 1024 * 1024

FUSION_MB_BOUNDS = (1.0, 128.0)

# (hierarchical allreduce, cache enabled) combinations, classic
# defaults first so warmup windows run the stock configuration.
_COMBOS = ((False, True), (True, True), (False, False), (True, False))


class ParameterManager:
    def __init__(self, warmup_samples: int = 3,
                 steps_per_sample: int = 10,
                 bayes_opt_max_samples: int = 20,
                 gp_noise: float = 0.8,
                 initial_fusion_bytes: int = 64 * MB,
                 initial_cycle_ms: float = 1.0,
                 log_path: Optional[str] = None,
                 tune_categorical: bool = True,
                 fixed_hierarchical: Optional[bool] = None,
                 fixed_cache: Optional[bool] = None,
                 on_update: Optional[Callable] = None):
        self._warmup_remaining = warmup_samples
        self._steps_per_sample = steps_per_sample
        self._max_samples = bayes_opt_max_samples
        self._on_update = on_update
        # Explicitly-set knobs are held fixed during tuning (the
        # reference likewise only tunes parameters the user left
        # unset, parameter_manager.cc SetAutoTuning semantics).
        combos = _COMBOS if tune_categorical else (_COMBOS[0],)
        combos = tuple(
            c for c in combos
            if (fixed_hierarchical is None or c[0] == fixed_hierarchical)
            and (fixed_cache is None or c[1] == fixed_cache))
        self._combos = combos or ((bool(fixed_hierarchical),
                                   fixed_cache is not False),)
        self._bo = {c: BayesianOptimization(bounds=[FUSION_MB_BOUNDS],
                                            gp_noise=gp_noise)
                    for c in self._combos}
        self._combo_idx = 0
        self.fusion_threshold_bytes = initial_fusion_bytes
        self.cycle_time_ms = initial_cycle_ms   # API parity; fixed
        self._current = np.array([initial_fusion_bytes / MB])
        self._samples_taken = 0
        self._steps = 0
        self._bytes = 0
        self._window_start = time.monotonic()
        self._done = False
        # Monotonic version: bumped whenever the categorical params
        # change, so the coordinator knows when to emit a PA frame.
        self.params_version = 0
        self._log = open(log_path, "w") if log_path else None
        if self._log:
            self._log.write("sample,fusion_mb,hierarchical,cache,"
                            "score_bytes_per_sec,is_best\n")

    @property
    def active(self) -> bool:
        return not self._done

    @property
    def categorical_params(self) -> Dict[str, bool]:
        h, c = self._combos[self._combo_idx]
        return {"hierarchical": h, "cache": c}

    def record_step(self, nbytes: int):
        """One negotiation round completed, moving ``nbytes`` of fused
        tensor payload.  Drives the sampling window."""
        if self._done:
            return
        self._bytes += nbytes
        self._steps += 1
        if self._steps < self._steps_per_sample:
            return
        elapsed = max(time.monotonic() - self._window_start, 1e-6)
        score = self._bytes / elapsed
        self._steps = 0
        self._bytes = 0
        self._window_start = time.monotonic()
        self._advance(score)

    def _advance(self, score: float):
        if self._warmup_remaining > 0:
            # Warmup windows pollute the score (compilation, cold
            # caches); discard them (reference warmup discard).
            self._warmup_remaining -= 1
            return
        combo = self._combos[self._combo_idx]
        bo = self._bo[combo]
        bo.add_sample(self._current, score)
        self._samples_taken += 1
        best = bo.best
        is_best = best is not None and np.allclose(best[0], self._current)
        if self._log:
            self._log.write(
                f"{self._samples_taken},{self._current[0]:.2f},"
                f"{int(combo[0])},{int(combo[1])},{score:.1f},"
                f"{int(bool(is_best))}\n")
            self._log.flush()
        if self._samples_taken >= self._max_samples:
            self._converge()
            return
        # Round-robin the category combinations; each keeps its own GP
        # over the fusion threshold.
        next_idx = (self._combo_idx + 1) % len(self._combos)
        next_bo = self._bo[self._combos[next_idx]]
        self._apply(next_idx, next_bo.next_sample())

    def _converge(self):
        best_combo, best_params, best_score = None, None, -np.inf
        for combo, bo in self._bo.items():
            if bo.best is not None and bo.best[1] > best_score:
                best_combo, (best_params, best_score) = combo, bo.best
        if best_combo is None:
            best_combo, best_params = self._combos[self._combo_idx], \
                self._current
            best_score = 0.0
        self._apply(self._combos.index(best_combo), best_params)
        self._done = True
        # Convergence is an announcable event even when the winning
        # combo is the one already applied: the final PA frame carries
        # tuning_active=false, which is what releases the steady-state
        # replay hold on every rank (warmup -> freeze -> replay).
        self.params_version += 1
        logger.info(
            "autotune converged: fusion=%.1fMB hierarchical=%s cache=%s "
            "(%.1f MB/s)", best_params[0], best_combo[0], best_combo[1],
            best_score / MB)
        if self._log:
            self._log.close()
            self._log = None

    def _apply(self, combo_idx: int, params):
        if combo_idx != self._combo_idx:
            self._combo_idx = combo_idx
            self.params_version += 1
        self._current = np.asarray(params, dtype=np.float64)
        self.fusion_threshold_bytes = int(self._current[0] * MB)
        if self._on_update:
            self._on_update(self.fusion_threshold_bytes,
                            self.cycle_time_ms, self.categorical_params)
