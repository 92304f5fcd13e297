"""Search strategies for the tuning session.

Two interchangeable strategies over the same knob space:

* ``CoordinateSearch`` ("grid") — deterministic coordinate descent:
  knobs are swept in declaration order, one candidate per sampling
  window, and after each sweep the best-scoring candidate (ties break
  toward the default) is locked in before the next knob starts.  No
  randomness anywhere — the strategy the tests and chaos drills pin.
* ``GPSearch`` ("gp") — the same coordinate loop, but continuous
  knobs are sampled by the resurrected Gaussian-process Expected-
  Improvement sampler (common/optim/bayesian_optimization.py, the
  reference parameter_manager lineage) under a fixed seed, so a given
  (seed, score stream) replays to the same proposals.

A knob space is an ordered ``{name: KnobSpec}``; continuous specs
carry (lo, hi) bounds + a sample budget, categorical specs a candidate
tuple.  Both strategies expose the same surface::

    s.current       # the full knob vector to run NEXT window
    s.advance(score)  # score the window just finished -> bool changed
    s.converged     # search space exhausted
    s.best, s.best_score, s.samples

Counterpart of :mod:`horovod_tpu.tune.search`, copied.
"""

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["KnobSpec", "CoordinateSearch", "GPSearch", "make_strategy"]


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One searchable knob: ``candidates`` for categorical/grid
    dimensions, or ``bounds`` (+ ``gp_samples``) for continuous ones —
    a continuous spec still carries candidates as the grid-strategy
    fallback."""
    default: object
    candidates: Tuple = ()
    bounds: Optional[Tuple[float, float]] = None
    gp_samples: int = 8

    def grid(self) -> Tuple:
        cands = tuple(self.candidates)
        if self.default in cands:
            # Default first: ties adopt the stock configuration, so a
            # flat objective can never "tune" away from the default.
            cands = (self.default,) + tuple(
                c for c in cands if c != self.default)
        else:
            cands = (self.default,) + cands
        return cands


class CoordinateSearch:
    def __init__(self, space: Dict[str, KnobSpec]):
        self._space = dict(space)
        self._order = list(space)
        self._vector = {k: s.default for k, s in space.items()}
        self._ki = 0
        self._ci = 0
        self._scores = []        # scores for the knob being swept
        self._cands = self._grid_for(0)
        self.samples = 0
        self.converged = not self._order
        self.best_score: Optional[float] = None

    def _grid_for(self, ki: int):
        if ki >= len(self._order):
            return ()
        return self._space[self._order[ki]].grid()

    @property
    def current(self) -> dict:
        v = dict(self._vector)
        if not self.converged:
            v[self._order[self._ki]] = self._cands[self._ci]
        return v

    @property
    def best(self) -> dict:
        return dict(self._vector)

    def advance(self, score: float) -> bool:
        """Record ``score`` for the vector in ``current`` and move to
        the next proposal.  Returns True when ``current`` changed."""
        if self.converged:
            return False
        self.samples += 1
        self._scores.append(float(score))
        prev = self.current
        self._ci += 1
        if self._ci >= len(self._cands):
            # Adopt the best candidate for this knob; max() keeps the
            # FIRST maximum, and the grid puts the default first, so a
            # tie adopts the default.
            knob = self._order[self._ki]
            best_i = max(range(len(self._scores)),
                         key=lambda i: self._scores[i])
            self._vector[knob] = self._cands[best_i]
            self.best_score = self._scores[best_i]
            self._scores = []
            self._ki += 1
            self._ci = 0
            if self._ki >= len(self._order):
                self.converged = True
            else:
                self._cands = self._grid_for(self._ki)
        return self.current != prev or self.converged

    def finish(self):
        """Force convergence (sample budget exhausted): adopt the best
        candidate seen so far for the knob mid-sweep, keep defaults
        for knobs never reached.  Deterministic like advance()."""
        if self.converged:
            return
        if self._scores:
            knob = self._order[self._ki]
            best_i = max(range(len(self._scores)),
                         key=lambda i: self._scores[i])
            self._vector[knob] = self._cands[best_i]
            self.best_score = self._scores[best_i]
            self._scores = []
        self.converged = True

    def adopt(self, vector: dict, score: float = None):
        """Pre-freeze the search on an externally chosen vector (a
        reloaded tuned profile): known knobs are adopted, the search
        is marked converged, nothing is ever proposed."""
        self._vector.update(
            {k: v for k, v in vector.items() if k in self._vector})
        if score is not None:
            self.best_score = float(score)
        self._scores = []
        self.converged = True


class GPSearch(CoordinateSearch):
    """Coordinate descent where continuous knobs (those declaring
    ``bounds``) are sampled by GP Expected Improvement instead of the
    fixed grid.  Deterministic under a fixed seed: the only randomness
    is the seeded proposal RNG inside BayesianOptimization."""

    def __init__(self, space: Dict[str, KnobSpec], seed: int = 0,
                 gp_noise: float = 0.8):
        self._seed = seed
        self._gp_noise = gp_noise
        self._bo = None
        self._bo_x = None
        self._bo_budget = 0
        super().__init__(space)

    def _spec(self, ki: int) -> Optional[KnobSpec]:
        if ki >= len(self._order):
            return None
        return self._space[self._order[ki]]

    def _grid_for(self, ki: int):
        spec = self._spec(ki)
        if spec is not None and spec.bounds is not None:
            from ..common.optim import BayesianOptimization
            self._bo = BayesianOptimization(
                bounds=[spec.bounds], gp_noise=self._gp_noise,
                seed=self._seed + ki)
            self._bo_budget = max(2, int(spec.gp_samples))
            self._bo_x = [float(spec.default)]
            # One pseudo-candidate slot per budgeted sample; current()
            # reads the actual value from _bo_x.
            return ("gp",) * self._bo_budget
        self._bo = None
        return super()._grid_for(ki)

    @property
    def current(self) -> dict:
        v = dict(self._vector)
        if not self.converged:
            knob = self._order[self._ki]
            if self._bo is not None:
                v[knob] = round(float(self._bo_x[0]), 4)
            else:
                v[knob] = self._cands[self._ci]
        return v

    def advance(self, score: float) -> bool:
        if self.converged or self._bo is None:
            return super().advance(score)
        self.samples += 1
        prev = self.current
        knob = self._order[self._ki]
        self._bo.add_sample([float(self._bo_x[0])], float(score))
        self._ci += 1
        if self._ci >= self._bo_budget:
            best = self._bo.best
            spec = self._space[knob]
            if best is not None:
                self._vector[knob] = round(float(best[0][0]), 4)
                self.best_score = float(best[1])
            else:
                self._vector[knob] = spec.default
            self._ci = 0
            self._ki += 1
            if self._ki >= len(self._order):
                self.converged = True
            else:
                self._cands = self._grid_for(self._ki)
        else:
            self._bo_x = [float(self._bo.next_sample()[0])]
        return self.current != prev or self.converged

    def finish(self):
        if self.converged:
            return
        if self._bo is not None and self._bo.best is not None:
            knob = self._order[self._ki]
            self._vector[knob] = round(float(self._bo.best[0][0]), 4)
            self.best_score = float(self._bo.best[1])
            self.converged = True
            return
        super().finish()


def make_strategy(name: str, space: Dict[str, KnobSpec],
                  seed: int = 0, gp_noise: float = 0.8):
    if name == "gp":
        return GPSearch(space, seed=seed, gp_noise=gp_noise)
    if name == "grid":
        return CoordinateSearch(space)
    raise ValueError("unknown tune strategy %r (grid|gp)" % (name,))
