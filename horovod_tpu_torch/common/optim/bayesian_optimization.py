"""Bayesian optimization with Expected Improvement.

Reference: common/optim/bayesian_optimization.{h,cc} (114+194) —
``AddSample``/``NextSample``/``ExpectedImprovement``: a GP is fit to
(params, score) samples and the next trial point maximizes EI.  The
reference maximizes EI with LBFGS over random restarts; here EI is
maximized over a dense random candidate set refined by L-BFGS-B
(scipy), which is equivalent in practice for the 1-3 dimensional knob
spaces involved.

Counterpart of :mod:`horovod_tpu.common.optim.bayesian_optimization`,
copied (numpy; scipy inside ``_minimize``).
"""

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .gaussian_process import GaussianProcessRegressor


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class BayesianOptimization:
    def __init__(self, bounds: Sequence[Tuple[float, float]],
                 gp_noise: float = 0.8, xi: float = 0.01, seed: int = 0):
        self.bounds = np.asarray(bounds, dtype=np.float64)
        self.dim = len(bounds)
        self.xi = xi
        self._rng = np.random.RandomState(seed)
        # Normalize inputs to [0,1]^d for a sane fixed length scale.
        self._gp = GaussianProcessRegressor(alpha=gp_noise ** 2,
                                            length_scale=0.3,
                                            sigma_f=1.0)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []

    def _to_unit(self, x):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (np.asarray(x, dtype=np.float64) - lo) / (hi - lo)

    def _from_unit(self, u):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + np.asarray(u) * (hi - lo)

    def add_sample(self, x, y: float):
        self._x.append(self._to_unit(x))
        self._y.append(float(y))
        self._gp.fit(np.vstack(self._x), np.asarray(self._y))

    def expected_improvement(self, u: np.ndarray) -> np.ndarray:
        mean, std = self._gp.predict(np.atleast_2d(u))
        best = max(self._y) if self._y else 0.0
        imp = mean - best - self.xi
        z = imp / std
        return imp * _norm_cdf(z) + std * _norm_pdf(z)

    def next_sample(self) -> np.ndarray:
        """The params (original scale) maximizing EI."""
        if not self._x:
            return self._from_unit(self._rng.uniform(size=self.dim))
        cands = self._rng.uniform(size=(256, self.dim))
        ei = self.expected_improvement(cands)
        u0 = cands[int(np.argmax(ei))]
        try:
            from scipy.optimize import minimize
        except ImportError:
            minimize = None
        if minimize is not None:
            res = minimize(
                lambda u: -self.expected_improvement(u[None, :])[0],
                u0, bounds=[(0.0, 1.0)] * self.dim, method="L-BFGS-B")
            if res.success:
                u0 = res.x
        return self._from_unit(np.clip(u0, 0.0, 1.0))

    @property
    def best(self) -> Optional[Tuple[np.ndarray, float]]:
        if not self._y:
            return None
        i = int(np.argmax(self._y))
        return self._from_unit(self._x[i]), self._y[i]
