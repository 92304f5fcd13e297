"""Gaussian-process regression with an RBF kernel.

The numpy re-derivation of the reference's Eigen implementation
(reference: common/optim/gaussian_process.{h,cc} (117+183) — RBF
kernel, cholesky solve, predictive mean/variance).  Kernel
hyperparameters (length scale, signal variance) are fixed per fit like
the reference; observation noise ``alpha`` regularizes the diagonal.

Counterpart of :mod:`horovod_tpu.common.optim.gaussian_process`, copied
(numpy only).
"""

from typing import Optional, Tuple

import numpy as np


class GaussianProcessRegressor:
    def __init__(self, alpha: float = 1e-8, length_scale: float = 1.0,
                 sigma_f: float = 1.0):
        self.alpha = alpha
        self.length_scale = length_scale
        self.sigma_f = sigma_f
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._L: Optional[np.ndarray] = None
        self._alpha_vec: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """RBF: sigma_f^2 * exp(-||a-b||^2 / (2 l^2))."""
        sq = (np.sum(a ** 2, axis=1)[:, None] +
              np.sum(b ** 2, axis=1)[None, :] - 2 * a @ b.T)
        sq = np.maximum(sq, 0.0)
        return self.sigma_f ** 2 * np.exp(-0.5 * sq /
                                          self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        K = self.kernel(x, x)
        K[np.diag_indices_from(K)] += self.alpha
        self._L = np.linalg.cholesky(K)
        self._alpha_vec = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn))
        self._x, self._y = x, yn
        return self

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (mean, std) of the posterior at x (denormalized)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        if self._x is None:
            return (np.full(len(x), self._y_mean),
                    np.full(len(x), self.sigma_f * self._y_std))
        Ks = self.kernel(x, self._x)
        mean = Ks @ self._alpha_vec
        v = np.linalg.solve(self._L, Ks.T)
        var = self.sigma_f ** 2 - np.sum(v ** 2, axis=0)
        var = np.maximum(var, 1e-12)
        return (mean * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)
