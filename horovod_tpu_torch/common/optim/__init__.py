"""Optimization utilities for the autotuner (reference:
horovod/common/optim/ — Gaussian-process regression + Bayesian
optimization with Expected Improvement).

Counterpart of :mod:`horovod_tpu.common.optim`, copied.
"""

from .gaussian_process import GaussianProcessRegressor
from .bayesian_optimization import BayesianOptimization

__all__ = ["GaussianProcessRegressor", "BayesianOptimization"]
