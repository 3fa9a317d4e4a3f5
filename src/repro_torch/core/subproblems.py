"""ADMM hyper-parameters and the staleness weights of minibatched rounds.

The port's counterpart of ``ADMMConfig`` and ``stale_weights`` in
``repro.core.subproblems``.  The global-form serial solver comes with the
serial trainer in a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    nu: float = 1e-3        # ν — penalty on intermediate-layer constraints
    rho: float = 1e-3       # ρ — augmented-Lagrangian penalty, last layer
    tau_init: float = 1.0   # initial curvature for backtracking
    backtrack_growth: float = 2.0
    max_backtracks: int = 30
    fista_iters: int = 8    # inner FISTA iterations for the Z_L prox problem
    # relative acceptance slack: P(x⁺;τ) ≥ φ(x⁺) − tol·|φ| guards against
    # reduction-order float noise when ∇φ ≈ 0 (exact ties at initialization)
    backtrack_rtol: float = 1e-6


def stale_weights(ages: np.ndarray, stale_decay: float) -> np.ndarray:
    """d_r = stale_decay ** age_r (float32): the damping of a neighbour's
    consensus terms after ``age_r`` rounds without a resample.  Age 0 gives
    exactly 1.0, so a full batch reproduces the undamped objective."""
    base = np.float32(stale_decay)
    return np.power(base, np.asarray(ages).astype(np.float32))
