"""Contextual-bandit calibration head (paper Eq. 13-14).

Calibrated utility  ũ_i = clip(α û_i + β + wᵀ s_i, 0, 1)  with (α, β, w)
updated online from *partial feedback*: the reward R_i = Δq_i − λ_t c_i is
observed only when the subtask was offloaded (r_i = 1). We use LinUCB on
the feature x = [û_i, 1, s_i]: the point estimate supplies the calibrated
utility, the UCB bonus drives exploration of offloading.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class LinUCBCalibrator:
    dim: int                      # len(s_i) context features
    alpha_ucb: float = 0.5        # exploration width
    ridge: float = 1.0
    A: np.ndarray = field(init=False)
    b: np.ndarray = field(init=False)

    def __post_init__(self):
        d = self.dim + 2          # [û, 1, s]
        self.A = np.eye(d) * self.ridge
        # warm-start prior θ0 = e1 (α=1, β=w=0): ũ == û until evidence
        # accumulates, so enabling calibration never degrades a well-
        # calibrated router from step 0
        self.b = np.zeros(d)
        self.b[0] = self.ridge

    def _x(self, u_hat: float, s: Sequence[float]) -> np.ndarray:
        return np.concatenate([[u_hat, 1.0], np.asarray(s, float)])

    @property
    def theta(self) -> np.ndarray:
        return np.linalg.solve(self.A, self.b)

    def calibrated(self, u_hat: float, s: Sequence[float]) -> float:
        """ũ point estimate (Eq. 13): α û + β + wᵀ s."""
        x = self._x(u_hat, s)
        return float(np.clip(self.theta @ x, 0.0, 1.0))

    def ucb(self, u_hat: float, s: Sequence[float]) -> float:
        """Optimistic utility used for the offload decision."""
        x = self._x(u_hat, s)
        width = np.sqrt(x @ np.linalg.solve(self.A, x))
        return float(np.clip(self.theta @ x + self.alpha_ucb * width, 0.0, 1.0))

    def update(self, u_hat: float, s: Sequence[float], reward: float) -> None:
        """Partial feedback: call only when the subtask was offloaded."""
        x = self._x(u_hat, s)
        self.A += np.outer(x, x)
        self.b += reward * x


def reward(dq: float, lam: float, c: float) -> float:
    """R_i = Δq_i − λ_t c_i (Eq. 14)."""
    return dq - lam * c
