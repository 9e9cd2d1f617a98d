"""Online dual thresholding (paper Eq. 10-11 / App. B.3, App. C Eq. 27).

Two equivalent parameterizations are provided:

  * ``DualController``   — shadow-price form: λ_{t+1}=[λ_t+η(C_used−C_max)]_+,
                           τ_t = clip(τ_0 + γ λ_t, 0, 1)        (Eq. 10-11)
  * ``TwoBudgetThreshold`` — the deployed two-resource form:
                           τ_t = clip(τ_0 + k_used/2K_max + l_used/2L_max, 0, 1)
                           (App. C Eq. 27; defaults τ_0=0.2, K_max=0.02,
                           L_max=20 exactly as the paper sets them)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DualController:
    eta: float = 0.5
    tau0: float = 0.2
    gamma: float = 1.0
    c_max: float = 0.5
    lam: float = 0.0

    def update(self, c_used: float) -> float:
        """Projected subgradient ascent on the dual (Eq. 10)."""
        self.lam = max(0.0, self.lam + self.eta * (c_used - self.c_max))
        return self.lam

    @property
    def tau(self) -> float:
        """Eq. 11."""
        return min(1.0, max(0.0, self.tau0 + self.gamma * self.lam))

    def step(self, c_used: float) -> float:
        self.update(c_used)
        return self.tau


@dataclass
class TwoBudgetThreshold:
    """App. C Eq. 27 — tracks (API $, latency s) budgets separately."""

    tau0: float = 0.2
    k_max: float = 0.02     # $ per query
    l_max: float = 20.0     # seconds per query
    k_used: float = 0.0
    l_used: float = 0.0

    def spend(self, dk: float = 0.0, dl: float = 0.0) -> None:
        self.k_used += dk
        self.l_used += dl

    @property
    def tau(self) -> float:
        t = (self.tau0 + self.k_used / (2 * self.k_max)
             + self.l_used / (2 * self.l_max))
        return min(1.0, max(0.0, t))

    @property
    def c_used(self) -> float:
        """Normalized cumulative cost (for the router's budget feature)."""
        return min(1.0, 0.5 * self.k_used / self.k_max
                   + 0.5 * self.l_used / self.l_max)

    def reset(self) -> None:
        self.k_used = 0.0
        self.l_used = 0.0
