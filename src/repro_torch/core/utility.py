"""Utility model + knapsack formulation (paper §3.1, App. B).

  c_i = ½·Δl_i/l_max + ½·Δk_i/k_max           (Eq. 1 / Eq. 24)
  u_i = clip(Δq_i / (c_i + ε), 0, 1)           (Eq. 2 / Eq. 25)

plus the 0-1 knapsack DP oracle (App. B.1 — the upper bound HybridFlow's
learned router approximates) and the Lagrangian threshold policy
r*_i(λ) = 1[Δq_i/c_i > λ] (Eq. 6 / Eq. 18-19).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

EPS = 1e-4
# App. C Eq. 24 normalization scales: 10 s latency, $0.02 API cost
L_MAX_SUB = 10.0
K_MAX_SUB = 0.02


def normalized_cost(dl: float, dk: float, *, l_max: float = L_MAX_SUB,
                    k_max: float = K_MAX_SUB) -> float:
    """Eq. 1/24 (clipped to [0,1])."""
    return float(np.clip(0.5 * dl / l_max + 0.5 * dk / k_max, 0.0, 1.0))


def utility(dq: float, c: float, *, eps: float = EPS) -> float:
    """Eq. 2/25."""
    return float(np.clip(dq / (c + eps), 0.0, 1.0))


def lagrangian_policy(dq: Sequence[float], c: Sequence[float], lam: float
                      ) -> np.ndarray:
    """r*_i(λ) = 1[Δq_i - λ c_i > 0] (Eq. 6)."""
    dq = np.asarray(dq, float)
    c = np.asarray(c, float)
    return (dq - lam * c > 0).astype(np.int64)


def knapsack_oracle(dq: Sequence[float], c: Sequence[float], budget: float,
                    *, grid: int = 1000) -> Tuple[np.ndarray, float]:
    """0-1 knapsack via DP on a discretized weight grid (App. B.1).

    Returns (allocation r, total value). Weights are FLOOR-discretized, so
    every continuously-feasible allocation stays feasible and the DP value
    UPPER-bounds the true optimum (the oracle's role in the paper: the
    bound the learned router approximates). The returned allocation may
    overshoot the budget by at most n/grid.
    """
    dq = np.asarray(dq, float)
    c = np.asarray(c, float)
    n = len(dq)
    W = int(np.floor(budget * grid + 1e-9))
    w = np.minimum(np.floor(c * grid + 1e-9).astype(int), grid * 10)
    w = np.maximum(w, 0)
    # value-maximizing DP; dp[j] = best value with weight <= j
    dp = np.zeros(W + 1)
    choice = np.zeros((n, W + 1), dtype=bool)
    for i in range(n):
        if dq[i] <= 0:
            continue
        wi = w[i]
        if wi > W:
            continue
        cand = np.concatenate([np.zeros(wi), dp[:W + 1 - wi] + dq[i]])
        take = cand > dp
        choice[i] = take
        dp = np.where(take, cand, dp)
    # backtrack
    r = np.zeros(n, dtype=np.int64)
    j = W
    for i in range(n - 1, -1, -1):
        if choice[i, j]:
            r[i] = 1
            j -= w[i]
    return r, float(np.sum(dq * r))


def greedy_ratio(dq: Sequence[float], c: Sequence[float], budget: float
                 ) -> np.ndarray:
    """Greedy benefit-cost ratio baseline (the relaxation's integral greedy)."""
    dq = np.asarray(dq, float)
    c = np.asarray(c, float)
    order = np.argsort(-dq / (c + EPS))
    r = np.zeros(len(dq), dtype=np.int64)
    used = 0.0
    for i in order:
        if dq[i] > 0 and used + c[i] <= budget:
            r[i] = 1
            used += c[i]
    return r


@dataclass(frozen=True)
class UnifiedMetric:
    """Paper Table 3/6 unified (normalized cost c, utility u) per method.

    Reverse-engineered from the paper's own numbers (Cloud row: lat 18.26,
    k 0.0185, edge-only lat 11.99 -> c = ½·0.0185/0.02 + ½·6.27/10 = 0.776
    and u = (57.28-25.54)/100 / 0.776 = 0.409, matching Table 3 exactly):
    both Δl and Δk are measured *relative to the Edge-only baseline*, with
    the per-subtask scales of Eq. 24 (10 s, $0.02).
    """

    accuracy: float
    latency: float
    api_cost: float

    def normalized_cost(self, *, edge_latency: float, edge_cost: float = 0.0,
                        l_scale: float = L_MAX_SUB,
                        k_scale: float = K_MAX_SUB) -> float:
        dl = self.latency - edge_latency
        dk = self.api_cost - edge_cost
        return float(np.clip(0.5 * dl / l_scale + 0.5 * dk / k_scale,
                             0.0, 1.0))

    def utility(self, edge_accuracy: float, edge_latency: float,
                edge_cost: float = 0.0) -> float:
        """Accuracy gain over edge-only per unit normalized cost."""
        dq = self.accuracy - edge_accuracy
        c = self.normalized_cost(edge_latency=edge_latency, edge_cost=edge_cost)
        return float(np.clip(dq / (c + EPS), 0.0, 1.0))
