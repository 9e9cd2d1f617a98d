"""HybridFlow core — the paper's primary contribution.

Dependency-aware DAG decomposition (dag, planner), utility-based
budget-adaptive routing (utility, router, dual, bandit), dependency-
triggered scheduling (scheduler), offline credit assignment (profiler),
and the end-to-end pipeline with all paper baselines (hybridflow).
The router is PyTorch; every other module is framework-free.
"""
__all__ = [
    "PlanDAG", "Node", "validate", "repair", "chain_fallback",
    "topological_order", "critical_path_length", "compression_ratio",
    "SyntheticPlanner", "parse_plan", "plan_to_xml", "decompose",
    "Router", "RouterConfig", "train_router",
    "FleetScheduler", "QueryResult", "Schedule", "SubtaskResult",
    "run_query",
    "DualController", "TwoBudgetThreshold", "LinUCBCalibrator",
    "Pipeline", "HybridFlowPolicy", "MethodOutput",
    "train_default_router", "profile_queries",
]

from repro_torch.core.dag import (PlanDAG, Node, validate, repair,
                                  chain_fallback, topological_order,
                                  critical_path_length, compression_ratio)
from repro_torch.core.planner import (SyntheticPlanner, parse_plan,
                                      plan_to_xml, decompose)
from repro_torch.core.router import Router, RouterConfig, train_router
from repro_torch.core.scheduler import (FleetScheduler, QueryResult,
                                        Schedule, SubtaskResult, run_query)
from repro_torch.core.dual import DualController, TwoBudgetThreshold
from repro_torch.core.bandit import LinUCBCalibrator
from repro_torch.core.hybridflow import (Pipeline, HybridFlowPolicy,
                                         MethodOutput)
from repro_torch.core.profiler import train_default_router, profile_queries
