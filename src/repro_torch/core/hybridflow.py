"""HybridFlow end-to-end pipeline + every baseline from the paper's tables.

Methods (Tables 1-3):
  direct(model)        — single prompt, no decomposition
  cot(model)           — sequential decomposed execution on one model
  sot(model)           — dependency-ignoring parallel execution (SoT)
  pasta(model)         — partial dependency respect (async decoding proxy)
  hybridllm            — query-level edge/cloud routing, sequential
  dot                  — per-step routing, sequential (DoT)
  hybridflow_chain     — our router, DAG parallelism disabled (ablation)
  hybridflow           — full system (Algorithm 1)
  random / fixed(τ0)   — Table 3 ablation arms
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import PlanDAG, chain_fallback
from repro_torch.core.planner import SyntheticPlanner
from repro_torch.core.scheduler import (QueryResult, RoutingPolicy, SubtaskResult,
                                  WorldModelExecutor, run_query,
                                  run_parallel_ignore_deps, Schedule)
from repro_torch.core.dual import TwoBudgetThreshold
from repro_torch.core.bandit import LinUCBCalibrator
from repro_torch.core.router import Router
from repro_torch.data.tasks import Query, WorldModel, _rng


# --------------------------------------------------------------------------
# routing policies
# --------------------------------------------------------------------------

class _BasePolicy:
    def observe(self, query, node, r, result, ctx):  # default no-op
        pass


class StaticPolicy(_BasePolicy):
    def __init__(self, r: int):
        self.r = r

    def decide(self, query, node, ctx):
        return self.r, {}


class RandomPolicy(_BasePolicy):
    def __init__(self, p: float = 0.5, seed: int = 0):
        self.p = p
        self.seed = seed

    def decide(self, query, node, ctx):
        u = float(_rng("randpolicy", self.seed, query.qid, node.sid).random())
        return int(u < self.p), {}


class FixedThresholdPolicy(_BasePolicy):
    """û_i > τ0 with no budget adaptation (Table 6 sweep arm)."""

    def __init__(self, router: Router, tau0: float):
        self.router = router
        self.tau0 = tau0

    def decide(self, query, node, ctx):
        u_hat = self.router.predict_one(node.desc, 0.0)
        ctx.tau_trace.append(self.tau0)
        return int(u_hat > self.tau0), {"u_hat": u_hat}


class QueryLevelPolicy(_BasePolicy):
    """HybridLLM-style: one routing decision for the whole query."""

    def __init__(self, router: Router, tau: float = 0.45):
        self.router = router
        self.tau = tau
        self._cache: Dict[str, int] = {}

    def decide(self, query, node, ctx):
        if query.qid not in self._cache:
            descs = [st.desc for st in query.subtasks]
            mean_u = float(np.mean(self.router.predict(descs, 0.0)))
            self._cache[query.qid] = int(mean_u > self.tau)
        return self._cache[query.qid], {}


class KnapsackPolicy(_BasePolicy):
    """Beyond-paper: per-query 0-1 knapsack allocation on PREDICTED
    utilities (App. B's DP oracle, run on û instead of the unobservable
    true Δq). Solves the whole query's allocation once when its first
    subtask is routed — a batch-planning upper baseline for the online
    threshold policy (no adaptation to realized spend)."""

    def __init__(self, router: Router, budget: float = 0.5):
        self.router = router
        self.budget = budget
        self._alloc: Dict[str, Dict[int, int]] = {}

    def _solve(self, query: Query) -> Dict[int, int]:
        from repro_torch.core.utility import knapsack_oracle, normalized_cost
        from repro_torch.data.tasks import EDGE_PROFILE, CLOUD_PROFILE
        descs = [st.desc for st in query.subtasks]
        u_hat = self.router.predict(descs, 0.0)
        cs = []
        for st in query.subtasks:
            dl = (CLOUD_PROFILE.latency(st.tok_in, st.tok_out)
                  - EDGE_PROFILE.latency(st.tok_in, st.tok_out))
            dk = CLOUD_PROFILE.cost(st.tok_in, st.tok_out)
            cs.append(normalized_cost(dl, dk))
        # value proxy: û·c ≈ Δq (û approximates Δq/c)
        vals = [float(u) * c for u, c in zip(u_hat, cs)]
        r, _ = knapsack_oracle(vals, cs, self.budget)
        return {st.sid: int(r[i]) for i, st in enumerate(query.subtasks)}

    def decide(self, query, node, ctx):
        if query.qid not in self._alloc:
            self._alloc[query.qid] = self._solve(query)
        return self._alloc[query.qid].get(node.sid, 0), {}


class HybridFlowPolicy(_BasePolicy):
    """Learned utility + online dual thresholding (+ optional LinUCB).

    Fresh per query (threshold state is per-query budget tracking, as in
    App. C Eq. 27); the bandit calibrator persists across queries.
    """

    # Defaults retuned for this world model's cost scale (paper: τ0=0.2,
    # K_max=0.02, L_max=20 — same structure, different operating point).
    def __init__(self, router: Router, *, tau0: float = 0.35,
                 k_max: float = 0.04, l_max: float = 40.0,
                 calibrator: Optional[LinUCBCalibrator] = None,
                 wm: Optional[WorldModel] = None):
        self.router = router
        self.tau0 = tau0
        self.k_max = k_max
        self.l_max = l_max
        self.calibrator = calibrator
        self.wm = wm                      # feedback source for the bandit
        self._thr: Dict[str, TwoBudgetThreshold] = {}
        self._pending: Dict[Tuple[str, int], Tuple[float, List[float], float]] = {}

    def _threshold(self, qid: str) -> TwoBudgetThreshold:
        if qid not in self._thr:
            self._thr[qid] = TwoBudgetThreshold(
                tau0=self.tau0, k_max=self.k_max, l_max=self.l_max)
        return self._thr[qid]

    def _context_features(self, node, thr) -> List[float]:
        return [1.0 - thr.c_used, len(node.deps) / 4.0,
                1.0 if node.role == "GENERATE" else 0.0]

    def decide(self, query, node, ctx):
        thr = self._threshold(query.qid)
        # "real-time budget status": latency pressure is the wall-clock
        # elapsed on this query at decision time (parallel execution means
        # elapsed < Σ latencies — the scheduler provides the clock)
        if "clock" in ctx.extra:
            thr.l_used = ctx.extra["clock"]
        u_hat = self.router.predict_one(node.desc, thr.c_used)
        tau_t = thr.tau
        if self.calibrator is not None:
            s = self._context_features(node, thr)
            u_bar = self.calibrator.ucb(u_hat, s)
            self._pending[(query.qid, node.sid)] = (u_hat, s, tau_t)
        else:
            u_bar = u_hat
        ctx.tau_trace.append(tau_t)
        r = int(u_bar > tau_t)
        return r, {"u_hat": u_hat, "u_bar": u_bar, "tau": tau_t}

    def observe(self, query, node, r, result, ctx):
        thr = self._threshold(query.qid)
        thr.spend(dk=result.api_cost, dl=0.0)  # latency tracked by wall clock
        if self.calibrator is not None and r == 1 and self.wm is not None:
            key = (query.qid, node.sid)
            if key in self._pending:
                u_hat, s, tau_t = self._pending.pop(key)
                st = next((x for x in query.subtasks if x.sid == node.sid), None)
                if st is not None:
                    dq, dl, dk = self.wm.deltas(query, st)
                    from repro_torch.core.utility import normalized_cost, utility
                    from repro_torch.core.profiler import UTILITY_GAMMA
                    # utility-scale feedback (same scale as û; Eq. 14's
                    # λ-penalty is carried by the threshold instead — a
                    # scale-consistent variant, see DESIGN.md)
                    rew = utility(dq, normalized_cost(dl, dk)) ** UTILITY_GAMMA
                    self.calibrator.update(u_hat, s, rew)


# --------------------------------------------------------------------------
# method runners
# --------------------------------------------------------------------------

@dataclass
class MethodOutput:
    name: str
    results: List[QueryResult]

    @property
    def accuracy(self) -> float:
        return float(np.mean([r.final_correct for r in self.results]))

    @property
    def latency(self) -> float:
        return float(np.mean([r.latency for r in self.results]))

    @property
    def api_cost(self) -> float:
        return float(np.mean([r.api_cost for r in self.results]))

    @property
    def offload_rate(self) -> float:
        rates = [r.offload_rate for r in self.results if r.offload]
        return float(np.mean(rates)) if rates else 0.0


@dataclass
class Pipeline:
    """Bundles the world model, planner and executors for one deployment."""

    wm: WorldModel = field(default_factory=WorldModel)
    planner: SyntheticPlanner = field(default_factory=SyntheticPlanner)
    edge_concurrency: int = 1      # one on-device accelerator
    cloud_concurrency: int = 8     # API parallelism

    def __post_init__(self):
        self.edge = WorldModelExecutor(self.wm, cloud=False,
                                       concurrency=self.edge_concurrency)
        self.cloud = WorldModelExecutor(self.wm, cloud=True,
                                        concurrency=self.cloud_concurrency)

    # ---- plan helpers -------------------------------------------------
    def plan(self, query: Query) -> Tuple[PlanDAG, str]:
        return self.planner.plan(query)

    # ---- method drivers -------------------------------------------------
    # Direct prompting solves the whole query in one draw at elevated
    # difficulty AND must not skip a needed reasoning step (completeness
    # factor). Calibrated to Table 1 direct-prompt anchors
    # (L3B 16.9 / G4.1 51.8 on GPQA).
    DIRECT_OFFSET = 0.30
    DIRECT_COMPLETENESS = 0.80

    def direct(self, queries: Sequence[Query], model: str) -> MethodOutput:
        """Single-prompt baseline: no decomposition benefit."""
        cloud = model == "cloud"
        prof = self.wm.profile(int(cloud))
        out = []
        for q in queries:
            d_agg = float(np.clip(np.mean([s.difficulty for s in q.subtasks])
                                  + self.DIRECT_OFFSET, 0, 1))
            tok_in = sum(s.tok_in for s in q.subtasks) // 2
            tok_out = int(sum(s.tok_out for s in q.subtasks) * 0.7)
            p = prof.p_correct(d_agg) * self.DIRECT_COMPLETENESS
            u = self.wm._u(q, -1)
            res = SubtaskResult(0, int(cloud), u < p,
                                prof.latency(tok_in, tok_out),
                                prof.cost(tok_in, tok_out), tok_in, tok_out)
            dag = chain_fallback(self.planner.true_dag(q))
            out.append(QueryResult(q.qid, res.correct, res.latency,
                                   res.api_cost, {0: res}, {}, [], dag))
        return MethodOutput(f"direct-{model}", out)

    def cot(self, queries: Sequence[Query], model: str) -> MethodOutput:
        pol = StaticPolicy(int(model == "cloud"))
        res = [self._run(q, pol, chain=True) for q in queries]
        return MethodOutput(f"cot-{model}", res)

    def sot(self, queries: Sequence[Query], model: str) -> MethodOutput:
        pol = StaticPolicy(int(model == "cloud"))
        out = []
        for q in queries:
            dag, status = self.plan(q)
            out.append(run_parallel_ignore_deps(q, dag, pol, self.edge, self.cloud))
        return MethodOutput(f"sot-{model}", out)

    def pasta(self, queries: Sequence[Query], model: str,
              keep_edge_prob: float = 0.5) -> MethodOutput:
        """Partial dependency respect: each edge survives w.p. keep_edge_prob."""
        pol = StaticPolicy(int(model == "cloud"))
        out = []
        for q in queries:
            dag, status = self.plan(q)
            rng = _rng("pasta", q.qid)
            nodes = []
            for nd in dag.nodes:
                deps = tuple(d for d in nd.deps
                             if rng.random() < keep_edge_prob)
                nodes.append(replace(nd, deps=deps,
                                     requires=tuple(f"r{d}" for d in deps)))
            out.append(run_query(q, PlanDAG(tuple(nodes)), pol,
                                 self.edge, self.cloud, plan_status=status))
        return MethodOutput(f"pasta-{model}", out)

    def hybridllm(self, queries: Sequence[Query], router: Router,
                  tau: float = 0.35) -> MethodOutput:
        pol = QueryLevelPolicy(router, tau)
        res = [self._run(q, pol, chain=True) for q in queries]
        return MethodOutput("hybridllm", res)

    def dot(self, queries: Sequence[Query], router: Router,
            tau0: float = 0.5) -> MethodOutput:
        pol = FixedThresholdPolicy(router, tau0)
        res = [self._run(q, pol, chain=True) for q in queries]
        return MethodOutput("dot", res)

    def random(self, queries: Sequence[Query], p: float = 0.42,
               seed: int = 0, *, chain: bool = True) -> MethodOutput:
        """Table 3 Random arm (sequential like the paper's ablation rows)."""
        pol = RandomPolicy(p, seed)
        res = [self._run(q, pol, chain=chain) for q in queries]
        return MethodOutput("random", res)

    def fixed(self, queries: Sequence[Query], router: Router,
              tau0: float = 0.5, *, chain: bool = True) -> MethodOutput:
        """Table 3/6 fixed-threshold arm (sequential; the paper's τ0=0 row
        reproduces CoT-cloud latency, so the sweep is chain-mode)."""
        pol = FixedThresholdPolicy(router, tau0)
        res = [self._run(q, pol, chain=chain) for q in queries]
        return MethodOutput(f"fixed-{tau0}", res)

    def knapsack(self, queries: Sequence[Query], router: Router,
                 budget: float = 0.5) -> MethodOutput:
        """Beyond-paper batch-DP allocation arm (upper baseline)."""
        pol = KnapsackPolicy(router, budget)
        res = [self._run(q, pol) for q in queries]
        return MethodOutput(f"knapsack-{budget}", res)

    def hybridflow(self, queries: Sequence[Query], router: Router, *,
                   chain: bool = False, calibrate: bool = False,
                   tau0: float = 0.35, k_max: float = 0.04,
                   l_max: float = 40.0,
                   schedules: Optional[List[Schedule]] = None) -> MethodOutput:
        cal = LinUCBCalibrator(dim=3) if calibrate else None
        pol = HybridFlowPolicy(router, tau0=tau0, k_max=k_max, l_max=l_max,
                               calibrator=cal, wm=self.wm)
        res = []
        for q in queries:
            sched = Schedule() if schedules is not None else None
            res.append(self._run(q, pol, chain=chain, schedule_out=sched))
            if schedules is not None:
                schedules.append(sched)
        return MethodOutput("hybridflow-chain" if chain else "hybridflow", res)

    def _run(self, q: Query, pol: RoutingPolicy, *, chain: bool = False,
             schedule_out: Optional[Schedule] = None) -> QueryResult:
        dag, status = self.plan(q)
        return run_query(q, dag, pol, self.edge, self.cloud, chain=chain,
                         plan_status=status, schedule_out=schedule_out)
