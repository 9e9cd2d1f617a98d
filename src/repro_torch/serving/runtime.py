"""Multi-query serving runtime: the fleet-level front-end to HybridFlow
(counterpart of ``repro.serving.runtime``).

``ServingRuntime`` admits many ``Query`` objects at once, plans each one
(unless a pre-planned DAG is supplied), and drains them through the shared
``FleetScheduler`` event loop: ready subtasks from *all* in-flight queries
multiplex onto one edge pool and one cloud pool with round-robin fairness,
bounded admission (``max_inflight``), optional fleet-wide budget caps and
optional cloud→edge spill under saturation. ``TorchExecutor`` pairs are
auto-detected and drained through the scheduler's pump loop, so
co-scheduled subtasks decode in the same engine micro-batches. One
dispatcher runs every mode::

    rt.serve(queries)                          # closed loop (fleet)
    rt.serve(queries, mode="sequential")       # one-at-a-time baseline
    rt.serve(queries, arrivals=trace)          # open loop (timed admission)

Not ported yet, and raising ``NotImplementedError`` when asked for: the
replicated cloud ``EnginePool`` (``replicas=``), its autoscaler
(``autoscale=``) and fault injection (``faults=``) — ROADMAP Queue A.
Scheduler-side recovery (``retry=RetryPolicy(...)``) is ported with the
scheduler.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.dag import PlanDAG
from repro_torch.core.dual import TwoBudgetThreshold
from repro_torch.core.scheduler import (Executor, FleetScheduler, QueryResult,
                                  RetryPolicy, RoutingPolicy, Schedule)
from repro_torch.data.tasks import Query
from repro_torch.serving.traffic import Trace


@dataclass(frozen=True)
class ServingConfig:
    """Every ``ServingRuntime`` knob in one frozen value object.

    Admission & budgets:
      * ``max_inflight`` — concurrently admitted queries (None = no cap)
      * ``global_k_max`` / ``global_l_max`` — fleet-wide $ / wall-clock
        budget caps (see ``_global_threshold``)
      * ``spill_to_edge`` — re-route cloud-bound work to an idle edge
        slot when the cloud is saturated

    Drivers & capacity:
      * ``pump`` — event-loop driver: True = real-time pump loop,
        False = synchronous dispatch, None = auto-detect from executors
      * ``replicas`` / ``autoscale`` — the replicated, elastic cloud
        pool; not ported yet (must stay None)

    Fault tolerance:
      * ``retry`` — scheduler-side recovery (``RetryPolicy``)
      * ``faults`` — fault injection; not ported yet (must stay None)
      * ``stall_grace`` — idle seconds the pumped driver tolerates
        before declaring the fleet stalled (recovery armed only)
    """

    max_inflight: Optional[int] = 8
    global_k_max: Optional[float] = None
    global_l_max: Optional[float] = None
    spill_to_edge: bool = False
    pump: Optional[bool] = None
    replicas: Optional[int] = None
    autoscale: object = None
    retry: Optional[RetryPolicy] = None
    faults: object = None
    stall_grace: float = 5.0


@dataclass
class RuntimeReport:
    """Fleet-level outcome of one ``serve`` call (any mode)."""

    results: List[QueryResult]
    makespan: float            # simulated fleet makespan (s)
    wall_s: float              # real wall-clock spent inside the loop
    stats: Dict[str, int] = field(default_factory=dict)
    # open-loop only: offered traffic + autoscale outcome (None otherwise,
    # keeping the closed-loop report shape exactly as before)
    trace: Optional[Dict[str, object]] = None

    @property
    def n(self) -> int:
        return len(self.results)

    @property
    def qps(self) -> float:
        """Queries per simulated second (fleet throughput)."""
        return self.n / self.makespan if self.makespan > 0 else 0.0

    @property
    def accuracy(self) -> float:
        if not self.results:
            return 0.0
        return float(np.mean([r.final_correct for r in self.results]))

    @property
    def api_cost(self) -> float:
        return float(sum(r.api_cost for r in self.results))

    def latency_percentile(self, p: float) -> float:
        """Percentile of per-query makespans (admission -> finish)."""
        if not self.results:
            return 0.0
        return float(np.percentile([r.latency for r in self.results], p))

    @property
    def p50_latency(self) -> float:
        return self.latency_percentile(50)

    @property
    def p99_latency(self) -> float:
        return self.latency_percentile(99)

    def ttft_percentile(self, p: float) -> float:
        """Percentile of per-query TTFT (arrival -> first completed
        subtask); meaningful for open-loop runs."""
        if not self.results:
            return 0.0
        return float(np.percentile([r.ttft for r in self.results], p))

    @property
    def p50_ttft(self) -> float:
        return self.ttft_percentile(50)

    @property
    def p99_ttft(self) -> float:
        return self.ttft_percentile(99)

    def queue_wait_percentile(self, p: float) -> float:
        """Percentile of per-query admission wait (arrival -> admission)."""
        if not self.results:
            return 0.0
        return float(np.percentile([r.queue_wait for r in self.results], p))

    def summary(self) -> str:
        line = (f"{self.n} queries | makespan {self.makespan:.2f}s | "
                f"{self.qps:.2f} q/s | acc {self.accuracy:.2f} | "
                f"p50 {self.p50_latency:.2f}s p99 {self.p99_latency:.2f}s | "
                f"API ${self.api_cost:.4f}")
        if self.trace is not None:
            line += (f" | offered {self.trace['offered_rps']:.2f} rps | "
                     f"ttft p50 {self.p50_ttft:.2f}s "
                     f"p99 {self.p99_ttft:.2f}s | queue p99 "
                     f"{self.queue_wait_percentile(99):.2f}s")
        return line


def _global_threshold(k_max: Optional[float],
                      l_max: Optional[float]) -> Optional[TwoBudgetThreshold]:
    """Fleet-wide dual: tau hits 1.0 when k_used/k_max + l_used/l_max
    reaches 1 — with one cap set that is exactly that budget's exhaustion;
    with both set the *sum* of fractional spends is capped (a linear
    combined budget, conservative by construction). That is the point
    where FleetScheduler starts forcing edge routing."""
    if k_max is None and l_max is None:
        return None
    k = math.inf if k_max is None else max(k_max, 0.0) / 2.0
    l = math.inf if l_max is None else max(l_max, 0.0) / 2.0
    # a zero cap means "no cloud budget at all": exhausted from the start
    tau0 = 1.0 if (k == 0.0 or l == 0.0) else 0.0
    return TwoBudgetThreshold(tau0=tau0, k_max=k or math.inf,
                              l_max=l or math.inf)


class ServingRuntime:
    """Admit -> plan -> fleet-execute many queries over shared pools."""

    def __init__(self, edge: Executor, cloud: Executor,
                 policy: RoutingPolicy, *, planner=None,
                 config: Optional[ServingConfig] = None):
        cfg = config if config is not None else ServingConfig()
        self._not_ported(cfg)
        self.config = cfg
        self.edge = edge
        self.cloud = cloud
        self.policy = policy
        self.planner = planner
        self.max_inflight = cfg.max_inflight
        self.global_k_max = cfg.global_k_max
        self.global_l_max = cfg.global_l_max
        self.spill_to_edge = cfg.spill_to_edge
        self.pump = cfg.pump
        self.stall_grace = cfg.stall_grace
        self.retry = cfg.retry
        self.global_budget: Optional[TwoBudgetThreshold] = None
        self._pending: List[Tuple[Query, PlanDAG, str,
                                  Optional[Schedule]]] = []

    @staticmethod
    def _not_ported(cfg: ServingConfig) -> None:
        """The pool, autoscale and fault branches of the reference."""
        for name in ("replicas", "autoscale", "faults"):
            if getattr(cfg, name) is not None:
                raise NotImplementedError(
                    f"ServingConfig.{name} needs the replicated engine pool"
                    f"/fault injection, which is not ported yet: ROADMAP "
                    f"Queue A, pool, faults and autoscale")

    def _pool_occupancy(self, stats: Dict) -> Dict:
        """Attach the KV prefix-reuse counters of engine-backed sides."""
        for name, ex in (("edge", self.edge), ("cloud", self.cloud)):
            est = getattr(getattr(ex, "engine", None), "stats", None)
            if est is not None and "prefix_hits" in est:
                stats[f"{name}_prefix_hits"] = est["prefix_hits"]
                stats[f"{name}_prefill_tokens_saved"] = \
                    est["prefill_tokens_saved"]
        return stats

    # ---- admission ----------------------------------------------------
    def submit(self, query: Query, dag: Optional[PlanDAG] = None, *,
               plan_status: str = "valid",
               schedule_out: Optional[Schedule] = None) -> int:
        """Enqueue one query; plans it if no DAG is supplied."""
        if dag is None:
            if self.planner is None:
                raise ValueError("no DAG given and no planner configured")
            dag, plan_status = self.planner.plan(query)
        self._pending.append((query, dag, plan_status, schedule_out))
        return len(self._pending) - 1

    # ---- execution ----------------------------------------------------
    def serve(self, queries: Sequence[Query] = (), *,
              arrivals: Union[Trace, Sequence[float], None] = None,
              mode: str = "fleet") -> RuntimeReport:
        """One dispatcher for every serving mode.

        * ``mode="fleet"`` (default), no ``arrivals`` — closed loop:
          drain everything submitted (plus ``queries``) concurrently.
        * ``mode="fleet"``, ``arrivals=`` a ``Trace`` or a sequence of
          arrival times (seconds, one per query in submit order) — open
          loop: queries enter the fleet at their arrival times and the
          report carries TTFT / queue-wait / offered-RPS metrics.
        * ``mode="sequential"`` — the one-query-at-a-time baseline
          (delegates to ``serve_sequential``; no arrivals).
        """
        if mode == "sequential":
            if arrivals is not None:
                raise ValueError("arrivals= requires mode='fleet'")
            return self.serve_sequential(queries)
        if mode != "fleet":
            raise ValueError(f"unknown serve mode {mode!r} "
                             f"(expected 'fleet' or 'sequential')")
        for q in queries:
            self.submit(q)
        batch, self._pending = self._pending, []
        times: Optional[List[float]] = None
        if arrivals is not None:
            times = [float(a) for a in arrivals]
            if len(times) != len(batch):
                raise ValueError(
                    f"arrivals length {len(times)} != {len(batch)} "
                    f"queries (one arrival time per query, submit order)")
        self.global_budget = _global_threshold(self.global_k_max,
                                               self.global_l_max)
        fleet = FleetScheduler(self.edge, self.cloud,
                               max_inflight=self.max_inflight,
                               global_budget=self.global_budget,
                               spill_to_edge=self.spill_to_edge,
                               pump=self.pump, retry=self.retry,
                               stall_grace=self.stall_grace)
        for i, (q, dag, status, sched) in enumerate(batch):
            fleet.submit(q, dag, self.policy, plan_status=status,
                         schedule_out=sched,
                         arrival=times[i] if times else 0.0)
        t0 = time.perf_counter()
        results = fleet.run()
        wall = time.perf_counter() - t0
        report = RuntimeReport(
            results, fleet.makespan, wall,
            stats=self._pool_occupancy(dict(fleet.stats)))
        if times is not None:
            report.trace = self._trace_summary(arrivals, times, report)
        return report

    def serve_trace(self, trace: Trace,
                    queries: Sequence[Query] = ()) -> RuntimeReport:
        """Replay an open-loop arrival trace: ``len(trace)`` queries
        (submitted + ``queries``) enter the fleet at the trace's arrival
        times. Alias for ``serve(queries, arrivals=trace)``."""
        return self.serve(queries, arrivals=trace)

    def _trace_summary(self, arrivals, times: List[float],
                       report: RuntimeReport) -> Dict[str, object]:
        """Offered-vs-served traffic summary attached to the report."""
        horizon = arrivals.duration if isinstance(arrivals, Trace) \
            else (max(times) if times else 0.0)
        out: Dict[str, object] = {
            "n": len(times),
            "duration": float(horizon),
            "offered_rps": len(times) / horizon if horizon > 0 else 0.0,
            "served_rps": report.qps,
        }
        if isinstance(arrivals, Trace):
            out["label"] = arrivals.label
            out["seed"] = arrivals.seed
            out["target_rps"] = arrivals.target_rps
        return out

    def serve_sequential(self, queries: Sequence[Query] = ()) -> RuntimeReport:
        """One-query-at-a-time baseline (the seed's serving shape): each
        query runs alone on the pools; fleet makespan is the plain sum."""
        for q in queries:
            self.submit(q)
        batch, self._pending = self._pending, []
        self.global_budget = _global_threshold(self.global_k_max,
                                               self.global_l_max)
        results: List[QueryResult] = []
        stats: Dict[str, int] = {}
        makespan = 0.0
        t0 = time.perf_counter()
        for q, dag, status, sched in batch:
            fleet = FleetScheduler(self.edge, self.cloud,
                                   global_budget=self.global_budget,
                                   pump=self.pump, retry=self.retry,
                                   stall_grace=self.stall_grace)
            fleet.submit(q, dag, self.policy, plan_status=status,
                         schedule_out=sched)
            results.extend(fleet.run())
            makespan += fleet.makespan
            for k, v in fleet.stats.items():
                stats[k] = stats.get(k, 0) + v
        wall = time.perf_counter() - t0
        stats["peak_inflight"] = 1 if batch else 0
        return RuntimeReport(results, makespan, wall,
                             stats=self._pool_occupancy(stats))
