"""Dependency-aware subtask scheduling (paper Algorithm 1, Stage 2).

Event-driven executor over a PlanDAG: subtasks enter the ready queue the
moment their parents complete; each ready subtask is routed by a pluggable
policy and dispatched to an edge or cloud worker pool. Wall-clock latency
is the simulated makespan (edge pool has limited concurrency — the single
on-device GPU; the cloud API pool is wide), matching the paper's
concurrent edge/cloud execution. ``chain=True`` forces sequential
topological execution (HybridFlow-Chain ablation).

The event loop lives in ``FleetScheduler``, which multiplexes the ready
queues of *many* concurrent queries onto the same shared edge/cloud pools
(the fleet is the scheduling unit, not the single query): round-robin
dispatch for fairness, bounded admission, an optional *global*
TwoBudgetThreshold that forces edge execution once the fleet-wide budget
is exhausted, and optional cloud→edge spill under pool saturation.
``run_query`` is the single-query view of the same loop and reproduces
the paper's per-query Algorithm 1 exactly.

The same scheduler drives either the analytic WorldModel executor (used
for benchmark tables) or real model executors from repro_torch.serving
(used in examples/integration tests) through the Executor protocol.

Failure semantics (``retry=RetryPolicy(...)``): an executor raising from
``run``/``submit``, or a dispatched subtask exceeding ``timeout_s``, is
retried up to ``max_retries`` times with capped exponential backoff;
a *cloud* subtask that exhausts its retries degrades to the edge
executor through the same path spill uses (its attempt counter resets —
the edge is a different resource). Only an edge-side exhaustion (or
``degrade_to_edge=False``) surfaces as an error. Timed-out attempts are
charged against the per-query and global budgets (tokens already
generated cost real money even when discarded), so the utility model
stays honest under faults. With ``retry=None`` (default) any executor
exception propagates unchanged — exactly the pre-fault-tolerance
behavior, and fault-free runs are bit-identical either way.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch.core.dag import PlanDAG, Node, topological_order
from repro_torch.core.dual import TwoBudgetThreshold
from repro_torch.data.tasks import Query, Subtask, WorldModel


class Executor(Protocol):
    """One side of the edge/cloud pair."""

    concurrency: int

    def run(self, query: Query, node: Node, dep_results: Dict[int, "SubtaskResult"]
            ) -> "SubtaskResult": ...


class RoutingPolicy(Protocol):
    def decide(self, query: Query, node: Node, ctx: "SchedulerContext"
               ) -> Tuple[int, Dict]: ...

    def observe(self, query: Query, node: Node, r: int,
                result: "SubtaskResult", ctx: "SchedulerContext") -> None: ...


@dataclass
class SubtaskResult:
    sid: int
    routed_cloud: int
    correct: bool
    latency: float
    api_cost: float
    tok_in: int
    tok_out: int
    answer: str = ""
    retries: int = 0           # failed attempts absorbed before this result
    degraded: bool = False     # cloud subtask that fell back to the edge


@dataclass(frozen=True)
class RetryPolicy:
    """Scheduler-side recovery knobs (see module docstring for the
    contract). ``backoff(n)`` is the delay before attempt ``n``'s
    re-dispatch: ``min(cap, base * 2**(n-1))``."""

    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    timeout_s: Optional[float] = None   # per-attempt deadline; None = off
    degrade_to_edge: bool = True

    def backoff(self, attempt: int) -> float:
        if attempt <= 0:
            return 0.0
        return min(self.backoff_cap, self.backoff_base * 2.0 ** (attempt - 1))


@dataclass(eq=False)   # identity semantics: one pending dispatch attempt
class _Dispatch:
    """A routed subtask waiting for (or holding) an executor slot, with
    its retry lineage. Mutated in place across attempts so the recovery
    path (retry → degrade) carries state without re-routing."""

    r: int
    node: Node
    attempt: int = 0           # failures on the CURRENT side (resets on
    #                            degrade: the edge is a fresh resource)
    retries: int = 0           # total failed attempts, both sides
    degraded: bool = False
    not_before: float = 0.0    # backoff gate (fleet-clock seconds)
    hint: Optional[object] = None  # KV prefix hint (shared-context token
    #                            ids); computed once at first dispatch and
    #                            carried — because the dispatch is mutated
    #                            in place — across retry, cloud→edge
    #                            spill, and degradation re-dispatch, so a
    #                            re-routed subtask still lands where its
    #                            query's context is hot


@dataclass
class SchedulerContext:
    """Mutable per-query state visible to the routing policy."""

    k_used: float = 0.0
    l_used: float = 0.0
    position: int = 0          # how many subtasks routed so far
    tau_trace: List[float] = field(default_factory=list)
    extra: Dict = field(default_factory=dict)


@dataclass
class QueryResult:
    qid: str
    final_correct: bool
    latency: float             # makespan (s), admission -> final subtask
    api_cost: float
    results: Dict[int, SubtaskResult]
    offload: Dict[int, int]
    tau_trace: List[float]
    dag: PlanDAG
    plan_status: str = "valid"
    # open-loop (timed-admission) metrics; all zero for closed-loop runs
    # where every query arrives at t=0 and admission is immediate
    arrival: float = 0.0       # fleet-clock arrival time
    queue_wait: float = 0.0    # arrival -> admission
    ttft: float = 0.0          # arrival -> first completed subtask

    @property
    def offload_rate(self) -> float:
        if not self.offload:
            return 0.0
        return float(np.mean(list(self.offload.values())))

    @property
    def n_retries(self) -> int:
        return sum(r.retries for r in self.results.values())

    @property
    def n_degraded(self) -> int:
        return sum(1 for r in self.results.values() if r.degraded)


class WorldModelExecutor:
    """Analytic executor backed by the seeded world model."""

    # executing without a needed input (dependency dropped or ignored by
    # SoT/PASTA-style schedulers) costs this factor per missing input —
    # milder than a *wrong* input (parent_penalty), matching the paper's
    # Table 1 pattern where SoT degrades CoT only moderately
    MISSING_DEP_PENALTY = 0.72

    def __init__(self, wm: WorldModel, cloud: bool, concurrency: int):
        self.wm = wm
        self.cloud = cloud
        self.concurrency = concurrency

    def run(self, query: Query, node: Node,
            dep_results: Dict[int, SubtaskResult]) -> SubtaskResult:
        st = _subtask_of(query, node)
        prof = self.wm.profile(int(self.cloud))
        p = prof.p_correct(st.difficulty)
        # penalties follow the query's GROUND-TRUTH information needs: a
        # planner/scheduler that drops an edge doesn't remove the need
        true_deps = st.deps
        n_bad = sum(1 for d in true_deps
                    if d in dep_results and not dep_results[d].correct)
        n_missing = sum(1 for d in true_deps if d not in dep_results)
        p *= self.wm.parent_penalty ** n_bad
        p *= self.MISSING_DEP_PENALTY ** n_missing
        u = self.wm._u(query, st.sid)
        # payload includes dependency answers (App. D.1): tok_in grows
        tok_in = st.tok_in + sum(dep_results[d].tok_out // 4
                                 for d in node.deps if d in dep_results)
        lat = prof.latency(tok_in, st.tok_out)
        cost = prof.cost(tok_in, st.tok_out)
        return SubtaskResult(st.sid, int(self.cloud), bool(u < p), lat, cost,
                             tok_in, st.tok_out,
                             answer=f"[{prof.name}] answer r{st.sid}")


def _saturated(ex: Executor) -> bool:
    """Whether an executor's real backing capacity is exhausted. Engine-
    backed executors expose ``saturated()`` (live KV-slot occupancy across
    every pool replica); analytic executors don't, and for them hitting
    the busy-count cap IS saturation."""
    sat = getattr(ex, "saturated", None)
    return True if sat is None else bool(sat())


def _subtask_of(query: Query, node: Node) -> Subtask:
    for st in query.subtasks:
        if st.sid == node.sid:
            return st
    # repaired/fallback plans may have synthesized filler nodes: derive one
    return Subtask(node.sid, node.desc, node.role, node.deps,
                   difficulty=0.5, tok_in=80, tok_out=120)


@dataclass
class Schedule:
    """Full event log of one query's execution (for Fig. 3 / traces)."""

    events: List[Tuple[float, float, int, int]] = field(default_factory=list)
    # (start, end, sid, routed_cloud)


@dataclass(eq=False)   # identity semantics: states are loop bookkeeping
class _QueryState:
    """Per-query bookkeeping inside the fleet event loop."""

    query: Query
    dag: PlanDAG
    policy: RoutingPolicy
    plan_status: str
    schedule_out: Optional[Schedule]
    order: List[int]
    ctx: SchedulerContext = field(default_factory=SchedulerContext)
    results: Dict[int, SubtaskResult] = field(default_factory=dict)
    offload: Dict[int, int] = field(default_factory=dict)
    indeg: Dict[int, int] = field(default_factory=dict)
    children: Dict[int, List[int]] = field(default_factory=dict)
    ready: List[Node] = field(default_factory=list)
    waiting: List["_Dispatch"] = field(default_factory=list)
    n_done: int = 0
    done_sids: set = field(default_factory=set)
    admitted: bool = False
    admit_clock: float = 0.0
    arrival: float = 0.0                # earliest admission time (open loop)
    first_done: Optional[float] = None  # fleet clock of first completion
    result: Optional[QueryResult] = None
    index: int = -1


class _LoopState:
    """Mutable shared state of one event-loop run (either driver): the
    fleet clock, per-pool busy counts, the admission backlog and the
    admitted-unfinished set."""

    __slots__ = ("clock", "busy", "backlog", "active")

    def __init__(self, fleet: "FleetScheduler"):
        self.clock = 0.0
        self.busy = {id(fleet.edge): 0, id(fleet.cloud): 0}
        # arrival order, submit order within a tie — identical to plain
        # submit order when every arrival is 0 (the closed-loop case)
        self.backlog = sorted(
            (qs for qs in fleet._states if qs.result is None),
            key=lambda qs: (qs.arrival, qs.index))
        self.active: List[_QueryState] = []    # admitted, unfinished


class FleetScheduler:
    """Shared event loop serving N queries over one edge/cloud pool pair.

    The paper's Algorithm 1 schedules a single query's DAG; the fleet
    scheduler is its multi-tenant generalization — every admitted query
    keeps its own ready queue, routing context and (policy-held) budget
    duals, while executor slots, the simulated clock and the optional
    *global* budget are shared across the fleet:

      * subtasks are routed the moment their parents complete (Algorithm 1
        pops immediately), then wait for a free slot in their target pool;
      * slot dispatch is round-robin over queries (fair: no query can
        starve another by flooding one pool), FIFO within a query;
      * ``max_inflight`` bounds concurrently-admitted queries; the rest
        queue in submit order and are admitted as earlier queries finish;
      * a global ``TwoBudgetThreshold`` (fleet-wide $ + wall-clock
        latency budget — dl is charged as the fleet clock advances, the
        same convention the per-query duals use) forces edge execution
        once exhausted (``tau >= 1``) so cloud spend is capped without
        deadlocking in-flight queries;
      * ``spill_to_edge`` re-routes a cloud-bound subtask onto an idle
        edge slot when the cloud pool is saturated (work conservation);
      * ``pump`` selects the event-loop driver: analytic executors run
        the *simulated* clock (``ex.run`` returns a latency, the heap
        advances time); async executors (``submit``/``poll``/``pump``,
        e.g. ``TorchExecutor``) run the *real-time pump loop* — every
        dispatch enqueues into its engine, the loop keeps stepping all
        engines while routing continues, and co-scheduled subtasks from
        different queries decode in the same micro-batches. ``pump=None``
        (default) auto-detects from the executor pair.

    With one submitted query, no global budget and no spill, the loop is
    step-for-step identical to the paper's per-query scheduler (the
    ``run_query`` fast path delegates here).
    """

    def __init__(self, edge: Executor, cloud: Executor, *,
                 max_inflight: Optional[int] = None,
                 global_budget: Optional[TwoBudgetThreshold] = None,
                 spill_to_edge: bool = False,
                 pump: Optional[bool] = None,
                 retry: Optional[RetryPolicy] = None,
                 stall_grace: float = 5.0):
        if getattr(edge, "concurrency", 1) < 1 or \
                getattr(cloud, "concurrency", 1) < 1:
            raise ValueError("executor pools need concurrency >= 1")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 (or None)")
        self.edge = edge
        self.cloud = cloud
        self.max_inflight = max_inflight
        self.global_budget = global_budget
        self.spill_to_edge = spill_to_edge
        self.pump = pump
        self.retry = retry
        # with retry enabled the pumped driver tolerates idle passes (back-
        # off gates + injected stalls park work with nothing to step) up to
        # this many seconds before declaring the fleet stalled
        self.stall_grace = stall_grace
        self.makespan = 0.0
        self.stats = {"forced_edge": 0, "spills": 0, "peak_inflight": 0,
                      "dispatched": 0, "retries": 0, "timeouts": 0,
                      "degraded": 0, "exec_faults": 0, "fault_cost": 0.0}
        self._states: List[_QueryState] = []

    def _async_capable(self) -> bool:
        return all(hasattr(ex, "submit") and hasattr(ex, "poll")
                   and hasattr(ex, "pump")
                   for ex in (self.edge, self.cloud))

    # ---- admission ----------------------------------------------------
    def submit(self, query: Query, dag: PlanDAG, policy: RoutingPolicy, *,
               plan_status: str = "valid",
               schedule_out: Optional[Schedule] = None,
               arrival: float = 0.0) -> int:
        """Enqueue one planned query; returns its fleet index.

        ``arrival`` (fleet-clock seconds, default 0) is the earliest time
        the query may be admitted — open-loop traces submit every query
        up front with its arrival time and the loop admits each one when
        the clock reaches it.  ``arrival=0`` for every query is the
        closed-loop case and leaves both drivers' behavior untouched.
        """
        if dag.n == 0:
            raise ValueError("scheduler requires a non-empty DAG")
        if arrival < 0:
            raise ValueError("arrival must be >= 0")
        order = topological_order(dag)
        if order is None:
            raise ValueError("scheduler requires a DAG (run repair first)")
        qs = _QueryState(query, dag, policy, plan_status, schedule_out, order)
        qs.arrival = float(arrival)
        # dangling deps (sid not in the DAG) are ignored, matching
        # topological_order/children — otherwise the node never becomes
        # ready and the query stalls holding an admission slot forever
        sids = set(dag.sids)
        qs.indeg = {nd.sid: sum(1 for d in nd.deps if d in sids)
                    for nd in dag.nodes}
        qs.children = {nd.sid: dag.children(nd.sid) for nd in dag.nodes}
        qs.index = len(self._states)
        self._states.append(qs)
        return qs.index

    # ---- event loop ---------------------------------------------------
    def run(self) -> List[QueryResult]:
        """Drain all submitted queries; results come back in submit order."""
        use_pump = self.pump if self.pump is not None else \
            self._async_capable()
        if use_pump:
            if not self._async_capable():
                raise ValueError("pump=True needs executors with "
                                 "submit/poll/pump (e.g. TorchExecutor)")
            return self._run_pumped()
        return self._run_sim()

    def _observe_completion(self, qs: _QueryState, node: Node, r: int,
                            res: SubtaskResult, start: float, end: float,
                            prev_clock: float,
                            disp: Optional[_Dispatch] = None) -> None:
        """Shared completion bookkeeping for both event-loop drivers:
        charge per-query and fleet budgets (dl is the fleet clock advance,
        NOT the per-subtask latency sum, which would scale with
        concurrency), notify the policy, log the schedule event and
        unlock children into the ready queue."""
        if disp is not None:
            res.retries = disp.retries
            res.degraded = disp.degraded
        if qs.first_done is None:
            qs.first_done = end    # TTFT anchor: first visible output
        qs.done_sids.add(node.sid)
        qs.ctx.k_used += res.api_cost
        qs.ctx.l_used += res.latency
        if self.global_budget is not None:
            self.global_budget.spend(dk=res.api_cost, dl=end - prev_clock)
        qs.policy.observe(qs.query, node, r, res, qs.ctx)
        if qs.schedule_out is not None:
            qs.schedule_out.events.append(
                (start - qs.admit_clock, end - qs.admit_clock, node.sid, r))
        for c in qs.children[node.sid]:
            qs.indeg[c] -= 1
            if qs.indeg[c] == 0:
                qs.ready.append(qs.dag.node(c))
        qs.n_done += 1

    # ---- fault recovery ------------------------------------------------
    def _charge_fault(self, qs: _QueryState, cost: float, elapsed: float,
                      dl: float = 0.0) -> None:
        """A failed/timed-out attempt still spent real resources: charge
        the per-query duals (cost + wasted wall-clock) and the global $
        budget. ``dl`` is the global-clock advance not yet charged by a
        completion (the drivers keep the dl chain gap-free)."""
        qs.ctx.k_used += cost
        qs.ctx.l_used += elapsed
        self.stats["fault_cost"] += cost
        if self.global_budget is not None:
            self.global_budget.spend(dk=cost, dl=dl)

    def _handle_fault(self, qs: _QueryState, disp: _Dispatch,
                      err: BaseException, requeue) -> None:
        """Recovery decision for one failed attempt (executor raise or
        deadline timeout): retry with backoff while attempts remain, then
        degrade cloud→edge, then surface. ``requeue(qs, disp, delay)`` is
        driver-specific (sim: heap event; pump: not_before gate)."""
        if self.retry is None:
            raise err
        disp.attempt += 1
        disp.retries += 1
        if disp.attempt <= self.retry.max_retries:
            self.stats["retries"] += 1
            requeue(qs, disp, self.retry.backoff(disp.attempt))
        elif disp.r == 1 and self.retry.degrade_to_edge:
            # cloud exhausted: re-route to the edge through the offload
            # map (same bookkeeping the spill path uses); the edge is a
            # fresh resource, so its attempt counter starts over
            disp.r = 0
            disp.attempt = 0
            disp.degraded = True
            qs.offload[disp.node.sid] = 0
            self.stats["degraded"] += 1
            requeue(qs, disp, 0.0)
        else:
            raise RuntimeError(
                f"subtask (qid={qs.query.qid}, sid={disp.node.sid}) failed "
                f"after {disp.retries} retries on "
                f"{'cloud' if disp.r else 'edge'}"
                + (" (degraded)" if disp.degraded else "")) from err

    def _make_loop(self, st: "_LoopState", dispatch_action, fail_action,
                   live_saturation: bool = False):
        """Build the admission/routing/dispatch closures shared by both
        event-loop drivers; only the dispatch *action* differs (sim:
        ``ex.run`` + heap push; pump: ``ex.submit`` into the engine).
        Keeping these in one place is what preserves the forced-edge
        budget rule, spill policy and round-robin fairness as a single
        behavior across drivers. ``live_saturation`` (pump driver only)
        additionally gates spill on the executor's real slot occupancy —
        meaningless under the sim driver, whose requests never stay
        resident in an engine between dispatches."""

        def admit_next():
            while st.backlog and (self.max_inflight is None
                                  or len(st.active) < self.max_inflight):
                if st.backlog[0].arrival > st.clock:
                    break          # open loop: next query hasn't arrived yet
                qs = st.backlog.pop(0)
                qs.admitted = True
                qs.admit_clock = st.clock
                qs.ready = [qs.dag.node(s) for s in qs.order
                            if qs.indeg[s] == 0]
                st.active.append(qs)
                self.stats["peak_inflight"] = max(
                    self.stats["peak_inflight"], len(st.active))
                route_ready(qs)

        def route_ready(qs: _QueryState):
            # route every ready subtask immediately (Algorithm 1 pops as
            # soon as dependencies resolve); the policy sees the query's
            # own elapsed clock, not the fleet clock
            for node in list(qs.ready):
                qs.ready.remove(node)
                qs.ctx.extra["clock"] = st.clock - qs.admit_clock
                r, _info = qs.policy.decide(qs.query, node, qs.ctx)
                if (r and self.global_budget is not None
                        and self.global_budget.tau >= 1.0):
                    r = 0
                    self.stats["forced_edge"] += 1
                qs.offload[node.sid] = r
                qs.ctx.position += 1
                qs.waiting.append(_Dispatch(r, node))

        def dispatch_one(qs: _QueryState) -> bool:
            for j, disp in enumerate(qs.waiting):
                if disp.not_before > st.clock:
                    continue           # still backing off after a failure
                ex = self.cloud if disp.r else self.edge
                if st.busy[id(ex)] >= ex.concurrency:
                    # pumped driver: spill-to-edge fires only when the
                    # cloud is REALLY out of capacity — engine-backed
                    # executors report live slot occupancy via
                    # saturated() (a replica pool is saturated only
                    # when EVERY replica is full). Sim driver and
                    # executors without the hook: hitting the busy-count
                    # cap (the check that just failed above) IS
                    # saturation
                    if not (self.spill_to_edge and disp.r == 1
                            and st.busy[id(self.edge)]
                            < self.edge.concurrency
                            and (not live_saturation or _saturated(ex))):
                        continue
                    ex, disp.r = self.edge, 0
                    qs.offload[disp.node.sid] = 0
                    self.stats["spills"] += 1
                qs.waiting.pop(j)
                st.busy[id(ex)] += 1
                self.stats["dispatched"] += 1
                try:
                    dispatch_action(qs, disp, ex)
                except Exception as exc:
                    # executor refused the attempt (injected fault or real
                    # submit error): the slot was never really taken
                    st.busy[id(ex)] -= 1
                    self.stats["exec_faults"] += 1
                    fail_action(qs, disp, exc)
                return True
            return False

        def dispatch_all() -> bool:
            # round-robin over admitted-unfinished queries: one dispatch
            # per query per pass until no pool slot can take any waiting
            # subtask
            any_progress = False
            progressed = True
            while progressed:
                progressed = False
                for qs in st.active:
                    if qs.waiting:
                        progressed |= dispatch_one(qs)
                any_progress |= progressed
            return any_progress

        return admit_next, route_ready, dispatch_all

    def _stuck_dump(self, qs: _QueryState) -> str:
        """One diagnostic line for a query wedged in the loop: where every
        node sits (done / in flight / waiting+backoff / ready / blocked)
        and the budget state — enough to debug a deadlock under faults
        without re-running with a debugger attached."""
        waiting = [(d.node.sid, "cloud" if d.r else "edge", d.attempt,
                    round(d.not_before, 3)) for d in qs.waiting]
        pend = {d.node.sid for d in qs.waiting} | {n.sid for n in qs.ready}
        inflight = sorted(set(qs.offload) - qs.done_sids - pend)
        blocked = sorted(s for s, d in qs.indeg.items()
                         if d > 0 and s not in qs.done_sids)
        return (f"  qid={qs.query.qid}: admitted={qs.admitted} "
                f"done={qs.n_done}/{qs.dag.n} "
                f"ready={sorted(n.sid for n in qs.ready)} "
                f"waiting(sid,side,attempt,not_before)={waiting} "
                f"inflight={inflight} blocked(indeg>0)={blocked} "
                f"k_used={qs.ctx.k_used:.4f} l_used={qs.ctx.l_used:.3f}")

    def _collect_results(self) -> List[QueryResult]:
        stuck = [qs for qs in self._states if qs.result is None]
        if stuck:
            dump = "\n".join(self._stuck_dump(qs) for qs in stuck)
            raise RuntimeError(
                f"fleet drained with unfinished queries (scheduler bug or "
                f"malformed DAG): {[qs.query.qid for qs in stuck]}\n{dump}")
        return [qs.result for qs in self._states]

    def _run_sim(self) -> List[QueryResult]:
        """Simulated-clock driver (analytic executors). Faults become heap
        events like completions: an attempt whose analytic latency exceeds
        ``timeout_s`` schedules a "timeout" event instead of a "done" (the
        slot is held until the deadline fires, as it would be live), and a
        retry waits out its backoff as a "retry" event so the clock keeps
        advancing and the loop can never spin on a backoff gate."""
        st = _LoopState(self)
        counter = itertools.count()
        timeout_s = self.retry.timeout_s if self.retry is not None else None
        # heap rows: (time, tick, kind, qi, dispatch, start, result) with
        # kind in {"done", "timeout", "retry"}; tick breaks all ties so
        # ordering never compares beyond (time, tick)
        running: List[Tuple] = []
        # fleet clock already charged to the global dl budget: "done" pops
        # charge the full advance since the last charge, so interleaved
        # fault events leave no gaps and fault-free runs charge exactly
        # the original prev_clock chain
        dl_mark = 0.0

        def dispatch_action(qs, disp, ex):
            res = ex.run(qs.query, disp.node, qs.results)
            if timeout_s is not None and res.latency > timeout_s:
                heapq.heappush(running, (st.clock + timeout_s,
                                         next(counter), "timeout", qs.index,
                                         disp, st.clock, res))
                return
            heapq.heappush(running, (st.clock + res.latency, next(counter),
                                     "done", qs.index, disp, st.clock, res))
            qs.results[disp.node.sid] = res  # provisional (fields final)

        def requeue(qs, disp, delay):
            heapq.heappush(running, (st.clock + delay, next(counter),
                                     "retry", qs.index, disp, st.clock,
                                     None))

        def fail_action(qs, disp, exc):
            self._handle_fault(qs, disp, exc, requeue)

        admit_next, route_ready, dispatch_all = self._make_loop(
            st, dispatch_action, fail_action)
        # open loop: each future arrival is a heap event; clock 0 arrivals
        # go through the legacy immediate admission below, so closed-loop
        # runs see an identical event sequence
        for qs_ in st.backlog:
            if qs_.arrival > 0.0:
                heapq.heappush(running, (qs_.arrival, next(counter),
                                         "arrive", qs_.index, None,
                                         qs_.arrival, None))
        admit_next()
        dispatch_all()
        while running:
            t, _, kind, qi, disp, start, res = heapq.heappop(running)
            qs = self._states[qi]
            if kind == "arrive":
                st.clock = max(st.clock, t)
                admit_next()
                dispatch_all()
                continue
            if kind == "retry":
                st.clock = t
                disp.not_before = 0.0
                qs.waiting.append(disp)
                dispatch_all()
                continue
            if kind == "timeout":
                st.clock = t
                st.busy[id(self.cloud if disp.r else self.edge)] -= 1
                self.stats["timeouts"] += 1
                self._charge_fault(qs, res.api_cost, timeout_s,
                                   dl=t - dl_mark)
                dl_mark = t
                self._handle_fault(
                    qs, disp, RuntimeError(
                        f"subtask (qid={qs.query.qid}, "
                        f"sid={disp.node.sid}) exceeded deadline "
                        f"{timeout_s}s (analytic latency "
                        f"{res.latency:.3f}s)"), requeue)
                dispatch_all()
                continue
            prev_clock, st.clock = dl_mark, t
            dl_mark = t
            ex = self.cloud if disp.r else self.edge
            st.busy[id(ex)] -= 1
            self._observe_completion(qs, disp.node, disp.r, res, start,
                                     st.clock, prev_clock, disp=disp)
            route_ready(qs)
            if qs.n_done == qs.dag.n:
                self._finalize(qs, st.clock)
                st.active.remove(qs)
                admit_next()
            dispatch_all()

        self.makespan = st.clock
        return self._collect_results()

    # reprolint: hot
    def _run_pumped(self) -> List[QueryResult]:
        """Real-time driver for async executors: dispatch = ``submit`` into
        the executor's engine; a pump loop then steps every engine while
        completions are polled, so subtasks co-scheduled on one engine
        decode in the same micro-batches and the fleet clock is genuine
        wall-clock (``makespan`` == elapsed seconds)."""
        t0 = time.perf_counter()
        st = _LoopState(self)
        prev_clock = 0.0
        timeout_s = self.retry.timeout_s if self.retry is not None else None
        idle_since = 0.0
        pools = list({id(ex): ex for ex in (self.edge, self.cloud)}.values())
        # in-flight rows: [future, qs, dispatch, executor, start_clock]
        inflight: List[List] = []

        def dispatch_action(qs, disp, ex):
            kw = {}
            if getattr(ex, "accepts_prefix_hint", False):
                if disp.hint is None:
                    # computed once per dispatch; the in-place-mutated
                    # _Dispatch carries it across retry / spill / degrade
                    disp.hint = ex.shared_context(qs.query)
                kw["prefix_hint"] = disp.hint
            fut = ex.submit(qs.query, disp.node, qs.results, **kw)
            inflight.append([fut, qs, disp, ex, st.clock])

        def requeue(qs, disp, delay):
            # re-dispatch happens from the normal waiting queue once the
            # fleet clock passes the backoff gate
            disp.not_before = st.clock + delay
            qs.waiting.append(disp)

        def fail_action(qs, disp, exc):
            self._handle_fault(qs, disp, exc, requeue)

        admit_next, route_ready, dispatch_all = self._make_loop(
            st, dispatch_action, fail_action, live_saturation=True)
        # timed admission is open-loop only; with every arrival at 0 the
        # loop below takes the exact legacy control flow (no admission
        # checks or gap naps on the hot path)
        timed = any(qs.arrival > 0.0 for qs in st.backlog)
        admit_next()
        dispatch_all()
        while inflight or any(qs.waiting for qs in st.active) \
                or (timed and st.backlog):
            stepped = False
            for ex in pools:
                stepped |= bool(ex.pump())
            st.clock = time.perf_counter() - t0
            if timed and st.backlog:
                admit_next()
                if dispatch_all():
                    # freshly arrived work was placed; poll it next pass
                    idle_since = st.clock
                    continue
                if not inflight and not any(qs.waiting
                                            for qs in st.active):
                    # traffic gap: everything admitted has drained and the
                    # next arrival is in the future — keep pumping pools
                    # (autoscalers tick on wall-clock) and nap briefly
                    time.sleep(min(max(st.backlog[0].arrival - st.clock,
                                       0.0), 0.002))
                    idle_since = st.clock
                    continue
            fault_fired = False
            if timeout_s is not None:
                for row in [r_ for r_ in inflight
                            if st.clock - r_[4] > timeout_s]:
                    fut, qs, disp, ex, start = row
                    inflight.remove(row)
                    st.busy[id(ex)] -= 1
                    cancel = getattr(ex, "cancel", None)
                    if cancel is not None:
                        cancel(fut)
                    # tokens the engine already decoded for the abandoned
                    # attempt were paid for — charge them
                    cost_fn = getattr(ex, "attempt_cost", None)
                    cost = float(cost_fn(fut)) if cost_fn is not None \
                        else 0.0
                    self.stats["timeouts"] += 1
                    self._charge_fault(qs, cost, st.clock - start,
                                       dl=st.clock - prev_clock)
                    prev_clock = st.clock
                    self._handle_fault(
                        qs, disp, RuntimeError(
                            f"subtask (qid={qs.query.qid}, "
                            f"sid={disp.node.sid}) exceeded deadline "
                            f"{timeout_s}s in flight"), requeue)
                    fault_fired = True
            done_rows = []
            for row in inflight:
                res = row[3].poll(row[0])
                if res is not None:
                    done_rows.append((row, res))
            # same-tick completions are observed in (qid, sid) order, not
            # engine-poll order: policies shared across the fleet (e.g. a
            # HybridFlowPolicy LinUCB calibrator) then see an update
            # sequence that is stable across runs/replica counts even
            # when co-batched subtasks finish on the same pump pass
            done_rows.sort(key=lambda dr: (dr[0][1].query.qid,
                                           dr[0][2].node.sid))
            if not done_rows and not fault_fired:
                if self.retry is None:
                    # pre-recovery contract, preserved exactly: an idle
                    # pass with work in flight is a wiring bug
                    if not stepped:
                        raise RuntimeError(
                            "fleet pump stalled: subtasks in flight but "
                            "every engine is idle (executor/engine "
                            "mismatch?)")
                    continue
                # recovery enabled: idle passes are expected (backoff
                # gates, injected stalls) — give backoff-expired work a
                # dispatch chance, and only past the grace window does an
                # idle fleet become a hard stall
                if bool(dispatch_all()) or stepped:
                    idle_since = st.clock
                elif st.clock - idle_since > self.stall_grace:
                    raise RuntimeError(
                        f"fleet pump stalled for "
                        f"{st.clock - idle_since:.1f}s (grace "
                        f"{self.stall_grace:.1f}s) with {len(inflight)} "
                        f"subtasks in flight:\n"
                        + "\n".join(self._stuck_dump(qs)
                                    for qs in st.active))
                else:
                    time.sleep(0.001)
                continue
            for row, res in done_rows:
                _fut, qs, disp, ex, start = row
                inflight.remove(row)
                st.busy[id(ex)] -= 1
                qs.results[disp.node.sid] = res
                self._observe_completion(qs, disp.node, disp.r, res, start,
                                         st.clock, prev_clock, disp=disp)
                prev_clock = st.clock
                route_ready(qs)
                if qs.n_done == qs.dag.n:
                    self._finalize(qs, st.clock)
                    st.active.remove(qs)
                    admit_next()
            dispatch_all()
            idle_since = st.clock

        self.makespan = st.clock
        return self._collect_results()

    def _finalize(self, qs: _QueryState, clock: float) -> None:
        gen = _generate_sid(qs.dag, qs.order)
        first = qs.first_done if qs.first_done is not None else clock
        qs.result = QueryResult(
            qs.query.qid, qs.results[gen].correct, clock - qs.admit_clock,
            sum(x.api_cost for x in qs.results.values()),
            qs.results, qs.offload, list(qs.ctx.tau_trace), qs.dag,
            qs.plan_status,
            arrival=qs.arrival,
            queue_wait=max(qs.admit_clock - qs.arrival, 0.0),
            ttft=max(first - qs.arrival, 0.0))


def run_query(query: Query, dag: PlanDAG, policy: RoutingPolicy,
              edge: Executor, cloud: Executor, *, chain: bool = False,
              plan_status: str = "valid",
              schedule_out: Optional[Schedule] = None) -> QueryResult:
    """Execute one query's DAG. Returns QueryResult with simulated makespan."""
    if dag.n == 0:
        raise ValueError("scheduler requires a non-empty DAG")
    order = topological_order(dag)
    if order is None:
        raise ValueError("scheduler requires a DAG (run repair first)")

    ctx = SchedulerContext()
    results: Dict[int, SubtaskResult] = {}
    offload: Dict[int, int] = {}

    if chain:
        # sequential topological execution (HybridFlow-Chain): still routed,
        # but no concurrency — makespan is the plain sum
        t = 0.0
        for sid in order:
            node = dag.node(sid)
            ctx.extra["clock"] = t
            r, info = policy.decide(query, node, ctx)
            ex = cloud if r else edge
            res = ex.run(query, node, results)
            results[sid] = res
            offload[sid] = r
            ctx.k_used += res.api_cost
            ctx.l_used += res.latency
            ctx.position += 1
            policy.observe(query, node, r, res, ctx)
            if schedule_out is not None:
                schedule_out.events.append((t, t + res.latency, sid, r))
            t += res.latency
        gen = _generate_sid(dag, order)
        return QueryResult(query.qid, results[gen].correct, t,
                           sum(x.api_cost for x in results.values()),
                           results, offload, list(ctx.tau_trace), dag,
                           plan_status)

    # ---- event-driven concurrent execution: single-tenant fleet ------
    fleet = FleetScheduler(edge, cloud)
    fleet.submit(query, dag, policy, plan_status=plan_status,
                 schedule_out=schedule_out)
    return fleet.run()[0]


def _generate_sid(dag: PlanDAG, order: List[int]) -> int:
    for nd in dag.nodes:
        if nd.role == "GENERATE":
            return nd.sid
    return order[-1]


def run_parallel_ignore_deps(query: Query, dag: PlanDAG, policy: RoutingPolicy,
                             edge: Executor, cloud: Executor) -> QueryResult:
    """SoT-style execution: every subtask launches at t=0 with no dependency
    context (missing-parent penalty applies). Used by baselines only."""
    ctx = SchedulerContext()
    results: Dict[int, SubtaskResult] = {}
    offload: Dict[int, int] = {}
    lat_pool: Dict[int, List[float]] = {}
    for nd in dag.nodes:
        r, _ = policy.decide(query, nd, ctx)
        ex = cloud if r else edge
        res = ex.run(query, nd, {})   # no dep results available
        results[nd.sid] = res
        offload[nd.sid] = r
        ctx.k_used += res.api_cost
        ctx.l_used += res.latency
        ctx.position += 1
        policy.observe(query, nd, r, res, ctx)
        lat_pool.setdefault(id(ex), []).append(res.latency)
    # makespan: per-pool serialization by concurrency
    makespan = 0.0
    pools = {id(edge): edge, id(cloud): cloud}
    for pid, lats in lat_pool.items():
        conc = max(pools[pid].concurrency, 1)
        # greedy LPT bound: sum/conc rounded with max item
        makespan = max(makespan, max(lats), sum(lats) / conc)
    gen = _generate_sid(dag, topological_order(dag) or [dag.nodes[-1].sid])
    return QueryResult(query.qid, results[gen].correct, makespan,
                       sum(x.api_cost for x in results.values()),
                       results, offload, list(ctx.tau_trace), dag)
