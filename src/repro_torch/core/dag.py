"""Task-decomposition DAG: validation, bounded repair, scheduling order.

Implements Definition C.1/C.2 and the validation-and-repair procedure of
HybridFlow App. C: a plan is valid iff it is (1) acyclic, (2) rooted at a
unique EXPLAIN node with no prerequisites, (3) fully reachable from the
root, (4) has exactly one GENERATE sink, (5) has at most n_max nodes, and
(6) is dependency-consistent (Req(t_i) ⊆ ∪_{j∈P_i} Prod(t_j)). Invalid
plans get at most R_max deterministic repair rounds; if still invalid the
plan falls back to a sequential chain (paper: R_max=2, n_max=7).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Set, Tuple

N_MAX = 7
R_MAX = 2

ROLES = ("EXPLAIN", "ANALYZE", "GENERATE")


@dataclass(frozen=True)
class Node:
    """One subtask in a plan DAG (Definition C.1)."""

    sid: int
    desc: str
    role: str                          # EXPLAIN | ANALYZE | GENERATE
    deps: Tuple[int, ...] = ()
    requires: Tuple[str, ...] = ()     # Req(t_i) symbols
    produces: Tuple[str, ...] = ()     # Prod(t_i) symbols
    confidence: Dict[int, float] = field(default_factory=dict)  # per-edge


@dataclass(frozen=True)
class PlanDAG:
    nodes: Tuple[Node, ...]

    @property
    def n(self) -> int:
        return len(self.nodes)

    def node(self, sid: int) -> Node:
        for nd in self.nodes:
            if nd.sid == sid:
                return nd
        raise KeyError(sid)

    @property
    def sids(self) -> List[int]:
        return [nd.sid for nd in self.nodes]

    def children(self, sid: int) -> List[int]:
        return [nd.sid for nd in self.nodes if sid in nd.deps]


@dataclass(frozen=True)
class ValidationResult:
    ok: bool
    errors: Tuple[str, ...] = ()


def validate(dag: PlanDAG, n_max: int = N_MAX) -> ValidationResult:
    errs: List[str] = []
    sids = dag.sids
    if len(set(sids)) != len(sids):
        errs.append("duplicate-ids")
    sid_set = set(sids)
    for nd in dag.nodes:
        for d in nd.deps:
            if d not in sid_set:
                errs.append(f"dangling-edge:{nd.sid}->{d}")
            if d == nd.sid:
                errs.append(f"self-edge:{nd.sid}")
    if dag.n > n_max:
        errs.append("too-many-nodes")
    if dag.n == 0:
        return ValidationResult(False, ("empty",))
    # acyclicity via Kahn
    order = topological_order(dag)
    if order is None:
        errs.append("cycle")
    # rooted plan: unique EXPLAIN node with no deps
    roots = [nd for nd in dag.nodes if not nd.deps]
    explain_roots = [nd for nd in roots if nd.role == "EXPLAIN"]
    if len(explain_roots) != 1 or len(roots) != 1:
        errs.append("not-rooted")
    # reachability from root
    elif order is not None:
        root = explain_roots[0].sid
        reach = {root}
        for sid in order:
            if sid == root:
                continue
            if any(d in reach for d in dag.node(sid).deps):
                reach.add(sid)
        if reach != sid_set:
            errs.append("unreachable")
    # GENERATE sinks: exactly one, and GENERATE nodes must be sinks
    gens = [nd for nd in dag.nodes if nd.role == "GENERATE"]
    if len(gens) != 1:
        errs.append("generate-count")
    for nd in gens:
        if dag.children(nd.sid):
            errs.append("generate-not-sink")
    # dependency consistency: Req ⊆ ∪ Prod(parents)
    for nd in dag.nodes:
        avail: Set[str] = set()
        for d in nd.deps:
            if d in sid_set:
                avail |= set(dag.node(d).produces)
        if not set(nd.requires) <= avail:
            errs.append(f"req-unmet:{nd.sid}")
    return ValidationResult(not errs, tuple(errs))


def topological_order(dag: PlanDAG) -> Optional[List[int]]:
    """Kahn's algorithm; None if cyclic. Stable (ascending sid) tiebreak."""
    sid_set = set(dag.sids)
    indeg = {nd.sid: sum(1 for d in nd.deps if d in sid_set) for nd in dag.nodes}
    ready = sorted(s for s, d in indeg.items() if d == 0)
    out: List[int] = []
    while ready:
        s = ready.pop(0)
        out.append(s)
        for c in dag.children(s):
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
                ready.sort()
    return out if len(out) == len(dag.nodes) else None


def critical_path_length(dag: PlanDAG) -> int:
    """L_crit — longest chain (#nodes) through the DAG (Table 7 R_comp)."""
    order = topological_order(dag)
    if order is None:
        return dag.n
    depth = {}
    for sid in order:
        nd = dag.node(sid)
        depth[sid] = 1 + max((depth[d] for d in nd.deps if d in depth), default=0)
    return max(depth.values(), default=0)


def compression_ratio(dag: PlanDAG) -> float:
    """R_comp = (n - L_crit) / n   (paper Eq. 28)."""
    if dag.n == 0:
        return 0.0
    return (dag.n - critical_path_length(dag)) / dag.n


def chain_fallback(dag: PlanDAG) -> PlanDAG:
    """Sequential chain with canonical roles (the paper's fallback)."""
    nodes = []
    n = dag.n
    for i, nd in enumerate(sorted(dag.nodes, key=lambda x: x.sid)):
        role = "EXPLAIN" if i == 0 else ("GENERATE" if i == n - 1 else "ANALYZE")
        deps = (nodes[-1].sid,) if nodes else ()
        req = nodes[-1].produces if nodes else ()
        nodes.append(replace(nd, role=role, deps=deps, requires=req,
                             produces=(f"r{nd.sid}",)))
    return PlanDAG(tuple(nodes))


def _break_cycles(dag: PlanDAG) -> PlanDAG:
    """Remove the lowest-confidence edge of each cycle found (App. C (ii))."""
    nodes = {nd.sid: nd for nd in dag.nodes}
    # iterate: while cyclic, find a cycle by DFS and cut its weakest edge
    for _ in range(dag.n * dag.n + 1):
        d = PlanDAG(tuple(nodes.values()))
        if topological_order(d) is not None:
            return d
        cycle = _find_cycle(d)
        if not cycle:
            return d
        # edges along the cycle: (dep -> node) pairs
        edges = [(cycle[i], cycle[(i + 1) % len(cycle)]) for i in range(len(cycle))]
        def conf(e):
            dep, s = e
            return nodes[s].confidence.get(dep, 0.5), -dep, -s  # deterministic
        dep, s = min(edges, key=conf)
        nd = nodes[s]
        nodes[s] = replace(nd, deps=tuple(x for x in nd.deps if x != dep))
    return PlanDAG(tuple(nodes.values()))


def _find_cycle(dag: PlanDAG) -> List[int]:
    color = {s: 0 for s in dag.sids}
    stack: List[int] = []

    def dfs(s) -> Optional[List[int]]:
        color[s] = 1
        stack.append(s)
        for c in dag.children(s):
            if color[c] == 1:
                i = stack.index(c)
                return stack[i:]
            if color[c] == 0:
                r = dfs(c)
                if r:
                    return r
        color[s] = 2
        stack.pop()
        return None

    for s in sorted(color):
        if color[s] == 0:
            r = dfs(s)
            if r:
                return r
    return []


def repair(dag: PlanDAG, *, n_max: int = N_MAX, r_max: int = R_MAX
           ) -> Tuple[PlanDAG, str]:
    """Bounded deterministic repair (App. C). Returns (dag, status) with
    status ∈ {valid, repaired, fallback}."""
    if validate(dag, n_max).ok:
        return dag, "valid"
    cur = dag
    for _ in range(r_max):
        cur = _repair_round(cur, n_max)
        if validate(cur, n_max).ok:
            return cur, "repaired"
    return chain_fallback(dag), "fallback"


def _repair_round(dag: PlanDAG, n_max: int) -> PlanDAG:
    nodes = {nd.sid: nd for nd in dag.nodes}
    sid_set = set(nodes)
    # (o) drop self/dangling edges; dedupe ids handled by dict construction
    for s, nd in list(nodes.items()):
        deps = tuple(d for d in nd.deps if d in sid_set and d != s)
        if deps != nd.deps:
            nodes[s] = replace(nd, deps=deps)
    # (i) remove ill-typed edges (dependency-consistency violations):
    # an edge j->i whose Prod(j) contributes nothing to Req(i) *and* whose
    # removal doesn't orphan i is dropped only when the req-check fails
    for s, nd in list(nodes.items()):
        if not nd.requires:
            continue
        avail = {sym for d in nd.deps for sym in nodes[d].produces}
        if not set(nd.requires) <= avail:
            # relax requirements we cannot satisfy (planner hallucinated them)
            nodes[s] = replace(nd, requires=tuple(r for r in nd.requires
                                                  if r in avail))
    # (ii) break cycles at lowest-confidence edges
    d = _break_cycles(PlanDAG(tuple(nodes.values())))
    nodes = {nd.sid: nd for nd in d.nodes}
    # size constraint: merge trailing extra nodes into the last n_max
    if len(nodes) > n_max:
        keep = sorted(nodes)[:n_max]
        kept = set(keep)
        for s in list(nodes):
            if s not in kept:
                del nodes[s]
        for s, nd in list(nodes.items()):
            nodes[s] = replace(nd, deps=tuple(x for x in nd.deps if x in kept))
    # (iii) enforce rootedness/reachability: unique EXPLAIN root, orphans
    # attach to it
    sids = sorted(nodes)
    root = None
    for s in sids:
        if nodes[s].role == "EXPLAIN" and not nodes[s].deps:
            root = s
            break
    if root is None:
        root = sids[0]
        nodes[root] = replace(nodes[root], role="EXPLAIN", deps=(), requires=())
    for s in sids:
        if s == root:
            # root must have no deps
            if nodes[s].deps:
                nodes[s] = replace(nodes[s], deps=(), requires=())
            continue
        if nodes[s].role == "EXPLAIN":
            nodes[s] = replace(nodes[s], role="ANALYZE")
        if not nodes[s].deps:
            nodes[s] = replace(nodes[s], deps=(root,))
    # reachability: attach any unreachable node to the root
    d = PlanDAG(tuple(nodes[s] for s in sorted(nodes)))
    order = topological_order(d)
    if order is not None:
        reach = {root}
        for sid in order:
            if sid != root and any(x in reach for x in nodes[sid].deps):
                reach.add(sid)
        for s in sids:
            if s not in reach:
                nodes[s] = replace(nodes[s], deps=tuple(set(nodes[s].deps) | {root}))
    # (iv) exactly one GENERATE sink: demote non-sink GENERATEs, promote the
    # last sink if none
    d = PlanDAG(tuple(nodes[s] for s in sorted(nodes)))
    gens = [s for s in sorted(nodes) if nodes[s].role == "GENERATE"]
    sinks = [s for s in sorted(nodes) if not d.children(s)]
    for s in gens:
        if d.children(s) or s != gens[-1]:
            nodes[s] = replace(nodes[s], role="ANALYZE")
    gens = [s for s in sorted(nodes) if nodes[s].role == "GENERATE"]
    if not gens and sinks:
        last = sinks[-1]
        if last == root and len(nodes) > 1:
            last = sorted(nodes)[-1]
        if last != root:
            nodes[last] = replace(nodes[last], role="GENERATE")
    # make the GENERATE node a sink by dropping out-edges
    gens = [s for s in sorted(nodes) if nodes[s].role == "GENERATE"]
    if gens:
        g = gens[0]
        for s, nd in list(nodes.items()):
            if g in nd.deps:
                nodes[s] = replace(nd, deps=tuple(x for x in nd.deps if x != g))
    return PlanDAG(tuple(nodes[s] for s in sorted(nodes)))
