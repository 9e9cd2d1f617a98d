"""Privacy exposure proxy (paper App. D.1).

E_cloud  = Σ_{i∈C} tok(x_i)   — tokens transmitted in cloud payloads
Ē_cloud  = E_cloud / Σ_{i∈E∪C} tok(x_i)

where tok(x_i) counts the subtask description plus dependency answers
actually included in the request (SubtaskResult.tok_in).
"""
from __future__ import annotations

from typing import Iterable, Tuple

from repro_torch.core.scheduler import QueryResult


def exposure(result: QueryResult) -> Tuple[int, float]:
    cloud_toks = sum(r.tok_in for r in result.results.values()
                     if r.routed_cloud)
    all_toks = sum(r.tok_in for r in result.results.values())
    return cloud_toks, (cloud_toks / all_toks if all_toks else 0.0)


def mean_exposure(results: Iterable[QueryResult]) -> Tuple[float, float]:
    es, ns = [], []
    for r in results:
        e, nbar = exposure(r)
        es.append(e)
        ns.append(nbar)
    if not es:
        return 0.0, 0.0
    return sum(es) / len(es), sum(ns) / len(ns)
