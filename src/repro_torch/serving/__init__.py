"""Real-model serving in PyTorch: the slot-batched engine, the Executor
adapter, the multi-query fleet runtime and open-loop traffic traces
(counterpart of ``repro.serving``).

* :class:`ServingRuntime` — admit → plan → fleet-execute; every knob lives
  on the frozen :class:`ServingConfig`.
* :class:`~repro_torch.serving.traffic.Trace` — seeded arrival schedules.
* :class:`ServingEngine` / :class:`TorchExecutor` — one KV slot pool per
  model on the card, and its HybridFlow executor.
* :class:`EngineLike` — the protocol an engine backing implements.

EngineLike protocol
-------------------
``TorchExecutor`` types against :class:`EngineLike`:

* ``submit(prompt, **kw) -> Request`` — enqueue; the request is the future
* ``step() -> list[Request]`` — one admit/prefill/decode pass
* ``pump() -> bool`` — step only if there is work; returns progress
* ``cancel(req) -> bool`` — withdraw a request, freeing its KV slot
* ``saturated() -> bool`` — no free KV slot
* ``run_until(req) -> Request`` — synchronous drain for one request
* ``capacity`` / ``load`` / ``has_work`` / ``stats`` — slot capacity,
  active+queued requests, pending-work flag, counters dict

The replicated ``EnginePool``, its autoscaler and fault injection are not
ported yet (ROADMAP Queue A); the runtime raises ``NotImplementedError``
when a ``ServingConfig`` asks for them.
"""
from typing import List, Protocol, runtime_checkable

from repro_torch.core.scheduler import RetryPolicy
from repro_torch.serving.engine import Request, ServingEngine, TorchExecutor
from repro_torch.serving.runtime import (RuntimeReport, ServingConfig,
                                         ServingRuntime)
from repro_torch.serving.traffic import Phase, Trace, day_cycle


@runtime_checkable
class EngineLike(Protocol):
    """What ``TorchExecutor`` (and the fleet loop through it) requires of
    an engine backing. Implemented by ``ServingEngine``."""

    @property
    def capacity(self) -> int: ...

    @property
    def load(self) -> int: ...

    @property
    def has_work(self) -> bool: ...

    @property
    def stats(self) -> dict: ...

    def submit(self, prompt, **kw) -> Request: ...

    def step(self) -> List[Request]: ...

    def pump(self) -> bool: ...

    def cancel(self, req: Request) -> bool: ...

    def saturated(self) -> bool: ...

    def run_until(self, req: Request, max_steps: int = 10_000) -> Request: ...


__all__ = ["EngineLike", "Phase", "Request", "RetryPolicy", "RuntimeReport",
           "ServingConfig", "ServingEngine", "ServingRuntime",
           "TorchExecutor", "Trace", "day_cycle"]
