"""Open-loop traffic: seeded arrival schedules and a replayable trace format.

Closed-loop benchmarks admit every query at t=0 and measure makespan;
a service under real traffic sees *arrivals* — bursty Poisson streams
with diurnal ramps, peaks, and zero-traffic gaps.  This module generates
those arrival schedules deterministically from a seed and packages them
as a :class:`Trace` that ``ServingRuntime.serve_trace`` can replay.

The rate profile is a sequence of :class:`Phase` segments (flat rate or
linear ramp); arrivals are drawn from the resulting non-homogeneous
Poisson process by thinning: sample a homogeneous process at the peak
rate, keep each point with probability ``rate(t) / rate_max``.  Same
seed + same phases => bit-identical schedule.

A :class:`Trace` is immutable and replayable: it round-trips through
JSON (``to_json`` / ``from_json``), and ``scaled()`` compresses the
wall-clock so a 60 s logical trace replays in a few seconds of test
time while keeping the same arrival *pattern*.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Phase",
    "Trace",
    "day_cycle",
]


@dataclass(frozen=True)
class Phase:
    """One segment of a rate profile.

    ``rps`` is the arrival rate at the start of the phase; when
    ``rps_end`` is set the rate ramps linearly to it over ``duration``
    seconds, otherwise the phase is flat.  ``rps=0`` models a
    zero-traffic gap.
    """

    duration: float
    rps: float
    rps_end: Optional[float] = None

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"Phase duration must be > 0, got {self.duration}")
        if self.rps < 0 or (self.rps_end is not None and self.rps_end < 0):
            raise ValueError("Phase rates must be >= 0")

    @property
    def peak(self) -> float:
        return max(self.rps, self.rps if self.rps_end is None else self.rps_end)

    @property
    def mean_rps(self) -> float:
        if self.rps_end is None:
            return self.rps
        return 0.5 * (self.rps + self.rps_end)

    def rate_at(self, t: float) -> float:
        """Instantaneous rate ``t`` seconds into this phase."""
        if self.rps_end is None:
            return self.rps
        frac = min(max(t / self.duration, 0.0), 1.0)
        return self.rps + (self.rps_end - self.rps) * frac


def day_cycle(*, base_rps: float, peak_rps: float,
              duration: float = 86400.0) -> Tuple[Phase, ...]:
    """A compressed diurnal profile: night trough, morning ramp, midday
    peak, evening decay back to the base rate, late-night gap.

    The segment fractions are fixed so the same (base, peak, duration)
    always yields the same profile; pass the result to
    :meth:`Trace.from_phases`.
    """
    if peak_rps < base_rps:
        raise ValueError("peak_rps must be >= base_rps")
    d = float(duration)
    return (
        Phase(0.20 * d, base_rps),                       # night trough
        Phase(0.15 * d, base_rps, rps_end=peak_rps),     # morning ramp
        Phase(0.25 * d, peak_rps),                       # midday peak
        Phase(0.20 * d, peak_rps, rps_end=base_rps),     # evening decay
        Phase(0.20 * d, base_rps),                       # late evening
    )


def _thin(phases: Sequence[Phase], seed: int) -> List[float]:
    """Non-homogeneous Poisson arrivals over ``phases`` by thinning."""
    rate_max = max((p.peak for p in phases), default=0.0)
    horizon = sum(p.duration for p in phases)
    if rate_max <= 0.0 or horizon <= 0.0:
        return []
    # phase lookup by cumulative start time
    starts: List[float] = []
    acc = 0.0
    for p in phases:
        starts.append(acc)
        acc += p.duration

    def rate_at(t: float) -> float:
        # phases are few; linear scan keeps this dependency-free
        for start, p in zip(reversed(starts), reversed(phases)):
            if t >= start:
                return p.rate_at(t - start)
        return phases[0].rate_at(t)

    rng = np.random.default_rng(seed)
    arrivals: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t >= horizon:
            break
        if float(rng.random()) * rate_max < rate_at(t):
            arrivals.append(t)
    return arrivals


@dataclass(frozen=True)
class Trace:
    """A replayable arrival schedule.

    ``arrivals`` are seconds from trace start, sorted ascending.
    ``target_rps`` is the *nominal* mean rate of the generating profile
    (integral of the rate over the horizon divided by the horizon);
    ``mean_rps`` is what the draw actually realised.
    """

    arrivals: Tuple[float, ...]
    duration: float
    seed: int = 0
    target_rps: Optional[float] = None
    label: str = "trace"
    phases: Tuple[Phase, ...] = field(default=(), repr=False)

    def __post_init__(self):
        arr = tuple(float(a) for a in self.arrivals)
        if any(b < a for a, b in zip(arr, arr[1:])):
            arr = tuple(sorted(arr))
        object.__setattr__(self, "arrivals", arr)
        if self.duration <= 0:
            raise ValueError("Trace duration must be > 0")

    # -- shape ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.arrivals)

    def __iter__(self):
        return iter(self.arrivals)

    @property
    def n(self) -> int:
        return len(self.arrivals)

    @property
    def mean_rps(self) -> float:
        """Realised mean arrival rate over the trace horizon."""
        return self.n / self.duration

    def largest_gap(self) -> float:
        """Longest inter-arrival gap (including the leading/trailing
        edges of the horizon) — the window an autoscaler can go idle in."""
        if not self.arrivals:
            return self.duration
        pts = (0.0,) + self.arrivals + (self.duration,)
        return max(b - a for a, b in zip(pts, pts[1:]))

    # -- construction --------------------------------------------------
    @classmethod
    def poisson(cls, rps: float, duration: float, *, seed: int = 0,
                label: str = "poisson") -> "Trace":
        """Homogeneous Poisson arrivals at ``rps`` for ``duration`` s."""
        return cls.from_phases([Phase(duration, rps)], seed=seed, label=label)

    @classmethod
    def from_phases(cls, phases: Sequence[Phase], *, seed: int = 0,
                    label: str = "phased") -> "Trace":
        """Non-homogeneous Poisson arrivals over a phase profile."""
        phases = tuple(phases)
        if not phases:
            raise ValueError("need at least one Phase")
        horizon = sum(p.duration for p in phases)
        target = sum(p.mean_rps * p.duration for p in phases) / horizon
        return cls(arrivals=tuple(_thin(phases, seed)), duration=horizon,
                   seed=seed, target_rps=target, label=label, phases=phases)

    @classmethod
    def bursty(cls, *, base_rps: float, duration: float, burst_rps: float,
               burst_at: float, burst_s: float, gap_at: Optional[float] = None,
               gap_s: float = 0.0, seed: int = 0,
               label: str = "bursty") -> "Trace":
        """Flat base traffic with one burst and an optional dead gap.

        Segments must fit inside ``duration`` in the order
        base | burst | base | gap | base; the gap (rate 0) must start
        after the burst ends.
        """
        marks = [(burst_at, burst_s, burst_rps)]
        if gap_at is not None and gap_s > 0:
            if gap_at < burst_at + burst_s:
                raise ValueError("gap must start after the burst ends")
            marks.append((gap_at, gap_s, 0.0))
        phases: List[Phase] = []
        t = 0.0
        for at, length, rate in marks:
            if at < t or at + length > duration:
                raise ValueError("burst/gap segment outside the trace horizon")
            if at > t:
                phases.append(Phase(at - t, base_rps))
            phases.append(Phase(length, rate))
            t = at + length
        if t < duration:
            phases.append(Phase(duration - t, base_rps))
        return cls.from_phases(phases, seed=seed, label=label)

    # -- transforms ----------------------------------------------------
    def scaled(self, factor: float) -> "Trace":
        """Compress (factor < 1) or stretch the wall-clock while keeping
        the arrival pattern: times and duration scale by ``factor``,
        rates by ``1/factor``."""
        if factor <= 0:
            raise ValueError("scale factor must be > 0")
        return replace(
            self,
            arrivals=tuple(a * factor for a in self.arrivals),
            duration=self.duration * factor,
            target_rps=None if self.target_rps is None
            else self.target_rps / factor,
            label=f"{self.label}@x{factor:g}",
            phases=tuple(
                Phase(p.duration * factor, p.rps / factor,
                      None if p.rps_end is None else p.rps_end / factor)
                for p in self.phases),
        )

    # -- persistence ---------------------------------------------------
    def to_json(self, path: Optional[str] = None) -> str:
        payload = {
            "label": self.label,
            "seed": self.seed,
            "duration": self.duration,
            "target_rps": self.target_rps,
            "arrivals": list(self.arrivals),
            "phases": [[p.duration, p.rps, p.rps_end] for p in self.phases],
        }
        text = json.dumps(payload, indent=1)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    @classmethod
    def from_json(cls, source) -> "Trace":
        """Load a trace from a JSON string or a path to a JSON file."""
        if not isinstance(source, str) or "{" not in source:
            with open(source) as f:
                source = f.read()
        d = json.loads(source)
        return cls(arrivals=tuple(d["arrivals"]), duration=d["duration"],
                   seed=d.get("seed", 0), target_rps=d.get("target_rps"),
                   label=d.get("label", "trace"),
                   phases=tuple(Phase(*p) for p in d.get("phases", ())))

    def describe(self) -> str:
        tgt = "-" if self.target_rps is None else f"{self.target_rps:.2f}"
        return (f"trace[{self.label}] n={self.n} dur={self.duration:.1f}s "
                f"target={tgt} rps measured={self.mean_rps:.2f} rps "
                f"max_gap={self.largest_gap():.1f}s")
