"""SLO engine: declarative objectives + multi-window burn-rate alerts.

The rest of the observability stack is retrospective — metrics,
traces, the timeline + flight recorder all answer "what
happened".  Nothing states an *objective*:
verification-as-a-service needs per-tenant quotas and QoS-aware
shedding, which presuppose a layer that can say "block-class verdict
latency is meeting its target, and we are burning error budget at rate
R".  This module is that layer:

* :class:`SloDef` — one declarative objective.  Three kinds:

  - ``latency`` — fraction of ``node.verdict_latency{priority=}``
    observations under ``threshold`` seconds.  Good/bad counts come
    straight from the live histogram's cumulative buckets
    (:meth:`tpunode_torch.metrics.Histogram.count_le`); thresholds sit on
    bucket boundaries so the counts are exact, not interpolated.
  - ``stall`` — fraction of evaluator ticks with no watchdog stall
    episode active (the ``watchdog.stalled`` gauge).
  - ``breaker`` — fraction of ticks with the verify circuit breaker not
    open (the ``verify.breaker_state`` gauge).

* :class:`SloEvaluator` — a small linked task that samples each SLO's
  cumulative (good, bad) counts into two ring tiers scaled to the
  timeline's (timeseries.py) 1s/15s tiers, and computes
  **multi-window burn rates**: burn = (bad fraction in window) / (1 −
  objective), over a fast 5-minute and a slow 1-hour window.  Burn ≥
  14.4 on the fast window (or ≥ 6 on the slow) means the error budget
  is being consumed at least that many times faster than the objective
  allows — the classic SRE two-window page condition.  A breach emits
  ONE ``slo.burn{slo=,window=}`` event per episode (re-armed when the
  burn drops below threshold, same latching as ``watchdog.stall``),
  which the flight recorder treats as a trigger: the bundle gains an
  ``slo`` section (definitions, budgets, burn history, and the verify
  cost ledger snapshot).

Like the timeline, there is an off-switch — ``NodeConfig.slos=None``
(or ``SloEvaluator(disabled=True)``) — and the disabled
:meth:`SloEvaluator.tick` is one attribute read.  Stdlib only; reads the registry, owns no locks beyond one.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from . import threadsan
from .events import EventLog, events
from .metrics import Metrics, metrics

__all__ = [
    "DEFAULT_SLOS",
    "FAST_WINDOW",
    "SLOW_WINDOW",
    "SloDef",
    "SloEvaluator",
]

# Window sizes + page thresholds (Google SRE workbook's 2-window tiers),
# scaled to the timeline's 1s/15s ring tiers: the fast window reads the
# 1s ring (600 samples = 10 min capacity), the slow window the 15s ring
# (480 samples = 2 h capacity).
FAST_WINDOW = 300.0  # seconds
SLOW_WINDOW = 3600.0
FAST_BURN = 14.4  # burn-rate page thresholds per window
SLOW_BURN = 6.0

# verify.breaker_state gauge encoding (engine.CircuitBreaker.STATES):
# ready=0, degraded=1, open=2, probing=3.  Only "open" spends breaker
# budget — probing is the half-open recovery and degraded still serves.
_BREAKER_OPEN = 2.0


@dataclass(frozen=True)
class SloDef:
    """One declarative objective (``NodeConfig.slos`` row).

    ``objective`` is the target good fraction (0.99 = 1% error budget);
    ``threshold`` is the latency cut in seconds (``latency`` kind only —
    pick a :data:`tpunode_torch.metrics.DEFAULT_BUCKETS` boundary so the
    histogram counts are exact); ``priority`` selects the
    ``node.verdict_latency`` label (``latency`` kind only)."""

    name: str
    kind: str  # "latency" | "stall" | "breaker"
    objective: float = 0.99
    threshold: float = 0.0
    priority: str = ""
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "stall", "breaker"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name}: objective must be in (0, 1)"
            )
        if self.kind == "latency" and (
            self.threshold <= 0 or not self.priority
        ):
            raise ValueError(
                f"SLO {self.name}: latency kind needs threshold+priority"
            )

    def describe(self) -> dict:
        out = {
            "name": self.name,
            "kind": self.kind,
            "objective": self.objective,
            "description": self.description,
        }
        if self.kind == "latency":
            out["threshold_seconds"] = self.threshold
            out["priority"] = self.priority
        return out


# Shipped defaults: per-class verdict-latency targets (thresholds on the
# log-scaled bucket boundaries 2**n µs — exact cumulative counts), a
# dispatch-stall budget and a breaker-open budget.  Tighter target for
# live block ingest, looser down the priority ladder.
DEFAULT_SLOS: tuple[SloDef, ...] = (
    SloDef(
        "verdict-latency-block", "latency", objective=0.99,
        threshold=1e-6 * 2**19, priority="block",  # ~0.524 s
        description="block-class submit->verdict latency",
    ),
    SloDef(
        "verdict-latency-mempool", "latency", objective=0.99,
        threshold=1e-6 * 2**21, priority="mempool",  # ~2.10 s
        description="mempool-class submit->verdict latency",
    ),
    SloDef(
        "verdict-latency-ibd", "latency", objective=0.95,
        threshold=1e-6 * 2**23, priority="ibd",  # ~8.39 s
        description="ibd-class submit->verdict latency",
    ),
    SloDef(
        "verdict-latency-bulk", "latency", objective=0.95,
        threshold=1e-6 * 2**24, priority="bulk",  # ~16.8 s
        description="bulk-class submit->verdict latency",
    ),
    SloDef(
        "dispatch-stall", "stall", objective=0.99,
        description="evaluator ticks with no watchdog stall active",
    ),
    SloDef(
        "breaker-open", "breaker", objective=0.99,
        description="evaluator ticks with the verify breaker not open",
    ),
)


class _SloState:
    """Per-SLO ring storage: cumulative (ts, good, bad) samples in two
    decimated tiers, mirroring the timeline's shape."""

    __slots__ = ("d", "rings", "good", "bad", "burn")

    def __init__(self, d: SloDef, tiers):
        self.d = d
        self.rings = tuple(deque(maxlen=cap) for _, cap in tiers)
        self.good = 0  # cumulative counters (stall/breaker kinds own
        self.bad = 0  # them; latency kinds mirror the histogram)
        self.burn = {"fast": 0.0, "slow": 0.0}


class SloEvaluator:
    """Evaluate a set of :class:`SloDef` against the live registry.

    ``tick``-style like StatsReporter/Timeline: the linked ``run`` loop
    and tests both drive :meth:`tick` (tests with explicit ``now=`` so
    burn scenarios need no wall-clock sleeps)."""

    # (decimation, capacity) per ring tier — scaled to the timeline's.
    TIERS: tuple[tuple[int, int], ...] = ((1, 600), (15, 480))

    def __init__(
        self,
        defs: Optional[Iterable[SloDef]] = DEFAULT_SLOS,
        registry: Optional[Metrics] = None,
        log_: Optional[EventLog] = None,
        interval: float = 1.0,
        ledger: Optional[Callable[[], dict]] = None,
        disabled: bool = False,
    ):
        if defs is None:
            disabled = True
            defs = ()
        self.disabled = disabled
        self.defs = tuple(defs)
        names = [d.name for d in self.defs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.registry = registry if registry is not None else metrics
        self.log = log_ if log_ is not None else events
        self.interval = interval
        self.ledger = ledger  # zero-arg -> engine ledger snapshot
        # one lock: tick() runs on the sampler task, snapshot() from
        # whatever thread the flight recorder fires on
        self._lock = threadsan.lock("slo.evaluator")
        self._states = {d.name: _SloState(d, self.TIERS) for d in self.defs}
        self._ticks = 0
        # (slo, window) pairs currently in a burn episode: emit once,
        # re-arm when the burn drops below the window's threshold
        self._burning: set[tuple[str, str]] = set()
        self._burn_history: deque[dict] = deque(maxlen=32)
        self.registry.describe(
            "slo.burn_rate",
            "error-budget burn rate per SLO and window (1.0 = budget "
            "consumed exactly at the objective's allowance)",
        )
        self.registry.describe(
            "slo.budget_remaining",
            "fraction of the slow-window error budget left per SLO",
        )

    # -- sampling -------------------------------------------------------------

    def _counts(self, st: _SloState) -> tuple[int, int]:
        """Cumulative (good, bad) for one SLO right now."""
        d = st.d
        if d.kind == "latency":
            h = self.registry.histogram(
                "node.verdict_latency", labels={"priority": d.priority}
            )
            if h is None:
                return 0, 0
            good = h.count_le(d.threshold)
            return good, h.count - good
        if d.kind == "stall":
            level = self.registry.get("watchdog.stalled") > 0.0
        else:  # breaker
            level = (
                self.registry.get("verify.breaker_state") == _BREAKER_OPEN
            )
        if level:
            st.bad += 1
        else:
            st.good += 1
        return st.good, st.bad

    @staticmethod
    def _window_delta(
        ring: deque, now: float, window: float, good: int, bad: int
    ) -> tuple[int, int]:
        """(good, bad) accrued inside the trailing window: current
        cumulative counts minus the newest ring sample at or before the
        window start (falling back to the ring's oldest — a young
        process burns against what it has)."""
        cutoff = now - window
        base_g = base_b = 0
        for ts, g, b in ring:
            if ts > cutoff:
                break
            base_g, base_b = g, b
        return good - base_g, bad - base_b

    def tick(self, now: Optional[float] = None) -> int:
        """Evaluate every SLO once; returns how many were evaluated
        (0 when disabled — the off path is this one attribute read)."""
        if self.disabled:
            return 0
        ts = time.time() if now is None else now
        with self._lock:
            self._ticks += 1
            live = tuple(
                i for i, (decim, _) in enumerate(self.TIERS)
                if self._ticks % decim == 0
            )
            burns: list[dict] = []
            for st in self._states.values():
                good, bad = self._counts(st)
                for i in live:
                    st.rings[i].append((ts, good, bad))
                budget = 1.0 - st.d.objective
                for window, ring_idx, span_s, limit in (
                    ("fast", 0, FAST_WINDOW, FAST_BURN),
                    ("slow", 1, SLOW_WINDOW, SLOW_BURN),
                ):
                    wg, wb = self._window_delta(
                        st.rings[ring_idx], ts, span_s, good, bad
                    )
                    total = wg + wb
                    burn = (wb / total) / budget if total else 0.0
                    st.burn[window] = burn
                    key = (st.d.name, window)
                    if burn >= limit and wb > 0:
                        if key not in self._burning:
                            self._burning.add(key)
                            burns.append(
                                dict(
                                    slo=st.d.name, window=window,
                                    burn=round(burn, 3),
                                    threshold=limit,
                                    bad=wb, total=total,
                                    objective=st.d.objective, ts=ts,
                                )
                            )
                    else:
                        self._burning.discard(key)
            evaluated = len(self._states)
        # gauges + events OUTSIDE the lock: the event log fans out to
        # subscribers (the flight recorder builds a bundle inline) and
        # a snapshot() from that path must not deadlock
        for st in self._states.values():
            for window, burn in st.burn.items():
                self.registry.set_gauge(
                    "slo.burn_rate", round(burn, 4),
                    labels={"slo": st.d.name, "window": window},
                )
            self.registry.set_gauge(
                "slo.budget_remaining",
                self._budget_remaining(st),
                labels={"slo": st.d.name},
            )
        for b in burns:
            self._burn_history.append(b)
            self.registry.inc(
                "slo.burns", labels={"slo": b["slo"], "window": b["window"]}
            )
            self.log.emit(
                "slo.burn",
                **{k: v for k, v in b.items() if k != "ts"},
            )
        return evaluated

    def _budget_remaining(self, st: _SloState) -> float:
        """Fraction of the slow-window error budget left (1.0 with no
        traffic): 1 − slow-window burn, clamped to [0, 1]."""
        return max(0.0, min(1.0, 1.0 - st.burn["slow"]))

    # -- query ----------------------------------------------------------------

    def burning(self, window: str = "fast") -> list[str]:
        """Names of SLOs currently in a burn episode on ``window`` — the
        health() degraded signal."""
        with self._lock:
            return sorted(s for s, w in self._burning if w == window)

    def snapshot(self) -> dict:
        """The ``Node.stats()["slo"]`` / ``/slo`` / flight-recorder
        section: definitions, per-SLO budgets + burn state, the burn
        episode history, and the verify cost-ledger snapshot."""
        with self._lock:
            slos = []
            for st in self._states.values():
                ring = st.rings[0]
                good, bad = (ring[-1][1], ring[-1][2]) if ring else (0, 0)
                slos.append(
                    {
                        "definition": st.d.describe(),
                        "good": good,
                        "bad": bad,
                        "budget_remaining": round(
                            self._budget_remaining(st), 4
                        ),
                        "burn": {
                            w: round(b, 4) for w, b in st.burn.items()
                        },
                        "burning": sorted(
                            w
                            for s, w in self._burning
                            if s == st.d.name
                        ),
                    }
                )
            out = {
                "enabled": not self.disabled,
                "interval": self.interval,
                "ticks": self._ticks,
                "windows": {
                    "fast": {"seconds": FAST_WINDOW, "burn": FAST_BURN},
                    "slow": {"seconds": SLOW_WINDOW, "burn": SLOW_BURN},
                },
                "slos": slos,
                "burn_history": list(self._burn_history),
            }
        if self.ledger is not None:
            try:
                out["ledger"] = self.ledger()
            except Exception as e:
                out["ledger"] = {"error": repr(e)}
        else:
            out["ledger"] = None
        return out

    # -- loop -----------------------------------------------------------------

    async def run(self) -> None:
        """Linked evaluator loop (paced like the timeline sampler)."""
        while True:
            await asyncio.sleep(self.interval)
            self.tick()
