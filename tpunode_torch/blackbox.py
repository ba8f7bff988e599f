"""Flight recorder: triggered post-mortem bundles (the node's black box).

An incident on a pod-shaped node — a watchdog stall, a breaker tripping
open, a fleet host partitioning, store corruption — currently evaporates
unless a human was tailing the event log when it happened.  The flight
recorder subscribes to the process event log and, when a **trigger**
event fires, freezes everything an operator would wish they had:

* the recent events ring (with per-type totals),
* the slowest + most recent causal traces (tracectx.py),
* the metrics timeline window around the trigger (timeseries.py)
  — including the per-host fleet series,
* live state sources wired in by the node: engine/breaker/mesh state,
  sched + fleet queue depths, watchdog surfaces, store stats, health,
* chaos-injection stats (so a chaos-driven incident is self-describing).

Triggers: ``watchdog.stall``, ``mesh.host_down``, ``store.corruption``,
``utxo.error``, ``asyncsan.task_leak``, ``slo.burn`` (an error-budget
burn-rate breach — the bundle's ``slo`` source carries the
breached definition, budgets, burn history and cost ledger), a circuit
breaker opening (``verify.breaker`` with ``to="open"``), and — via an
explicit :meth:`record` call from ``Node.__aexit__`` — an unclean
shutdown.

Bundles are **rate-limited** (``min_interval``, default 30s): an incident
storm produces one bundle plus a ``blackbox.suppressed`` count, never a
disk flood.  Bundles always land in an in-memory ring (``/flightrecords``
endpoint); with ``TPUNODE_BLACKBOX_DIR`` (or ``FlightRecorderConfig.dir``)
set, each is also written as one JSON file.  Stdlib-only; safe to fire from the engine's dispatch worker threads (one lock,
sources wrapped so a broken provider degrades to an error string).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import threadsan
from .chaos import chaos
from .events import EventLog, events
from .metrics import metrics
from .tracectx import tracer

__all__ = ["FlightRecorderConfig", "FlightRecorder", "TRIGGERS"]

log = logging.getLogger("tpunode_torch.blackbox")

# Event types that always trigger a dump.  ``verify.breaker`` is handled
# conditionally (only the transition INTO "open" is an incident) and
# ``blackbox.dump`` itself must never be here (self-triggering).
TRIGGERS = frozenset(
    {
        "watchdog.stall",
        "mesh.host_down",
        "store.corruption",
        "utxo.error",
        "asyncsan.task_leak",
        "threadsan.lock_cycle",
        "threadsan.lock_reentry",
        "slo.burn",
    }
)


@dataclass
class FlightRecorderConfig:
    dir: Optional[str] = None  # None -> $TPUNODE_BLACKBOX_DIR -> memory-only
    min_interval: float = 30.0  # seconds between dumps (rate limit)
    ring: int = 16  # in-memory bundles retained
    events_tail: int = 256  # recent events per bundle
    traces: int = 8  # slowest + recent traces per bundle
    window: float = 120.0  # timeline seconds captured before the trigger

    def __post_init__(self) -> None:
        if self.dir is None:
            self.dir = os.environ.get("TPUNODE_BLACKBOX_DIR") or None


class FlightRecorder:
    """Event-triggered post-mortem bundle writer."""

    def __init__(
        self,
        cfg: Optional[FlightRecorderConfig] = None,
        log_: Optional[EventLog] = None,
        timeline=None,  # tpunode_torch.timeseries.Timeline (or None)
        tracer_=None,
        sources: Optional[dict[str, Callable[[], object]]] = None,
    ):
        self.cfg = cfg or FlightRecorderConfig()
        self.log = log_ if log_ is not None else events
        self.timeline = timeline
        self.tracer = tracer_ if tracer_ is not None else tracer
        # name -> zero-arg callable; each lands as a top-level bundle key
        # (engine stats, watchdog snapshot, node health, store stats, ...)
        self.sources = dict(sources or {})
        self._lock = threadsan.lock("blackbox.recorder")
        self._records: deque[dict] = deque(maxlen=self.cfg.ring)
        self._last_dump = -float("inf")
        self._suppressed = 0
        self._dumps = 0
        self._write_errors = 0
        self._unsub: Optional[Callable[[], None]] = None

    # -- wiring ---------------------------------------------------------------

    def attach(self) -> None:
        """Subscribe to the event log (idempotent)."""
        if self._unsub is None:
            self._unsub = self.log.subscribe(self._on_event)

    def detach(self) -> None:
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    def _on_event(self, ev: dict) -> None:
        type_ = ev.get("type")
        if type_ in TRIGGERS or (
            type_ == "verify.breaker" and ev.get("to") == "open"
        ):
            self.record(reason=type_, trigger=ev)

    # -- recording ------------------------------------------------------------

    def record(
        self, reason: str, trigger: Optional[dict] = None, force: bool = False
    ) -> Optional[dict]:
        """Build one bundle now (rate-limited unless ``force``); returns
        the bundle, or None when suppressed."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_dump < self.cfg.min_interval:
                self._suppressed += 1
                metrics.inc("blackbox.suppressed")
                return None
            self._last_dump = now
        bundle = self._build(reason, trigger)
        bundle["path"] = self._write(bundle)
        with self._lock:
            self._records.append(bundle)
            self._dumps += 1
        metrics.inc("blackbox.dumps")
        # emitted AFTER the bundle is banked; not a trigger type, so the
        # recorder never feeds itself (observers run outside the log lock)
        self.log.emit(
            "blackbox.dump",
            reason=reason,
            trigger_seq=(trigger or {}).get("seq"),
            path=bundle["path"],
        )
        log.warning("[blackbox] flight record captured: %s", reason)
        return bundle

    def _build(self, reason: str, trigger: Optional[dict]) -> dict:
        ts = time.time()
        bundle: dict = {
            "ts": round(ts, 6),
            "reason": reason,
            "trigger": dict(trigger) if trigger else None,
            "events": self.log.tail(self.cfg.events_tail),
            "event_counts": self.log.counts(),
            "traces": {
                "slowest": self._safe(
                    lambda: self.tracer.slowest(self.cfg.traces)
                ),
                "recent": self._safe(
                    lambda: self.tracer.recent_traces(self.cfg.traces)
                ),
            },
            "chaos": self._safe(chaos.stats),
        }
        if self.timeline is not None:
            bundle["timeline"] = self._safe(
                lambda: self.timeline.window(ts - self.cfg.window, ts)
            )
            bundle["fleet_history"] = self._safe(self.timeline.fleet_history)
        else:
            bundle["timeline"] = {}
            bundle["fleet_history"] = {}
        for name, fn in self.sources.items():
            bundle[name] = self._safe(fn)
        return bundle

    @staticmethod
    def _safe(fn: Callable[[], object]):
        # a broken state provider degrades to an error string — a flight
        # record from a half-dead node must still be written
        try:
            return fn()
        except Exception as e:
            return {"error": repr(e)}

    def _write(self, bundle: dict) -> Optional[str]:
        directory = self.cfg.dir
        if not directory:
            return None
        name = "blackbox-{}-{}.json".format(
            int(bundle["ts"] * 1000), bundle["reason"].replace(".", "_")
        )
        path = os.path.join(directory, name)
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
            os.replace(tmp, path)
            return path
        except OSError as e:
            with self._lock:
                self._write_errors += 1
            metrics.inc("blackbox.write_errors")
            log.warning("[blackbox] bundle write failed: %r", e)
            return None

    # -- query ----------------------------------------------------------------

    def records(self, n: int = 16) -> list[dict]:
        """Newest ``n`` bundles, newest first (the /flightrecords body)."""
        with self._lock:
            return list(self._records)[-n:][::-1]

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.cfg.dir,
                "min_interval": self.cfg.min_interval,
                "dumps": self._dumps,
                "suppressed": self._suppressed,
                "write_errors": self._write_errors,
                "attached": self._unsub is not None,
            }
