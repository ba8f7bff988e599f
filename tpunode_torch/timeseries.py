"""Metrics timeline: fixed-interval ring-buffer history of the registry.

Every metric in metrics.py is a point-in-time value; the moment
an incident is noticed, the shape that led up to it is gone.  This module
is the retrospective half: a sampler task snapshots the registry
(:meth:`Metrics.flat_sample` — counters, gauges, histogram
``.count``/``.sum`` moments) into per-series ring buffers on a fixed
interval, with **downsampling tiers** so recent history is fine-grained
and older history is cheap:

* tier 0 — every sample (default 1s × 600 = 10 minutes),
* tier 1 — every 15th sample (default 15s × 480 = 2 hours).

Decimation (keep the Nth sample) rather than averaging: counters are
monotonic so any retained sample is exact, and a gauge's decimated value
is a real observed value, not a synthetic mean.

Cardinality discipline: unlabeled series are always captured; **labeled**
series are captured only for families in ``label_families`` (default:
the per-host fleet series — ``sched.host_depth``, ``sched.host_steals``,
``verify.breaker_state``, ``mesh.host_chips`` — whose label set is fixed
at engine construction, plus ``slo.burn_rate`` whose label set is fixed
by the declared SLOs).
Per-peer families never reach the rings (address churn would grow them
without bound), and a hard ``max_series`` cap drops anything beyond it
(counted in ``tsdb.dropped_series``).

Query surface: :meth:`series`, :meth:`names`, :meth:`window` (the flight
recorder's bundle input), :meth:`fleet_history` (per-host view for
``Node.stats()["fleet_history"]`` and the ``/fleet`` endpoint).

Like span(): there is an off-switch — ``Timeline(disabled=True)`` (the
node's ``timeline_interval=0`` builds none) makes :meth:`tick` one
attribute read.  Stdlib-only.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Callable, Iterable, Optional

from . import threadsan
from .metrics import Metrics, metrics

__all__ = ["Timeline", "DEFAULT_TIERS", "DEFAULT_LABEL_FAMILIES"]

# (decimation factor vs. the base sampling interval, ring capacity).
# With the default 1s base interval: 1s x 600 = 10min, 15s x 480 = 2h.
DEFAULT_TIERS: tuple[tuple[int, int], ...] = ((1, 600), (15, 480))

# Labeled families worth a ring per label value: the per-host fleet
# gauges (bounded label set — hosts are fixed at engine construction)
# and the per-SLO burn rates (bounded by the declared SLO set).
DEFAULT_LABEL_FAMILIES: tuple[str, ...] = (
    "sched.host_depth",
    "sched.host_steals",
    "verify.breaker_state",
    "mesh.host_chips",
    "slo.burn_rate",
    # host-affine feed surface: bounded by the fixed host set
    "sched.feed_idle",
    "sched.affinity_routed",
)


class Timeline:
    """Ring-buffered metrics history with downsampling tiers."""

    def __init__(
        self,
        interval: float = 1.0,
        tiers: tuple[tuple[int, int], ...] = DEFAULT_TIERS,
        registry: Optional[Metrics] = None,
        extra: Optional[Callable[[], dict]] = None,
        label_families: Iterable[str] = DEFAULT_LABEL_FAMILIES,
        max_series: int = 512,
        disabled: bool = False,
    ):
        self.disabled = disabled
        self.interval = interval
        self.tiers = tuple(tiers)
        self.registry = registry if registry is not None else metrics
        self.extra = extra  # node hook: series the registry does not carry
        self.label_families = tuple(label_families)
        self.max_series = max_series
        # series name -> per-tier deque[(ts, value)].  One lock: tick()
        # writes from the sampler task, window() reads from whatever
        # thread the flight recorder fires on (engine dispatch workers).
        self._lock = threadsan.lock("timeseries.rings")
        self._rings: dict[str, tuple[deque, ...]] = {}
        self._ticks = 0
        self._dropped: set[str] = set()
        # Labeled-series lifecycle: when the registry evicts
        # a label pair (host retirement at engine teardown, peer-session
        # end), retire the matching rings too — otherwise fleet churn
        # regrows them from the drop cap forever.  on_drop holds the
        # hook weakly; the bound method dies with this Timeline.
        self.registry.on_drop(self.drop_label)

    # -- capture --------------------------------------------------------------

    def _keep(self, key: str) -> bool:
        if "{" not in key:
            return True
        family = key.split("{", 1)[0]
        # histogram moments of a labeled family: strip the moment suffix
        if family.endswith(".count") or family.endswith(".sum"):
            return False
        return family in self.label_families

    def tick(self, now: Optional[float] = None) -> int:
        """Capture one sample of every kept series; returns the number of
        series written (0 when disabled)."""
        if self.disabled:
            return 0
        ts = time.time() if now is None else now
        sample = self.registry.flat_sample()
        if self.extra is not None:
            try:
                sample.update(self.extra())
            except Exception:
                self.registry.inc("tsdb.extra_errors")
        with self._lock:
            self._ticks += 1
            # which tiers take this sample (tier 0 takes every one)
            live = tuple(
                i for i, (decim, _) in enumerate(self.tiers)
                if self._ticks % decim == 0
            )
            written = 0
            for key, value in sample.items():
                if not self._keep(key):
                    continue
                rings = self._rings.get(key)
                if rings is None:
                    if len(self._rings) >= self.max_series:
                        if key not in self._dropped:
                            self._dropped.add(key)
                            self.registry.inc("tsdb.dropped_series")
                        continue
                    rings = self._rings[key] = tuple(
                        deque(maxlen=cap) for _, cap in self.tiers
                    )
                point = (ts, value)
                for i in live:
                    rings[i].append(point)
                written += 1
        self.registry.inc("tsdb.samples")
        self.registry.set_gauge("tsdb.series", float(len(self._rings)))
        return written

    def drop_label(self, key: str, value: str) -> None:
        """Retire every ring whose rendered series key carries
        ``key="value"`` — the Timeline half of the registry's
        :meth:`Metrics.drop_label` eviction (wired via ``on_drop`` at
        construction).  Matching keys leave the ``_dropped`` set too:
        a host name REUSED by a future fleet gets a fresh ring instead
        of being silently discarded against the old cap entry."""
        needle = f'{key}="{value}"'
        with self._lock:
            for name in [n for n in self._rings if needle in n]:
                del self._rings[name]
            for name in [n for n in self._dropped if needle in n]:
                self._dropped.discard(name)

    # -- query ----------------------------------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def series(
        self, name: str, tier: int = 0, since: float = 0.0
    ) -> list[tuple[float, float]]:
        """Points ``[(ts, value), ...]`` (oldest first) for one series.
        Unknown series (or a disabled timeline) -> empty list."""
        with self._lock:
            rings = self._rings.get(name)
            if rings is None or not 0 <= tier < len(rings):
                return []
            pts = list(rings[tier])
        if since:
            pts = [p for p in pts if p[0] >= since]
        return pts

    def window(
        self, start: float, end: float, tier: int = 0
    ) -> dict[str, list[tuple[float, float]]]:
        """Every series' points with ``start <= ts <= end`` — the flight
        recorder's "timeline around the trigger" bundle section.  Series
        with no points in the window are omitted."""
        with self._lock:
            snap = {
                name: list(rings[tier])
                for name, rings in self._rings.items()
                if tier < len(rings)
            }
        out: dict[str, list[tuple[float, float]]] = {}
        for name, pts in snap.items():
            kept = [p for p in pts if start <= p[0] <= end]
            if kept:
                out[name] = kept
        return out

    def fleet_history(self, tier: int = 0) -> dict[str, dict[str, list]]:
        """Per-host view of the labeled fleet series:
        ``{host: {family: [(ts, value), ...]}}`` — how an 8→1→8 shrink
        looked, reconstructible after the fact."""
        with self._lock:
            snap = {
                name: list(rings[tier])
                for name, rings in self._rings.items()
                if "{" in name and tier < len(rings)
            }
        out: dict[str, dict[str, list]] = {}
        for name, pts in snap.items():
            family, _, labels = name.partition("{")
            host = None
            for part in labels.rstrip("}").split(","):
                k, _, v = part.partition("=")
                if k == "host":
                    host = v.strip('"')
                    break
            if host is None:
                continue
            out.setdefault(host, {})[family] = pts
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": not self.disabled,
                "interval": self.interval,
                "tiers": [
                    {"interval": self.interval * decim, "capacity": cap}
                    for decim, cap in self.tiers
                ],
                "series": len(self._rings),
                "ticks": self._ticks,
                "dropped_series": len(self._dropped),
            }

    # -- loop -----------------------------------------------------------------

    async def run(self) -> None:
        """Linked sampler loop (``NodeConfig.timeline_interval``)."""
        while True:
            await asyncio.sleep(self.interval)
            self.tick()
