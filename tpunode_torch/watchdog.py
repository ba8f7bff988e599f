"""Stall watchdog: localize hangs instead of discovering them post-mortem.

A device call blocking for an entire watchdog budget with nothing in
the logs but a timeout is exactly the failure this actor exists for.  It watches three stall surfaces:

* **event-loop lag** — the gap between when a timer should have fired and
  when it did.  A blocked loop (sync I/O, a long pure-Python section)
  shows up here before anything else does.  Exposed as the
  ``watchdog.loop_lag_seconds`` gauge + ``watchdog.loop_lag`` histogram.
* **mailbox head age** — per-:class:`tpunode_torch.actors.Mailbox` oldest-message
  age.  A healthy actor drains its queue; a head message older than the
  threshold means the consumer is stuck, even when qsize looks plausible.
* **verify dispatch in-flight time** — how long the engine's current
  device dispatch has been running in its worker thread.  A wedged
  backend pins this while the event loop stays healthy.

Each stall emits ONE ``watchdog.stall`` event per episode (re-armed when
the condition clears) so a persistent hang cannot flood the event log.
The node links a :class:`Watchdog` like its other loops
(``NodeConfig.watchdog_interval``; 0 disables).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Iterable, Optional

from .actors import Mailbox
from .events import EventLog, events
from .metrics import metrics

__all__ = ["WatchdogConfig", "Watchdog"]

log = logging.getLogger("tpunode_torch.watchdog")

metrics.describe(
    "watchdog.stalled",
    "stall surfaces currently in an episode (0 = healthy)",
)


@dataclass
class WatchdogConfig:
    interval: float = 1.0  # seconds between checks
    lag_threshold: float = 0.5  # event-loop lag that counts as a stall
    mailbox_age_threshold: float = 30.0  # head-message age that counts
    dispatch_stall_threshold: float = 60.0  # verify dispatch in-flight time


class Watchdog:
    """Periodic stall checker (``tick``-style, like StatsReporter: the
    ``run`` loop and tests both drive :meth:`check`)."""

    def __init__(
        self,
        cfg: Optional[WatchdogConfig] = None,
        mailboxes: Iterable[Mailbox] = (),
        engine=None,  # anything with dispatch_inflight_seconds() -> float
        log_: Optional[EventLog] = None,
        attributor=None,  # asyncsan.LoopAttributor (or None): names the
        # frame that froze the loop, merged into event_loop stall events
    ):
        self.cfg = cfg or WatchdogConfig()
        self.mailboxes = list(mailboxes)
        self.engine = engine
        self.log = log_ if log_ is not None else events
        self.attributor = attributor
        # stall keys currently in an episode: emit once, re-arm on clear
        self._stalled: set[str] = set()
        self._last_lag = 0.0  # newest measured loop lag (snapshot())

    def add_mailbox(self, mb: Mailbox) -> None:
        self.mailboxes.append(mb)

    # -- checks ---------------------------------------------------------------

    def check(self, lag: float = 0.0) -> list[dict]:
        """One pass over every stall surface; returns the ``watchdog.stall``
        events emitted this pass (empty on a healthy node)."""
        emitted: list[dict] = []
        self._last_lag = lag
        metrics.set_gauge("watchdog.loop_lag_seconds", lag)
        metrics.observe("watchdog.loop_lag", lag)
        if lag > self.cfg.lag_threshold:
            fields = dict(
                kind="event_loop", lag_seconds=round(lag, 4),
                threshold=self.cfg.lag_threshold,
            )
            # asyncsan attribution: the stack captured DURING the freeze
            # upgrades "the loop stalled" to "the loop stalled here".
            # max_age scopes the capture to THIS episode — the freeze just
            # measured plus a couple of intervals of slack — so a stale
            # capture from an earlier stall never blames the wrong code.
            if self.attributor is not None:
                blocked = self.attributor.last_blocked(
                    max_age=lag + 2 * self.cfg.interval
                )
                if blocked is not None:
                    fields["blocked_frames"] = blocked["frames"]
                    fields["blocked_age_seconds"] = blocked["age_seconds"]
            emitted += self._stall("event_loop", **fields)
        else:
            self._clear("event_loop")
        now = time.monotonic()
        for mb in self.mailboxes:
            age = mb.oldest_age(now)
            key = f"mailbox:{mb.name or id(mb)}"
            if age > self.cfg.mailbox_age_threshold:
                emitted += self._stall(
                    key, kind="mailbox", mailbox=mb.name,
                    age_seconds=round(age, 3), depth=mb.qsize(),
                    threshold=self.cfg.mailbox_age_threshold,
                )
            else:
                self._clear(key)
        if self.engine is not None:
            # Oldest-inflight age: with a dispatch pipeline
            # the engine tracks per-lane start times and reports the
            # OLDEST — a single wedged lane is visible even while
            # younger lanes keep completing.  The contract is unchanged:
            # 0.0 when idle, one stall event per episode.
            age = self.engine.dispatch_inflight_seconds()
            if age > self.cfg.dispatch_stall_threshold:
                fields = dict(
                    kind="verify_dispatch",
                    age_seconds=round(age, 3),
                    threshold=self.cfg.dispatch_stall_threshold,
                )
                depth = getattr(self.engine, "dispatch_inflight", None)
                if depth is not None:
                    fields["inflight"] = depth()
                emitted += self._stall("verify_dispatch", **fields)
            else:
                self._clear("verify_dispatch")
        # Level signal for the SLO evaluator: episodes emit one
        # event each, but burn-rate accounting needs "are we stalled NOW".
        metrics.set_gauge("watchdog.stalled", float(len(self._stalled)))
        return emitted

    def snapshot(self) -> dict:
        """Current state of every stall surface — the flight recorder's
        ``watchdog`` bundle section (what was stuck, and how stuck, at
        the moment of the trigger)."""
        now = time.monotonic()
        out: dict = {
            "last_lag_seconds": round(self._last_lag, 4),
            "stalled": sorted(self._stalled),
            "mailboxes": [
                {
                    "mailbox": mb.name,
                    "oldest_age_seconds": round(mb.oldest_age(now), 3),
                    "depth": mb.qsize(),
                }
                for mb in self.mailboxes
            ],
            "thresholds": {
                "lag": self.cfg.lag_threshold,
                "mailbox_age": self.cfg.mailbox_age_threshold,
                "dispatch_stall": self.cfg.dispatch_stall_threshold,
            },
        }
        if self.engine is not None:
            out["dispatch_inflight_seconds"] = round(
                self.engine.dispatch_inflight_seconds(), 3
            )
            depth = getattr(self.engine, "dispatch_inflight", None)
            if depth is not None:
                out["dispatch_inflight"] = depth()
        return out

    def _stall(self, key: str, **fields) -> list[dict]:
        if key in self._stalled:
            return []  # already reported this episode
        self._stalled.add(key)
        metrics.inc("watchdog.stalls")
        log.warning("[Watchdog] stall detected: %s %r", key, fields)
        return [self.log.emit("watchdog.stall", **fields)]

    def _clear(self, key: str) -> None:
        if key in self._stalled:
            self._stalled.discard(key)
            log.info("[Watchdog] stall cleared: %s", key)

    # -- loop -----------------------------------------------------------------

    async def run(self) -> None:
        """Linked watchdog loop: measures its own wakeup lag as the
        event-loop health signal, then sweeps the other surfaces."""
        last = time.monotonic()
        while True:
            await asyncio.sleep(self.cfg.interval)
            now = time.monotonic()
            lag = max(0.0, now - last - self.cfg.interval)
            self.check(lag)
            last = time.monotonic()
