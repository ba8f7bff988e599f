"""Structured event log: append-only JSONL sink + StatsReporter actor.

The reference's only observability is ad-hoc textual logging; this module
records *typed* events — peer connect/disconnect/ban, handshake results,
chain reorgs, header-batch imports, verify-batch dispatches and failures —
into an in-memory ring buffer, optionally mirrored to a JSONL file
(``EventLog(path=...)``).  Every event is one JSON object::

    {"ts": <unix seconds>, "type": "<layer>.<name>", ...fields, "seq": <n>}

``seq`` is a per-log monotonic sequence number (assigned under the ring
lock) — the ``/events?since=<seq>`` cursor and the flight recorder's
ordering both key off it.

so a session's history can be replayed, grepped, or diffed (the schema is
pinned by tests/test_events.py).  Emission is thread-safe (the verify
engine emits from its dispatch worker thread) and cheap enough for the
per-batch path; it is NOT wired into per-message hot loops.

:class:`StatsReporter` is the periodic telemetry actor: it snapshots the
metrics registry on an interval, computes *windowed* rates by diffing
successive snapshots (fixing the since-process-start ``rate()``), and
emits a ``node.stats`` event — the node links it like its other loops
(tpunode/actors.py substrate).
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import threading
import time
from collections import Counter, deque
from typing import Callable, Optional

from . import threadsan
from .metrics import metrics

__all__ = ["EventLog", "events", "StatsReporter"]

log = logging.getLogger("tpunode_torch.events")


class _Observer:
    """One subscriber: its callback plus a consecutive-failure count (the
    auto-unsubscribe bookkeeping — see ``EventLog.emit``)."""

    __slots__ = ("cb", "failures")

    def __init__(self, cb: Callable[[dict], None]):
        self.cb = cb
        self.failures = 0


class EventLog:
    """Ring buffer of typed events with an optional JSONL file sink."""

    # Consecutive callback failures before a subscriber is dropped: a
    # persistently-broken observer must not keep burning the emitters'
    # hot path (each failure pays exception handling + a counter).
    MAX_SUBSCRIBER_FAILURES = 10

    def __init__(self, maxlen: int = 4096, path: Optional[str] = None):
        self._lock = threadsan.lock("events.ring")
        # Monotonic per-log sequence number, assigned under the ring lock:
        # the /events?since=<seq> cursor (pollers fetch only what they
        # have not seen) and the flight recorder's bundle ordering both
        # key off it.  Never reset — a restart starts a new JSONL file
        # anyway, and within one process seq strictly increases.
        self._seq = 0
        # Separate sink lock: TextIOWrapper is NOT thread-safe, so file
        # writes must serialize — but behind their own lock, so a slow
        # disk stalls only writers, never ring readers/counters.
        self._sink_lock = threadsan.lock("events.sink")
        self._ring: deque[dict] = deque(maxlen=maxlen)
        self._counts: Counter[str] = Counter()
        self._file: Optional[io.TextIOBase] = None
        self._path = path
        # observers get every event dict (node republishes to its bus)
        self._observers: list[_Observer] = []

    def emit(self, type: str, **fields) -> dict:
        """Record one event; returns the event dict (with ``ts`` set)."""
        ev = {"ts": round(time.time(), 6), "type": type}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            self._counts[type] += 1
            if self._path is not None and self._file is None:
                try:
                    # line-buffered: every event line reaches the OS
                    # without an explicit flush() per emit
                    self._file = open(
                        self._path, "a", encoding="utf-8", buffering=1
                    )
                except OSError:
                    self._path = None  # sink broken: memory ring only
            sink = self._file
            observers = tuple(self._observers)
        if sink is not None:
            line = json.dumps(ev, default=str) + "\n"
            try:
                with self._sink_lock:
                    sink.write(line)
            except (OSError, ValueError):
                with self._lock:
                    self._file = None
                    self._path = None
        for ob in observers:
            # a raised callback must not propagate into the emitter's hot
            # path: count it, and drop the subscriber after enough
            # CONSECUTIVE failures (one success re-arms the budget)
            try:
                ob.cb(ev)
                ob.failures = 0
            except Exception as e:
                metrics.inc("events.subscriber_errors")
                ob.failures += 1
                if ob.failures >= self.MAX_SUBSCRIBER_FAILURES:
                    with self._lock:
                        if ob in self._observers:
                            self._observers.remove(ob)
                    log.warning(
                        "event subscriber %r dropped after %d consecutive "
                        "failures (last: %r)", ob.cb, ob.failures, e,
                    )
        return ev

    def tail(self, n: int = 100, type: Optional[str] = None) -> list[dict]:
        """Newest ``n`` events (oldest first), optionally one type only."""
        with self._lock:
            evs = list(self._ring)
        if type is not None:
            evs = [e for e in evs if e["type"] == type]
        return evs[-n:]

    def tail_since(self, seq: int, n: int = 100) -> list[dict]:
        """Events with ``seq > seq`` (oldest first), capped at ``n`` —
        the /events cursor: a poller remembers the last seq it saw and
        never re-downloads the whole ring."""
        with self._lock:
            evs = [e for e in self._ring if e["seq"] > seq]
        return evs[-n:]

    def seq(self) -> int:
        """The seq of the newest event (0 before the first emit)."""
        with self._lock:
            return self._seq

    def counts(self) -> dict[str, int]:
        """Total events per type since start (survives ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def subscribe(self, cb: Callable[[dict], None]) -> Callable[[], None]:
        """Register an observer; returns an unsubscribe callable.

        Observer exceptions never reach emitters: they are counted in the
        ``events.subscriber_errors`` metric, and a subscriber that fails
        :data:`MAX_SUBSCRIBER_FAILURES` times in a row is dropped."""
        ob = _Observer(cb)
        with self._lock:
            self._observers.append(ob)

        def unsubscribe() -> None:
            with self._lock:
                if ob in self._observers:
                    self._observers.remove(ob)

        return unsubscribe

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._counts.clear()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None


# Process-wide event log (tests may construct their own).
events = EventLog()


# Counters surfaced as windowed rates in every stats event (the headline
# node signals; anything else can be read from the snapshot itself).
_RATED = (
    "chain.headers",
    "node.verify_txs",
    "node.verify_inputs",
    "verify.items",
    "peer.msgs_in",
    "peer.bytes_in",
    "peer.bytes_out",
)

# Labeled families summarized into every node.stats event as bounded-cardinality
# aggregates: family name -> the label key to sum by.  The raw per-peer
# series stay out of the persisted event (unbounded cardinality — they
# belong to Node.stats()/render_prometheus() pulls); summing ``peer.msgs``
# by ``cmd`` keeps the message-mix signal without the peer dimension.
_LABEL_AGG: dict[str, str] = {"peer.msgs": "cmd"}


class StatsReporter:
    """Periodic registry snapshot -> windowed rates -> ``node.stats`` events.

    Rates are computed by diffing successive snapshots over the actual
    elapsed interval, so an idle hour does not dilute the current
    throughput the way ``lifetime_rate`` does.  Run it linked like any
    node loop::

        reporter = StatsReporter(interval=30.0)
        tasks.link(reporter.run(), name="stats")
    """

    def __init__(
        self,
        interval: float = 30.0,
        log: Optional[EventLog] = None,
        extra: Optional[Callable[[], dict]] = None,
        label_agg: Optional[dict[str, str]] = None,
    ):
        self.interval = interval
        self.log = log if log is not None else events
        self.extra = extra  # node hook: chain height, fleet size, backlog
        self.label_agg = _LABEL_AGG if label_agg is None else label_agg
        self._last: Optional[tuple[float, dict[str, float]]] = None

    def tick(self) -> dict:
        """One report (synchronous; the loop and tests both use it)."""
        now = time.monotonic()
        # unlabeled series only: the labeled families (per-peer msgs/RTT)
        # are unbounded-cardinality and belong to Node.stats()/
        # render_prometheus() pulls, not to an event persisted every tick
        snap = {
            k: v for k, v in metrics.snapshot().items() if "{" not in k
        }
        rates: dict[str, float] = {}
        if self._last is not None:
            t0, prev = self._last
            dt = max(1e-9, now - t0)
            for name in _RATED:
                cur = snap.get(name, 0.0)
                if cur or prev.get(name):
                    rates[name] = round((cur - prev.get(name, 0.0)) / dt, 3)
        self._last = (now, snap)
        # labeled-series aggregates (see _LABEL_AGG): bounded by the label
        # key's value space (e.g. wire commands), never by peer count
        labeled: dict[str, dict[str, float]] = {}
        for family, key in self.label_agg.items():
            agg: dict[str, float] = {}
            for lk, v in metrics.series(family).items():
                value = dict(lk).get(key)
                if value is not None:
                    agg[value] = agg.get(value, 0.0) + v
            if agg:
                labeled[family] = agg
        fields: dict = {"rates": rates, "counters": snap, "labeled": labeled}
        if self.extra is not None:
            try:
                fields.update(self.extra())
            except Exception as e:
                fields["extra_error"] = repr(e)
        # "node.stats": the event type followed the
        # <layer>.<name> schema everywhere else; the old grandfathered
        # bare "stats" name is gone.
        return self.log.emit("node.stats", **fields)

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self.tick()
