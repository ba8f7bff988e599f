"""Request-scoped causal tracing: per-block/tx pipeline trace trees.

The aggregates (metrics.py histograms, events.py) answer "what is slow";
this module answers "why was THIS one slow": one block or tx message yields
a single :class:`Trace` — a tree of timed spans with one trace id — that
follows the item through the actor pipeline:

    peer.payload -> peer.decode -> [mailbox hops] -> node.extract ->
    verify.queue -> verify.dispatch -> verify.prepare/transfer/kernel/
    readback -> node.commit

Propagation is ``contextvars``-based and implicit:

* ``_ACTIVE`` holds ``(trace, span_id)`` for the current task/thread;
* :class:`actors.Mailbox` captures it on ``send`` and re-activates
  it on ``receive`` (actor hops);
* ``asyncio.ensure_future``/``to_thread`` copy the context into child
  tasks; the verify engine re-activates it explicitly in its dispatch
  worker thread (the one boundary ``contextvars`` cannot cross alone);
* :class:`trace.span` records into the active trace when one
  exists — and costs nothing extra when none does (the <5µs pin in
  tests/test_bench.py covers the no-trace fast path).

The process-wide :data:`tracer` retains the N slowest finished traces (the
BENCH JSON ``slowest_traces`` section) plus a ring of recent ones (the
debug server's ``/traces``), and exports each finished trace as Chrome
trace-event JSON when ``TPUNODE_TRACE_DIR`` is set (load the file in
``chrome://tracing`` or Perfetto).  ``Tracer(enabled=False)`` creates no
traces; span/metrics recording is unaffected.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Iterator, Optional

from . import threadsan
from .metrics import metrics

__all__ = [
    "SpanRec",
    "Trace",
    "Tracer",
    "tracer",
    "current",
    "activate",
    "start_trace",
    "finish_active",
    "discard_active",
    "clear_active",
]

log = logging.getLogger("tpunode_torch.tracectx")

# The active trace position: None, or a (Trace, parent_span_id) pair.
_ACTIVE: contextvars.ContextVar[Optional[tuple["Trace", int]]] = (
    contextvars.ContextVar("tpunode_trace", default=None)
)

# Trace ids: a per-process random prefix + a counter — unique across the
# processes that may share one TPUNODE_TRACE_DIR, cheap per trace.
_ID_PREFIX = os.urandom(4).hex()
_ids = itertools.count(1)


class SpanRec:
    """One timed region inside a trace (flat record; the tree is encoded
    by ``parent`` span ids)."""

    __slots__ = ("id", "parent", "name", "t", "dur", "tid", "fields")

    def __init__(self, id: int, parent: Optional[int], name: str, t: float):
        self.id = id
        self.parent = parent
        self.name = name
        self.t = t  # seconds since trace start
        self.dur: Optional[float] = None  # seconds; None while open
        self.tid = threading.get_ident()
        self.fields: Optional[dict] = None

    def as_dict(self) -> dict:
        out = {
            "id": self.id,
            "parent": self.parent,
            "name": self.name,
            "t": round(self.t, 6),
            "dur": round(self.dur, 6) if self.dur is not None else None,
        }
        if self.fields:
            out["fields"] = self.fields
        return out


class Trace:
    """One item's lifecycle: a span tree under a single trace id.

    ``begin``/``end`` are thread-safe — the verify engine records phases
    from its dispatch worker thread while the event loop records actor
    spans into the same trace.
    """

    __slots__ = (
        "trace_id",
        "name",
        "t0",
        "wall0",
        "spans",
        "root",
        "finished",
        "_lock",
        "_next",
    )

    def __init__(self, name: str, trace_id: Optional[str] = None, **fields):
        self.trace_id = trace_id or f"{_ID_PREFIX}-{next(_ids):x}"
        self.name = name
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.finished = False
        self._lock = threadsan.lock("tracectx.trace")
        self._next = itertools.count(2)
        root = SpanRec(1, None, name, 0.0)
        if fields:
            root.fields = fields
        self.root = root
        self.spans: list[SpanRec] = [root]

    def begin(
        self, name: str, parent: Optional[int] = None, **fields
    ) -> SpanRec:
        """Open a child span; returns its record (close with :meth:`end`
        or by setting ``rec.dur`` directly)."""
        with self._lock:
            rec = SpanRec(
                next(self._next),
                parent if parent is not None else self.root.id,
                name,
                time.perf_counter() - self.t0,
            )
            if fields:
                rec.fields = fields
            self.spans.append(rec)
        return rec

    def end(self, rec: SpanRec, dur: Optional[float] = None) -> None:
        rec.dur = (
            dur if dur is not None else (time.perf_counter() - self.t0) - rec.t
        )

    @property
    def duration(self) -> float:
        """Root duration once finished; live extent of the tree until then."""
        if self.root.dur is not None:
            return self.root.dur
        with self._lock:
            return max((s.t + (s.dur or 0.0)) for s in self.spans)

    def as_dict(self) -> dict:
        with self._lock:
            spans = [s.as_dict() for s in self.spans]
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "start_ts": round(self.wall0, 6),
            "duration": round(self.duration, 6),
            "spans": spans,
        }

    def to_chrome(self) -> dict:
        """Chrome trace-event / Perfetto JSON (``ph: "X"`` complete events,
        µs timestamps on the wall clock)."""
        pid = os.getpid()
        evs = []
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            args = {"trace_id": self.trace_id, "span_id": s.id}
            if s.parent is not None:
                args["parent"] = s.parent
            if s.fields:
                args.update(s.fields)
            evs.append(
                {
                    "name": s.name,
                    "cat": "tpunode",
                    "ph": "X",
                    "pid": pid,
                    "tid": s.tid,
                    "ts": (self.wall0 + s.t) * 1e6,
                    "dur": (s.dur or 0.0) * 1e6,
                    "args": args,
                }
            )
        return {
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id, "name": self.name},
            "traceEvents": evs,
        }


class Tracer:
    """Process-wide trace collector: start/finish, slowest-N retention,
    recent ring, optional Chrome-JSON export directory."""

    def __init__(
        self,
        trace_dir: Optional[str] = None,
        ring: int = 8,
        recent: int = 32,
        enabled: bool = True,
    ):
        self.trace_dir = (
            trace_dir
            if trace_dir is not None
            else os.environ.get("TPUNODE_TRACE_DIR")
        )
        self.enabled = enabled
        self.ring = ring
        self._lock = threadsan.lock("tracectx.tracer")
        self._slowest: list[Trace] = []  # kept sorted, slowest first
        self._recent: deque[Trace] = deque(maxlen=recent)

    def start(self, name: str, **fields) -> Trace:
        """New trace with an open root span (finish with :meth:`finish`)."""
        metrics.inc("trace.started")
        return Trace(name, **fields)

    def finish(self, trace: Trace) -> None:
        """Close the root span and retain the trace (idempotent — a trace
        may reach more than one finish site on coalesced paths)."""
        if trace.finished:
            return
        trace.finished = True
        if trace.root.dur is None:
            trace.end(trace.root)
        metrics.inc("trace.finished")
        with self._lock:
            self._recent.append(trace)
            self._slowest.append(trace)
            self._slowest.sort(key=lambda t: t.root.dur or 0.0, reverse=True)
            del self._slowest[self.ring :]
        if self.trace_dir:
            self._export(trace)

    def _export(self, trace: Trace) -> None:
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            fname = f"{trace.name.replace('.', '_')}-{trace.trace_id}.json"
            path = os.path.join(self.trace_dir, fname)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(trace.to_chrome(), f)
        except OSError as e:  # export is best-effort, never a hot-path error
            log.warning("trace export to %s failed, disabling: %s",
                        self.trace_dir, e)
            self.trace_dir = None

    def discard(self, trace: Trace) -> None:
        """Close a trace WITHOUT retaining or exporting it — the overload
        paths (verify shed/drop) end traces they will never attribute, and
        flooding the rings with shed stubs would evict the traces that
        matter.  Counted separately so started == finished + discarded."""
        if trace.finished:
            return
        trace.finished = True
        if trace.root.dur is None:
            trace.end(trace.root)
        metrics.inc("trace.discarded")

    def slowest(self, n: Optional[int] = None, name: Optional[str] = None
                ) -> list[dict]:
        """The slowest finished traces (dicts), slowest first."""
        with self._lock:
            traces = list(self._slowest)
        if name is not None:
            traces = [t for t in traces if t.name == name]
        return [t.as_dict() for t in traces[: n if n is not None else self.ring]]

    def recent_traces(self, n: int = 32) -> list[dict]:
        """The most recently finished traces (dicts), newest first."""
        if n <= 0:
            return []  # list[-0:] would be the WHOLE ring
        with self._lock:
            traces = list(self._recent)[-n:]
        return [t.as_dict() for t in reversed(traces)]

    def reset(self) -> None:
        with self._lock:
            self._slowest.clear()
            self._recent.clear()


# Process-wide tracer (tests may construct their own).
tracer = Tracer()


def current() -> Optional[tuple[Trace, int]]:
    """The active ``(trace, span_id)`` position, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(act: Optional[tuple[Trace, int]]) -> Iterator[None]:
    """Make ``act`` the active trace position for the enclosed region
    (no-op when None).  Works in worker threads too — this is how the
    verify engine carries a trace across the thread-pool boundary."""
    if act is None:
        yield
        return
    tok = _ACTIVE.set(act)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


@contextlib.contextmanager
def start_trace(
    name: str, tracer_: Optional[Tracer] = None, **fields
) -> Iterator[Optional[Trace]]:
    """Start a trace, activate its root for the enclosed region, finish on
    exit.  Yields None (and does nothing) when the tracer is disabled."""
    col = tracer_ if tracer_ is not None else tracer
    if not col.enabled:
        yield None
        return
    tr = col.start(name, **fields)
    tok = _ACTIVE.set((tr, tr.root.id))
    try:
        yield tr
    finally:
        _ACTIVE.reset(tok)
        col.finish(tr)


def finish_active(tracer_: Optional[Tracer] = None) -> None:
    """Finish the active trace (if any) and clear the context — the end
    of an item's pipeline (verdicts published, headers imported)."""
    act = _ACTIVE.get()
    if act is not None:
        (tracer_ if tracer_ is not None else tracer).finish(act[0])
        _ACTIVE.set(None)


def discard_active(tracer_: Optional[Tracer] = None) -> None:
    """Close and drop the active trace (if any) without retention — the
    shed/overload paths, where the item's pipeline ends by design."""
    act = _ACTIVE.get()
    if act is not None:
        (tracer_ if tracer_ is not None else tracer).discard(act[0])
        _ACTIVE.set(None)


def clear_active() -> None:
    """Detach the current context from any trace without ending it — for
    long-lived tasks that inherited a request context at creation."""
    if _ACTIVE.get() is not None:
        _ACTIVE.set(None)
