"""Actor substrate: typed mailboxes, pub/sub, supervision.

The reference builds on the NQE actor library (reference: package.yaml:29;
``Inbox``/``Mailbox``/``Publisher``/``Supervisor`` imported at
src/Haskoin/Node.hs:49-56, src/Haskoin/Node/PeerMgr.hs:98-115, etc.).  This is
the asyncio-native equivalent:

* :class:`Mailbox` — a typed queue; ``send`` never blocks (NQE's
  ``send``/``sendSTM``), ``receive`` awaits the next message.  Optionally
  bounded with a counted drop-oldest policy.
* :class:`Publisher` — broadcast pub/sub where every subscriber owns a private
  queue (NQE ``withPublisher``/``withSubscription``); subscribing is an async
  context manager so subscriptions are always scoped.  Subscriber queues are
  bounded by default (drop-oldest) — one stalled embedder must not grow
  memory without bound.
* :class:`Supervisor` — owns child tasks and delivers death notifications to a
  callback, the analog of NQE's ``withSupervisor (Notify ...)`` + ``addChild``
  (reference: PeerMgr.hs:215,230,562-563).
* :class:`LinkedTasks` — the ``withAsync``+``link`` pattern: background loops
  whose failure must take the whole enclosing scope down
  (reference: Node.hs:191-192, Chain.hs:296, PeerMgr.hs:234).
* :class:`TaskRegistry` / :func:`spawn_supervised` — the asyncsan
  task-supervision registry: EVERY task tpunode spawns goes through here
  (the ``raw-spawn`` lint in tpunode/analysis enforces it), so an
  orphaned task — pending, with no live open owner — is reported at node
  shutdown as an ``asyncsan.task_leak`` event with its spawn site,
  instead of being garbage-collected mid-flight in silence.

Everything runs on one event loop; like the reference's STM-guarded actors,
state transitions are race-free because they never yield mid-update.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import sys
import time
import weakref
from collections import deque

from .chaos import chaos
from .compat import timeout as _timeout
from .events import events
from .metrics import metrics
from .tracectx import _ACTIVE as _active_trace
from typing import (
    AsyncIterator,
    Awaitable,
    Callable,
    Generic,
    Optional,
    TypeVar,
)

__all__ = [
    "Mailbox",
    "Publisher",
    "Supervisor",
    "LinkedTasks",
    "TaskRegistry",
    "task_registry",
    "spawn_supervised",
    "receive_match",
]

T = TypeVar("T")
U = TypeVar("U")


class _TaskRecord:
    """Registry bookkeeping for one spawned task: display name, spawn
    site (file:line outside actors.py), and a weakref to the owning
    supervisor-ish object (None = caller promised to await/cancel)."""

    __slots__ = ("name", "where", "owner")

    def __init__(self, name: str, where: str, owner: Optional[object]):
        self.name = name
        self.where = where
        self.owner = weakref.ref(owner) if owner is not None else None


class TaskRegistry:
    """Process-wide supervision registry (asyncsan runtime sanitizer).

    Every task spawned through :func:`spawn_supervised` is tracked until
    it completes.  :meth:`report_leaks` — called at node shutdown —
    emits one ``asyncsan.task_leak`` event (+ ``asyncsan.task_leaks``
    metric) per task that is still pending with no live, open owner:
    exactly the fire-and-forget orphans whose dropped handle the static
    ``dropped-task`` rule catches at lint time when the spawn is literal,
    and only this registry can catch when it is not.

    An *owner* scopes the leak check: a task whose owner is alive and not
    closing (``_closing`` false — the Supervisor/LinkedTasks convention)
    is supervised, not leaked, even while another node in the same
    process shuts down.  All mutation happens on the event-loop thread.
    """

    def __init__(self):
        self._records: dict[asyncio.Task, _TaskRecord] = {}

    def spawn(
        self,
        coro: Awaitable,
        name: str = "",
        owner: Optional[object] = None,
    ) -> asyncio.Task:
        task = asyncio.ensure_future(coro)  # asyncsan: disable=raw-spawn
        if name:
            task.set_name(name)
        self._records[task] = _TaskRecord(
            name or task.get_name(), _spawn_site(), owner
        )
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task: asyncio.Task) -> None:
        self._records.pop(task, None)

    def live(self) -> "list[asyncio.Task]":
        """Tracked tasks still pending (telemetry/debug view)."""
        return [t for t in self._records if not t.done()]

    def report_leaks(self, log_=None) -> "list[dict]":
        """Emit one ``asyncsan.task_leak`` event per orphaned pending
        task; returns the events.  Each leak is reported exactly once:
        its record is dropped from the registry on report (the task
        itself stays alive — cancelling it is the caller's call)."""
        sink = log_ if log_ is not None else events
        out: list[dict] = []
        for task, rec in list(self._records.items()):
            if task.done():
                continue
            if rec.owner is not None:
                owner = rec.owner()
                if owner is not None and not getattr(owner, "_closing", False):
                    continue  # supervised by a live, open owner
            del self._records[task]
            task.remove_done_callback(self._task_done)
            metrics.inc("asyncsan.task_leaks")
            out.append(
                sink.emit(
                    "asyncsan.task_leak", task=rec.name, where=rec.where,
                )
            )
        return out


# This module's own filename, for skipping registry-internal frames in
# _spawn_site (code objects compiled from this module carry exactly this
# string, so no per-spawn abspath work is needed).
_HERE = __file__


def _spawn_site() -> str:
    """file:line of the first caller frame outside this module — the
    attribution that makes a task-leak report actionable."""
    fr = sys._getframe(1)
    while fr is not None and fr.f_code.co_filename == _HERE:
        fr = fr.f_back
    if fr is None:
        return "?"
    return f"{os.path.basename(fr.f_code.co_filename)}:{fr.f_lineno}"


#: The process-wide registry (tests may construct private ones).
task_registry = TaskRegistry()


def spawn_supervised(
    coro: Awaitable, name: str = "", owner: Optional[object] = None
) -> asyncio.Task:
    """Spawn a task through the supervision registry — the only sanctioned
    way to create a task inside tpunode (lint rule ``raw-spawn``).

    ``owner`` is the supervising object (Supervisor, LinkedTasks, engine,
    peer handle...) responsible for cancelling/awaiting the task; pass
    None only when the spawning code itself awaits the handle before its
    scope exits.  Pending tasks with no live open owner are reported as
    ``asyncsan.task_leak`` at node shutdown."""
    return task_registry.spawn(coro, name=name, owner=owner)


class _Traced:
    """Queue envelope carrying a message's trace position (tracectx): the
    sender's active ``(trace, span_id)`` rides along so the receiving
    actor's processing lands in the same per-item trace."""

    __slots__ = ("item", "act")

    def __init__(self, item, act):
        self.item = item
        self.act = act


class Mailbox(Generic[T]):
    """Typed actor queue (NQE ``Inbox``/``Mailbox``).

    Unbounded by default (actor-internal mailboxes are drained by linked
    loops whose death tears the node down — crash-only, never silently
    lossy).  With ``maxsize`` set, ``send`` on a full queue evicts the
    OLDEST queued item instead of blocking or raising (drop-oldest), and
    counts the eviction in ``dropped`` + the process-wide
    ``bus.dropped`` metric — the policy for user-facing subscriptions,
    where one stalled embedder must not grow memory without bound
    (reference analog: bounded NQE/STM mailboxes, SURVEY.md C5).
    """

    def __init__(self, name: str = "", maxsize: Optional[int] = None):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 or None, got {maxsize}")
        self._queue: asyncio.Queue = asyncio.Queue()
        # enqueue monotonic timestamps, parallel to _queue: the watchdog's
        # oldest-message-age signal (a growing head age localizes a stuck
        # consumer even when qsize alone looks plausible)
        self._times: deque[float] = deque()
        self.name = name
        self.maxsize = maxsize
        self.dropped = 0

    def send(self, item: T) -> None:
        """Enqueue without blocking (NQE ``send``); see drop-oldest above.
        Captures the sender's active trace position (tracectx) so causal
        traces flow across actor hops."""
        act = _active_trace.get()
        if act is not None:
            item = _Traced(item, act)  # type: ignore[assignment]
        if chaos.on:  # injected delivery faults (tpunode/chaos.py)
            spec = chaos.decide("mailbox.send", self.name)
            if spec is not None and self._chaos_deliver(spec, item):
                return
        self._put(item)

    def _put(self, item) -> None:
        """Enqueue a (possibly trace-wrapped) item: the delivery core."""
        if self.maxsize is not None and self._queue.qsize() >= self.maxsize:
            try:
                self._queue.get_nowait()
                if self._times:
                    self._times.popleft()
            except asyncio.QueueEmpty:
                pass
            self.dropped += 1
            metrics.inc("bus.dropped")
        self._queue.put_nowait(item)
        self._times.append(time.monotonic())

    def _chaos_deliver(self, spec, item) -> bool:
        """Apply an injected delivery fault; True = chaos owns delivery.
        ``delay`` re-enqueues after ``dur`` seconds via the running loop;
        ``reorder`` jumps this message ahead of the current queue head.
        Both preserve at-least-once delivery — chaos perturbs timing and
        order, never drops actor mail (mailboxes are the crash-only
        control plane; loss belongs to the socket points)."""
        if spec.action == "delay":
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return False  # no loop to schedule on: deliver normally
            loop.call_later(spec.dur, self._put, item)
            return True
        if spec.action == "reorder":
            try:
                prev = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                return False  # nothing to swap with
            if self._times:
                self._times.popleft()
            self._put(item)  # the newcomer jumps the head
            self._put(prev)
            return True
        return False

    def _unwrap(self, item) -> T:
        """Pop-side of the trace envelope: re-activate the carried trace
        position for the receiving task (or clear a stale one)."""
        if type(item) is _Traced:
            _active_trace.set(item.act)
            return item.item
        if _active_trace.get() is not None:
            _active_trace.set(None)
        return item

    async def receive(self) -> T:
        item = await self._queue.get()
        if self._times:
            self._times.popleft()
        return self._unwrap(item)

    async def receive_match(self, select: Callable[[T], Optional[U]]) -> U:
        """Await the first message for which ``select`` returns non-None;
        non-matching messages are discarded (NQE ``receiveMatch`` as used on
        event subscriptions, e.g. NodeSpec.hs:202-205)."""
        while True:
            item = await self._queue.get()
            if self._times:
                self._times.popleft()
            out = select(self._unwrap(item))
            if out is not None:
                return out

    def drain_nowait(self) -> list[T]:
        """Pop every queued message without waiting (test/shutdown helper;
        unwraps trace envelopes like ``receive``)."""
        out: list[T] = []
        while True:
            try:
                item = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                return out
            if self._times:
                self._times.popleft()
            out.append(self._unwrap(item))

    def qsize(self) -> int:
        return self._queue.qsize()

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Seconds the head message has been waiting (0.0 when empty) —
        the watchdog's per-mailbox stall signal."""
        if not self._times:
            return 0.0
        return (time.monotonic() if now is None else now) - self._times[0]

    def __repr__(self) -> str:
        return f"<Mailbox {self.name or hex(id(self))} n={self._queue.qsize()}>"


async def receive_match(
    mailbox: Mailbox[T],
    select: Callable[[T], Optional[U]],
    timeout: float | None = None,
) -> U:
    """``receive_match`` with an optional timeout (NQE ``receiveMatchS``)."""
    if timeout is None:
        return await mailbox.receive_match(select)
    async with _timeout(timeout):
        return await mailbox.receive_match(select)


class Publisher(Generic[T]):
    """Broadcast bus with per-subscriber queues (NQE ``Publisher``).

    ``maxsize`` bounds every subscriber's private queue (drop-oldest,
    counted — see :class:`Mailbox`).  The default bounds the user event
    bus: the node republishes every peer message there (node.py
    ``_peer_events``), so a subscriber that stalls during a 150k-sig
    block or a mempool flood would otherwise grow memory without bound
   .  Pass ``maxsize=None`` for the internal
    always-drained glue buses.
    """

    DEFAULT_MAXSIZE = 10_000

    def __init__(self, name: str = "", maxsize: Optional[int] = DEFAULT_MAXSIZE):
        self._subscribers: set[Mailbox[T]] = set()
        self.name = name
        self.maxsize = maxsize

    def publish(self, event: T) -> None:
        for sub in tuple(self._subscribers):
            sub.send(event)

    @property
    def dropped(self) -> int:
        """Total events evicted across current subscribers."""
        return sum(sub.dropped for sub in self._subscribers)

    @contextlib.asynccontextmanager
    async def subscription(self) -> AsyncIterator[Mailbox[T]]:
        """Scoped subscription (NQE ``withSubscription``)."""
        mb: Mailbox[T] = Mailbox(name=f"{self.name}-sub", maxsize=self.maxsize)
        self._subscribers.add(mb)
        try:
            yield mb
        finally:
            self._subscribers.discard(mb)


DeathCallback = Callable[[asyncio.Task, Optional[BaseException]], None]


class Supervisor:
    """Parent of crash-isolated child tasks with death notification.

    Equivalent of NQE's ``withSupervisor (Notify cb)``: any child ending — by
    crash, cancellation or normal return — invokes ``on_death(task, exc)``
    instead of propagating, exactly how the reference turns peer-thread deaths
    into ``PeerDied`` manager messages (PeerMgr.hs:230).
    """

    def __init__(self, on_death: Optional[DeathCallback] = None, name: str = ""):
        self._children: set[asyncio.Task] = set()
        self._on_death = on_death
        self._closing = False
        self.name = name

    def add_child(self, coro: Awaitable, name: str = "") -> asyncio.Task:
        task = spawn_supervised(coro, name=name, owner=self)
        self._children.add(task)
        task.add_done_callback(self._child_done)
        return task

    def _child_done(self, task: asyncio.Task) -> None:
        self._children.discard(task)
        if self._closing:
            return
        if task.cancelled():
            exc: Optional[BaseException] = asyncio.CancelledError()
        else:
            exc = task.exception()
        if self._on_death is not None:
            self._on_death(task, exc)

    @property
    def children(self) -> set[asyncio.Task]:
        return set(self._children)

    async def aclose(self) -> None:
        """Cancel and await every child (end of the supervisor bracket)."""
        self._closing = True
        children = tuple(self._children)
        for t in children:
            t.cancel()
        for t in children:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._children.clear()

    async def __aenter__(self) -> "Supervisor":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()


class LinkedTasks:
    """Background loops whose crash must abort the owning scope.

    The reference ``link``s its glue loops and actor main loops so an internal
    crash tears down the whole node bracket (crash-only design, SURVEY.md §5).
    Here: the first exception from any linked task cancels all of them, is
    reported to ``on_failure`` (the hook the node uses to abort the embedding
    scope) and re-raised when the scope closes.
    """

    def __init__(
        self,
        name: str = "",
        on_failure: Optional[Callable[[BaseException], None]] = None,
    ):
        self._tasks: set[asyncio.Task] = set()
        self._failure: Optional[BaseException] = None
        self._closing = False
        self.name = name
        self.on_failure = on_failure

    def link(self, coro: Awaitable, name: str = "") -> asyncio.Task:
        task = spawn_supervised(coro, name=name, owner=self)
        self._tasks.add(task)
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if self._closing or task.cancelled():
            return
        exc = task.exception()
        if exc is not None and self._failure is None:
            self._failure = exc
            for t in tuple(self._tasks):
                t.cancel()
            if self.on_failure is not None:
                self.on_failure(exc)

    def check(self) -> None:
        if self._failure is not None:
            raise self._failure

    async def aclose(self) -> None:
        self._closing = True
        tasks = tuple(self._tasks)
        for t in tasks:
            t.cancel()
        for t in tasks:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._tasks.clear()
        if self._failure is not None:
            raise self._failure

    async def __aenter__(self) -> "LinkedTasks":
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self._closing = True
        tasks = tuple(self._tasks)
        for t in tasks:
            t.cancel()
        for t in tasks:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._tasks.clear()
        # don't mask an exception already unwinding the scope
        if exc is None and self._failure is not None:
            raise self._failure
